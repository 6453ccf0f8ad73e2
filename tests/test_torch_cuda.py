"""horovod_tpu_torch on the card: each CUDA kernel against its plain
version, the fused BatchNorm and a small ResNet training through the
kernels, and the engine's grouped allreduce through the pack kernel on NCCL.

These tests import only torch and the port, so they also run where jax is
not installed. On a machine with a GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The multi-card tests (``-k cards``) start one process per visible card on
NCCL and skip with fewer than two cards.

Without a GPU every test skips. Tolerances: the BN statistics are fp32 sums
of the same values in another order; a thread of the kernel sums up to a few
thousand terms in sequence, so they agree within 1e-4 of sum |terms|. The
pack is a copy and must be bitwise.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.engine import bucket_by_size
from horovod_tpu_torch.models.resnet import ResNet18ish
from horovod_tpu_torch.ops import kernels as K
from horovod_tpu_torch.ops.fused_batch_norm import FusedBatchNorm
from torch_worker import mlp_data, mlp_params, run_world, shard_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c", [(802816, 64), (12544, 1024), (3136, 2048),
                                 (777, 384)])
def test_cuda_bn_kernels_match_plain(cuda, dtype, m, c):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, c, device=cuda, generator=gen).to(dtype)
    dy = torch.randn(m, c, device=cuda, generator=gen).to(dtype)
    s, q = K.bn_stats(x)
    s_ref, q_ref = K.bn_stats_plain(x)
    xf, dyf = x.float(), dy.float()
    mean = s_ref / m
    invstd = torch.rsqrt(q_ref / m - mean * mean + 1e-5)
    s1, s2 = K.bn_bwd_stats(dy, x, mean, invstd)
    s1_ref, s2_ref = K.bn_bwd_stats_plain(dy, x, mean, invstd)
    xh = (xf - mean) * invstd
    for got, want, terms in ((s, s_ref, xf), (q, q_ref, xf * xf),
                             (s1, s1_ref, dyf), (s2, s2_ref, dyf * xh)):
        bound = 1e-5 * terms.abs().sum(0)    # per-thread fp32 runs
        assert bool(((got - want).abs() <= bound + 1e-6).all())
    again = K.bn_stats(x)
    assert torch.equal(again[0], s) and torch.equal(again[1], q)


def test_cuda_bn_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(64, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K.bn_stats(x.t())                       # not contiguous
    with pytest.raises(ValueError):
        K.bn_stats(x.half())                    # dtype
    with pytest.raises(ValueError):
        K.bn_stats(torch.zeros(64, 12, device=cuda, dtype=torch.bfloat16))


def test_cuda_pack_is_bitwise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(64, 3, 7, 7), (64,), (1000, 2048), (1000,), (3,), (7, 5)]
    ts = [torch.randn(s, device=cuda, generator=gen) for s in shapes]
    n0 = K.pack.launches
    assert torch.equal(K.pack(ts), K.pack_plain(ts))
    # a misaligned view exercises the 4-byte and byte paths
    base = torch.randn(4099, device=cuda, generator=gen)
    odd = [base[1:1000], base[1001:1004], base[3:4000]]
    assert torch.equal(K.pack(odd), K.pack_plain(odd))
    halves = [t.half() for t in odd]
    assert torch.equal(K.pack(halves), K.pack_plain(halves))
    assert K.pack.launches == n0 + 3


def test_cuda_resnet18ish_trains_through_the_bn_kernels(cuda):
    dev = cuda
    model = ResNet18ish(num_classes=10, dtype=torch.bfloat16,
                        fused_bn=True).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(8, 64, 64, 3, device=dev, generator=gen)
    y = torch.randint(0, 10, (8,), device=dev, generator=gen)
    K.reset_launch_counts()
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    # 17 BN layers: the stem, 3 per block, one projection per stage
    assert K.launch_counts()["bn_stats"] == 3 * 17
    assert K.launch_counts()["bn_bwd_stats"] == 3 * 17
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_cuda_fused_batch_norm_matches_its_cpu_path(cuda):
    """The same fp32 module on the card (kernels) and on the CPU (plain):
    outputs, all three gradients and the running statistics."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 64, 9, 9).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        bn = FusedBatchNorm(64, dtype=torch.float32).to(dev)
        with torch.no_grad():
            bn.weight.copy_(torch.tensor(w))
        xt = torch.tensor(x, device=dev).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = bn(xt)
        torch.sin(y).sum().backward()
        outs[dev.type] = [t.detach().cpu() for t in
                          (y, xt.grad, bn.weight.grad, bn.bias.grad,
                           bn.running_mean, bn.running_var)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


def test_cuda_grouped_allreduce_through_the_pack_kernel(cuda, monkeypatch):
    monkeypatch.setenv("HOROVOD_PALLAS_PACK", "1")
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(1 << 20))
    monkeypatch.delenv("HOROVOD_TPU_COORDINATOR", raising=False)
    hvd.init()
    try:
        assert hvd.device().type == "cuda"
        gen = torch.Generator(device=cuda).manual_seed(0)
        grads = [torch.randn(s, device=cuda, generator=gen)
                 for s in [(512, 256), (256,), (300, 1000), (7,)]]
        n_buckets = len(bucket_by_size(grads, 1 << 20))
        assert n_buckets > 1
        K.reset_launch_counts()
        for op in (hvd.Sum, hvd.Average):
            outs = hvd.grouped_allreduce(grads, op=op)
            assert all(torch.equal(o, g) for o, g in zip(outs, grads))
        assert K.launch_counts()["pack"] == 2 * n_buckets
    finally:
        hvd.shutdown()


@pytest.fixture
def cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    return n


def test_cuda_cards_engine_on_nccl(cards, tmp_path):
    res = run_world("engine", cards, tmp_path, device="cuda")
    xs = [r["x"] for r in res]
    groups = [r["group"] for r in res]
    rows = np.concatenate([r["gather_in"] for r in res])
    for rank, r in enumerate(res):
        assert (r["rank"], r["size"]) == (rank, cards)
        np.testing.assert_allclose(r["allreduce_sum"], sum(xs), rtol=1e-5)
        np.testing.assert_allclose(r["allreduce_avg"],
                                   2 * sum(xs) / cards * 0.5, rtol=1e-5)
        np.testing.assert_array_equal(r["allreduce_max"],
                                      np.max(np.stack(xs), axis=0))
        for op, div in (("sum", 1), ("avg", cards)):
            for got, *parts in zip(r[f"grouped_{op}"], *groups):
                np.testing.assert_allclose(got, 3 * sum(parts) / div * 0.25,
                                           rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["broadcast"], [float(cards)] * 3)
        np.testing.assert_array_equal(r["allgather"], rows)
        np.testing.assert_allclose(r["async"],
                                   [(cards + 1) / 2] * 4, rtol=1e-6)
        assert r["objects"] == [{"rank": i} for i in range(cards)]


def test_cuda_cards_optimizer_on_nccl(cards, tmp_path):
    """Ranks stay identical and follow SGD-momentum on the averaged shard
    gradients (a one-process torch reference on the CPU)."""
    res = run_world("optimizer", cards, tmp_path, device="cuda")
    x, y = (torch.tensor(a) for a in mlp_data())
    ref = torch.nn.Sequential(torch.nn.Linear(4, 8, bias=False),
                              torch.nn.Tanh(),
                              torch.nn.Linear(8, 2, bias=False))
    with torch.no_grad():
        ref[0].weight.copy_(torch.tensor(mlp_params()[0].T))
        ref[2].weight.copy_(torch.tensor(mlp_params()[1].T))
    opt = torch.optim.SGD(ref.parameters(), lr=0.01, momentum=0.9)
    shards = [shard_rows(r, cards, len(x)) for r in range(cards)]
    for step in range(3):
        opt.zero_grad()
        for s in shards:
            (((ref(x[s]) - y[s]) ** 2).mean() / cards).backward()
        opt.step()
        for r in res:
            got = r["traj"][step]
            np.testing.assert_array_equal(got[0], res[0]["traj"][step][0])
            np.testing.assert_allclose(
                got[0], ref[0].weight.detach().numpy().T, rtol=1e-4,
                atol=1e-5)
            np.testing.assert_allclose(
                got[1], ref[2].weight.detach().numpy().T, rtol=1e-4,
                atol=1e-5)
