"""horovod_tpu_torch on the card: each CUDA kernel against its plain
version, the fused BatchNorm and a small ResNet training through the
kernels, a small LM and ViT through the flash-attention kernels, the
engine's grouped allreduce through the pack kernel on NCCL, Adasum's
combine kernels (K4/K5) alone and training the flagship LM on 2 and 4
cards, SyncBatchNorm on K2/K3's raw sums (on one card against its CPU
path; on 2 and 4 cards against the global batch on one card), alltoall
and join on 2 and 4 cards, and step replay (``-k replay``: the CUDA graph
against the eager path on one card; ``-k "cards and replay"`` on 2 and 4),
the ZeRO-1 sharded optimizer (``-k sharded``: K1's ``out=`` form and
the sharded LM against the dense one on one card; ``-k "cards and
sharded"`` on 2 and 4), and the wire codecs (``-k "cards and codec"``:
the flagship LM through int8, fp8, bf16 and sharded int8 on 2 and 4), and
the observability around the engine (``-k observability``: no instrument
synchronizes, the native timeline, the memory gauge against
``torch.cuda.memory_stats()``, the watchdog breaking a hung launch), and
the overlap modes and the size cache (``-k "cards and overlap"``: the
flagship LM's reduction and ZeRO-1 step under off, interleave and staged
on 2 and 4 cards, bitwise alike; ``-k "cards and meta_cache"``: no
blocking size exchange in steady state on 2 cards, a size change raising
on both), and
durable checkpointing (``-k checkpoint``: a snapshot copies on the card
with no host wait; ``-k "cards and checkpoint"``: 4 cards write, 2
restore), and elastic training (``-k "elastic and not cards"``: a
recovery and a host update in process on NCCL; ``-k "cards and
elastic"``: a worker killed on 4 cards and relaunched by the port's
elastic launcher, and a scale-down from 4 cards to 2), and the survivable
control plane (``-k "cards and control_plane"``: 4 workers on 4 cards as
two islands outlive a SIGKILL of their driver and KV primary, the
telemetry rolled up per slice), and the estimator (``-k "cards and
estimator"``: the flagship at 2 layers through ``Estimator.fit`` on 2
cards with uneven shards, the replicas bitwise after each epoch).

These tests import only torch and the port, so they also run where jax is
not installed. On a machine with a GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The multi-card tests (``-k cards``) start one process per visible card on
NCCL and skip with fewer than two cards.

Without a GPU every test skips. Tolerances: the BN statistics are fp32 sums
of the same values in another order; a thread of the kernel sums up to a few
thousand terms in sequence, so they agree within 1e-4 of sum |terms|. The
pack is a copy and must be bitwise. The flash-attention kernels are held to
an fp32 computation from the same bf16 or fp16 inputs: their error may be
twice the plain version's in the input dtype, plus 1e-3 of the largest
entry (see ``_assert_flash_close``); with fp32 inputs they run on tf32
tensor cores (operands keep 10 mantissa bits, unit roundoff 2^-11), and
their error may be twice the plain version's in tf32 (``_plain_matmuls``),
plus 2^-12 of the largest entry (``TF32_FLOOR``); a whole attention path in
fp32 on the card is held to the CPU's within 1e-2 of the largest entry
(``TF32_PATH_TOL``). K4's triple is an fp32 sum in another order
than a float64 one: within 1e-5 of sum |terms|; K5's output within twice
the plain version's error against float64, plus the dtype's epsilon and
1e-6 of the largest entry (see ``test_cuda_adasum_kernels_match_plain``).
SyncBatchNorm's outputs (y, dx) agree to the dtype's epsilon (at least
1e-5) of the largest entry, its per-channel sums within 1e-4 of sum
|terms| as the BN statistics above, its statistics and running
statistics within 1e-5 of the largest entry.
"""

import contextlib
import math
import re
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.engine import bucket_by_size
from horovod_tpu_torch.models.resnet import ResNet18ish
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  lean_lm_loss)
from horovod_tpu_torch.models.vit import ViT
from horovod_tpu_torch.ops import adasum as A, collectives as C, \
    kernels as K
from horovod_tpu_torch.ops.fused_batch_norm import FusedBatchNorm
from horovod_tpu_torch.ops.sync_batch_norm import SyncBatchNorm
from horovod_tpu_torch.parallel.flash_attention import flash_attention_local
from horovod_tpu_torch.parallel.mesh import Topology
from torch_worker import (ADASUM_CARD_STEPS, ALGO_CARD_FORMS, CODEC_CARD_RUNS,
                          CODEC_CARD_STEPS, JOIN_TENSORS, OVERLAP_CARD_RUNS,
                          REPLAY_EXTRA, REPLAY_STEPS, RESNET_CARD_MODES,
                          SP_CARD_DIMS, SP_LRS, SP_STEPS,
                          SP_VARIANTS, SYNC_BN_CHANNELS, SYNC_BN_DTYPES,
                          SYNC_BN_EPS, SYNC_BN_LAYOUTS, alltoall_input,
                          join_adasum_inputs, mlp_data, mlp_params,
                          replay_leaf, run_world, shard_rows, sp_card_model,
                          sp_card_tokens, sparse_input, sync_bn_case,
                          sync_bn_run, trace_events, check_algo_cards)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# the 12 distinct (M, C) of ResNet-50's 53 BN layers at batch 64, 224 px
RESNET50_BN_SHAPES = [
    (802816, 64), (200704, 64), (200704, 256), (200704, 128), (50176, 128),
    (50176, 512), (50176, 256), (12544, 256), (12544, 1024), (12544, 512),
    (3136, 512), (3136, 2048)]
# every ResNet-50 shape in bf16; fp32 at some; inputs the TMA route does
# not take (fp16 C = 3, bf16 C = 12: a row pitch that is not a multiple of
# 16 bytes), one row, and a channel count that ends inside a tile
BN_CASES = ([(torch.bfloat16, m, c) for m, c in RESNET50_BN_SHAPES]
            + [(torch.float32, m, c) for m, c in
               [(802816, 64), (12544, 1024), (3136, 2048), (777, 384)]]
            + [(torch.float16, 4096, 3), (torch.bfloat16, 1000, 12),
               (torch.float16, 1, 64), (torch.float32, 1, 3),
               (torch.float16, 50176, 200)])
EPS32 = 2.0 ** -23


def _bn_inputs(dev, m, c, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(m, c, device=dev, generator=gen) * 2 + 0.5).to(dtype)
    dy = torch.randn(m, c, device=dev, generator=gen).to(dtype)
    scale = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
    bias = 0.1 * torch.randn(c, device=dev, generator=gen)
    return x, dy, scale, bias


def _fwd_epilogue(s, q, m, scale, bias, eps):
    """bn_forward_plain's math from given sums."""
    mean = s / m
    var = torch.clamp(q / m - mean * mean, min=0.0)
    invstd = torch.rsqrt(var + eps)
    a = scale * invstd
    return torch.stack([mean, var, invstd, a, bias - mean * a])


def _bwd_epilogue(s1, s2, m, invstd, scale):
    """bn_backward_plain's math from given sums."""
    a = scale * invstd
    return torch.stack([s2, s1, a, -a * (s1 / m), -a * invstd * (s2 / m)])


def _assert_ulps(got, want, n=8):
    """Within n fp32 units of the largest entry of each row: the epilogue
    from the same sums, rsqrt approximated in both."""
    tol = n * EPS32 * want.abs().amax(-1, keepdim=True) + 1e-30
    assert bool(((got - want).abs() <= tol).all()), \
        float(((got - want).abs() - tol).max())


@pytest.mark.parametrize("dtype,m,c", BN_CASES)
def test_cuda_bn_kernels_match_plain(cuda, dtype, m, c):
    """K2/K3 in both modes against their plain versions: the sums within
    1e-5 of sum |terms|; the epilogues (and the EMA in place) within a few
    fp32 units of the module's math on the kernel's own sums; two runs
    bitwise equal; one launch each."""
    x, dy, scale, bias = _bn_inputs(cuda, m, c, dtype)
    n0 = K.launch_counts()
    s, q = K.bn_stats(x)
    s_ref, q_ref = K.bn_stats_plain(x)
    xf, dyf = x.float(), dy.float()
    mean = s_ref / m
    invstd = torch.rsqrt(torch.clamp(q_ref / m - mean * mean, min=0) + 1e-5)
    s1, s2 = K.bn_bwd_stats(dy, x, mean, invstd)
    s1_ref, s2_ref = K.bn_bwd_stats_plain(dy, x, mean, invstd)
    xh = (xf - mean) * invstd
    for got, want, terms in ((s, s_ref, xf), (q, q_ref, xf * xf),
                             (s1, s1_ref, dyf), (s2, s2_ref, dyf * xh)):
        bound = 1e-5 * terms.abs().sum(0)    # per-thread fp32 runs
        assert bool(((got - want).abs() <= bound + 1e-6).all())
    again = K.bn_stats(x)
    assert torch.equal(again[0], s) and torch.equal(again[1], q)
    gen = torch.Generator(device=cuda).manual_seed(1)
    rm = torch.randn(c, device=cuda, generator=gen)
    rv = 1 + torch.rand(c, device=cuda, generator=gen)
    rm0, rv0 = rm.clone(), rv.clone()
    fwd = K.bn_forward(x, scale, bias, 1e-5, rm, rv, 0.9)
    want = _fwd_epilogue(s, q, m, scale, bias, 1e-5)
    _assert_ulps(fwd, want)
    _assert_ulps(torch.stack([rm, rv]),
                 torch.stack([0.9 * rm0 + (1 - 0.9) * fwd[0],
                              0.9 * rv0 + (1 - 0.9) * fwd[1]]))
    assert torch.equal(K.bn_forward(x, scale, bias, 1e-5), fwd)
    bwd = K.bn_backward(dy, x, fwd[0], fwd[2], scale)
    b1, b2 = K.bn_bwd_stats(dy, x, fwd[0], fwd[2])
    _assert_ulps(bwd, _bwd_epilogue(b1, b2, m, fwd[2], scale))
    assert torch.equal(K.bn_backward(dy, x, fwd[0], fwd[2], scale), bwd)
    counts = K.launch_counts()
    assert counts["bn_stats"] == n0["bn_stats"] + 4
    assert counts["bn_bwd_stats"] == n0["bn_bwd_stats"] + 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_cuda_bn_kernels_route_does_not_change_the_bits(cuda, dtype):
    """An (M, C) view 2 or 4 bytes past a 16-byte boundary takes the plain
    loads, its aligned copy TMA: the same elements summed in the same
    order, the same bits, in both modes."""
    m, c = 3136, 512
    base = torch.randn(m * c + 1, device=cuda).to(dtype)
    x = base[1:].view(m, c)
    dy = torch.randn(m * c + 1, device=cuda).to(dtype)[1:].view(m, c)
    assert x.data_ptr() % 16 and x.is_contiguous()
    xc, dyc = x.clone(), dy.clone()
    assert xc.data_ptr() % 16 == 0
    for a, b in zip(K.bn_stats(x), K.bn_stats(xc)):
        assert torch.equal(a, b)
    scale = torch.ones(c, device=cuda)
    fwd = K.bn_forward(x, scale, torch.zeros(c, device=cuda), 1e-5)
    assert torch.equal(fwd, K.bn_forward(xc, scale, torch.zeros_like(scale),
                                         1e-5))
    assert torch.equal(K.bn_backward(dy, x, fwd[0], fwd[2], scale),
                       K.bn_backward(dyc, xc, fwd[0], fwd[2], scale))


def test_cuda_bn_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(64, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K.bn_stats(x.t())                       # not contiguous
    with pytest.raises(ValueError):
        K.bn_stats(x.double())                  # dtype
    with pytest.raises(ValueError):
        K.bn_stats(x[:0])                       # no rows
    with pytest.raises(ValueError):
        K.bn_forward(x, torch.ones(128, device=cuda, dtype=torch.float16),
                     torch.zeros(128, device=cuda), 1e-5)   # scale's dtype
    with pytest.raises(ValueError):
        K.bn_bwd_stats(x, x.float(), torch.zeros(128, device=cuda),
                       torch.ones(128, device=cuda))        # mixed dtypes


def _kernel_launches(fn):
    """The CUDA kernels (and copies) that ``fn`` runs, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_cuda_fused_batch_norm_launches_per_layer(cuda, dtype):
    """One FusedBatchNorm layer issues at most 2 kernels forward (K2 with
    the EMA in its epilogue, the affine) and 4 backward (K3, dx's three
    passes)."""
    bn = FusedBatchNorm(64, dtype=dtype).to(cuda)
    x = torch.randn(8, 64, 14, 14, device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    dy = torch.randn_like(x)
    bn(x).backward(dy)                          # warm up
    bn.zero_grad(set_to_none=True)
    x.grad = None
    out = {}
    fwd = _kernel_launches(lambda: out.setdefault("y", bn(x)))
    bwd = _kernel_launches(lambda: out["y"].backward(dy))
    assert 1 <= len(fwd) <= 2, fwd
    assert 1 <= len(bwd) <= 4, bwd
    assert sum("bn_stats_kernel" in n for n in fwd + bwd) == 2


def test_cuda_fused_batch_norm_fp16_trains(cuda):
    """FusedBatchNorm(dtype=float16) on the card against its CPU path:
    outputs and dx within fp16's epsilon of the largest entry, the
    parameter gradients and running statistics within 1e-3; SGD steps
    through it stay finite and lower the loss."""
    rng = np.random.RandomState(1)
    x = (rng.randn(16, 12, 9, 9) * 2 + 0.5).astype(np.float16)
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        bn = FusedBatchNorm(12, dtype=torch.float16).to(dev)
        xt = torch.tensor(x, device=dev).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = bn(xt)
        torch.sin(y.float()).sum().backward()
        outs[dev.type] = [t.detach().float().cpu() for t in
                          (y, xt.grad, bn.weight.grad, bn.bias.grad,
                           bn.running_mean, bn.running_var)]
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        tol = (2 * 2.0 ** -10 if i < 2 else 1e-3) * float(a.abs().max())
        assert float((a - b).abs().max()) <= tol + 1e-6, i
    bn = FusedBatchNorm(12, dtype=torch.float16).to(cuda)
    opt = torch.optim.SGD(bn.parameters(), lr=0.1)
    xt = torch.tensor(x, device=cuda).contiguous(
        memory_format=torch.channels_last)
    target = torch.randn(xt.shape, device=cuda).contiguous(
        memory_format=torch.channels_last)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = ((bn(xt).float() - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_cuda_bn_and_mma_kernels_do_not_spill(cuda):
    """The build's ptxas report: no kernel of bn_stats.cu or flash_attn.cu
    (di) spills, flash_attn.cu builds no mma.sync kernel (every attention
    launch runs a Hopper wgmma kernel), and no instance of the deep 16-bit
    dk/dv and dq (above head dim 256) spills: dk/dv at kOut 128, dq at 192
    and 256, two input and two output types each."""
    from horovod_tpu_torch.ops import build
    for stem in ("bn_stats", "flash_attn"):
        report = build.ptxas_report(stem)
        assert report, stem
        for name, r in report.items():
            assert r["spill_stores"] == 0 and r["spill_loads"] == 0, name
    mma = [name for name in build.ptxas_report("flash_attn")
           if "_mma_kernel" in name]
    assert not mma, mma
    report = build.ptxas_report("flash_bwd_sm90")
    for kernel, outs in (("flash_bwd_dkdv", ["128"] * 4),
                         ("flash_bwd_dq", ["192"] * 4 + ["256"] * 4)):
        deep = [name for name in report
                if f"{kernel}_sm90_kernel_deep" in name]
        assert sorted(re.search(r"ILi(\d+)E", name).group(1)
                      for name in deep) == outs, deep
        for name in deep:
            r = report[name]
            assert r["spill_stores"] == 0 and r["spill_loads"] == 0, name


def test_cuda_hopper_attention_kernels_do_not_spill(cuda):
    """The build's ptxas report: no instance of the Hopper attention
    kernels (every head dim, the wide ones at 192 and 256, the forward's
    at 320, 384 and 512 and the deep forward, dk/dv and dq above them
    included, every input and output type, and the tf32 forward, dk/dv and
    dq of fp32 inputs at kOut 64 and 128) spills."""
    from horovod_tpu_torch.ops import build
    for stem in ("flash_fwd_sm90", "flash_bwd_sm90"):
        report = build.ptxas_report(stem)
        assert any("Li256E" in name for name in report), stem
        for d in (320, 384, 512):
            assert any(f"Li{d}E" in name for name in report) == \
                (stem == "flash_fwd_sm90"), (stem, d)
        # the forward and dq at kOut 192 and 256, dk/dv at 128, two input
        # and two output types
        deep = [name for name in report if "kernel_deep" in name]
        assert len(deep) == (8 if stem == "flash_fwd_sm90" else 12), deep
        for kernel, outs in (("flash_fwd", ["128", "64"]),
                             ("flash_bwd_dq", ["128", "64"]),
                             ("flash_bwd_dkdv", ["128", "64"])):
            tf32 = [name for name in report
                    if f"{kernel}_sm90_tf32_kernel" in name]
            assert sorted(re.search(r"ILi(\d+)E", name).group(1)
                          for name in tf32) == (
                outs if stem.startswith(kernel[:9]) else []), tf32
        for name, r in report.items():
            assert r["spill_stores"] == 0 and r["spill_loads"] == 0, name


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


SYNC_BN_CUDA_CASES = [(torch.bfloat16, (64, 256, 14, 14)),
                      (torch.float16, (32, 3, 8, 8)),
                      (torch.float32, (777, 384)),
                      (torch.bfloat16, (1000, 12))]


def _sync_bn_inputs(dtype, shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen).to(dtype)
    if x.dim() == 4:
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    scale = 1 + 0.1 * torch.randn(c, generator=gen)
    bias = 0.1 * torch.randn(c, generator=gen)
    return x, dy, scale, bias


def _sync_bn_step(dev, x, dy, scale, bias):
    """One training step of a SyncBatchNorm layer on ``dev``: y, dx,
    dscale, dbias and the running statistics, on the CPU."""
    mod = SyncBatchNorm(x.shape[1], eps=SYNC_BN_EPS, device=dev)
    with torch.no_grad():
        mod.weight.copy_(scale)
        mod.bias.copy_(bias)
    xt = x.to(dev).requires_grad_()
    y = mod(xt)
    y.backward(dy.to(dev))
    return [t.detach().cpu() for t in (y, xt.grad, mod.weight.grad,
                                       mod.bias.grad, mod.running_mean,
                                       mod.running_var)]


def _rows_of(t):
    t = t.float()
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]) if t.dim() == 4 \
        else t


def _assert_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), rel * scale)


@pytest.mark.parametrize("dtype,shape", SYNC_BN_CUDA_CASES)
def test_cuda_sync_batch_norm_matches_its_cpu_path(cuda, dtype, shape):
    """SyncBatchNorm on one card (K2 and K3 in raw mode, once each a layer)
    against the same module on the CPU (their plain versions)."""
    x, dy, scale, bias = _sync_bn_inputs(dtype, shape)
    n0 = K.launch_counts()
    card = _sync_bn_step(cuda, x, dy, scale, bias)
    n1 = K.launch_counts()
    assert (n1["bn_stats"] - n0["bn_stats"],
            n1["bn_bwd_stats"] - n0["bn_bwd_stats"]) == (1, 1)
    plain = _sync_bn_step(torch.device("cpu"), x, dy, scale, bias)
    tol = max(torch.finfo(dtype).eps, 1e-5)
    for i in (0, 1):                                      # y, dx
        _assert_rel(card[i].float(), plain[i].float(), tol)
    rows, dyr = _rows_of(x), _rows_of(dy)
    xh = (rows - rows.mean(0)) * torch.rsqrt(rows.var(0, unbiased=False)
                                             + SYNC_BN_EPS)
    for i, terms in ((2, dyr * xh), (3, dyr)):            # dscale, dbias
        bound = 1e-4 * terms.abs().sum(0) + 1e-6
        assert ((card[i] - plain[i]).abs() <= bound).all()
    for i in (4, 5):                                      # running stats
        _assert_rel(card[i], plain[i], 1e-5)


def test_cuda_sync_batch_norm_issues_no_host_wait(cuda):
    """A forward and backward raise nothing under torch's sync debug mode,
    and issued behind a second of device sleep they return while the
    sleep still runs: nothing reads a device value."""
    x, dy, scale, bias = _sync_bn_inputs(torch.bfloat16, (64, 256, 14, 14))
    mod = SyncBatchNorm(256, device=cuda)
    x, dy = x.to(cuda), dy.to(cuda)

    def step():
        xt = x.detach().requires_grad_()
        mod(xt).backward(dy)

    step()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(2_000_000_000)
    step()
    issue_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    assert busy and issue_s < total_s / 2, (issue_s, total_s)


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


# step replay on one card: gradients of these shapes a step, cut into
# several buckets at a 1 MB fusion threshold
REPLAY_SHAPES = [(512, 256), (256,), (300, 1000), (7,), (64, 3, 3, 3)]
REPLAYED_STEPS = 4             # replayed steps after the warm-up


def _replay_init(monkeypatch, pack: str):
    monkeypatch.setenv("HOROVOD_PALLAS_PACK", pack)
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(1 << 20))
    monkeypatch.delenv("HOROVOD_TPU_COORDINATOR", raising=False)
    monkeypatch.delenv("HOROVOD_TPU_STEP_REPLAY", raising=False)
    hvd.init()
    from horovod_tpu_torch.core.state import engine
    return engine()


def _replay_step(grads, tag):
    """One step's reduction: a grouped Average with a postscale (so the
    math is not the identity), issued under the sync debug mode: nothing
    may wait on the card."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        with hvd.step():
            hs = hvd.grouped_allreduce_async(grads, name=tag, op=hvd.Average,
                                             postscale_factor=0.5)
        return [h.synchronize() for h in hs]
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("pack", ["1", "0"])
def test_cuda_replay_matches_eager_and_keeps_held_results(cuda, monkeypatch,
                                                          pack):
    """Warm-up steps record, the stream arms once, and every later step
    replays as the CUDA graph: its results bitwise the eager path's on the
    same gradients, the gradients fresh tensors each step (the pack
    kernel's table refreshed with new addresses), a result held from one
    step unchanged after the next replays, K1 a graph node once a bucket
    and step (with the pack knob off, the plain pack before the graph), and
    no host wait while arming, refreshing or launching."""
    eng = _replay_init(monkeypatch, pack)
    try:
        warm = eng.config.step_replay_warmup
        n_buckets = len(bucket_by_size(
            [torch.empty(s) for s in REPLAY_SHAPES], 1 << 20))
        assert n_buckets > 1
        gen = torch.Generator(device=cuda).manual_seed(0)
        kept, held = [], None
        K.reset_launch_counts()
        for step in range(warm + REPLAYED_STEPS):
            grads = [torch.randn(s, device=cuda, generator=gen)
                     for s in REPLAY_SHAPES]
            if kept:
                assert {g.data_ptr() for g in grads}.isdisjoint(
                    g.data_ptr() for g in kept[-1])
            kept.append(grads)
            want = [h.synchronize() for h in eng.grouped_allreduce(
                grads, op=hvd.Average, postscale_factor=0.5)]
            got = _replay_step(grads, f"g.{step}")
            assert all(torch.equal(a, b) for a, b in zip(got, want)), step
            if held is not None:
                assert all(torch.equal(a, b) for a, b in held), step
            held = [(g, g.clone()) for g in got]
            r = eng.replay
            assert (r.captured_streams, r.replayed_steps, r.fallbacks) == \
                (int(step + 1 >= warm), max(0, step + 1 - warm), 0), step
        counts = K.launch_counts()
        assert counts["pack_graph"] == (REPLAYED_STEPS * n_buckets
                                        if pack == "1" else 0)
        # the eager references (and the warm-up steps with the knob on)
        # launch K1 eagerly: once a bucket and call
        assert counts["pack"] == (
            (warm + REPLAYED_STEPS + warm) * n_buckets if pack == "1" else 0)
        torch.cuda.synchronize()
    finally:
        hvd.shutdown()


def test_cuda_replay_is_one_graph_launch(cuda, monkeypatch):
    """A profiled replayed reduction issues exactly one cudaGraphLaunch and
    no kernel launch: its other runtime calls are the counted table
    refreshes and copy-outs (one of each a bucket). The graph's kernels
    hold K1 once a bucket. A divergent step (one gradient left out) falls
    back with correct values and counts one fallback; the next matching
    step replays again."""
    eng = _replay_init(monkeypatch, "1")
    try:
        warm = eng.config.step_replay_warmup
        n_buckets = len(bucket_by_size(
            [torch.empty(s) for s in REPLAY_SHAPES], 1 << 20))
        gen = torch.Generator(device=cuda).manual_seed(1)
        grads = [torch.randn(s, device=cuda, generator=gen)
                 for s in REPLAY_SHAPES]
        for step in range(warm + 1):
            _replay_step(grads, f"g.{step}")
        torch.cuda.synchronize()
        r = eng.replay
        before = (r.replayed_steps, r.table_copies, r.copy_outs)
        out = {}
        host, dev = trace_events(
            lambda: out.update(got=_replay_step(grads, "g.100")),
            lambda h, d: sum("pack_kernel" in n for n in d) == n_buckets)
        got = out["got"]
        replays = r.replayed_steps - before[0]
        assert replays >= 2 and r.fallbacks == 0
        assert (r.table_copies - before[1], r.copy_outs - before[2]) == \
            (n_buckets * replays, n_buckets * replays)
        assert host.count("cudaGraphLaunch") == 1, host
        assert host.count("cudaLaunchKernel") == 0, host
        assert host.count("cudaMemcpyAsync") == 2 * n_buckets, host
        assert sum("pack_kernel" in n for n in dev) == n_buckets, dev
        for g, o in zip(grads, got):
            assert torch.equal(o, g * 0.5)
        # divergence: one gradient left out
        before = eng.replay.replayed_steps
        got = _replay_step(grads[:-1], "g.101")
        assert all(torch.equal(o, g * 0.5) for g, o in zip(grads, got))
        assert (eng.replay.fallbacks, eng.replay.replayed_steps) == \
            (1, before)
        _replay_step(grads, "g.102")
        assert (eng.replay.fallbacks, eng.replay.replayed_steps) == \
            (1, before + 1)
        torch.cuda.synchronize()
    finally:
        hvd.shutdown()


def test_cuda_observability_adds_no_sync_and_writes_the_timeline(
        cuda, monkeypatch, tmp_path):
    """Every instrument on (the defaults, the timeline and the metrics
    file): the warm-up and the replayed steps of a grouped reduction run
    under the sync debug mode's "error" (no instrument waits on the card),
    the native timeline writer is the one loaded, and its file holds a
    span and a launch span for each tensor of each eager step and one a
    replayed step, balanced, pid 0."""
    import json
    monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / "tl.json"))
    monkeypatch.setenv("HOROVOD_TPU_METRICS_FILE", str(tmp_path / "m.jsonl"))
    eng = _replay_init(monkeypatch, "1")
    try:
        gs = hvd.global_state()
        assert gs.timeline.native_active
        assert eng.trace is not None and eng.health is not None
        warm = eng.config.step_replay_warmup
        gen = torch.Generator(device=cuda).manual_seed(3)
        grads = [torch.randn(s, device=cuda, generator=gen)
                 for s in REPLAY_SHAPES]
        for step in range(warm + 2):
            _replay_step(grads, f"obs.{step}")
        assert eng.replay.replayed_steps == 2
        torch.cuda.synchronize()
    finally:
        hvd.shutdown()
    events = json.load(open(tmp_path / "tl.json"))
    names = [e["name"] for e in events]
    n = len(REPLAY_SHAPES)
    assert names.count("GROUPED_ALLREDUCE") == n * warm
    assert names.count("XLA_DISPATCH") == n * warm
    assert names.count("REPLAY") == names.count("XLA_REPLAY_DISPATCH") == 2
    depth = {}
    for e in events:
        if e["ph"] in ("B", "E"):
            depth[e["tid"]] = depth.get(e["tid"], 0) + (
                1 if e["ph"] == "B" else -1)
    assert not any(depth.values())
    assert {e["pid"] for e in events} == {0}


def test_cuda_observability_hbm_gauge_matches_memory_stats(cuda,
                                                           monkeypatch):
    """The memory sampler reads the engine's card: the gauge equals
    torch.cuda.memory_stats() read at the same sample."""
    eng = _replay_init(monkeypatch, "1")
    try:
        keep = torch.empty(1 << 24, device=cuda)
        sampler = hvd.global_state().hbm_sampler
        stats = sampler.sample()
        mem = torch.cuda.memory_stats(cuda)
        assert stats is not None and sampler._supported
        gauge = {labels["kind"]: v for labels, v in hvd.metrics_snapshot()[
            "gauges"]["hvd_tpu_hbm_bytes"]["values"]}
        assert gauge == {
            "in_use": float(mem["allocated_bytes.all.current"]),
            "peak": float(mem["allocated_bytes.all.peak"]),
            "limit": float(torch.cuda.get_device_properties(
                cuda).total_memory)}
        assert gauge["in_use"] >= keep.nbytes
        assert sampler.last() == (mem["allocated_bytes.all.current"],
                                  mem["allocated_bytes.all.peak"])
    finally:
        hvd.shutdown()


def test_cuda_observability_watchdog_breaks_a_hung_launch(cuda, monkeypatch,
                                                          tmp_path):
    """A hang armed before an NCCL launch under a short collective
    deadline: the watchdog dumps the trace ring, poisons the engine and
    breaks the hang with HorovodInternalError; every later call raises."""
    from horovod_tpu_torch import faults
    monkeypatch.setenv("HOROVOD_TPU_COLLECTIVE_DEADLINE", "0.5")
    monkeypatch.setenv("HOROVOD_TPU_TRACE_DUMP_DIR", str(tmp_path))
    _replay_init(monkeypatch, "1")
    try:
        x = torch.ones(1024, device=cuda)
        assert torch.equal(hvd.allreduce(x, name="ok", op=hvd.Sum), x)
        faults.arm("engine.dispatch=hang()")
        with pytest.raises(hvd.HorovodInternalError,
                           match="collective watchdog"):
            hvd.allreduce(x, name="wedged", op=hvd.Sum)
        faults.disarm()
        assert (tmp_path / "hvd_tpu_flight_rank0.json").exists()
        with pytest.raises(hvd.HorovodInternalError,
                           match="collective watchdog"):
            hvd.grouped_allreduce([x, x], name="after", op=hvd.Sum)
        torch.cuda.synchronize()
    finally:
        faults.disarm()
        hvd.shutdown()


# K1's out= form (ZeRO-1's padded buckets): (dtype, shapes, padded)
# a tail that is no whole 16-byte word, a one-element tensor, a bucket
# whose padding is most of a shard, and a large bucket past many tiles
PACK_OUT_CASES = [
    (torch.float32, [(512, 256), (7,), (1,), (299, 5)], 4 * 34625),
    (torch.bfloat16, [(3,), (129, 3), (1,)], 4 * 100),
    (torch.float16, [(5,)], 8),
    (torch.float32, [(2048, 2048), (8192,), (13,)], 4 * 1050628)]


@pytest.mark.parametrize("case", range(len(PACK_OUT_CASES)))
def test_cuda_sharded_pack_out_matches_plain(cuda, case):
    """K1 into a caller's padded buffer: ``out[:numel]`` bitwise the plain
    version's, the tail (filled with a sentinel) untouched, one launch
    counted in ``pack`` and in ``pack_out``."""
    dtype, shapes, padded = PACK_OUT_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(case)
    ts = [torch.randn(s, device=cuda, generator=gen).to(dtype)
          for s in shapes]
    total = sum(t.numel() for t in ts)
    assert padded > total and (total * ts[0].element_size()) % 16
    got = torch.full((padded,), 7.0, device=cuda, dtype=dtype)
    want = got.clone()
    K.reset_launch_counts()
    assert K.pack(ts, out=got) is got
    K.pack_plain(ts, out=want)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[total:] == 7.0).all())
    counts = K.launch_counts()
    assert (counts["pack"], counts["pack_out"]) == (1, 1)
    with pytest.raises(ValueError, match="out must be"):
        K.pack(ts, out=got[:total - 1])


# the sharded LM on one card: SP_CARD_DIMS' LM, fp32 parameters, bf16
# compute, cut into several buckets at a 1 MB fusion threshold
SHARDED_CARD_LM_STEPS = 6      # the warm-up (3) + 3 replayed steps


def _moment_bytes(optimizer) -> int:
    return sum(v.nbytes for st in optimizer.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim())


def _sharded_lm_run(cuda, sharded, steps=SHARDED_CARD_LM_STEPS):
    model = sp_card_model(TransformerConfig(
        dtype=torch.bfloat16, attention="flash", **SP_CARD_DIMS), cuda)
    x, y = (torch.from_numpy(a).to(cuda) for a in sp_card_tokens())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4),
        sharded=sharded)

    def step():
        opt.zero_grad()
        loss = lean_lm_loss(model, x, y)
        loss.backward()
        opt.step()
        return float(loss.detach())

    return model, opt, [step() for _ in range(steps)]


def test_cuda_sharded_lm_step_matches_dense(cuda, monkeypatch):
    """DistributedOptimizer(sharded=True) on one card (size 1: shard =
    total, the collectives NCCL's own) against the dense optimizer from
    the same seed: the same losses and bitwise the same parameters after
    the warm-up's eager steps and the replayed ones; K1 moves each
    bucket's parameters once, packs each eager step's gradients in padded
    mode and runs once a bucket as a graph node of each replayed step;
    and the shard optimizer's state is the dense one's."""
    eng = _replay_init(monkeypatch, "1")
    try:
        warm = eng.config.step_replay_warmup
        dense, dense_opt, want = _sharded_lm_run(cuda, False)
        K.reset_launch_counts()
        model, opt, got = _sharded_lm_run(cuda, True)
        counts = K.launch_counts()
        n = len(opt._zero.buckets)
        assert n > 1
        assert got == want
        for p, q in zip(model.parameters(), dense.parameters()):
            assert torch.equal(p, q)
        r = eng.replay
        assert (r.captured_streams, r.replayed_steps, r.fallbacks) == (
            1, SHARDED_CARD_LM_STEPS - warm, 0)
        assert counts["pack_out"] == counts["pack"] == n * (1 + warm)
        assert counts["pack_graph"] == n * (SHARDED_CARD_LM_STEPS - warm)
        # the moments, all of them at size 1 (the step counts are scalars
        # a parameter, or a shard)
        assert [_moment_bytes(o) for o in (opt._zero.optimizer,
                                           dense_opt.optimizer)] == [
            2 * 4 * sum(p.numel() for p in model.parameters())] * 2
    finally:
        hvd.shutdown()


def test_cuda_sharded_replay_graph_holds_k1_and_no_host_wait(cuda,
                                                             monkeypatch):
    """A replayed sharded step: one cudaGraphLaunch, K1 a graph node once a
    bucket (the table refreshes are its only copies), and no host wait
    under the sync debug mode, the optimizer's update and the all-gathers
    included."""
    eng = _replay_init(monkeypatch, "1")
    try:
        model, opt, _ = _sharded_lm_run(cuda, True)
        n = len(opt._zero.buckets)
        assert eng.replay.replayed_steps >= 1
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host, dev = trace_events(
            opt.step, lambda h, d: sum("pack_kernel" in k for k in d) == n)
        assert host.count("cudaGraphLaunch") == 1, host
        assert sum("pack_kernel" in k for k in dev) == n, dev
        assert host.count("cudaMemcpyAsync") == n, host
        assert eng.replay.fallbacks == 0
        torch.cuda.synchronize()
    finally:
        hvd.shutdown()


def _flash_inputs(dev, b, h, t, d, layout, seed=0, dtype=torch.bfloat16,
                  tk=None):
    """q, k, v, do of ``dtype`` as [B, H, T, D] views of tensors laid out as
    ``layout`` (a "bthk" tensor is passed transposed, with its strides); q
    and do have t rows, k and v tk (default t)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ts = []
    for rows in (t, tk or t, tk or t, t):
        shape = (b, rows, h, d) if layout == "bthk" else (b, h, rows, d)
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        ts.append(x.transpose(1, 2) if layout == "bthk" else x)
    return ts


# fp32 inputs run on tf32 tensor cores: operands keep 10 mantissa bits (unit
# roundoff 2^-11). A kernel's error may be twice the plain version's in
# tf32, plus this share of the largest entry (half tf32's roundoff, as the
# 16-bit limit's 1e-3 is about half of bf16's 2^-9)
TF32_FLOOR = 2.0 ** -12
# a whole attention path in fp32 on the card against the CPU's fp32
TF32_PATH_TOL = 1e-2


def _tf32(x):
    """fp32 ``x`` rounded to tf32: 10 mantissa bits, to nearest with ties
    away from zero (the kernels' cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Matmuls(torch.overrides.TorchFunctionMode):
    """torch.matmul with both operands rounded to tf32 and fp32 sums: every
    product rounded where the tf32 kernels round it, whatever kernel cuBLAS
    picks (with tf32 allowed it still runs head dim 16 in fp32)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.matmul:
            args = tuple(_tf32(a) for a in args)
        return func(*args, **(kwargs or {}))


def _plain_matmuls(dtype):
    """The context in which the plain versions run in the input dtype."""
    return (_Tf32Matmuls() if dtype == torch.float32
            else contextlib.nullcontext())


def _assert_flash_close(name, got, want32, plain):
    """The kernel's error against the fp32 plain version is at most twice
    the bf16 plain version's, plus 1e-3 of the largest entry (other
    rounding points: p relative to the running max, sums in another order),
    plus 1e-5 for outputs that are zero up to rounding (dq and dk at
    T = 1)."""
    err = float((got.float() - want32).abs().max())
    base = float((plain.float() - want32).abs().max())
    bound = 2 * base + 1e-3 * float(want32.abs().max()) + 1e-5
    assert err <= bound, f"{name}: error {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("layout", ["bhtk", "bthk"])
@pytest.mark.parametrize("t", [1, 63, 64, 127, 128, 129, 200, 257])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_kernels_match_plain(cuda, d, causal, t, layout):
    """K6 against its plain versions, across the forward's 128-row tiles
    (127, 128, 129, 257) and the backward's 64-row ones; the forward
    repeats bitwise and gives the same bits on strided views as on
    contiguous copies."""
    q, k, v, do = _flash_inputs(cuda, 2, 3, t, d, layout)
    scale = d ** -0.5
    f32 = [x.float() for x in (q, k, v, do)]
    o32, lse32 = K.flash_attention_fwd_plain(*f32[:3], causal, scale)
    dq32, dk32, dv32 = K.flash_attention_bwd_plain(
        *f32[:3], o32, lse32, f32[3], causal, scale)
    ob, lseb = K.flash_attention_fwd_plain(q, k, v, causal, scale)
    dqb, dkb, dvb = K.flash_attention_bwd_plain(q, k, v, ob, lseb, do,
                                                causal, scale)
    n0 = K.launch_counts()
    o, lse = K.flash_fwd(q, k, v, causal, scale)
    di = K.flash_bwd_pre(o, do)
    dk, dv = K.flash_bwd_dkdv(q, k, v, do, lse, di, causal, scale)
    dq = K.flash_bwd_dq(q, k, v, do, lse, di, causal, scale)
    torch.cuda.synchronize()
    assert o.stride() == q.stride() and dq.stride() == q.stride()
    for name, got, want, plain in (("o", o, o32, ob),
                                   ("lse", lse, lse32, lseb),
                                   ("dq", dq, dq32, dqb),
                                   ("dk", dk, dk32, dkb),
                                   ("dv", dv, dv32, dvb)):
        _assert_flash_close(name, got, want, plain)
    torch.testing.assert_close(di, K.flash_bwd_pre_plain(o, do), rtol=1e-5,
                               atol=1e-5)
    counts = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_pre", "flash_bwd_dkdv",
                 "flash_bwd_dq"):
        assert counts[name] == n0[name] + 1
    again = K.flash_bwd_dq(q, k, v, do, lse, di, causal, scale)
    assert torch.equal(again, dq)        # no atomics: bitwise repeatable
    o2, lse2 = K.flash_fwd(q, k, v, causal, scale)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    oc, lsec = K.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal, scale)
    assert torch.equal(oc, o) and torch.equal(lsec, lse)


def test_cuda_flash_rejects_what_it_does_not_take(cuda):
    """Mixed dtypes and float64 raise; every dtype, head dim and length
    pair the reference computes runs (the next tests), a head dim above 128
    too."""
    q, k, v, _ = _flash_inputs(cuda, 1, 2, 64, 64, "bhtk")
    with pytest.raises(ValueError, match="one dtype"):
        K.flash_fwd(q, k.float(), v, True, 0.125)
    with pytest.raises(ValueError, match="float32"):
        K.flash_fwd(q.double(), k.double(), v.double(), True, 0.125)
    q192 = torch.zeros(1, 2, 64, 192, device=cuda, dtype=torch.bfloat16)
    o, lse = K.flash_fwd(q192, q192, q192, True, 0.1)
    assert o.shape == q192.shape and lse.shape == (1, 2, 64)
    out = flash_attention_local(q192, q192, q192, layout="bhtk")
    assert out.shape == q192.shape


# (dtype, head dim, Tq, Tk): fp16 and fp32 inputs, head dims the kernels pad
# (ViT_Tiny's 16, 32, 80, 96), and q and k/v of different lengths
FLASH_CASES = [
    (torch.float16, 128, 257, 257), (torch.float16, 64, 200, 200),
    (torch.float32, 64, 200, 200), (torch.float32, 128, 129, 129),
    (torch.bfloat16, 16, 65, 65), (torch.bfloat16, 32, 130, 130),
    (torch.bfloat16, 80, 127, 127), (torch.float16, 96, 100, 100),
    (torch.float32, 16, 65, 65),
    (torch.bfloat16, 64, 96, 160), (torch.bfloat16, 128, 160, 96),
    (torch.float16, 64, 1, 129), (torch.float32, 64, 96, 160),
    (torch.float32, 80, 200, 70),
]


def _check_flash_case(got, want32, plain, name, dtype):
    """``plain`` is the plain version in the input dtype (for fp32, in
    tf32: ``_plain_matmuls``)."""
    if dtype == torch.float32:
        err = float((got.float() - want32).abs().max())
        base = float((plain.float() - want32).abs().max())
        bound = (2 * base + TF32_FLOOR * float(want32.abs().max()) + 1e-5)
        assert err <= bound, f"{name}: error {err:.3g} > {bound:.3g}"
    else:
        _assert_flash_close(name, got, want32, plain)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,d,tq,tk", FLASH_CASES)
def test_cuda_flash_takes_what_the_reference_computes(cuda, dtype, d, tq, tk,
                                                      causal):
    """K6 against its plain versions for every input the reference's
    flash_attention_local computes: fp16 and fp32, head dims the kernels
    pad, and Tq != Tk (causal: key <= query by absolute index); outputs in
    the input dtype, sliced back to the head dim, one launch each."""
    _check_k6_case(cuda, dtype, d, tq, tk, causal)


# head dims above 128: bf16 and fp16 at 160 (built at 192), 192 and 256
# on the Hopper kernels, the forward, dk/dv and dq at every head dim (dk/dv
# and dq above 256 on the deep kernels: flash_route)
WIDE_DIMS = [160, 192, 256, 320, 384, 576, 640, 1024, 1280]
WIDE_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _wide_route(dtype, d, name):
    """The route a wide launch must take: flash_route's answer, checked
    against the rule it states (bf16 and fp16: the Hopper kernels above
    128 at every head dim; fp32: the Hopper tf32 kernels)."""
    route = K.flash_route(dtype, d, name)
    assert route == ("sm90_tf32" if dtype == torch.float32 else "sm90_wide")
    return route


@pytest.mark.parametrize("causal,tq,tk", [(True, 130, 130), (False, 96, 160),
                                          (True, 160, 96)])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("dtype", WIDE_DTYPES)
def test_cuda_flash_takes_any_head_dim(cuda, dtype, d, causal, tq, tk):
    """Every K6 entry point at head dims 160 (built at 192), 192, 256,
    320, 384, 576, 640, 1024 and 1280 in bf16, fp16 and fp32, causal and
    full, Tq != Tk: within
    the flash limits, counted by their route (the Hopper wide kernels or
    the Hopper tf32 ones), dq repeats bitwise."""
    n0 = K.launch_counts()
    q, k, v, do, lse, di, dq = _check_k6_case(cuda, dtype, d, tq, tk, causal)
    n1 = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        counted = f"{name}_{_wide_route(dtype, d, name)}"
        assert n1[counted] == n0[counted] + 1
    scale = d ** -0.5
    assert torch.equal(K.flash_bwd_dq(q, k, v, do, lse, di, causal, scale),
                       dq)


@pytest.mark.parametrize("tq,tk", [(257, 257), (100, 300), (300, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [160, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_flash_wide_hopper_kernels(cuda, dtype, d, causal, tq, tk):
    """The Hopper forward, dk/dv and dq at head dims 160 (padded to 192),
    192 and 256: within the flash limits against the plain versions at
    lengths that end inside the 64-row q and kv tiles (Tq = Tk, Tq < Tk,
    Tq > Tk), one launch each counted on the sm90_wide route, the same
    bits from run to run and on contiguous copies of the strided views."""
    n0 = K.launch_counts()
    q, k, v, do, lse, di, _ = _check_k6_case(cuda, dtype, d, tq, tk, causal)
    n1 = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert n1[f"{name}_sm90_wide"] == n0[f"{name}_sm90_wide"] + 1
        assert n1[f"{name}_pad_copies"] == n0[f"{name}_pad_copies"]
    _check_k6_repeats(q, k, v, do, lse, di, causal, d ** -0.5)


@pytest.mark.parametrize("tq,tk", [(257, 257), (100, 300), (300, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64, 128] + WIDE_DIMS)
def test_cuda_flash_tf32_hopper_kernels(cuda, d, causal, tq, tk):
    """The Hopper tf32 kernels on fp32 inputs at every head dim: K6a and
    K7a (on the first min(Tq, Tk) rows), K6c and K7b, K6d and K7c (under
    the fp32 plain lse and di, K7's on strided [B, H, S] views), on strided
    [B, T, H, D] views at lengths that end inside the 64-row tiles (Tq =
    Tk, Tq < Tk, Tq > Tk): within twice the plain version's error in tf32
    plus 2^-12 of the largest entry, each call counted on the sm90_tf32
    route with no zero-padded copy, the same bits from run to run and on
    contiguous copies."""
    _check_every_entry_point(cuda, torch.float32, d, causal, tq, tk,
                             "sm90_tf32")


# head dims of the deep 16-bit dk/dv and dq: 288 read in place by the 320
# instance, resident operands (to 640, 512 or 576: DeepPlan) and streamed
# ones (1024, 1280), groups whole and partial
DEEP_DIMS = [288, 320, 384, 512, 576, 1024, 1280]


@pytest.mark.parametrize("tq,tk", [(257, 257), (100, 300), (300, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", DEEP_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_flash_deep_backward_kernels(cuda, dtype, d, causal, tq, tk):
    """The deep Hopper dk/dv and dq of bf16 and fp16 inputs above head dim
    256 (the output columns in groups over blocks, S and dP summed over the
    depth's slabs), K6c/K6d (outputs in the input dtype) and K7b/K7c (fp32
    outputs, on the first min(Tq, Tk) rows under strided [B, H, S] lse and
    di), beside K6a and K7a, on strided [B, T, H, D] views at lengths that
    end inside the 64-row tiles (Tq = Tk, Tq < Tk, Tq > Tk): within twice
    the plain version's error in the input dtype plus 1e-3 of the largest
    entry, each call counted on the sm90_wide route with no zero-padded
    copy, the same bits from run to run and on contiguous copies."""
    _check_every_entry_point(cuda, dtype, d, causal, tq, tk, "sm90_wide")


def _check_every_entry_point(cuda, dtype, d, causal, tq, tk, route):
    """K6a, K7a (on the first min(Tq, Tk) rows), K6c, K7b, K6d and K7c
    (under the fp32 plain lse and di) on strided [B, T, H, D] views of
    ``dtype`` at head dim ``d`` against the plain versions (fp32: in tf32),
    each call counted on ``route`` with no zero-padded copy, repeated
    bitwise and on contiguous copies."""
    q, k, v, do = _flash_inputs(cuda, 2, 3, tq, d, "bthk", seed=d,
                                dtype=dtype, tk=tk)
    scale = d ** -0.5
    s = min(tq, tk)
    seg = [x[:, :, :s] for x in (q, k, v, do)]
    o32, lse32 = K.flash_attention_fwd_plain(
        *(x.float() for x in (q, k, v)), causal, scale)
    di32 = K.flash_bwd_pre_plain(o32, do.float())
    slse, sdi = lse32[:, :, :s], di32[:, :, :s]
    cases = [(K.flash_fwd, K.flash_attention_fwd_plain, (q, k, v)),
             (K.flash_seg_fwd, K.flash_seg_fwd_plain, seg[:3]),
             (K.flash_bwd_dkdv, K.flash_bwd_dkdv_plain,
              (q, k, v, do, lse32, di32)),
             (K.flash_seg_bwd_dkdv, K.flash_seg_bwd_dkdv_plain,
              (*seg, slse, sdi)),
             (K.flash_bwd_dq, K.flash_bwd_dq_plain,
              (q, k, v, do, lse32, di32)),
             (K.flash_seg_bwd_dq, K.flash_seg_bwd_dq_plain,
              (*seg, slse, sdi))]
    for fn, plain, ins in cases:
        n0 = K.launch_counts()
        got = fn(*ins, causal, scale)
        torch.cuda.synchronize()
        n1 = K.launch_counts()
        name = fn.__name__
        assert n1[f"{name}_{route}"] == n0[f"{name}_{route}"] + 1
        assert n1[f"{name}_pad_copies"] == n0[f"{name}_pad_copies"], name
        got = got if isinstance(got, tuple) else (got,)
        want32 = plain(*(x.float() for x in ins), causal, scale)
        with _plain_matmuls(dtype):
            want = plain(*ins, causal, scale)
        want32 = want32 if isinstance(want32, tuple) else (want32,)
        want = want if isinstance(want, tuple) else (want,)
        # dk/dv are laid out as k and v, the rest as q
        assert got[0].shape == ins["dkdv" in name].shape
        for i, (g, w32, wb) in enumerate(zip(got, want32, want)):
            assert bool(torch.isfinite(g).all()), (name, i)
            _check_flash_case(g, w32, wb, f"{name}[{i}]", dtype)
        again = fn(*ins, causal, scale)
        copies = fn(*(x.contiguous() for x in ins), causal, scale)
        again = again if isinstance(again, tuple) else (again,)
        copies = copies if isinstance(copies, tuple) else (copies,)
        for a, b, c in zip(got, again, copies):
            assert torch.equal(a, b) and torch.equal(a, c), name


def _check_k6_repeats(q, k, v, do, lse, di, causal, scale):
    """K6's outputs repeat bitwise, and strided views give the bits of
    contiguous copies."""
    def run(q, k, v, do):
        return (*K.flash_fwd(q, k, v, causal, scale),
                *K.flash_bwd_dkdv(q, k, v, do, lse, di, causal, scale),
                K.flash_bwd_dq(q, k, v, do, lse, di, causal, scale))
    first, again = run(q, k, v, do), run(q, k, v, do)
    copies = run(*(x.contiguous() for x in (q, k, v, do)))
    assert torch.equal(first[1], lse)
    for a, b, c in zip(first, again, copies):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("tq,tk", [(257, 257), (100, 300), (300, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [288, 320])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_flash_wide_hopper_forward_at_320(cuda, dtype, d, causal, tq,
                                               tk):
    """The Hopper forward at head dims 288 (padded to 320) and 320, O in two
    accumulators, and the deep dk/dv and dq: within the flash limits
    against the plain versions at lengths that end inside the 64-row tiles
    (Tq = Tk, Tq < Tk, Tq > Tk), one launch each counted on the sm90_wide
    route with no zero-padded copy, the same bits from run to run and on
    contiguous copies."""
    n0 = K.launch_counts()
    q, k, v, do, lse, di, _ = _check_k6_case(cuda, dtype, d, tq, tk, causal)
    n1 = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert n1[f"{name}_sm90_wide"] == n0[f"{name}_sm90_wide"] + 1
        assert n1[f"{name}_pad_copies"] == n0[f"{name}_pad_copies"]
    _check_k6_repeats(q, k, v, do, lse, di, causal, d ** -0.5)


@pytest.mark.parametrize("tq,tk", [(257, 257), (100, 300), (300, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [352, 384, 448, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_flash_hopper_forward_above_320(cuda, dtype, d, causal, tq,
                                             tk):
    """The Hopper forward above head dim 320, O's columns split over blocks
    (D 384 two groups of 192, 512 two of 256; 352 read in place by the 384
    instance, 448 by the 512 one, whose last slab lies wholly past it), K6a
    and K7a (on the first min(Tq, Tk) rows): within
    the flash limits against the plain version at lengths that end inside
    the 64-row tiles (Tq = Tk, Tq < Tk, Tq > Tk), each call counted on the
    sm90_wide route with no zero-padded copy, o laid out as q, the same
    bits from run to run and on contiguous copies."""
    _check_hopper_forward(cuda, dtype, d, causal, tq, tk)


@pytest.mark.parametrize("tq,tk", [(257, 257), (100, 300), (300, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [576, 600, 640, 1024, 1152, 1280])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_flash_hopper_forward_above_512(cuda, dtype, d, causal, tq,
                                             tk):
    """The Hopper forward above head dim 512, S summed over the depth's
    slabs (D 576 three groups of 192 columns of O; 600 read in place by the
    640 instance, whose last group of 256 lies partly past it; 640 and
    1024 groups of 256 with Q resident, 1152 and 1280 with Q streamed
    beside K), K6a and K7a as the previous test: within the flash limits
    against the plain version (twice its error in the input dtype plus
    1e-3 of the largest entry) on strided [B, T, H, D] views at lengths
    that end inside the 64-row tiles (Tq = Tk, Tq < Tk, Tq > Tk), each call
    counted on the sm90_wide route with no zero-padded copy, the same bits
    from run to run and on contiguous copies."""
    _check_hopper_forward(cuda, dtype, d, causal, tq, tk)


def _check_hopper_forward(cuda, dtype, d, causal, tq, tk):
    """K6a and K7a (on the first min(Tq, Tk) rows) at head dim ``d`` on
    strided [B, T, H, D] views against the plain versions, counted on the
    sm90_wide route, repeated bitwise and on contiguous copies."""
    q, k, v, _ = _flash_inputs(cuda, 2, 3, tq, d, "bthk", dtype=dtype, tk=tk)
    scale = d ** -0.5
    s = min(tq, tk)
    seg = [x[:, :, :s] for x in (q, k, v)]
    n0 = K.launch_counts()
    o, lse = K.flash_fwd(q, k, v, causal, scale)
    so, slse = K.flash_seg_fwd(*seg, causal, scale)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for name in ("flash_fwd", "flash_seg_fwd"):
        assert n1[f"{name}_sm90_wide"] == n0[f"{name}_sm90_wide"] + 1
        assert n1[f"{name}_pad_copies"] == n0[f"{name}_pad_copies"]
    assert o.shape == q.shape and o.stride() == q.stride()
    assert so.dtype == torch.float32 and so.shape == seg[0].shape
    for fwd, plain, ins, outs in (
            (K.flash_fwd, K.flash_attention_fwd_plain, (q, k, v), (o, lse)),
            (K.flash_seg_fwd, K.flash_seg_fwd_plain, seg, (so, slse))):
        want32 = plain(*(x.float() for x in ins), causal, scale)
        want = plain(*ins, causal, scale)
        for name, got, w32, wb in zip(("o", "lse"), outs, want32, want):
            assert bool(torch.isfinite(got).all()), name
            _assert_flash_close(name, got, w32, wb)
        again = fwd(*ins, causal, scale)
        copies = fwd(*(x.contiguous() for x in ins), causal, scale)
        for a, b, c in zip(outs, again, copies):
            assert torch.equal(a, b) and torch.equal(a, c)


# head dims the kernels are built above: ViT_Tiny's 16 (on the D 64
# instance), 80 and 96 (128), 160 (192) and 288 (320; dk/dv and dq on the
# deep kernels, their last slab half past it)
PADDED_DIMS = [16, 80, 96, 160, 288]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_padded_head_dims_read_in_place(cuda, dtype, d, causal):
    """K6 at a head dim below its kernel's, on [B, T, H, D] views as the
    models hand them (Tq != Tk): within the flash limits, no zero-padded
    copy (every launch is a Hopper kernel's), outputs allocated at the real
    D and laid out as the inputs, the same bits from run to run and on
    contiguous copies."""
    n0 = K.launch_counts()
    q, k, v, do, lse, di, dq = _check_k6_case(cuda, dtype, d, 150, 200,
                                              causal)
    n1 = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_pre", "flash_bwd_dkdv",
                 "flash_bwd_dq"):
        copies = n1[f"{name}_pad_copies"] - n0[f"{name}_pad_copies"]
        assert copies == 0, (name, copies)
    scale = d ** -0.5
    o, _ = K.flash_fwd(q, k, v, causal, scale)
    dk, dv = K.flash_bwd_dkdv(q, k, v, do, lse, di, causal, scale)
    outs = [(o, q), (dq, q), (dk, k), (dv, v)]
    for got, like in outs:
        assert got.shape[-1] == d and got.stride() == like.stride()
        assert got.untyped_storage().nbytes() == \
            like.untyped_storage().nbytes()
    _check_k6_repeats(q, k, v, do, lse, di, causal, scale)


@pytest.mark.parametrize("part", ["full", "diag"])
@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_seg_padded_head_dims_read_in_place(cuda, dtype, d, part):
    """K7 at a head dim below its kernel's on strided halves: within the
    flash limits, fp32 outputs [B, H, S, D] allocated at the real D, no
    zero-padded copy (every launch is a Hopper kernel's), the same bits on
    contiguous copies."""
    n0 = K.launch_counts()
    seg, got = _check_k7_case(cuda, dtype, d, part)
    n1 = K.launch_counts()
    for name in ("flash_seg_fwd", "flash_seg_bwd_dkdv", "flash_seg_bwd_dq"):
        copies = n1[f"{name}_pad_copies"] - n0[f"{name}_pad_copies"]
        assert copies == 0, (name, copies)
    for name, g, like in zip(("o", "lse", "dk", "dv", "dq"), got,
                             (seg[0], seg[4], seg[1], seg[2], seg[0])):
        assert g.shape == like.shape and g.is_contiguous(), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_view_tma_cannot_take_is_copied_and_counted(cuda, dtype):
    """A [B, T, H, 20] tensor (its H stride of 20 elements is no multiple
    of 8) is copied zero-padded to 64 for the forward, dk/dv and dq, each
    copy counted, and runs the same kernel as a view TMA takes (the first
    20 columns of a 64-wide tensor): the same bits. di reads its pairs in
    place."""
    wide = _flash_inputs(cuda, 2, 3, 150, 64, "bthk", seed=9, dtype=dtype)
    views = [x[..., :20] for x in wide]
    tight = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in views]
    assert tight[0].stride()[1] == 20
    scale = 20 ** -0.5
    results = {}
    for what, (q, k, v, do) in (("view", views), ("copy", tight)):
        n0 = K.launch_counts()
        o, lse = K.flash_fwd(q, k, v, True, scale)
        di = K.flash_bwd_pre(o, do)
        dk, dv = K.flash_bwd_dkdv(q, k, v, do, lse, di, True, scale)
        dq = K.flash_bwd_dq(q, k, v, do, lse, di, True, scale)
        torch.cuda.synchronize()
        n1 = K.launch_counts()
        for name in ("flash_fwd", "flash_bwd_pre", "flash_bwd_dkdv",
                     "flash_bwd_dq"):
            assert n1[name] == n0[name] + 1
            copies = n1[f"{name}_pad_copies"] - n0[f"{name}_pad_copies"]
            assert copies == (what == "copy" and name != "flash_bwd_pre")
        results[what] = (o, lse, di, dk, dv, dq)
    for a, b in zip(results["view"], results["copy"]):
        assert a.shape == b.shape and torch.equal(a, b)
    q, k, v, do = views
    o32, lse32 = K.flash_attention_fwd_plain(
        *(x.float() for x in (q, k, v)), True, scale)
    ob, lseb = K.flash_attention_fwd_plain(q, k, v, True, scale)
    _assert_flash_close("o", results["view"][0], o32, ob)
    _assert_flash_close("lse", results["view"][1], lse32, lseb)


def _check_k6_case(cuda, dtype, d, tq, tk, causal):
    """One K6 forward and backward against the plain versions; returns the
    inputs, lse, di and dq."""
    q, k, v, do = _flash_inputs(cuda, 2, 3, tq, d, "bthk", dtype=dtype,
                                tk=tk)
    scale = d ** -0.5
    f32 = [x.float() for x in (q, k, v, do)]
    o32, lse32 = K.flash_attention_fwd_plain(*f32[:3], causal, scale)
    dq32, dk32, dv32 = K.flash_attention_bwd_plain(
        *f32[:3], o32, lse32, f32[3], causal, scale)
    with _plain_matmuls(dtype):
        ob, lseb = K.flash_attention_fwd_plain(q, k, v, causal, scale)
        dqb, dkb, dvb = K.flash_attention_bwd_plain(q, k, v, ob, lseb, do,
                                                    causal, scale)
    n0 = K.launch_counts()
    o, lse = K.flash_fwd(q, k, v, causal, scale)
    di = K.flash_bwd_pre(o, do)
    dk, dv = K.flash_bwd_dkdv(q, k, v, do, lse, di, causal, scale)
    dq = K.flash_bwd_dq(q, k, v, do, lse, di, causal, scale)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_pre", "flash_bwd_dkdv",
                 "flash_bwd_dq"):
        assert n1[name] == n0[name] + 1
    for got, like in ((o, q), (dq, q), (dk, k), (dv, v)):
        assert got.dtype == dtype and got.shape == like.shape
    for name, got, want, plain in (("o", o, o32, ob),
                                   ("lse", lse, lse32, lseb),
                                   ("dq", dq, dq32, dqb),
                                   ("dk", dk, dk32, dkb),
                                   ("dv", dv, dv32, dvb)):
        assert bool(torch.isfinite(got).all()), name
        _check_flash_case(got, want, plain, name, dtype)
    torch.testing.assert_close(di, K.flash_bwd_pre_plain(o, do), rtol=1e-5,
                               atol=1e-5)
    return q, k, v, do, lse, di, dq


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_backward_repeats_bitwise(cuda, dtype, causal):
    """The Hopper backward gives the same bits from run to run and on
    strided views as on contiguous copies (no atomics; the arithmetic
    never sees the strides)."""
    q, k, v, do = _flash_inputs(cuda, 2, 4, 300, 128, "bthk", seed=4,
                                dtype=dtype)
    o, lse = K.flash_fwd(q, k, v, causal, 128 ** -0.5)
    di = K.flash_bwd_pre(o, do)
    args = (lse, di, causal, 128 ** -0.5)
    first = (*K.flash_bwd_dkdv(q, k, v, do, *args),
             K.flash_bwd_dq(q, k, v, do, *args))
    again = (*K.flash_bwd_dkdv(q, k, v, do, *args),
             K.flash_bwd_dq(q, k, v, do, *args))
    cont = [x.contiguous() for x in (q, k, v, do)]
    copies = (*K.flash_bwd_dkdv(*cont, *args), K.flash_bwd_dq(*cont, *args))
    for a, b, c in zip(first, again, copies):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("layout", ["bthk", "bhtk"])
def test_cuda_flash_attention_local_autograd(cuda, layout):
    """The autograd function on the card against the plain path on the
    CPU, and one launch of each kernel per forward and backward."""
    q, k, v, do = _flash_inputs(cuda, 2, 4, 197, 64, layout, seed=1)
    if layout == "bthk":
        q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    outs = {}
    for dev in ("cpu", "cuda"):
        ins = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        n0 = K.launch_counts()
        out = flash_attention_local(*ins, causal=False, layout=layout)
        out.backward(do.to(dev))
        outs[dev] = [out.detach().float().cpu()] + [
            x.grad.float().cpu() for x in ins]
        n1 = K.launch_counts()
        assert all(n1[name] - n0[name] == (dev == "cuda")
                   for name in ("flash_fwd", "flash_bwd_pre",
                                "flash_bwd_dkdv", "flash_bwd_dq"))
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=2e-2,
                                   atol=2e-2 * float(a.abs().max()))


def test_cuda_flash_backward_takes_an_expanded_gradient(cuda):
    """out.sum() hands the backward a stride-0 gradient: it is copied, not
    refused, and the result is the plain version's."""
    q, k, v, _ = _flash_inputs(cuda, 1, 2, 70, 64, "bhtk", seed=2)
    grads = {}
    for dev in ("cpu", "cuda"):
        ins = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        flash_attention_local(*ins, layout="bhtk").sum().backward()
        grads[dev] = [x.grad.float().cpu() for x in ins]
    for a, b in zip(grads["cpu"], grads["cuda"]):
        torch.testing.assert_close(b, a, rtol=2e-2,
                                   atol=2e-2 * float(a.abs().max()))


def test_cuda_transformer_trains_through_the_flash_kernels(cuda):
    cfg = TransformerConfig(vocab_size=256, d_model=256, n_heads=2,
                            n_layers=2, d_ff=512, max_seq=128,
                            dtype=torch.bfloat16, attention="flash")
    model = Transformer(cfg).to(cuda)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, 256, (2, 129), device=cuda, generator=gen)
    K.reset_launch_counts()
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = lean_lm_loss(model, tokens[:, :-1], tokens[:, 1:])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    counts = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_pre", "flash_bwd_dkdv",
                 "flash_bwd_dq"):
        assert counts[name] == 2 * 3, (name, counts)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("dtype,n_heads", [(torch.float32, 4),
                                           (torch.float16, 2),
                                           (torch.bfloat16, 8)])
def test_cuda_transformer_of_any_dtype_and_head_dim_trains(cuda, dtype,
                                                           n_heads):
    """TransformerConfig(attention="flash") in fp32 (head dim 64), fp16
    (128) and bf16 with head dim 32 (padded): the flash kernels run, the
    loss is finite and falls."""
    cfg = TransformerConfig(vocab_size=256, d_model=256, n_heads=n_heads,
                            n_layers=2, d_ff=512, max_seq=128, dtype=dtype,
                            attention="flash")
    model = Transformer(cfg).to(cuda)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, 256, (2, 129), device=cuda, generator=gen)
    K.reset_launch_counts()
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = lean_lm_loss(model, tokens[:, :-1], tokens[:, 1:])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    counts = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert counts[name] == 2 * 3, (name, counts)
        # fp32: every kernel on the Hopper tf32 route
        assert counts[f"{name}_sm90_tf32"] == (
            6 if dtype == torch.float32 else 0)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.float16, 128),
                                     (torch.bfloat16, 16)])
def test_cuda_flash_attention_local_autograd_dtypes(cuda, dtype, d):
    """flash_attention_local on the card against its plain path on the CPU
    for fp32, fp16 and a padded head dim, causal, one launch of each
    kernel a forward and backward."""
    q, k, v, do = _flash_inputs(cuda, 2, 2, 150, d, "bhtk", seed=6,
                                dtype=dtype)
    outs = {}
    for dev in ("cpu", "cuda"):
        ins = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        n0 = K.launch_counts()
        out = flash_attention_local(*ins, causal=True, layout="bhtk")
        out.backward(do.to(dev))
        outs[dev] = [out.detach().float().cpu()] + [
            x.grad.float().cpu() for x in ins]
        n1 = K.launch_counts()
        assert all(n1[name] - n0[name] == (dev == "cuda")
                   for name in ("flash_fwd", "flash_bwd_pre",
                                "flash_bwd_dkdv", "flash_bwd_dq"))
    tol = TF32_PATH_TOL if dtype == torch.float32 else 2e-2
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=tol,
                                   atol=tol * float(a.abs().max()))


def test_cuda_vit_tiny_trains_through_the_flash_kernels(cuda):
    """ViT_Tiny (head dim 16, read in place at 64 on the card) in fp32:
    the kernels run on the Hopper tf32 route with no zero-padded copy, the
    loss is finite and falls."""
    from horovod_tpu_torch.models.vit import ViT_Tiny
    model = ViT_Tiny(num_classes=10, dtype=torch.float32,
                     image_size=32).to(cuda)
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(8, 32, 32, 3, device=cuda, generator=gen)
    y = torch.randint(0, 10, (8,), device=cuda, generator=gen)
    K.reset_launch_counts()
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x).float(), y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    layers = len(model.blocks)
    counts = K.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        assert counts[name] == counts[f"{name}_sm90_tf32"] == 3 * layers
        assert counts[f"{name}_pad_copies"] == 0
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_cuda_vit_runs_the_flash_kernels(cuda):
    model = ViT(num_classes=10, patch=16, d_model=128, n_layers=2,
                n_heads=2, d_ff=256, image_size=64).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(4, 64, 64, 3, device=cuda, generator=gen)
    K.reset_launch_counts()
    logits = model(x)
    logits.float().square().mean().backward()
    assert logits.shape == (4, 10) and bool(torch.isfinite(logits).all())
    assert K.launch_counts()["flash_fwd"] == 2
    assert K.launch_counts()["flash_bwd_dq"] == 2


def _seg_case(dev, b, h, s, d, part, seed=0):
    """One ring segment as the zig-zag ring hands it: q, k, v, do halves of
    [B, 2S, H, D] tensors (taken as [B, H, T, D] views) and the strided
    halves of the causal attention's lse and di over all 2S rows."""
    q, k, v, do = _flash_inputs(dev, b, h, 2 * s, d, "bthk", seed)
    o, lse = K.flash_fwd(q, k, v, True, d ** -0.5)
    di = K.flash_bwd_pre(o, do)
    rows_q = slice(s, 2 * s) if part == "full" else slice(0, s)
    lo = slice(0, s)
    return (q[:, :, rows_q], k[:, :, lo], v[:, :, lo], do[:, :, rows_q],
            lse[:, :, rows_q], di[:, :, rows_q]), part == "diag"


@pytest.mark.parametrize("part", ["full", "diag"])
@pytest.mark.parametrize("s", [1, 64, 129, 1000])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_seg_kernels_match_plain(cuda, d, s, part):
    """K7 on strided halves against its plain versions in fp32 (the same
    bound as K6's), bitwise equal to itself on contiguous copies and from
    run to run, fp32 outputs, one launch counted per call. S = 129 and
    1000 end inside a 128-row tile of the forward."""
    seg, causal = _seg_case(cuda, 2, 3, s, d, part)
    scale = d ** -0.5
    f32 = [x.float() for x in seg]
    o32, lse32 = K.flash_seg_fwd_plain(*f32[:3], causal, scale)
    dq32, dk32, dv32 = K.flash_seg_bwd_plain(
        f32[0], f32[1], f32[2], f32[4], f32[3], f32[5], causal, scale)
    ob, lseb = K.flash_seg_fwd_plain(*seg[:3], causal, scale)
    dqb, dkb, dvb = K.flash_seg_bwd_plain(seg[0], seg[1], seg[2], seg[4],
                                          seg[3], seg[5], causal, scale)
    n0 = K.launch_counts()
    o, lse = K.flash_seg_fwd(*seg[:3], causal, scale)
    dk, dv = K.flash_seg_bwd_dkdv(*seg, causal, scale)
    dq = K.flash_seg_bwd_dq(*seg, causal, scale)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for name in ("flash_seg_fwd", "flash_seg_bwd_dkdv", "flash_seg_bwd_dq"):
        assert counts[name] == n0[name] + 1
    assert counts["flash_fwd"] == n0["flash_fwd"]
    for name, got, want, plain in (("o", o, o32, ob),
                                   ("lse", lse, lse32, lseb),
                                   ("dq", dq, dq32, dqb),
                                   ("dk", dk, dk32, dkb),
                                   ("dv", dv, dv32, dvb)):
        assert got.dtype == torch.float32
        _assert_flash_close(name, got, want, plain)
    cont = [x.contiguous() for x in seg]
    again = (*K.flash_seg_fwd(*cont[:3], causal, scale),
             *K.flash_seg_bwd_dkdv(*cont, causal, scale),
             K.flash_seg_bwd_dq(*cont, causal, scale))
    for a, b in zip((o, lse, dk, dv, dq), again):
        assert torch.equal(a, b)
    o2, lse2 = K.flash_seg_fwd(*seg[:3], causal, scale)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.parametrize("dtype,d", [(torch.float16, 128), (torch.float32, 64),
                                     (torch.bfloat16, 96)])
@pytest.mark.parametrize("part", ["full", "diag"])
def test_cuda_seg_kernels_take_every_dtype(cuda, dtype, d, part):
    """K7 with fp16 and fp32 inputs and a padded head dim, on strided
    halves: fp32 outputs within K6's limits, the same bits on contiguous
    copies."""
    _check_k7_case(cuda, dtype, d, part)


@pytest.mark.parametrize("part", ["full", "diag"])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("dtype", WIDE_DTYPES)
def test_cuda_seg_kernels_take_any_head_dim(cuda, dtype, d, part):
    """The three K7 entry points at head dims 160, 192, 256, 320, 384, 576,
    640, 1024 and 1280 in bf16, fp16 and fp32 on strided halves, as the
    previous test, counted by their route."""
    n0 = K.launch_counts()
    _check_k7_case(cuda, dtype, d, part)
    n1 = K.launch_counts()
    for name in ("flash_seg_fwd", "flash_seg_bwd_dkdv", "flash_seg_bwd_dq"):
        counted = f"{name}_{_wide_route(dtype, d, name)}"
        assert n1[counted] >= n0[counted] + 2


@pytest.mark.parametrize("part", ["full", "diag"])
@pytest.mark.parametrize("d", [256, 320, 576, 1280])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_seg_wide_hopper_kernels(cuda, dtype, d, part):
    """K7's Hopper kernels at head dim 256 and, above it, its deep dk/dv
    and dq on strided halves: within the flash limits, each call counted on
    the sm90_wide route with no zero-padded copy, the same bits from run
    to run and on contiguous copies."""
    n0 = K.launch_counts()
    seg, got = _check_k7_case(cuda, dtype, d, part)
    n1 = K.launch_counts()
    for name in ("flash_seg_fwd", "flash_seg_bwd_dkdv", "flash_seg_bwd_dq"):
        assert n1[f"{name}_sm90_wide"] == n0[f"{name}_sm90_wide"] + 2
        assert n1[f"{name}_pad_copies"] == n0[f"{name}_pad_copies"]
    causal, scale = part == "diag", d ** -0.5
    again = (*K.flash_seg_fwd(*seg[:3], causal, scale),
             *K.flash_seg_bwd_dkdv(*seg, causal, scale),
             K.flash_seg_bwd_dq(*seg, causal, scale))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def _check_k7_case(cuda, dtype, d, part):
    """K7 on the zig-zag FULL or DIAG half of a causal attention's
    inputs against the plain versions; the same bits on contiguous
    copies. Returns the segment's inputs and the kernels' outputs."""
    s = 200
    q, k, v, do = _flash_inputs(cuda, 2, 3, 2 * s, d, "bthk", seed=7,
                                dtype=dtype)
    o, lse = K.flash_fwd(q, k, v, True, d ** -0.5)
    di = K.flash_bwd_pre(o, do)
    rows_q = slice(s, 2 * s) if part == "full" else slice(0, s)
    lo = slice(0, s)
    seg = (q[:, :, rows_q], k[:, :, lo], v[:, :, lo], do[:, :, rows_q],
           lse[:, :, rows_q], di[:, :, rows_q])
    causal, scale = part == "diag", d ** -0.5
    f32 = [x.float() for x in seg]
    o32, lse32 = K.flash_seg_fwd_plain(*f32[:3], causal, scale)
    dq32, dk32, dv32 = K.flash_seg_bwd_plain(
        f32[0], f32[1], f32[2], f32[4], f32[3], f32[5], causal, scale)
    with _plain_matmuls(dtype):
        ob, lseb = K.flash_seg_fwd_plain(*seg[:3], causal, scale)
        dqb, dkb, dvb = K.flash_seg_bwd_plain(seg[0], seg[1], seg[2], seg[4],
                                              seg[3], seg[5], causal, scale)
    got = (*K.flash_seg_fwd(*seg[:3], causal, scale),
           *K.flash_seg_bwd_dkdv(*seg, causal, scale),
           K.flash_seg_bwd_dq(*seg, causal, scale))
    torch.cuda.synchronize()
    for name, g, want, plain in zip(("o", "lse", "dk", "dv", "dq"), got,
                                    (o32, lse32, dk32, dv32, dq32),
                                    (ob, lseb, dkb, dvb, dqb)):
        assert g.dtype == torch.float32
        _check_flash_case(g, want, plain, name, dtype)
    cont = [x.contiguous() for x in seg]
    again = (*K.flash_seg_fwd(*cont[:3], causal, scale),
             *K.flash_seg_bwd_dkdv(*cont, causal, scale),
             K.flash_seg_bwd_dq(*cont, causal, scale))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    return seg, got


def test_cuda_k6_keeps_its_bf16_outputs(cuda):
    """K6 and K7 share their kernels; K6's outputs stay bf16, laid out as
    its inputs."""
    q, k, v, do = _flash_inputs(cuda, 1, 2, 100, 64, "bthk", seed=3)
    o, lse = K.flash_fwd(q, k, v, True, 0.125)
    di = K.flash_bwd_pre(o, do)
    dk, dv = K.flash_bwd_dkdv(q, k, v, do, lse, di, True, 0.125)
    assert o.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert o.stride() == q.stride() and lse.is_contiguous()
    o32, _ = K.flash_seg_fwd(q, k, v, True, 0.125)
    torch.testing.assert_close(o.float(), o32, rtol=0, atol=2 ** -8 *
                               float(o32.abs().max()))


@pytest.mark.parametrize("layout", ["zigzag", "contiguous"])
def test_cuda_ring_path_matches_flash(cuda, layout):
    """The ring at n = 1 (force_ring) against K6 on the same inputs, output
    and gradients of sum(out²), within twice the bf16 plain version's error
    against fp32 plus 1e-3 of the largest entry; 3 (zig-zag) or 1
    (contiguous) launch of each K7 kernel a call, none of K6's forward."""
    from horovod_tpu_torch.parallel.ring_attention import ring_attention_p
    gen = torch.Generator(device=cuda).manual_seed(5)
    base = [(0.3 * torch.randn(2, 256, 4, 64, device=cuda, generator=gen))
            .to(torch.bfloat16) for _ in range(3)]
    outs = {}
    for name in ("ring", "flash"):
        q, k, v = (x.detach().requires_grad_() for x in base)
        n0 = K.launch_counts()
        if name == "ring":
            out = ring_attention_p(q, k, v, None, 1, causal=True,
                                   layout=layout, force_ring=True)
        else:
            out = flash_attention_local(q, k, v, causal=True)
        (out.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        n1 = K.launch_counts()
        if name == "ring":
            want = 3 if layout == "zigzag" else 1
            for kern in ("flash_seg_fwd", "flash_seg_bwd_dkdv",
                         "flash_seg_bwd_dq"):
                assert n1[kern] - n0[kern] == want
            assert n1["flash_fwd"] == n0["flash_fwd"]
        outs[name] = [out.detach(), q.grad, k.grad, v.grad]
    f32 = [x.float().transpose(1, 2) for x in base]
    o32, lse32 = K.flash_attention_fwd_plain(*f32, True, 0.125)
    ref32 = (o32, *K.flash_attention_bwd_plain(*f32, o32, lse32, 2 * o32,
                                               True, 0.125))
    bf = [x.transpose(1, 2) for x in base]
    ob, lseb = K.flash_attention_fwd_plain(*bf, True, 0.125)
    refb = (ob, *K.flash_attention_bwd_plain(
        *bf, ob, lseb, (2 * ob.float()).to(torch.bfloat16), True, 0.125))
    for got, want, w32, wb in zip(outs["ring"], outs["flash"], ref32, refb):
        err = float((got.float() - want.float()).abs().max())
        base_err = float((wb.float() - w32).abs().max())
        assert err <= 2 * base_err + 1e-3 * float(w32.abs().max())


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.float32, 64),
                                     (torch.bfloat16, 32)])
@pytest.mark.parametrize("path", ["zigzag", "contiguous", "ulysses"])
def test_cuda_sequence_parallel_paths_take_every_dtype(cuda, dtype, d,
                                                       path):
    """The ring (force_ring at n = 1) and Ulysses (n = 1: K6) with fp16,
    fp32 and a padded head dim: output and gradients of sum(out²) against
    the plain path on the CPU."""
    from horovod_tpu_torch.parallel.ring_attention import ring_attention_p
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention_p
    gen = torch.Generator(device=cuda).manual_seed(8)
    base = [(0.5 * torch.randn(2, 128, 4, d, device=cuda, generator=gen))
            .to(dtype) for _ in range(3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        q, k, v = (x.detach().to(dev).requires_grad_() for x in base)
        if path == "ulysses":
            out = ulysses_attention_p(q, k, v, None, 1, causal=True)
        else:
            out = ring_attention_p(q, k, v, None, 1, causal=True,
                                   layout=path, force_ring=True)
        (out.float() ** 2).sum().backward()
        outs[dev] = [x.detach().float().cpu()
                     for x in (out, q.grad, k.grad, v.grad)]
    tol = TF32_PATH_TOL if dtype == torch.float32 else 2e-2
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=tol,
                                   atol=tol * float(a.abs().max()))


# every distinct gradient size of the flagship LM, and tails
ADASUM_SIZES = (67108864, 16777216, 4194304, 2048, 1, 1000, 65537)


def _adasum_operands(dev, n, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(n, device=dev, generator=gen)
    b = 0.6 * a + torch.randn(n, device=dev, generator=gen)
    return a.to(dtype), b.to(dtype)


def _combine64(triple, a, b):
    dot, na, nb = (float(v) for v in triple)
    ca = 0.0 if na == 0 else 1.0 - dot / (2 * na)
    cb = 0.0 if nb == 0 else 1.0 - dot / (2 * nb)
    return ca * a.double() + cb * b.double()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", ADASUM_SIZES)
def test_cuda_adasum_kernels_match_plain(cuda, n, dtype):
    """K4's triple within 1e-5 of sum |terms| of float64's; K5's output
    within twice the plain version's error against float64 plus the
    dtype's epsilon and 1e-6 of the largest entry (the two round the same
    fp32 value, from coefficients a few ulps apart); bitwise repeatable and
    swap-symmetric; one launch each."""
    a, b = _adasum_operands(cuda, n, dtype)
    n0 = K.launch_counts()
    t = K.adasum_triple(a, b)
    out = K.adasum_scale(t, a, b)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    assert n1["adasum_triple"] == n0["adasum_triple"] + 1
    assert n1["adasum_scale"] == n0["adasum_scale"] + 1
    assert out.dtype == dtype and t.dtype == torch.float32
    af, bf = a.double(), b.double()
    t64 = torch.stack([(af * bf).sum(), (af * af).sum(), (bf * bf).sum()])
    terms = torch.stack([(af * bf).abs().sum(), t64[1], t64[2]])
    assert bool(((t.double() - t64).abs() <= 1e-5 * terms).all())
    ref = _combine64(t64, a, b)
    plain = K.adasum_scale_plain(K.adasum_triple_plain(a, b), a, b)
    err = float((out.double() - ref).abs().max())
    base = float((plain.double() - ref).abs().max())
    big = float(ref.abs().max())
    assert err <= 2 * base + (torch.finfo(dtype).eps + 1e-6) * big
    assert torch.equal(K.adasum_triple(a, b), t)
    assert torch.equal(K.adasum_scale(t, a, b), out)
    t_ba = K.adasum_triple(b, a)
    assert torch.equal(t_ba, t[[0, 2, 1]])
    assert torch.equal(K.adasum_scale(t_ba, b, a), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_adasum_alignment_does_not_change_the_bits(cuda, dtype):
    """Views that are not 16-byte aligned are read element by element into
    the same lanes: the same bits as aligned copies."""
    a, b = _adasum_operands(cuda, 65541, dtype, seed=1)
    av, bv = a[1:65538], b[3:65540]          # 65537 elements each
    ac, bc = av.clone(), bv.clone()
    assert av.data_ptr() % 16 and not ac.data_ptr() % 16
    assert torch.equal(K.adasum_triple(av, bv), K.adasum_triple(ac, bc))
    t = K.adasum_triple(ac, bc)
    assert torch.equal(K.adasum_scale(t, av, bv), K.adasum_scale(t, ac, bc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_adasum_combine_with_a_zero_operand(cuda, dtype):
    """adasum_combine is K4 then K5 on the card: a zero operand has a zero
    coefficient, so 0 combined with b is b, bit for bit."""
    a, b = _adasum_operands(cuda, 4194304, dtype, seed=2)
    z = torch.zeros_like(a)
    n0 = K.launch_counts()
    assert torch.equal(A.adasum_combine(z, b), b)
    assert torch.equal(A.adasum_combine(a, z), a)
    assert torch.equal(A.adasum_combine(z, z), z)
    n1 = K.launch_counts()
    for name in ("adasum_triple", "adasum_scale"):
        assert n1[name] == n0[name] + 3


def test_cuda_adasum_kernels_reject_what_they_do_not_take(cuda):
    a = torch.zeros(64, device=cuda)
    t = K.adasum_triple(a, a)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        K.adasum_triple(a.double(), a.double())
    with pytest.raises(ValueError, match="one dtype"):
        K.adasum_triple(a, a.bfloat16())
    with pytest.raises(ValueError, match="not contiguous"):
        K.adasum_triple(torch.zeros(128, device=cuda)[::2], a)
    with pytest.raises(ValueError, match="shape"):
        K.adasum_scale(t, a, torch.zeros(65, device=cuda))
    with pytest.raises(ValueError, match="triple"):
        K.adasum_scale(t.double(), a, a)
    with pytest.raises(ValueError, match="CUDA"):
        K.adasum_triple(a, a.cpu())
    with pytest.raises(ValueError, match="empty"):
        K.adasum_triple(a[:0], a[:0])


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
    for step in range(len(res[0]["traj"])):
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


@pytest.mark.parametrize("seq", [2, 4])
def test_cuda_cards_sp_train_step_on_nccl(cards, tmp_path, seq):
    """The LM's sequence-parallel train step with ``seq`` cards on the seq
    axis (ring contiguous, ring zig-zag, Ulysses; K7 or K6 on NCCL) against
    one card training on the whole batch with K6: the ranks agree bitwise,
    the losses to 2e-2 relative and each parameter's change over two SGD
    steps to 5e-2 of its largest entry (bf16 attention, rounded at other
    places by the two paths)."""
    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      _local_loss)
    if seq > cards:
        pytest.skip(f"needs {seq} CUDA devices")
    res = run_world("sp_cards", seq, tmp_path, device="cuda")
    dev = torch.device("cuda", 0)
    x, y = (torch.from_numpy(a).to(dev) for a in sp_card_tokens())
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash",
                            **SP_CARD_DIMS)
    model = sp_card_model(cfg, dev)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=SP_LRS["sgd"])
    losses = []
    for _ in range(SP_STEPS):
        opt.zero_grad()
        total, count = _local_loss(model, x, y)
        (total / count).backward()
        opt.step()
        losses.append(float(total.detach() / count))
    for case in SP_VARIANTS:
        for r in res[1:]:
            for name, p in res[0][case]["params"].items():
                np.testing.assert_array_equal(r[case]["params"][name], p)
        np.testing.assert_allclose(res[0][case]["losses"], losses,
                                   rtol=2e-2)
        for name, p in model.named_parameters():
            want = (p.detach() - start[name]).cpu().numpy()
            got = res[0][case]["params"][name] - start[name].cpu().numpy()
            assert np.abs(got - want).max() <= \
                5e-2 * np.abs(want).max() + 1e-6, (case, name)


LM_TENSORS = 34        # the flagship LM's gradients: embed, 8 x 4, ln_f


@pytest.mark.parametrize("n,local", [(2, 0), (4, 0), (4, 2)])
def test_cuda_cards_adasum_lm_on_nccl(cards, tmp_path, n, local):
    """The flagship LM, one sequence a card, three AdamW steps through
    DistributedOptimizer(op=Adasum) and DistributedDeltaAdasumOptimizer on
    NCCL, flat or hierarchical (local size 2 at 4 cards): ranks agree
    bitwise, every reduced gradient of the first step matches
    ``adasum_stacked`` of the gathered per-rank gradients on one card to
    1e-6 of its largest entry, and K4/K5 launch once a tensor and level on
    every rank. Prints tokens/s per card and the ms of one Adasum
    reduction of the 34 gradients."""
    if n > cards:
        pytest.skip(f"needs {n} CUDA devices")
    env = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"} if local else None
    res = run_world("adasum_cards", n, tmp_path, device="cuda",
                    local_size=local or None, env=env, timeout=600)
    levels = int(math.log2(n // max(local, 1)))
    want = ADASUM_CARD_STEPS * LM_TENSORS * levels
    for kind in ("grad", "delta"):
        assert len({r[kind]["digest"] for r in res}) == 1, kind
        for r in res:
            assert np.isfinite(r[kind]["losses"]).all()
            assert r[kind]["launches"] == {"adasum_triple": want,
                                           "adasum_scale": want}, kind
    for r in res:
        assert r["local_size"] == local
        assert len(r["grad"]["rel_err"]) == LM_TENSORS
        assert max(r["grad"]["rel_err"]) <= 1e-6
    for kind in ("grad", "delta"):
        step_s = [float(np.median(r[kind]["step_s"][1:])) for r in res]
        print(f"adasum_cards n={n} local={local} {kind}: "
              f"{res[0]['tokens_per_step'] / max(step_s):.1f} tokens/s per "
              f"card (step {1e3 * max(step_s):.2f} ms, the slowest rank's "
              f"median of steps 2-{ADASUM_CARD_STEPS}), losses "
              f"{res[0][kind]['losses']}"
              + (f", one Adasum reduction of the {LM_TENSORS} gradients "
                 f"{1e3 * max(r['grad']['adasum_s'] for r in res):.2f} ms, "
                 f"largest error against adasum_stacked "
                 f"{max(max(r['grad']['rel_err']) for r in res):.3g}"
                 if kind == "grad" else ""))


@pytest.fixture
def built(cards):
    """The kernels built in this process before the ranks start, so no
    rank spends its world timeout on nvcc."""
    from horovod_tpu_torch.ops import build
    build.library()
    return cards


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_sync_bn_on_nccl(built, tmp_path, n):
    """SyncBatchNorm on each card's rows (torch_worker's sync_bn cases,
    even and ragged) over NCCL against the module on the global batch on
    one card: y, dx and eval's y by rows, dscale and dbias summed over the
    cards, the statistics and running statistics on every card."""
    if n > built:
        pytest.skip(f"needs {n} CUDA devices")
    res = run_world("sync_bn", n, tmp_path, device="cuda")
    for dtype in SYNC_BN_DTYPES:
        tol = max(float(torch.finfo(getattr(torch, dtype)).eps), 1e-5)
        for c in SYNC_BN_CHANNELS:
            for layout in SYNC_BN_LAYOUTS:
                key = (dtype, c, layout)
                want = sync_bn_run(0, 1, dtype, c, layout, device="cuda")
                for field in ("y", "dx", "y_eval"):
                    _assert_rel(np.concatenate([r[key][field] for r in res]),
                                want[field], tol)
                case = sync_bn_case(*key)
                x = case["x"].reshape(-1, c).astype(np.float64)
                dy = case["dy"].reshape(-1, c).astype(np.float64)
                xh = (x - x.mean(0)) / np.sqrt(x.var(0) + SYNC_BN_EPS)
                for field, terms in (("dscale", dy * xh), ("dbias", dy)):
                    got = sum(r[key][field] for r in res)
                    bound = 1e-4 * np.abs(terms).sum(0) + 1e-6
                    assert np.all(np.abs(got - want[field]) <= bound), key
                for r in res:
                    for i in (0, 1):
                        _assert_rel(r[key]["stats"][i], want["stats"][i],
                                    1e-5)
                    for field in ("mean1", "var1", "mean2", "var2"):
                        _assert_rel(r[key][field], want[field], 1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_alltoall_and_sparse_on_nccl(built, tmp_path, n):
    """alltoall even, uneven and seeded-uneven, and allreduce_sparse, on
    NCCL: what the gloo tests assert (tests/test_torch_collectives.py)."""
    if n > built:
        pytest.skip(f"needs {n} CUDA devices")
    res = run_world("collectives", n, tmp_path, device="cuda")
    ins = [alltoall_input(s, n) for s in range(n)]
    sp = [sparse_input(s) for s in range(n)]
    idx = np.concatenate([i for i, _ in sp])
    rows = np.unique(idx)
    sums = np.zeros((len(rows), 2))
    np.add.at(sums, np.searchsorted(rows, idx),
              np.concatenate([v for _, v in sp]))
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(
            r["even"], [[100.0 * s + rank] * 2 for s in range(n)])
        assert r["recv_counts"] == list(range(1, n + 1))
        parts = [t[sum(sp_[:rank]):sum(sp_[:rank + 1])] for t, sp_ in ins]
        np.testing.assert_array_equal(r["random"], np.concatenate(parts))
        assert r["random_counts"] == [sp_[rank] for _, sp_ in ins]
        assert len(r["errors"]) == 2
        u, c = r["sparse_sum"]
        np.testing.assert_array_equal(u, rows)
        np.testing.assert_allclose(c, sums, rtol=1e-6, atol=1e-7)
        assert r["sparse_ref"][0].tolist() == [1, 3, 5]


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_join_on_nccl(built, tmp_path, n):
    """The join scenario on NCCL, under the world timeout: what the gloo
    tests assert (tests/test_torch_join.py), and the active ranks' round
    issued behind a second of device sleep returns while it runs."""
    if n > built:
        pytest.skip(f"needs {n} CUDA devices")
    res = run_world("join", n, tmp_path, device="cuda")
    if n == 4:
        for rank, r in enumerate(res):
            assert r["sums"] == [10.0, 9.0, 7.0, 4.0][:rank + 1]
            assert r["last"] == 3
        return
    r0, r1 = res
    assert r0["ragged"] == ([3.0] * 3, 1)
    assert r1["ragged"] == ([3.0] * 3 + [2.0] * 3, 1)
    assert r1["grouped"] == ([[3.0, 3.0]] * 2 + [[2.0, 2.0]] * 2, 1)
    assert r1["mixed"] == {"bcast": 7.0, "gather_rows": 4, "rs": 1.0,
                           "alltoall": ([0.0, 2.0, 3.0], [1, 2]), "last": 1}
    assert "no data to broadcast" in r0["dead_root"]
    assert "has already joined" in r1["dead_root"]
    assert r1["overflow"][0][2:] == [[2.0] * JOIN_TENSORS] * 2
    np.testing.assert_array_equal(r1["adasum"][0][1],
                                  join_adasum_inputs(1)[1])
    assert (len(r1["optimizer"][0]), r1["optimizer"][1]) == (3, 1)
    for r in res:
        assert r["reads"] == [] and r["disabled"] == 1
        issue_s, total_s = r["wait"]
        assert issue_s < total_s / 2, r["wait"]


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_replay_on_nccl(built, tmp_path, n):
    """Step replay on NCCL (torch_worker's replay scenario, the pack kernel
    on): DistributedOptimizer's parameters after REPLAY_STEPS steps with
    replay on are bitwise those with it off (two eager runs agree bitwise
    too: no spread to hold to); a per-leaf stream arms and replays with
    the sums of every rank's tensors; rank 0 joins after the warm-up and
    the others replay against its substitutes with correct sums; and a
    profiled replayed step is one graph launch and no kernel launch on the
    host, its graph holding K1 and the NCCL allreduce once a bucket and the
    advertisement's two all_gathers."""
    if n > built:
        pytest.skip(f"needs {n} CUDA devices")
    res = run_world("replay", n, tmp_path, device="cuda",
                    env={"HOROVOD_PALLAS_PACK": "1"})
    warm = 3
    total = float(n * (n + 1) // 2)
    buckets = bucket_by_size(
        [torch.empty(2, i + 1) for i in range(JOIN_TENSORS)], 64)
    n_buckets = len(buckets)
    # auto's form of these small buckets on one node of n cards: the
    # tree's log2(n) pair rounds at 4 or more, else one all_reduce
    topo = Topology(size=n, local_size=n)
    rounds = sum(
        int(math.log2(n)) if C.choose_algorithm(
            "allreduce", sum(8 * (i + 1) for i in b), topo) == "tree" else 1
        for b in buckets)
    for rank, r in enumerate(res):
        for mode in ("on", "off", "off2"):
            assert len(r[mode]["traj"]) == REPLAY_STEPS
            for a, b, c in zip(r["on"]["traj"], r["off"]["traj"],
                               r["off2"]["traj"]):
                for x, y, z in zip(a, b, c):
                    np.testing.assert_array_equal(y, z)    # eager spread: 0
                    np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(r[mode]["traj"][-1][0],
                                          res[0][mode]["traj"][-1][0])
        assert r["on"]["replay"] == (1, REPLAY_STEPS - warm, 0)
        assert r["leaf"]["replay"] == (1, 2, 0)
        want = [sum(replay_leaf(q, i) for q in range(n)) for i in range(3)]
        for sums in r["leaf"]["sums"]:
            for got, w in zip(sums, want):
                np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)
        ej = r["early_join"]
        extra = 0 if rank == 0 else REPLAY_EXTRA
        assert ej["replay"] == (1, extra, 0)
        assert ej["sums"] == ([[total] * JOIN_TENSORS] * warm
                              + [[total - 1] * JOIN_TENSORS] * extra)
        assert ej["last"] == n - 1
        tr = r["trace"]
        assert tr["replay"][1] >= 1 and tr["replay"][2] == 0
        assert tr["host"].count("cudaGraphLaunch") == 1, tr["host"]
        assert tr["host"].count("cudaLaunchKernel") == 0, tr["host"]
        nccl = [k for k in tr["device"] if "nccl" in k.lower()]
        print(f"replay_cards n={n} rank {rank}: graph kernels "
              f"{len(tr['device'])}, NCCL {len(nccl)} "
              f"({sorted(set(nccl))}), buckets {n_buckets}")
        assert sum("pack_kernel" in k for k in tr["device"]) == n_buckets
        assert sum("AllReduce" in k for k in nccl) == rounds, nccl
        assert sum("AllGather" in k for k in nccl) == 2, nccl


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_sharded_on_nccl(built, tmp_path, n):
    """ZeRO-1 on NCCL (torch_worker's sharded_cards scenario: the flagship
    LM, AdamW, one sequence a card, the pack kernel on): every card's
    parameters bitwise alike in both runs; the sharded run's equal to the
    dense run's (bitwise at 2 cards, whose sums have one order; within
    1e-6 of the largest entry at 4, where NCCL's allreduce and
    reduce-scatter may add in other orders); each card's AdamW state near
    1/n of the dense run's; and a replayed step's trace: one graph launch,
    K1 and the NCCL reduce-scatter once a bucket in the graph, the
    all-gathers a bucket after it."""
    if n > built:
        pytest.skip(f"needs {n} CUDA devices")
    res = run_world("sharded_cards", n, tmp_path, device="cuda",
                    env={"HOROVOD_PALLAS_PACK": "1"}, timeout=600)
    for kind in ("dense", "sharded"):
        assert len({r[kind]["digest"] for r in res}) == 1, kind
        for r in res:
            assert r[kind]["replay"] == (1, 2, 0), (kind, r[kind]["replay"])
    for rank, r in enumerate(res):
        sh, de = r["sharded"], r["dense"]
        buckets = sh["buckets"]
        assert all(s == -(-t // n) for t, s, _ in buckets)
        if n == 2:
            assert sh["bitwise"], sh["max_diff"]
        assert sh["max_diff"] <= 1e-6 * sh["max_entry"], sh["max_diff"]
        ratio = sh["state_bytes"] / de["state_bytes"]
        pad = sum(p - t for t, _, p in buckets) / sum(t for t, _, _ in
                                                      buckets)
        assert abs(ratio - 1 / n) <= 1e-3 + pad, ratio
        host, device = sh["trace"]["host"], sh["trace"]["device"]
        nccl = [k for k in device if "nccl" in k.lower()]
        calls = sorted((k, host.count(k)) for k in set(host) if "cuda" in k)
        print(f"sharded_cards n={n} rank {rank}: {len(buckets)} buckets, "
              f"state {sh['state_bytes'] / 2**30:.3f} GiB against "
              f"{de['state_bytes'] / 2**30:.3f} (ratio {ratio:.4f}), "
              f"largest difference {sh['max_diff']:.3g} of "
              f"{sh['max_entry']:.3g}, bitwise {sh['bitwise']}, NCCL "
              f"{sorted(set(nccl))}, runtime calls {calls}")
        assert host.count("cudaGraphLaunch") == 1, host
        assert sum("pack_kernel" in k for k in device) == len(buckets)
        assert sum("ReduceScatter" in k for k in nccl) == len(buckets), nccl
        # the all-gathers a bucket, and the join round's (read on a side
        # stream before the launch)
        assert sum("AllGather" in k for k in nccl) == len(buckets) + 1, nccl


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_overlap_on_nccl(built, tmp_path, n):
    """The overlap modes on NCCL (torch_worker's overlap_cards scenario:
    the flagship LM's widths at 2 layers, AdamW, one sequence a card, join
    off so "staged" stays staged): the dense reduction under off and
    staged with K1, and staged with the pack off (the single-launch form
    in the warm-up); ZeRO-1 under off and under staged with the prefetch
    leg.
    Every card's parameters alike in each run; each run's parameters and
    losses bitwise the first run's of its arm (the modes move launches,
    never arithmetic); sharded_off's parameters equal to dense_off's
    (bitwise at 2 cards, whose sums have one order; within 1e-6 of the
    largest entry at 4, where NCCL's allreduce and reduce-scatter may add
    in other orders, as in test_cuda_cards_sharded_on_nccl); each run
    armed once and replayed twice with no fallback; a staged replay one
    sub-launch a bucket; the staged ZeRO-1 run one leg a step."""
    from torch_worker import OVERLAP_CARD_STEPS
    if n > built:
        pytest.skip(f"needs {n} CUDA devices")
    res = run_world("overlap_cards", n, tmp_path, device="cuda",
                    env={"HOROVOD_JOIN_DISABLE": "1"}, timeout=600)
    runs = [r for r, *_ in OVERLAP_CARD_RUNS]
    for rank, r in enumerate(res):
        print(f"overlap_cards n={n} rank {rank}: " + "; ".join(
            f"{k} digest {r[k]['digest'][:12]}, largest difference "
            f"{r[k]['max_diff']:.3g} of {r[k]['max_entry']:.3g}, "
            f"dispatches {r[k]['dispatches']}, counters (stages, steps, "
            f"legs) {r[k]['counters']}" for k in runs))
    for k in runs:
        assert len({r[k]["digest"] for r in res}) == 1, k
    for r in res:
        for arm in ("dense_", "sharded_"):
            mine = [k for k in runs if k.startswith(arm)]
            for k in mine:
                assert r[k]["digest"] == r[mine[0]]["digest"], k
                assert r[k]["losses"] == r[mine[0]]["losses"], k
        for k in runs:
            assert r[k]["replay"] == (1, 2, 0), (k, r[k]["replay"])
        sh = r["sharded_off"]
        if n == 2:
            assert sh["digest"] == r["dense_off"]["digest"]
            assert sh["losses"] == r["dense_off"]["losses"]
        assert sh["max_diff"] <= 1e-6 * sh["max_entry"], sh["max_diff"]
        buckets = r["dense_off"]["buckets"]
        assert buckets > 1
        for k in ("dense_staged", "dense_single_staged"):
            assert r[k]["counters"][0] == 2 * buckets, (k, r[k])
            assert r[k]["dispatches"] == OVERLAP_CARD_STEPS * buckets
        assert r["sharded_staged"]["counters"][2] == OVERLAP_CARD_STEPS
        assert r["sharded_off"]["counters"][2] == 0


def test_cuda_cards_meta_cache_on_nccl(built, tmp_path):
    """The steady-state size cache on 2 cards (torch_worker's meta_cache
    scenario on NCCL): after the warm-up, ten rounds of an uneven
    allgather and alltoall make no blocking host fetch and twenty
    deferred checks, with the reference's rows; a size change after the
    entry went hot raises on both cards at every extract, then 1 + 2 rows
    are negotiated."""
    from torch_worker import META_ROUNDS
    res = run_world("meta_cache", 2, tmp_path, device="cuda", timeout=300)
    for rank, r in enumerate(res):
        print(f"meta_cache cards rank {rank}: host_fetches {r['fetches']}, "
              f"deferred checks {r['checks']} over {META_ROUNDS} rounds")
        assert r["fetches"] == 0 and r["checks"] == 2 * META_ROUNDS
        assert r["g"].shape == (3, 2) and r["counts"] == [1, 2]
        assert r["recv"][:, 0].tolist() == [0.0, 1.0, 1.0]
        assert r["b"] == 7.0
        assert len(r["mismatch"]["errors"]) == 2
        assert all("size cache mismatch" in e
                   for e in r["mismatch"]["errors"])
        assert r["mismatch"]["after"].tolist() == \
            [[1.0, 1.0], [2.0, 2.0], [2.0, 2.0]]


@pytest.fixture(scope="module")
def codec_worlds(tmp_path_factory):
    """torch_worker's codec_cards scenario on NCCL (the flagship LM,
    AdamW, one sequence a card, the pack kernel on) on 2 and 4 cards,
    each world run once for the tests below; n is skipped where the
    machine has fewer cards."""
    from horovod_tpu_torch.ops import build
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    build.library()
    worlds = {}

    def get(n):
        if n > torch.cuda.device_count():
            pytest.skip(f"needs {n} CUDA devices")
        if n not in worlds:
            worlds[n] = run_world(
                "codec_cards", n, tmp_path_factory.mktemp(f"codec{n}"),
                device="cuda", env={"HOROVOD_PALLAS_PACK": "1"},
                timeout=900)
        return worlds[n]

    return get


def _codec_rel(res, run) -> float:
    """The largest relative difference of ``run``'s loss from the
    uncompressed run's over the steps."""
    return max(abs(a - b) / abs(b) for a, b in zip(res[0][run]["losses"],
                                                  res[0]["none"]["losses"]))


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_codec_on_nccl(codec_worlds, n):
    """The wire codecs on NCCL: uncompressed,
    DistributedOptimizer(compression=Compression.int8) with replay on and
    off, fp8, the bf16 codec through HOROVOD_TPU_COMPRESSION and
    sharded=True with int8, CODEC_CARD_STEPS steps each from the same
    seed, replayed after the warm-up. Every card's parameters bitwise
    alike; losses finite and falling; a replayed step one graph launch
    holding K1 and the codec legs (the all-to-all's send/receive and the
    all-gathers); the replayed int8 run bitwise the eager one. Prints each
    run's losses and step time against the uncompressed run's (recorded,
    not gated) before any check."""
    res = codec_worlds(n)
    warm = 3

    def step_ms(run):
        # the replayed steps' host ms, the slower rank's
        return float(np.median([max(r[run]["step_ms"][i] for r in res)
                                for i in range(warm, CODEC_CARD_STEPS)]))

    faults = []
    for run, codec, knob, sharded, replay in CODEC_CARD_RUNS:
        got = res[0][run]
        print(f"codec_cards n={n} {run}: losses "
              f"{' '.join(f'{v:.4f}' for v in got['losses'])} (largest "
              f"difference from none {_codec_rel(res, run):.2e}); step "
              f"{step_ms(run):.2f} ms against none's {step_ms('none'):.2f} "
              f"(steps 4-7, slower rank); residuals "
              f"{got['residual_bytes'] / 2**30:.3f} GiB; selections "
              f"{got['selections']}")
        if len({r[run]["digest"] for r in res}) != 1:
            faults.append((run, "the ranks' parameters differ"))
        for r in res:
            want = (1, CODEC_CARD_STEPS - warm, 0) if replay else (0, 0, 0)
            if r[run]["replay"] != want:
                faults.append((run, "replay", r[run]["replay"]))
            ls = r[run]["losses"]
            if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
                faults.append((run, "losses not finite and falling", ls))
        if run == "none" or not replay:
            continue
        host, device = got["trace"]["host"], got["trace"]["device"]
        nccl = sorted({k for k in device if "nccl" in k.lower()})
        print(f"  {run}: the replayed step's graph NCCL {nccl}")
        if (host.count("cudaGraphLaunch") != 1
                or not any("pack_kernel" in k for k in device)
                or not any("SendRecv" in k or "AllToAll" in k for k in nccl)
                or sum("AllGather" in k for k in device) < 2):
            faults.append((run, "the replayed step's trace", host, nccl))
    # the codec legs in the graph compute what the eager path does
    if (res[0]["int8_eager"]["losses"] != res[0]["int8"]["losses"]
            or res[0]["int8_eager"]["digest"] != res[0]["int8"]["digest"]):
        faults.append(("int8", "replayed not bitwise the eager run"))
    assert not faults, faults


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_codec_losses_near_uncompressed(codec_worlds, n):
    """Every compressed run's loss within 2% of the uncompressed run's at
    every step (the same worlds as the test above)."""
    res = codec_worlds(n)
    far = {run: _codec_rel(res, run) for run, *_ in CODEC_CARD_RUNS}
    assert all(v < 0.02 for v in far.values()), far

def test_cuda_cards_resnet50_join_round_cost(built, tmp_path):
    """ResNet-50 at batch 64 a card on 2 cards through
    DistributedOptimizer, windows with the join round on and off in turns:
    prints each mode's img/s per card (the slower rank's, median of its
    windows). Recorded, not gated."""
    res = run_world("resnet_cards", 2, tmp_path, device="cuda", timeout=600)
    for r in res:
        assert np.isfinite(r["losses"]).all()
        assert [on for on, _ in r["windows"]] == list(RESNET_CARD_MODES)
    rates = {on: [min(r["windows"][i][1] for r in res)
                  for i, (m, _) in enumerate(res[0]["windows"]) if m == on]
             for on in (True, False)}
    print(f"resnet_cards n=2: img/s per card, join round on "
          f"{np.median(rates[True]):.1f} (windows "
          f"{', '.join(f'{v:.1f}' for v in rates[True])}), off "
          f"{np.median(rates[False]):.1f} (windows "
          f"{', '.join(f'{v:.1f}' for v in rates[False])})")


@pytest.fixture(scope="module")
def algo_worlds(tmp_path_factory):
    """torch_worker's algo_cards scenario on NCCL (the flagship LM, AdamW,
    one sequence a card, the pack kernel on): 2 cards as one node, 4
    cards as two nodes of 2 (``HOROVOD_LOCAL_SIZE=2``: two "islands" on
    one NVLink box), each world run once for the tests below."""
    from horovod_tpu_torch.ops import build
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    build.library()
    worlds = {}

    def get(n):
        if n > torch.cuda.device_count():
            pytest.skip(f"needs {n} CUDA devices")
        if n not in worlds:
            worlds[n] = run_world(
                "algo_cards", n, tmp_path_factory.mktemp(f"algo{n}"),
                device="cuda", local_size=2,
                env={"HOROVOD_PALLAS_PACK": "1"}, timeout=900)
        return worlds[n]

    return get


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_algo_on_nccl(algo_worlds, n):
    """The collective algorithms on NCCL (torch_worker.check_algo_cards):
    the flagship LM trained under auto, flat, tree and hierarchical,
    replayed after the warm-up, ranks bitwise alike, the first reduced
    gradients and the losses near the flat run's; auto's ladder for the
    LM's buckets on two nodes of 2 and its tree for 64 KiB; the two-level
    allgather and alltoall bitwise the flat ones; ZeRO-1's two-level
    all-gather bitwise the flat leg; int8 on the ladder replayed. Prints
    each form's losses and step time (recorded, not gated; the "cross"
    legs are NVLink too on one box) before any check."""
    res = algo_worlds(n)
    warm = 3

    def step_ms(run):
        # the replayed steps' host ms, the slower rank's
        return float(np.median([max(r["forms"][run]["step_ms"][i]
                                    for r in res)
                                for i in range(warm, len(res[0]["forms"][
                                    run]["step_ms"]))]))

    for form in ALGO_CARD_FORMS:
        got = res[0]["forms"][form]
        print(f"algo_cards n={n} {form}: losses "
              f"{' '.join(f'{v:.5f}' for v in got['losses'])}; step "
              f"{step_ms(form):.2f} ms (replayed steps, slower rank); "
              f"selections {got['selections']}; first gradients "
              f"{got['grad_ratio']:.3f} of the bound (bitwise "
              f"{got['grad_bitwise']})")
    print(f"algo_cards n={n}: 64 KiB {res[0]['small_selections']}, "
          f"alltoall int8 error {res[0]['alltoall_int8_err']}, sharded "
          f"auto {res[0]['sharded_auto']['selections']}, int8 ladder "
          f"losses {res[0]['int8_hier']['losses']}")
    check_algo_cards(res, n, "hierarchical" if n == 4 else "flat")



# -- the tensor axis: tensor parallelism and MoE-EP --------------------------

def _one_card_tp(cfg, dev, x, y, steps, timed):
    """The one-card run of tp_cards: ``steps`` SGD steps of the whole
    batch's loss (with the MoE FFN's aux term): the losses, the parameters
    after the first step, and the ms of ``timed`` steps after them."""
    from horovod_tpu_torch.models.transformer import _local_loss_aux
    model = sp_card_model(cfg, dev)
    opt = torch.optim.SGD(model.parameters(), lr=SP_LRS["sgd"])

    def step():
        opt.zero_grad()
        total, count, aux = _local_loss_aux(model, x, y)
        loss = total / count + (cfg.moe_aux_weight * aux if cfg.use_moe
                                else 0.0)
        loss.backward()
        opt.step()
        return float(loss.detach())

    losses = [step()]
    params1 = {n: p.detach().float().cpu().clone()
               for n, p in model.named_parameters()}
    losses += [step() for _ in range(steps - 1)]
    ms = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, params1, ms


def _change_close(got, start, want, what, tol=5e-2):
    """Each parameter's change from ``start`` (one SGD step: the gradient)
    within ``tol`` of the one-card change's largest entry (bf16 compute,
    or fp32 through K6's tf32 route: the two paths round apart)."""
    for name, w in want.items():
        dw = w - start[name]
        dg = got[name] - start[name]
        scale = float(dw.abs().max()) or 1e-12
        err = float((dg - dw).abs().max())
        assert err <= tol * scale, (what, name, err, scale)


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_tensor_parallel_on_nccl(built, tmp_path, n):
    """Tensor parallelism on NCCL (torch_worker's tp_cards: the LM, K6 on
    each card's heads, two SGD steps): the whole world on the tensor axis,
    dense in bf16 and with the MoE FFN in fp32 (its experts over the tensor
    axis), and (data 2, tensor 2) on 4 cards, against the one-card run of
    the same weights: the losses of both steps to 2e-2 relative, each
    parameter's change over the first step (the gradient) to 5e-2 of its
    largest entry, the ranks of one tensor index bitwise alike, K6 once a
    layer and step on every card. Prints the step times beside one card's
    (recorded, not gated)."""
    from horovod_tpu_torch.models.convert import transformer_unshard
    from torch_worker import (TP_CARD_STEPS, TP_CARD_TIMED, tp_card_cases,
                              tp_card_config)
    if n > built:
        pytest.skip(f"needs {n} CUDA devices")
    res = run_world("tp_cards", n, tmp_path, device="cuda", timeout=600)
    dev = torch.device("cuda", 0)
    x, y = (torch.from_numpy(a).to(dev) for a in sp_card_tokens())
    for kind, axes in tp_card_cases(n):
        key = (kind, tuple(axes.values()))
        cfg = tp_card_config(torch, kind)
        t = axes["tensor"]
        want_losses, want, one_ms = _one_card_tp(cfg, dev, x, y,
                                                 TP_CARD_STEPS, TP_CARD_TIMED)
        start = {k: v.float().cpu() for k, v in
                 sp_card_model(cfg, "cpu").state_dict().items()}
        states = {}
        for r, res_r in enumerate(res):
            got = res_r[key]
            assert got["tensor_index"] == r % t
            np.testing.assert_allclose(got["losses"], want_losses,
                                       rtol=2e-2)
            mine = {k: torch.from_numpy(v)
                    for k, v in got["params1"].items()}
            if r % t in states:
                for k, v in mine.items():
                    assert torch.equal(v, states[r % t][k]), (key, r, k)
            states.setdefault(r % t, mine)
            layers = cfg.n_layers * TP_CARD_STEPS
            assert got["k6"] == {"flash_fwd": layers,
                                 "flash_bwd_dkdv": layers,
                                 "flash_bwd_dq": layers}, got["k6"]
            print(f"tp_cards n={n} {kind} {axes} rank {r}: losses "
                  f"{got['losses']} (one card {want_losses}); step ms "
                  f"{' '.join(f'{v:.2f}' for v in got['step_ms'])} (one "
                  f"card {' '.join(f'{v:.2f}' for v in one_ms)})")
        full = transformer_unshard([states[i] for i in range(t)], cfg)
        _change_close(full, start, want, key)


def _one_card_moe_ep(cfg, dev, n):
    """The one-card run of moe_cards' first step: each rank's token block
    through the single-shard MoE LM (every expert local), the shared
    gradients averaged and the experts' summed over the blocks (the EP
    step's reduction), one SGD step. Returns the blocks' mean loss and the
    full parameters after the step."""
    from horovod_tpu_torch.models.transformer import lean_lm_loss
    from torch_worker import moe_card_tokens
    model = sp_card_model(cfg, dev)
    grads, losses = [], []
    for r in range(n):
        model.zero_grad()
        x, y = (torch.from_numpy(a).to(dev) for a in moe_card_tokens(r))
        loss = lean_lm_loss(model, x, y)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.detach().float().clone()
                      for k, p in model.named_parameters()})
    out = {}
    for k, p in model.named_parameters():
        g = sum(gr[k] for gr in grads)
        if not k.endswith((".w1", ".w2")):
            g = g / n
        out[k] = (p.detach().float() - SP_LRS["sgd"] * g).cpu()
    return sum(losses) / n, out


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_moe_ep_on_nccl(built, tmp_path, n):
    """The MoE-EP step on NCCL (torch_worker's moe_cards: the bf16 MoE LM,
    8 experts over the cards, each card its own tokens, join off): the
    first step's loss (the world mean) to 2e-2 and each rank's parameters'
    change (the shared ones and its experts) to 5e-2 of the one-card run's
    largest entry; once armed, each of the 4·L exchange rounds and the
    shared-gradient round one replayed dispatch a step, with no staged
    sub-launch ("auto" is off on the card); K6 once a layer and step and
    K1 in the shared-gradient round. Prints the step times (recorded, not
    gated)."""
    from horovod_tpu_torch.models.convert import transformer_shard
    from torch_worker import (MOE_CARD_STEPS, MOE_CARD_WARM,
                              tp_card_config)
    if n > built:
        pytest.skip(f"needs {n} CUDA devices")
    res = run_world("moe_cards", n, tmp_path, device="cuda",
                    env={"HOROVOD_JOIN_DISABLE": "1",
                         "HOROVOD_PALLAS_PACK": "1"}, timeout=600)
    cfg = tp_card_config(torch, "moe", factor=2.0, aux_weight=0.01)
    dev = torch.device("cuda", 0)
    want_loss, want = _one_card_moe_ep(cfg, dev, n)
    start = {k: v.float().cpu() for k, v in
             sp_card_model(cfg, "cpu").state_dict().items()}
    rounds = 4 * cfg.n_layers + 1
    for r, got in enumerate(res):
        print(f"moe_cards n={n} rank {r}: losses "
              f"{' '.join(f'{v:.4f}' for v in got['losses'])} (one card's "
              f"first {want_loss:.4f}); step ms "
              f"{' '.join(f'{v:.2f}' for v in got['step_ms'])}; "
              f"dispatches, replayed rounds {got['marks']}")
        assert abs(got["losses"][0] - want_loss) <= 2e-2 * abs(want_loss)
        assert got["losses"][-1] < got["losses"][0]
        mine = transformer_shard(want, cfg, n, r, ep=True)
        begin = transformer_shard(start, cfg, n, r, ep=True)
        _change_close({k: torch.from_numpy(v)
                       for k, v in got["params1"].items()}, begin, mine,
                      ("moe_ep", n, r))
        for m in got["marks"][MOE_CARD_WARM:]:
            assert m == (rounds, rounds, 0), got["marks"]
        for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
            assert got["counts"][name] == cfg.n_layers * MOE_CARD_STEPS
        assert got["counts"]["pack"] + got["counts"].get(
            "pack_graph", 0) >= 1


def test_cuda_moe_ep_step_replays_bitwise(cuda, monkeypatch):
    """The MoE-EP step at size 1 on the card: replay armed gives the eager
    run's losses bitwise, each replayed step is 4·L graph launches, and a
    replayed step synchronizes the host once (the routing counts' read)."""
    import warnings
    from horovod_tpu_torch.core.state import engine
    from horovod_tpu_torch.models.transformer import (
        make_moe_ep_train_step, moe_ep_partition)
    from torch_worker import moe_card_tokens, tp_card_config
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_TPU_STEP_REPLAY"):
        monkeypatch.delenv(var, raising=False)
    hvd.init()
    eng = engine()
    cfg = tp_card_config(torch, "moe", factor=2.0, aux_weight=0.01)
    x, y = (torch.from_numpy(a).to(cuda) for a in moe_card_tokens(0))

    def run(replay, steps=5):
        eng.config.step_replay = replay
        eng.replay.invalidate_all("test")
        model = sp_card_model(cfg, cuda)
        moe_ep_partition(model, 0, 1, cfg)
        step = make_moe_ep_train_step(eng, cfg, torch.optim.SGD(
            model.parameters(), lr=0.1))
        return [float(step(model, x, y)) for _ in range(steps)], step, model

    eager, _, _ = run(False)
    replayed, step, model = run(True)
    eng.config.step_replay = True
    assert replayed == eager
    d0 = eng.dispatch_count
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(model, x, y)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert eng.dispatch_count - d0 == 4 * cfg.n_layers
    assert len(syncs) <= 1, [str(w.message) for w in syncs]


# -- the pipeline: its schedules over NCCL P2P -------------------------------

def _one_card_pp_losses(dims, n_layers, dev):
    """One card's first loss of pp_cards' seed-0 weights on each
    microbatch count's whole batch (lean_lm_loss: the pipeline's
    objective, bf16 logits)."""
    from horovod_tpu_torch.models.transformer import Transformer, lean_lm_loss
    from torch_worker import PP_CARD_MICRO, pp_card_config, pp_card_tokens
    cfg = pp_card_config(torch, dims, n_layers)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0)).to(
        dev)
    x_all, y_all = pp_card_tokens(dims, max(PP_CARD_MICRO))
    out = {}
    with torch.no_grad():
        for m in PP_CARD_MICRO:
            x, y = (torch.from_numpy(a[:m]).to(dev) for a in (x_all, y_all))
            out[m] = float(lean_lm_loss(model, x, y))
    del model
    torch.cuda.empty_cache()
    return out


def test_cuda_checkpoint_snapshot_copies_on_the_card_without_a_wait(
        cuda, tmp_path):
    """snapshot() of a tree of CUDA tensors (fp32, bf16 at an odd byte
    offset, a bool mask), a CPU step count and a Python scalar, stamped
    behind the card spinning: no synchronizing call, it returns before the
    card reaches its copies, and a write in place queued after it does not
    reach the generation; the restore puts each leaf on its template
    leaf's device, bitwise."""
    import warnings
    from horovod_tpu_torch.checkpoint import CheckpointManager
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"a_mask": torch.rand(3, device=cuda, generator=g) > 0.5,
            "h": torch.randn(333, device=cuda, generator=g).to(
                torch.bfloat16),
            "w": torch.randn(1024, 1024, device=cuda, generator=g),
            "step": torch.tensor(3.0), "lr": 0.1}
    want = {k: v.clone() for k, v in tree.items() if torch.is_tensor(v)}
    m = CheckpointManager(str(tmp_path))
    try:
        # a first generation warms the allocator, the pinned ring and the
        # side stream
        assert m.snapshot(tree, step=1) and m.wait_idle(60)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                torch.cuda._sleep(200_000_000)
                assert m.snapshot(tree, step=2)
                after = torch.cuda.Event()
                after.record()
                ahead = not after.query()
                tree["w"].mul_(2.0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert ahead
        assert not [w for w in caught
                    if "called a synchronizing" in str(w.message)]
        assert m.wait_idle(60) and m.last_written_step == 2
        res = m.restore_latest(template=tree)
    finally:
        m.close(flush=False)
    assert res.step == 2 and res.tree["lr"] == 0.1
    for k, v in want.items():
        assert res.tree[k].device == v.device and torch.equal(res.tree[k], v)


def test_cuda_cards_checkpoint_restores_4_cards_on_2(built, tmp_path):
    """Durable checkpointing on NCCL (torch_worker's ckpt_cards: the SP
    card LM, bf16 on fp32 parameters, AdamW, one sequence a card): 4 cards
    snapshot at every step through the engine's step hook at redundancy 1
    through a test-started KVStoreServer, then take as many ZeRO-1 steps
    and snapshot checkpoint_payload(); with rank3/ deleted, 2 cards
    restore both: parameters and moments bitwise the 4-card run's, the
    ZeRO-1 state through zero1_reshard 4 → 2 (check_ckpt_cards)."""
    from torch_worker import check_ckpt_cards, run_ckpt_cards
    if built < 4:
        pytest.skip("needs 4 CUDA devices")
    t0 = time.perf_counter()
    written, restored = run_ckpt_cards(tmp_path, "cuda", 4, 2)
    check_ckpt_cards(written, restored)
    print(f"ckpt_cards: 4 cards wrote and 2 restored in "
          f"{time.perf_counter() - t0:.1f} s; losses "
          f"{[r['losses'] for r in written]}, ZeRO-1 "
          f"{written[0]['zero1_losses']}")


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_cards_pipeline_on_nccl(built, tmp_path, n):
    """The pipelined flagship on NCCL (torch_worker's pp_cards: the
    flagship LM's widths, bf16 on fp32 parameters, AdamW, microbatches of
    one sequence, 8 and 4 a step): 1f1b, zb and interleaved v=2 over the
    whole world as the pipe axis (interleaved at 8 layers on 4 stages,
    beside 1f1b there), and the engine step (pipe 2; data 2 x pipe 2 on 4
    cards). At a fixed stage count and depth every schedule's losses and
    embedding bitwise 1F1B's; every rank the same loss (each replica's in
    the engine step); the first loss within 1e-3 of one card's on the
    same batch (the replicas' mean in the engine step); K6 on every card.
    Prints each schedule's step ms and its bubble measured by the
    marginal-microbatch method beside pipeline_bubble_fraction and
    predict_schedule_bubble (recorded, not gated)."""
    from horovod_tpu_torch.parallel import pipeline as PL
    from torch_worker import (PP_CARD_DIMS, PP_CARD_MICRO, PP_CARD_STEPS,
                              pp_card_cases)
    if n > built:
        pytest.skip(f"needs {n} CUDA devices")
    res = run_world("pp_cards", n, tmp_path, device="cuda", timeout=1200)
    dev = torch.device("cuda", 0)
    cases = pp_card_cases(n)
    one = {nl: _one_card_pp_losses(PP_CARD_DIMS, nl, dev)
           for nl in sorted({c[4] for c in cases})}
    base = {4: "1f1b", 8: "1f1b_l8"}
    m_hi, m_lo = PP_CARD_MICRO
    for name, axes, sched, v, n_layers, engine in cases:
        p, d = axes["pipe"], axes.get("data", 1)
        for m in PP_CARD_MICRO:
            got = [r[name][m] for r in res]
            if engine:
                for dd in range(d):
                    rep = [g["losses"] for g, r in zip(got, res)
                           if r[name]["index"].get("data", 0) == dd]
                    assert all(x == rep[0] for x in rep), (name, m, rep)
                first = np.mean([g["losses"][0] for g in got])
            else:
                assert all(g["losses"] == got[0]["losses"] for g in got)
                first = got[0]["losses"][0]
                b = [r[base[n_layers]][m] for r in res]
                assert got[0]["losses"] == b[0]["losses"], (name, m)
                assert [g["embed_sum"] for g in got] == \
                    [g["embed_sum"] for g in b], (name, m)
            assert abs(first - one[n_layers][m]) <= \
                1e-3 * abs(one[n_layers][m]), (name, m, first, one)
            for g in got:
                assert all(np.isfinite(g["losses"]))
                assert min(g["k6"].values()) >= 1, g["k6"]
        t_hi = float(np.median([np.median(r[name][m_hi]["ms"])
                                for r in res]))
        t_lo = float(np.median([np.median(r[name][m_lo]["ms"])
                                for r in res]))
        c = (t_hi - t_lo) / (m_hi - m_lo)
        bubble = (t_hi - m_hi * c) / t_hi
        resolved = res[0][name][m_hi]["resolved"]
        pb = PL.pipeline_bubble_fraction(p, m_hi // d, resolved[0],
                                         resolved[1])
        pr = PL.predict_schedule_bubble(resolved[0], p, m_hi // d,
                                        resolved[1])
        print(f"pp_cards n={n} {name} {axes} L{n_layers} {resolved}: "
              f"losses m={m_hi} {res[0][name][m_hi]['losses']} (one card "
              f"{one[n_layers][m_hi]:.6f}); step ms m={m_hi} "
              f"{' '.join(f'{x:.2f}' for x in res[0][name][m_hi]['ms'])}, "
              f"m={m_lo} "
              f"{' '.join(f'{x:.2f}' for x in res[0][name][m_lo]['ms'])}; "
              f"measured bubble {bubble:.4f} (pipeline_bubble_fraction "
              f"{pb:.4f}, predicted {pr:.4f}); K6 {res[0][name][m_hi]['k6']}"
              f"; peak {res[0][name][m_hi].get('peak_gib', 0):.2f} GiB")


def test_cuda_elastic_in_process_recovery(cuda):
    """``@hvd.elastic.run`` on one card (chip_smoke's phase 23 (a) at the
    256-wide LM): a HorovodInternalError after step 3 restores the commit
    of step 2 and builds a new NCCL world in this process; a host update
    pushed through a real WorkerNotificationClient interrupts the commit
    of step 4 and resets without a sync. The losses after each reset are
    bitwise an uninterrupted run's, the world version moves forward, the
    engine is new and K6 launches on the steps after each reset."""
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.elastic import (HostUpdateResult, TPUState,
                                           WorkerNotificationClient,
                                           notification_manager)
    from horovod_tpu_torch.runner.http_server import KVStoreServer
    steps, commit = 6, 2
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash",
                            **SP_CARD_DIMS)
    x, y = (torch.from_numpy(a).to(cuda) for a in sp_card_tokens())

    def trainer():
        model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
        model.to(cuda)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4))

        def step():
            opt.zero_grad()
            loss = lean_lm_loss(model, x, y)
            loss.backward()
            opt.step()
            return float(loss.detach())
        return model, opt, step

    import os
    version = os.environ.get("HOROVOD_TPU_WORLD_VERSION")
    hvd.init()
    kv = KVStoreServer()
    kv.start()
    manager = notification_manager()
    try:
        _, _, step = trainer()
        want = [step() for _ in range(steps)]
        manager.init(rendezvous_addr="127.0.0.1", rendezvous_port=kv.port,
                     rank=0, hostname="127.0.0.1")
        addr = kv.snapshot()["worker_addresses"]["0"].decode()
        model, opt, step = trainer()
        state = TPUState(params=model, opt_state=opt, step=0)
        lives, got = [], []
        K.reset_launch_counts()

        @hvd.elastic.run
        def train(state):
            lives.append((hvd._engine(), hvd._engine().world_version,
                          K.launch_counts()["flash_fwd"]))
            while state.step < steps:
                loss = step()
                state.step += 1
                got.append((len(lives), state.step, loss))
                if state.step == 3 and len(lives) == 1:
                    raise HorovodInternalError("injected")
                if state.step == 3 and len(lives) == 2:
                    WorkerNotificationClient(addr).notify_hosts_updated(
                        1, HostUpdateResult.ADDED)
                    deadline = time.monotonic() + 10
                    while state._host_messages.empty() and \
                            time.monotonic() < deadline:
                        time.sleep(0.01)
                if state.step % commit == 0:
                    state.commit()
            return state.step

        assert train(state) == steps
        end = K.launch_counts()["flash_fwd"]
    finally:
        manager.shutdown()
        kv.stop()
        hvd.shutdown()
        if version is None:
            os.environ.pop("HOROVOD_TPU_WORLD_VERSION", None)
        else:
            os.environ["HOROVOD_TPU_WORLD_VERSION"] = version
    assert len(lives) == 3
    assert lives[0][1] < lives[1][1] < lives[2][1]
    assert lives[0][0] is not lives[1][0] and lives[1][0] is not lives[2][0]
    after = [(s, v) for life, s, v in got if life > 1]
    assert [s for s, _ in after] == [3, 4, 5, 6]
    assert all(v == want[s - 1] for s, v in after), (after, want)
    ends = [lives[1][2], lives[2][2], end]
    assert ends[1] - lives[1][2] == cfg.n_layers * 2
    assert ends[2] - lives[2][2] == cfg.n_layers * 2


def _elastic_card_env():
    return {"HOROVOD_TPU_SHUTDOWN_TIMEOUT": "30",
            "HOROVOD_ELASTIC_FAILURE_BACKOFF": "0.5"}


def test_cuda_cards_elastic_crash_recovery_4_cards(built, tmp_path):
    """Elastic training on NCCL through the port's launcher (torch_worker
    elastic: the 256-wide LM, bf16 on fp32 parameters, AdamW, a commit
    every batch): rank 3 dies hard at batch 20 of 60. The survivors must
    get HorovodInternalError within the elastic timeout (no hang, no
    abort by the NCCL watchdog), restore and re-rendezvous; the driver
    relaunches the slot. All 4 finish at size 4 with bitwise-equal
    parameters, K6 launched on every card."""
    from torch_worker import run_elastic_job
    if built < 4:
        pytest.skip("needs 4 CUDA devices")
    t0 = time.perf_counter()
    rc, log, done, removed, lingering = run_elastic_job(
        tmp_path, "localhost:4\n", np_=4, max_np=4, total=60,
        device="cuda", timeout=600,
        env=dict(_elastic_card_env(), TEST_CRASH_RANK="3",
                 TEST_CRASH_BATCH="20"))
    took = time.perf_counter() - t0
    assert rc == 0, log[-8000:]
    assert not lingering, log[-8000:]
    assert (tmp_path / "crashed.marker").exists()
    assert len(done) == 4 and not removed, log[-8000:]
    assert all(r["size"] == 4 and r["batch"] == 60 for r in done), done
    assert len({r["digest"] for r in done}) == 1
    assert all(r["flash_launches"]["flash_fwd"] > 0 for r in done)
    lives = {r["rank"]: r["lives"] for r in done}
    print(f"elastic_cards crash: 4 cards, rank 3 killed at batch 20, "
          f"finished in {took:.1f} s; lives {lives}")


def test_cuda_cards_elastic_scale_down_4_to_2(built, tmp_path):
    """4 workers on NCCL; the discovery script drops to 2 slots mid-run:
    the two removed workers exit 0, the two left finish at size 2 with
    equal parameters (the reference's test_elastic_scale_down)."""
    from torch_worker import run_elastic_job, set_hosts
    if built < 4:
        pytest.skip("needs 4 CUDA devices")
    t0 = time.perf_counter()
    rc, log, done, removed, lingering = run_elastic_job(
        tmp_path, "localhost:4\n", np_=4, max_np=4, min_np=2, total=120,
        device="cuda", timeout=600,
        env=dict(_elastic_card_env(), TEST_BATCH_SLEEP="0.05"),
        on_world=lambda hostsfile: set_hosts(hostsfile, "localhost:2\n"))
    took = time.perf_counter() - t0
    assert rc == 0, log[-8000:]
    assert not lingering, log[-8000:]
    assert len(done) == 2, log[-8000:]
    assert all(r["size"] == 2 and r["batch"] == 120 for r in done), done
    assert len({r["digest"] for r in done}) == 1
    assert len(removed) == 2 and all(r == {"removed": True}
                                     for r in removed)
    print(f"elastic_cards scale-down: 4 cards to 2 in {took:.1f} s")


def _control_plane_job(tmp_path, agg: bool):
    from torch_worker import run_control_plane_job
    return run_control_plane_job(
        tmp_path, 4, 60, 20, device="cuda", timeout=600,
        env=dict(_elastic_card_env(), HOROVOD_PALLAS_PACK="1",
                 HOROVOD_TPU_LOCAL_SIZE="2", TEST_BATCH_SLEEP="0.1",
                 HOROVOD_TPU_AGG_ENABLE="1" if agg else "0",
                 HOROVOD_TPU_AGG_INTERVAL="0.5",
                 HOROVOD_TPU_METRICS_INTERVAL="0.5",
                 HOROVOD_TPU_TRACE_INTERVAL="0.5"))


def test_cuda_cards_control_plane_survives_primary_kill_4_cards(
        built, tmp_path):
    """The survivable control plane on NCCL: 4 workers of the 256-wide LM
    (torch_worker elastic) on 4 cards as two islands of 2, so ranks 0 and
    2 host the slice aggregators; the driver and the KV primary in one
    subprocess, the standby in this process; the primary SIGKILLed after
    rank 0's batch 20 of 60. Every worker finishes in its first life with
    equal parameters and no restore; both tiers of the standby promote
    and the journal has no gap; the survivor's /metrics holds the 4 ranks
    through the 2 slices' rollups and /agg lists both; K1 ran in every
    reduction. The same job with HOROVOD_TPU_AGG_ENABLE=0 puts more
    telemetry on the root a second than with the aggregators."""
    from torch_worker import prom_ranks, telemetry_puts
    if built < 4:
        pytest.skip("needs 4 CUDA devices")
    runs = {}
    for agg in (True, False):
        out = tmp_path / ("agg" if agg else "flat")
        out.mkdir()
        t0 = time.perf_counter()
        res = runs[agg] = _control_plane_job(out, agg)
        took = time.perf_counter() - t0
        logs = "\n".join(res["logs"])[-8000:]
        assert res["codes"] == [0, 0, 0, 0], logs
        assert res["kill_to_kv_s"] is not None and \
            res["kill_to_driver_s"] is not None, res
        assert res["audit"]["gaps"] == [], res["audit"]
        assert res["finished"] and not res["spawned"], res["results"]
        done = res["done"]
        assert len(done) == 4 and not res["removed"], logs
        assert all(r["size"] == 4 and r["batch"] == 60 and
                   len(r["lives"]) == 1 and not r["restores"]
                   for r in done), done
        assert len({r["digest"] for r in done}) == 1
        # K1 once a bucket each step's reduction, at least once a step
        assert all(r["pack_launches"]["pack"] >= 60 for r in done), done
        assert all(r["flash_launches"]["flash_fwd"] > 0 for r in done)
        assert prom_ranks(res["metrics"], "hvd_tpu_dispatches_total") >= \
            {"0", "1", "2", "3"}
        res["put_rate"] = telemetry_puts(res["requests"]) / \
            res["requests_s"]
        print(f"control_plane cards (aggregators {'on' if agg else 'off'}"
              f"): {took:.1f} s; kill -> KV {res['kill_to_kv_s']:.2f} s, "
              f"-> driver {res['kill_to_driver_s']:.2f} s; telemetry puts "
              f"at the survivor {res['put_rate']:.1f}/s "
              f"({telemetry_puts(res['requests'])} in "
              f"{res['requests_s']:.1f} s)")
    slices = runs[True]["agg"]["slices"]
    assert sorted(slices) == ["0", "1"], runs[True]["agg"]
    assert not runs[False]["agg"]["slices"], runs[False]["agg"]
    assert runs[True]["put_rate"] < runs[False]["put_rate"]


def test_cuda_cards_estimator_on_nccl(built, tmp_path):
    """The estimator on NCCL (torch_worker's estimator scenario): the
    flagship LM at full width and 2 layers, bf16 on fp32 parameters,
    AdamW, through ``Estimator.fit`` for 2 epochs on 3 uneven shards (rank
    1 joins halfway each epoch): finite losses, the model and AdamW state
    bitwise equal on both cards after each epoch, K1 in every reduction and
    the join's substitutes counted; rank 0's LocalStore checkpoints,
    resumed by both ranks, the trained model bitwise
    (check_estimator_world)."""
    from torch_worker import check_estimator_world, write_estimator_data
    write_estimator_data(str(tmp_path), "cuda")
    t0 = time.perf_counter()
    res = run_world("estimator", 2, tmp_path, device="cuda",
                    env={"ESTIMATOR_DIR": str(tmp_path),
                         "HOROVOD_PALLAS_PACK": "1"}, timeout=600)
    check_estimator_world(res, "cuda")
    print(f"estimator cards: {time.perf_counter() - t0:.1f} s; fit "
          f"{[round(r['seconds'], 2) for r in res]} s, resume "
          f"{[round(r['resume_s'], 2) for r in res]} s; losses "
          f"{[(h['train_loss'], h['val_loss']) for h in res[0]['history']]}"
          f"; batches {[r['batches'] for r in res]}, substitutes "
          f"{[len(r['subs']) for r in res]}; K1 "
          f"{[(r['pack'], r['pack_graph'], r['n_buckets']) for r in res]}; "
          f"K6a {[r['flash']['flash_fwd'] for r in res]}; peak "
          f"{[round(r['peak_gib'], 2) for r in res]} GiB")
