"""horovod_tpu_torch on the card: each CUDA kernel against its plain
version, the fused BatchNorm and a small ResNet training through the
kernels, a small LM and ViT through the flash-attention kernels, the
engine's grouped allreduce through the pack kernel on NCCL, and Adasum's
combine kernels (K4/K5) alone and training the flagship LM on 2 and 4
cards.

These tests import only torch and the port, so they also run where jax is
not installed. On a machine with a GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The multi-card tests (``-k cards``) start one process per visible card on
NCCL and skip with fewer than two cards.

Without a GPU every test skips. Tolerances: the BN statistics are fp32 sums
of the same values in another order; a thread of the kernel sums up to a few
thousand terms in sequence, so they agree within 1e-4 of sum |terms|. The
pack is a copy and must be bitwise. The flash-attention kernels are held to
an fp32 computation from the same bf16 inputs: their error may be twice the
bf16 plain version's, plus 1e-3 of the largest entry (see
``_assert_flash_close``). K4's triple is an fp32 sum in another order
than a float64 one: within 1e-5 of sum |terms|; K5's output within twice
the plain version's error against float64, plus the dtype's epsilon and
1e-6 of the largest entry (see ``test_cuda_adasum_kernels_match_plain``).
"""

import math

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
from horovod_tpu_torch.ops import adasum as A, kernels as K
from horovod_tpu_torch.ops.fused_batch_norm import FusedBatchNorm
from horovod_tpu_torch.parallel.flash_attention import flash_attention_local
from torch_worker import (ADASUM_CARD_STEPS, SP_CARD_DIMS, SP_LRS,
                          SP_STEPS, SP_VARIANTS, mlp_data, mlp_params,
                          run_world, shard_rows, sp_card_model,
                          sp_card_tokens)

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


def _flash_inputs(dev, b, h, t, d, layout, seed=0):
    """bf16 q, k, v, do as [B, H, T, D] views of tensors laid out as
    ``layout`` (a "bthk" tensor is passed transposed, with its strides)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, t, h, d) if layout == "bthk" else (b, h, t, d)
    ts = [torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
          for _ in range(4)]
    return [x.transpose(1, 2) for x in ts] if layout == "bthk" else ts


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
@pytest.mark.parametrize("t", [1, 63, 64, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_kernels_match_plain(cuda, d, causal, t, layout):
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


def test_cuda_flash_rejects_what_it_does_not_take(cuda):
    q, k, v, _ = _flash_inputs(cuda, 1, 2, 64, 64, "bhtk")
    with pytest.raises(ValueError, match="bfloat16"):
        K.flash_fwd(q.float(), k.float(), v.float(), True, 0.125)
    q96 = torch.zeros(1, 2, 64, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        K.flash_fwd(q96, q96, q96, True, 0.1)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_local(q96, q96, q96, layout="bhtk")
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention_local(q.float(), k.float(), v.float(), layout="bhtk")


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
@pytest.mark.parametrize("s", [1, 64, 1000])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_seg_kernels_match_plain(cuda, d, s, part):
    """K7 on strided halves against its plain versions in fp32 (the same
    bound as K6's), bitwise equal to itself on contiguous copies, fp32
    outputs, one launch counted per call."""
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


def test_cuda_k6_keeps_its_bf16_outputs(cuda):
    """K6 and K7 share their tile code; K6's outputs stay bf16, laid out
    as its inputs."""
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
