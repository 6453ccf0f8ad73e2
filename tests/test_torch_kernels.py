"""horovod_tpu_torch kernels: the plain versions against the JAX package's
Pallas kernels (run in interpret mode on the CPU, as
tests/test_pallas_kernels.py runs them), and the wrappers' CPU routing
(the CUDA kernels against their plain versions are in test_torch_cuda.py).

Tolerances: the BN statistics are fp32 sums of the same bf16 values taken in
another order, so they agree to fp32 rounding of the sum: |err| <= 1e-5 of
sum |terms| per channel. The pack is a copy and must be bitwise.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from horovod_tpu.ops.pallas_kernels import (bn_bwd_stats_pallas,
                                            bn_stats_pallas, pack_pallas)
from horovod_tpu_torch.ops import kernels as K

SUM_RTOL = 1e-5     # of sum |terms|: fp32 accumulation order only

# tests/test_pallas_kernels.py's (m, c) cases, its backward case, and more
# C=64 cases (ResNet-50's stem and first stage)
BN_CASES = [(1000, 256), (1000, 64), (512, 128), (777, 384), (900, 256),
            (2048, 64)]


def _bf16_pair(m, c, seed):
    """The same bf16 values as a jax array and a torch tensor."""
    rng = np.random.RandomState(seed)
    xj = jnp.asarray(rng.randn(m, c), jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)
    return xj, xt


def _close_to_sum(got, want, terms):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = SUM_RTOL * np.abs(np.asarray(terms, np.float64)).sum(0)
    assert np.all(np.abs(got - want) <= bound + 1e-6), \
        np.max(np.abs(got - want) - bound)


@pytest.mark.parametrize("m,c", BN_CASES)
def test_bn_stats_plain_matches_pallas(m, c):
    xj, xt = _bf16_pair(m, c, 0)
    s_ref, q_ref = bn_stats_pallas(xj)
    s, q = K.bn_stats_plain(xt)
    xf = xt.float().numpy()
    _close_to_sum(s, s_ref, xf)
    _close_to_sum(q, q_ref, xf * xf)


@pytest.mark.parametrize("m,c", BN_CASES)
def test_bn_bwd_stats_plain_matches_pallas(m, c):
    xj, xt = _bf16_pair(m, c, 1)
    dyj, dyt = _bf16_pair(m, c, 2)
    xf = xt.float().numpy()
    mean = xf.mean(0)
    invstd = (1.0 / (xf.std(0) + 1e-5)).astype(np.float32)
    s1_ref, s2_ref = bn_bwd_stats_pallas(dyj, xj, jnp.asarray(mean),
                                         jnp.asarray(invstd))
    s1, s2 = K.bn_bwd_stats_plain(dyt, xt, torch.from_numpy(mean),
                                  torch.from_numpy(invstd))
    dyf = dyt.float().numpy()
    _close_to_sum(s1, s1_ref, dyf)
    _close_to_sum(s2, s2_ref, dyf * (xf - mean) * invstd)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16", np.int32])
def test_pack_plain_matches_pallas(dtype):
    rng = np.random.RandomState(3)
    shapes = [(5,), (3, 4), (2, 2, 2), (1,), (64, 3, 3)]
    arrs = [jnp.asarray(rng.randn(*s) * 10, dtype) for s in shapes]
    want = np.asarray(pack_pallas(arrs)).astype(np.float32)
    got = K.pack_plain([torch.tensor(np.asarray(a).astype(np.float32))
                        for a in arrs])
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_the_plain_path_on_cpu():
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(300, 64), dtype=torch.float32)
    dy = torch.tensor(rng.randn(300, 64), dtype=torch.float32)
    mean, invstd = x.mean(0), 1.0 / (x.std(0) + 1e-5)
    before = K.launch_counts()
    for a, b in zip(K.bn_stats(x), K.bn_stats_plain(x)):
        assert torch.equal(a, b)
    for a, b in zip(K.bn_bwd_stats(dy, x, mean, invstd),
                    K.bn_bwd_stats_plain(dy, x, mean, invstd)):
        assert torch.equal(a, b)
    ts = [x[:7], dy[3], x[:2, :5].contiguous()]
    assert torch.equal(K.pack(ts), K.pack_plain(ts))
    assert K.launch_counts() == before   # plain runs are no launches


FLASH_ROUTED = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                "flash_seg_fwd", "flash_seg_bwd_dkdv", "flash_seg_bwd_dq")


@pytest.mark.parametrize("d", [16, 64, 80, 128, 129, 160, 192, 193, 256,
                               257, 288, 320, 384, 448, 512, 530, 576, 640,
                               1024, 1280])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_flash_route_follows_dtype_head_dim_and_entry_point(dtype, d):
    """Which kernel a K6/K7 wrapper launches on the card: bf16 and fp16 at
    head dims built at 64 or 128 the Hopper kernels; above 128 the Hopper
    wide kernels, every wrapper at every head dim (129 and 160 are built
    at 192, 193 at 256, 257 and 288 at 320, 530 at 576; dk/dv and dq above
    256 on the deep kernels); fp32 the Hopper tf32 kernels, every wrapper
    at every head dim."""
    padded = K._flash_dim(d)
    for kernel in FLASH_ROUTED:
        route = K.flash_route(dtype, d, kernel)
        if dtype == torch.float32:
            want = "sm90_tf32"
        elif padded <= 128:
            want = "sm90"
        else:
            want = "sm90_wide"
        assert route == want, (kernel, route)
    assert padded >= d and padded % 64 == 0


def test_flash_route_counters_and_refusals():
    """Each route has its counter in launch_counts (sm90_wide on all six
    wrappers, whose Hopper kernels take every head dim above 128;
    sm90_tf32, the Hopper kernels on fp32), and each of the seven K6/K7
    wrappers, di included, its count of zero-padded copies; di and other
    dtypes have no route, and no wrapper counts a route off the Hopper
    kernels (the mma.sync family's "wide" is gone): bf16 and fp16 at every
    head dim above 128, fp32 at every head dim."""
    counts = K.launch_counts()
    for kernel in FLASH_ROUTED:
        for route in ("sm90_wide", "sm90_tf32"):
            assert f"{kernel}_{route}" in counts
        assert f"{kernel}_wide" not in counts
        assert f"{kernel}_tf32" not in counts
        for d in (257, 1280):
            assert K.flash_route(torch.bfloat16, d, kernel) == "sm90_wide"
            assert K.flash_route(torch.float32, d, kernel) == "sm90_tf32"
    assert not hasattr(K, "SM90_BWD_MAX_DIM")
    for kernel in FLASH_ROUTED + ("flash_bwd_pre",):
        assert f"{kernel}_pad_copies" in counts
    assert "flash_bwd_pre_sm90_wide" not in counts
    assert "flash_bwd_pre_sm90_tf32" not in counts
    with pytest.raises(ValueError, match="wrapper"):
        K.flash_route(torch.bfloat16, 256, "flash_bwd_pre")
    with pytest.raises(ValueError, match="dtype"):
        K.flash_route(torch.float64, 64, "flash_fwd")


@pytest.mark.parametrize("d", [2, 16, 64, 128, 160, 256, 257, 320, 576,
                               1280])
def test_fp32_dkdv_and_wide_dq_keep_the_mma_sync_route(d):
    """fp32 dk/dv, dq and the forwards run the Hopper tf32 kernels at every
    head dim, above 256 as below it: no launch goes to the mma.sync family
    any more (the test's name is from when fp32 dk/dv and dq above 256
    did). The route's counter, which the plain path on the CPU leaves at
    0."""
    for kernel in FLASH_ROUTED:
        assert K.flash_route(torch.float32, d, kernel) == "sm90_tf32"
    rng = np.random.RandomState(d)
    q, k, v, do = (torch.tensor(rng.randn(1, 2, 9, d), dtype=torch.float32)
                   for _ in range(4))
    before = K.launch_counts()
    o, lse = K.flash_fwd(q, k, v, True, d ** -0.5)
    di = K.flash_bwd_pre(o, do)
    K.flash_bwd_dkdv(q, k, v, do, lse, di, True, d ** -0.5)
    K.flash_bwd_dq(q, k, v, do, lse, di, True, d ** -0.5)
    assert K.launch_counts() == before


@pytest.mark.parametrize("d", [288, 600])
def test_fp32_wide_backward_on_cpu_counts_no_route(d):
    """fp32 dk/dv and dq above head dim 256, K6's and K7's, on the CPU:
    their plain versions bit for bit, and every launch, route and
    zero-padded copy counter left at 0."""
    rng = np.random.RandomState(d)
    q, k, v, do = (torch.tensor(rng.randn(1, 2, 9, d), dtype=torch.float32)
                   for _ in range(4))
    scale = d ** -0.5
    K.reset_launch_counts()
    o, lse = K.flash_fwd(q, k, v, True, scale)
    di = K.flash_bwd_pre(o, do)
    for fn, plain in ((K.flash_bwd_dkdv, K.flash_bwd_dkdv_plain),
                      (K.flash_bwd_dq, K.flash_bwd_dq_plain),
                      (K.flash_seg_bwd_dkdv, K.flash_seg_bwd_dkdv_plain),
                      (K.flash_seg_bwd_dq, K.flash_seg_bwd_dq_plain)):
        got = fn(q, k, v, do, lse, di, True, scale)
        want = plain(q, k, v, do, lse, di, True, scale)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), fn.__name__
    counts = K.launch_counts()
    assert counts and all(n == 0 for n in counts.values()), counts


@pytest.mark.parametrize("d", [192, 256, 320])
def test_wide_flash_wrappers_take_the_plain_path_on_cpu(d):
    """On the CPU the wrappers at the Hopper wide head dims are their plain
    versions, bit for bit, and count no launch of any route."""
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.tensor(rng.randn(1, 2, 24, d),
                                dtype=torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    before = K.launch_counts()
    o, lse = K.flash_fwd(q, k, v, True, scale)
    ow, lsew = K.flash_attention_fwd_plain(q, k, v, True, scale)
    assert torch.equal(o, ow) and torch.equal(lse, lsew)
    di = K.flash_bwd_pre(o, do)
    for a, b in zip(K.flash_bwd_dkdv(q, k, v, do, lse, di, True, scale),
                    K.flash_bwd_dkdv_plain(q, k, v, do, lse, di, True,
                                           scale)):
        assert torch.equal(a, b)
    assert torch.equal(K.flash_bwd_dq(q, k, v, do, lse, di, True, scale),
                       K.flash_bwd_dq_plain(q, k, v, do, lse, di, True,
                                            scale))
    for a, b in zip(K.flash_seg_fwd(q, k, v, False, scale),
                    K.flash_seg_fwd_plain(q, k, v, False, scale)):
        assert torch.equal(a, b)
    assert K.launch_counts() == before


def _bthd(d, dtype=torch.bfloat16, offset=0, width=None):
    """A [B, H, T, D] view of a [B, T, H, width] tensor (width defaults to
    D: the models' layout) whose data starts ``offset`` elements in."""
    b, t, h = 2, 8, 3
    width = width or d
    flat = torch.zeros(offset + b * t * h * width, dtype=dtype)
    return flat[offset:].view(b, t, h, width)[..., :d].transpose(1, 2)


# (what, dtype, head dim, layout) -> the wrappers that copy: every K6/K7
# wrapper at a built head dim reads its views as they are; below one the
# Hopper kernels (every wrapper) read an even D in place where TMA takes
# the strides (multiples of 16 bytes: 8 elements of 16 bits, 4 of fp32),
# di copies only what its pairs cannot read. The cases whose ids name the
# mma.sync family keep the ids they had when it ran fp32 dk/dv, then
# 16-bit dk/dv and dq above 256, and copied; the Hopper kernels now read
# them in place.
_HOPPER = ("flash_fwd", "flash_seg_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
           "flash_seg_bwd_dkdv", "flash_seg_bwd_dq")
COPY_CASES = [
    ("built D64", torch.bfloat16, 64, {}, ()),
    ("built D128 fp32", torch.float32, 128, {}, ()),
    ("built D576", torch.bfloat16, 576, {}, ()),
    ("ViT_Tiny D16", torch.bfloat16, 16, {}, ()),
    ("D80", torch.bfloat16, 80, {}, ()),
    ("D96 fp16", torch.float16, 96, {}, ()),
    ("D160 fp16", torch.float16, 160, {}, ()),
    ("D288: the mma.sync backward copies", torch.bfloat16, 288, {}, ()),
    ("D336: the same", torch.float16, 336, {}, ()),
    ("D530 of a 536-wide tensor: the forwards read it in place",
     torch.bfloat16, 530, {"width": 536}, ()),
    ("D600: the same", torch.float16, 600, {}, ()),
    ("fp32 D16: the tf32 family copies", torch.float32, 16, {}, ()),
    ("fp32 D20: H stride of 20, a multiple of 4 and not of 8",
     torch.float32, 20, {}, ()),
    ("fp32 D18: H stride of 18, not a multiple of 4", torch.float32, 18, {},
     _HOPPER),
    ("fp32 D16 two elements past 16 bytes", torch.float32, 16,
     {"offset": 2}, _HOPPER),
    ("fp32 D160 of a 164-wide tensor", torch.float32, 160, {"width": 164},
     ()),
    ("fp32 D288: the mma.sync dk/dv and dq copy", torch.float32, 288, {},
     ()),
    ("D20: H stride of 20", torch.bfloat16, 20, {}, _HOPPER),
    ("D330: H stride of 330", torch.bfloat16, 330, {}, _HOPPER),
    ("D20 of a 64-wide tensor", torch.bfloat16, 20, {"width": 64}, ()),
    ("D16 one element past 16 bytes", torch.bfloat16, 16, {"offset": 1},
     _HOPPER + ("flash_bwd_pre",)),
    ("D16 four elements past", torch.float16, 16, {"offset": 4}, _HOPPER),
    ("odd D17 of a 64-wide tensor", torch.bfloat16, 17, {"width": 64},
     _HOPPER + ("flash_bwd_pre",)),
]


@pytest.mark.parametrize("what,dtype,d,view,copies", COPY_CASES,
                         ids=[c[0] for c in COPY_CASES])
def test_flash_copy_decision_follows_route_and_strides(what, dtype, d, view,
                                                       copies):
    """Which calls pay a zero-padded copy of their inputs
    (flash_needs_copy): a function of the views' shape, strides, dtype and
    address, decided without a card, by route and strides."""
    x = _bthd(d, dtype, **view)
    for kernel in FLASH_ROUTED + ("flash_bwd_pre",):
        assert K.flash_needs_copy(kernel, x, x, x) == (kernel in copies), \
            kernel


@pytest.mark.parametrize("dtype,d,ok", [
    (torch.float32, 16, True), (torch.float32, 20, True),
    (torch.float32, 18, False), (torch.bfloat16, 20, False),
    (torch.bfloat16, 24, True), (torch.float16, 12, False)])
def test_flash_strides_ok_counts_16_bytes(dtype, d, ok):
    """TMA's stride rule in bytes: a [B, T, H, D] view's strides are
    multiples of D, so D 20 and 16 pass in fp32 (multiples of 4) and D 20
    fails in bf16 (not of 8)."""
    assert K.flash_strides_ok(_bthd(d, dtype)) == ok


def test_flash_copy_decision_reads_every_view():
    """One view TMA cannot take makes the call copy all of them."""
    good, bad = _bthd(80), _bthd(80, offset=1)
    assert not K.flash_needs_copy("flash_fwd", good, good, good)
    assert K.flash_needs_copy("flash_fwd", good, good, bad)
    assert K.flash_needs_copy("flash_bwd_pre", good, bad)


def _expanded(d, dtype=torch.bfloat16):
    """A [B, H, T, D] gradient expanded from a scalar: every stride 0."""
    return torch.ones((), dtype=dtype).expand(2, 3, 8, d)


# (what, the incoming gradient, the backward's dk/dv wrapper, whether it is
# cloned): a clone only where the kernels will read the clone in place. The
# fp32 D16 and the D288 cases keep their ids from when the mma.sync dk/dv
# copied them; the Hopper dk/dv reads the clone in place.
GRAD_CASES = [
    ("D80 [B, T, H, D]", lambda: _bthd(80), "flash_bwd_dkdv", False),
    ("D80 expanded", lambda: _expanded(80), "flash_bwd_dkdv", True),
    ("D80 misaligned", lambda: _bthd(80, offset=1), "flash_seg_bwd_dkdv",
     True),
    ("built D64 expanded", lambda: _expanded(64), "flash_bwd_dkdv", True),
    ("built fp32 D64 expanded", lambda: _expanded(64, torch.float32),
     "flash_bwd_dkdv", True),
    ("D20: no clone TMA takes", lambda: _expanded(20), "flash_bwd_dkdv",
     False),
    ("D288: the mma.sync dk/dv copies", lambda: _expanded(288),
     "flash_seg_bwd_dkdv", True),
    ("fp32 D16: the tf32 family copies", lambda: _expanded(16, torch.float32),
     "flash_bwd_dkdv", True),
    ("fp32 D20 [B, T, H, D]: TMA takes strides of 4", lambda: _bthd(
        20, torch.float32), "flash_bwd_dkdv", False),
    ("fp32 D18 expanded: no clone TMA takes", lambda: _expanded(
        18, torch.float32), "flash_seg_bwd_dkdv", False),
]


@pytest.mark.parametrize("what,make,kernel,cloned", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_flash_grad_in_clones_only_what_the_kernels_read(what, make, kernel,
                                                         cloned):
    """The autograd backwards' incoming gradient: kept where TMA takes it
    or the wrappers copy it anyway, else one contiguous clone TMA takes."""
    do = make()
    got = K.flash_grad_in(do, kernel)
    assert (got is not do) == cloned
    if cloned:
        assert K.flash_strides_ok(got)
        assert not K.flash_needs_copy(kernel, got)
        torch.testing.assert_close(got, do, rtol=0, atol=0)


def test_pack_rejects_mixed_dtypes_and_empty():
    with pytest.raises(ValueError):
        K.pack([torch.zeros(3), torch.zeros(3, dtype=torch.float64)])
    with pytest.raises(ValueError):
        K.pack([])


SLOTS = 2 * 132     # 2 CTAs an SM of a 132-SM card, in clusters of 8


@pytest.mark.parametrize("m,c", [(802816, 64), (200704, 256),
                                 (12544, 1024), (3136, 2048)])
def test_bn_plan_fills_an_h100_at_resnet50_shapes(m, c):
    """At least one CTA per SM of a 132-SM card and no more than one wave
    at every ResNet-50 shape (batch 64, bf16), including the small-M
    layers; whole clusters of 4 to 16, and every row in some CTA's
    range."""
    plan = K.bn_plan(m, c, 2, SLOTS, 132)
    assert plan.tile_channels == 64 and plan.tiles == -(-c // 64)
    assert 132 <= plan.tiles * plan.ctas <= SLOTS
    assert 4 <= plan.cluster <= 16 and plan.ctas % plan.cluster == 0
    assert plan.ctas * plan.rows_per_cta >= m


@pytest.mark.parametrize("m,c,itemsize", [(1, 3, 4), (1, 3, 2), (10, 64, 4)])
def test_bn_plan_keeps_tiny_inputs_in_one_cta(m, c, itemsize):
    """Fewer rows than one stage: one CTA, a cluster of one, no
    workspace rows beyond the tile's own."""
    plan = K.bn_plan(m, c, itemsize, SLOTS, 132)
    assert (plan.ctas, plan.cluster, plan.clusters) == (1, 1, 1)
    assert plan.tile_channels == 128 // itemsize
    assert plan.rows_per_cta >= m
    assert plan.tiles == -(-c // plan.tile_channels)


def test_bn_plan_cluster_and_workspace_at_the_stem():
    """M=802,816 C=64 is one channel tile of 103 MB: 33 clusters of 8 CTAs
    each write one partial row, and the last sums all 33; a card that holds
    fewer clusters gets fewer."""
    plan = K.bn_plan(802816, 64, 2, SLOTS, 132)
    assert (plan.tiles, plan.ctas, plan.cluster, plan.clusters) == \
        (1, 264, 8, 33)
    assert plan.workspace_floats == 33 * 2 * 64
    assert plan.rows_per_cta == 3041
    assert K.bn_plan(802816, 64, 2, 240, 132).clusters == 30


def test_bn_plan_clusters_divide_odd_counts():
    """66 CTAs a tile (M=200704 C=256 on 264 slots) are 11 clusters of 6,
    with a ticket; a tile of few rows is one cluster, no ticket: 16 CTAs at
    M=3136 C=512 (8 of them on a card that runs no cluster above 8), 9 at
    M=12544 C=1024 (16 tiles on 132 SMs)."""
    assert K.bn_plan(200704, 256, 2, SLOTS, 132)[2:4] == (66, 6)
    for m, c, cap, n in ((3136, 512, 16, 16), (3136, 512, 8, 8),
                         (12544, 1024, 16, 9)):
        plan = K.bn_plan(m, c, 2, SLOTS, 132, cap)
        assert (plan.ctas, plan.cluster, plan.clusters) == (n, n, 1)


PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z5fwd64v' for 'sm_90a'
ptxas info    : Function properties for _Z5fwd64v
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z6fwd128v' for 'sm_90a'
ptxas info    : Function properties for _Z6fwd128v
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_ptxas_report_is_parsed_per_kernel():
    """The build keeps nvcc's -Xptxas -v report beside the library; each
    kernel's registers and spill bytes are read from it by name."""
    from horovod_tpu_torch.ops.build import parse_ptxas
    assert parse_ptxas(PTXAS_SAMPLE) == {
        "_Z5fwd64v": {"spill_stores": 0, "spill_loads": 0, "registers": 168},
        "_Z6fwd128v": {"spill_stores": 12, "spill_loads": 16,
                       "registers": 255}}
    assert parse_ptxas("") == {}


def test_sass_rename_matches_an_instance_to_its_successor():
    """The opcode diff of two builds compares an instance whose template
    parameters an edit removed (the mma.sync family's slice width and ONE
    flag) with its successor once --rename rewrites the old build's
    names; a function whose opcodes moved is counted, one only one build
    has is listed."""
    from horovod_tpu_torch.ops.sass import diff, renamed
    old = {"_ZN12_GLOBAL__N_125flash_bwd_dq_mma_kernelILi128E6__halfS1_Lb0EEEv"
           "N5flash4ArgsE": ["HMMA", "EXIT"],
           "_ZN12_GLOBAL__N_1gone": ["EXIT"]}
    new = {"_ZN12_GLOBAL__N_125flash_bwd_dq_mma_kernelI6__halfS1_EEv"
           "N5flash4ArgsE": ["HMMA", "EXIT"],
           "_ZN12_GLOBAL__N_1moved": ["NOP"]}
    assert diff(old, new)["differ"] == {}
    res = diff(renamed(old, r"ILi128E(\w+?)Lb0EE=I\1E"), new)
    assert list(res["differ"].values()) == [0]
    assert res["only_in_one"] == ["_ZN12_GLOBAL__N_1gone",
                                  "_ZN12_GLOBAL__N_1moved"]
    moved = dict(new, **{"_ZN12_GLOBAL__N_1gone": ["NOP", "EXIT"]})
    assert diff(old, moved, "gone")["differ"] == {"_ZN12_GLOBAL__N_1gone": 1}
