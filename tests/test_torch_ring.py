"""horovod_tpu_torch's ring attention, its segment kernels' plain versions
(K7) and Ulysses against the JAX package on the CPU.

The same numpy inputs go through both packages: the reference in-process on
the conftest's virtual CPU devices (``shard_map`` over a ``seq`` mesh), the
port on gloo worlds of 2 and 4 processes (``tests/torch_worker.py``), each
world started before the reference compiles so the two overlap.
Tolerances: fp32 ring and Ulysses outputs and gradients agree to JAX's own
ring tests' rtol 2e-4, atol 2e-5 (measured near 1e-6: the same math summed
in another order); the plain segment kernels to 1e-5 of the largest entry
in fp32, to 2e-2 in bf16 and to 2e-3 in fp16, where the port rounds p and
ds to the input dtype before their products as the kernel does and the
reference's chunked version does not (one ulp of a product's terms: 2^-8 in
bf16, 2^-11 in fp16).
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.parallel import ring_attention as JR
from horovod_tpu.parallel.ulysses import ulysses_attention_p as jax_ulysses
from horovod_tpu_torch.ops import kernels as K
from horovod_tpu_torch.parallel import ring_attention as R
from horovod_tpu_torch.parallel.flash_attention import flash_attention_local
from horovod_tpu_torch.parallel.ulysses import ulysses_attention_p
from torch_worker import RING_CASES, RING_DIMS, World, ring_inputs

RTOL, ATOL = 2e-4, 2e-5
SEG = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}
WORLD_SIZES = (2, 4)


def _out_and_grads(fn, q, k, v, do):
    """fn(q, k, v) and its q/k/v gradients for cotangent ``do``, compiled
    (op-by-op shard_map is slow)."""
    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    out, grads = run(q, k, v, do)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), scale)


def _seg_inputs(dtype, seed=0, s=24):
    """q, k, v, do [B, H, S, D] and a global lse/di ([B, H, S]) as the ring
    hands a segment: lse at least the block's own, as (jax, torch) pairs."""
    rng = np.random.RandomState(seed)
    xs = [rng.randn(2, 3, s, 16) for _ in range(4)]
    lse = (np.abs(rng.randn(2, 3, s)) + 6.0).astype(np.float32)
    di = rng.randn(2, 3, s).astype(np.float32)
    pairs = []
    for x in xs:
        a = jnp.asarray(x, getattr(jnp, dtype))
        pairs.append((a, torch.tensor(np.asarray(a, np.float32)).to(
            getattr(torch, dtype))))
    return pairs, (jnp.asarray(lse), torch.tensor(lse)), \
        (jnp.asarray(di), torch.tensor(di))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False], ids=["DIAG", "FULL"])
def test_seg_forward_plain_matches_reference(causal, dtype):
    ((qj, qt), (kj, kt), (vj, vt), _), _, _ = _seg_inputs(dtype)
    o_ref, lse_ref = JR._seg_fwd_jax(qj, kj, vj, causal)
    o, lse = K.flash_seg_fwd_plain(qt, kt, vt, causal, 16 ** -0.5)
    assert o.dtype == lse.dtype == torch.float32
    _close(o.numpy(), np.asarray(o_ref), SEG[dtype])
    _close(lse.numpy(), np.asarray(lse_ref), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False], ids=["DIAG", "FULL"])
def test_seg_backward_plain_matches_reference(causal, dtype):
    ((qj, qt), (kj, kt), (vj, vt), (doj, dot)), (lj, lt), (dj, dt) = \
        _seg_inputs(dtype, seed=1)
    want = JR._seg_bwd_jax(qj, kj, vj, lj, doj, dj, causal)
    got = K.flash_seg_bwd_plain(qt, kt, vt, lt, dot, dt, causal, 16 ** -0.5)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), np.asarray(w), SEG[dtype])
    # the wrappers take these plain versions on the CPU, launching nothing
    before = K.launch_counts()
    dk, dv = K.flash_seg_bwd_dkdv(qt, kt, vt, dot, lt, dt, causal,
                                  16 ** -0.5)
    dq = K.flash_seg_bwd_dq(qt, kt, vt, dot, lt, dt, causal, 16 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), got))
    assert K.launch_counts() == before


def test_merge_with_an_empty_segment_is_the_identity():
    """An EMPTY segment's result is (0, -1e30): merged in, it leaves (o,
    lse) as they were, bit for bit, and two empty results stay empty
    without NaN (logaddexp of two -inf would be NaN)."""
    rng = np.random.RandomState(3)
    o = torch.tensor(rng.randn(2, 3, 5, 4), dtype=torch.float32)
    lse = torch.tensor(rng.randn(2, 3, 5), dtype=torch.float32)
    empty_o = torch.zeros_like(o)
    empty_lse = torch.full_like(lse, R._NEG_INF)
    for args in ((o, lse, empty_o, empty_lse), (empty_o, empty_lse, o, lse)):
        got_o, got_lse = R._merge(*args)
        assert torch.equal(got_o, o) and torch.equal(got_lse, lse)
    both_o, both_lse = R._merge(empty_o, empty_lse, empty_o, empty_lse)
    assert torch.equal(both_o, empty_o)
    assert bool(torch.isfinite(both_lse).all())
    # the reference's merge agrees
    jo, jl = JR._merge(jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()),
                       jnp.asarray(empty_o.numpy()),
                       jnp.asarray(empty_lse.numpy()))
    np.testing.assert_array_equal(np.asarray(jo), o.numpy())
    np.testing.assert_array_equal(np.asarray(jl), lse.numpy())


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_force_ring_single_rank_matches_reference(layout):
    """n = 1 with force_ring: the ring path with an identity hop, output and
    q/k/v gradients against the reference's force_ring on a 1-device mesh
    (the pattern of test_ring_attention.py:196-216)."""
    rng = np.random.RandomState(5)
    q, k, v, do = (rng.randn(2, 16, 2, 8).astype(np.float32) * s
                   for s in (0.3, 0.3, 1.0, 1.0))
    mesh = Mesh(np.array(jax.devices()[:1]), ("seq",))
    fn = jax.shard_map(
        lambda q, k, v: JR.ring_attention_p(q, k, v, "seq", 1, causal=True,
                                            layout=layout, force_ring=True),
        mesh=mesh, in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"))
    want, want_grads = _out_and_grads(fn, q, k, v, do)
    ins = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    R.SEGMENTS.update(forward=0, backward=0)
    out = R.ring_attention_p(*ins, None, 1, causal=True, layout=layout,
                             force_ring=True)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    for x, w in zip(ins, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=RTOL, atol=ATOL)
    per_pass = 3 if layout == "zigzag" else 1   # (lo, hi) is never run
    assert R.SEGMENTS == {"forward": per_pass, "backward": per_pass}


@pytest.mark.parametrize("layout,causal", [("zigzag", True),
                                           ("contiguous", True),
                                           ("contiguous", False)])
def test_force_ring_at_head_dim_256_matches_reference(layout, causal):
    """The ring path (n = 1, force_ring) at head dim 256, which the CUDA
    segment kernels run on the Hopper wide kernels for bf16 and fp16:
    output and q/k/v gradients against the reference's force_ring on a
    1-device mesh."""
    _check_force_ring(256, layout, causal, seed=11)


@pytest.mark.parametrize("layout,causal", [("zigzag", True),
                                           ("contiguous", True),
                                           ("contiguous", False)])
def test_force_ring_at_head_dim_320_matches_reference(layout, causal):
    """As above at head dim 320, where bf16 and fp16 run the Hopper forward
    with O in two accumulators and the deep dk/dv and dq."""
    _check_force_ring(320, layout, causal, seed=12)


def _check_force_ring(d, layout, causal, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(1, 16, 2, d).astype(np.float32) * s
                   for s in (0.1, 0.1, 1.0, 1.0))
    mesh = Mesh(np.array(jax.devices()[:1]), ("seq",))
    fn = jax.shard_map(
        lambda q, k, v: JR.ring_attention_p(q, k, v, "seq", 1, causal=causal,
                                            layout=layout, force_ring=True),
        mesh=mesh, in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"))
    want, want_grads = _out_and_grads(fn, q, k, v, do)
    ins = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    out = R.ring_attention_p(*ins, None, 1, causal=causal, layout=layout,
                             force_ring=True)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    for x, w in zip(ins, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=RTOL, atol=ATOL)


def test_single_rank_routes_to_flash_attention():
    rng = np.random.RandomState(6)
    q, k, v = (torch.tensor(rng.randn(1, 12, 2, 8), dtype=torch.float32)
               for _ in range(3))
    want = flash_attention_local(q, k, v, causal=True)
    R.SEGMENTS.update(forward=0, backward=0)
    assert torch.equal(R.ring_attention_p(q, k, v, None, 1), want)
    assert R.SEGMENTS["forward"] == 0
    assert torch.equal(ulysses_attention_p(q, k, v, None, 1), want)


def _reference(n, att, causal, layout):
    """The reference's output and q/k/v gradients on an n-device mesh."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    if att == "ring":
        def body(q, k, v):
            return JR.ring_attention_p(q, k, v, "seq", n, causal=causal,
                                       layout=layout)
    else:
        def body(q, k, v):
            return jax_ulysses(q, k, v, "seq", n, causal=causal)
    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                       out_specs=P(None, "seq"))
    return _out_and_grads(fn, *ring_inputs(n, causal, layout))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: (the port's per-rank results, {case: the reference's})}: the
    port's worlds start first and run while the reference computes."""
    started = {n: World("ring", n, tmp_path_factory.mktemp(f"ring{n}"))
               for n in WORLD_SIZES}
    refs = {n: {case: _reference(n, *case) for case in RING_CASES}
            for n in WORLD_SIZES}
    return {n: (w.results(), refs[n]) for n, w in started.items()}


@pytest.mark.parametrize("case", RING_CASES,
                         ids=["-".join(map(str, c)) for c in RING_CASES])
@pytest.mark.parametrize("n", WORLD_SIZES)
def test_world_matches_reference(worlds, n, case):
    """Each rank's output block and q/k/v gradient blocks against the
    reference's on an n-device mesh, the inputs in ``layout`` order."""
    ranks, refs = worlds[n]
    out, grads = refs[case]
    t = RING_DIMS[1]
    for rank, res in enumerate(ranks):
        blk = slice(rank * t, (rank + 1) * t)
        got = res[case]
        np.testing.assert_allclose(got["out"], out[:, blk], rtol=RTOL,
                                   atol=ATOL)
        for g, w in zip(got["grads"], grads):
            np.testing.assert_allclose(g, w[:, blk], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_world_runs_only_non_empty_segments(worlds, n):
    """Segments each rank ran per pass: zig-zag 3 on the diagonal step and
    2 on every other (identical on every rank); contiguous r + 1 on rank r
    (the blocks before it and its diagonal; EMPTY steps launch nothing);
    full attention n. Ulysses runs none."""
    for rank, res in enumerate(worlds[n][0]):
        expect = {("ring", True, "zigzag"): 2 * n + 1,
                  ("ring", True, "contiguous"): rank + 1,
                  ("ring", False, "contiguous"): n,
                  ("ring", False, "zigzag"): n,
                  ("ulysses", True, "contiguous"): 0,
                  ("ulysses", False, "contiguous"): 0}
        for case, count in expect.items():
            assert res[case]["segments"] == {"forward": count,
                                             "backward": count}, (rank, case)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_zigzag_schedule_matches_reference(n):
    t = 4 * n
    idx, inv = R.zigzag_indices(t, n)
    jidx, jinv = JR.zigzag_indices(t, n)
    assert idx.dtype == inv.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    for rank in range(n):
        for owner in range(n):
            assert R.zigzag_pair_kinds(rank, owner, n) == \
                JR.zigzag_pair_kinds(rank, owner, n)
    with pytest.raises(ValueError, match="zigzag stripes"):
        R.zigzag_indices(t + 1, n)


def test_error_paths():
    x = torch.zeros(1, 6, 4, 8)
    with pytest.raises(ValueError, match="unknown ring layout"):
        R.ring_attention_p(x, x, x, None, 2, layout="striped")
    odd = torch.zeros(1, 5, 4, 8)
    with pytest.raises(ValueError, match="even local block length"):
        R.ring_attention_p(odd, odd, odd, None, 1, layout="zigzag",
                           force_ring=True)
    with pytest.raises(ValueError, match="divisible by the sequence axis"):
        ulysses_attention_p(torch.zeros(1, 6, 3, 8), torch.zeros(1, 6, 3, 8),
                            torch.zeros(1, 6, 3, 8), None, 2)
    with pytest.raises(ValueError, match="process group"):
        R.ring_attention_p(x, x, x, None, 2)


def test_ring_scale_is_the_reference_scale():
    """The segments run at 1/sqrt(D), the scale of _seg_fwd_jax."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.tensor(rng.randn(1, 4, 2, 32), dtype=torch.float32)
               for _ in range(3))
    o, lse = K.flash_seg_fwd_plain(*(x.transpose(1, 2) for x in (q, k, v)),
                                   False, 1 / math.sqrt(32))
    got = R.ring_attention_p(q, k, v, None, 1, causal=False,
                             force_ring=True)
    torch.testing.assert_close(got, o.transpose(1, 2), rtol=0, atol=0)
