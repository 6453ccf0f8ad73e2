"""horovod_tpu_torch's wire codecs (``ops/compression.py``, the flat codec
reduction of ``ops/collectives.py``, the engine's codec arms and residual
table, replay's codec rows, the optimizers' ``compression=``) on gloo/CPU,
against the JAX package (``tests/test_compression.py``'s classes, with the
same kinds of numpy-seeded inputs).

Tolerances. The codec primitives are the reference's arithmetic as XLA
compiles it into the reference's programs (``jax.jit``): payloads, scales
and float32 residuals bitwise; a 16-bit residual within one unit of its
dtype. A reduced result is a float32 sum of the n ranks' decoded
contributions in another order than XLA's: within 2 float32
units of the sum of their magnitudes (``_sum_bound``). The optimizers'
parameters after a step are held to ``p - lr * g`` with ``g`` from the
reference's primitives on the same gradients (rtol 1e-6, atol 1e-6: the
sum above, times lr, then one subtraction).

Worlds of 2 and 4 ranks (``torch_worker.py``'s ``codec`` scenario) run
each compressed reduction on buckets of 7 and 1001 elements, which divide
neither 2 nor 4; the reference runs ``ef_allreduce_p`` and
``_rs_flat_codec`` under ``shard_map`` on as many of the conftest's CPU
devices.
"""

import collections

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P
import torch

from horovod_tpu.common.reduce_ops import ReduceOp as RefOp
from horovod_tpu.ops import collectives as RC
from horovod_tpu.ops import compression as rcomp
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.core.engine import _op_field, _split_op_field, \
    bucket_by_size
from horovod_tpu_torch.core.state import engine as port_engine
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import compression as comp
from horovod_tpu_torch.optimizer import (AXIS_SHARDED_COMPRESSION_ERROR,
                                         DELTA_ADASUM_CODEC_ERROR,
                                         SHARDED_CAST_ERROR,
                                         WIRE_CODEC_OP_ERROR,
                                         allreduce_gradients)
from torch_worker import (CODEC_CLOSE_DIM, CODEC_CARD_RUNS, CODEC_NAMES,
                          CODEC_OPS, CODEC_OPT_STEPS, CODEC_SGD_LR, CODEC_STEPS,
                          CODEC_TOTALS, SHARDED_THRESHOLD, World,
                          codec_input, run_world)

SIZES = (2, 4)
EPS32 = 2.0 ** -23
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("codec")
    started = {n: World("codec", n, out) for n in SIZES}
    return {n: w.results() for n, w in started.items()}


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    return _bits(t.contiguous().view(torch.uint8).numpy().view(
        {1: np.uint8, 2: np.uint16, 4: np.uint32}[t.element_size()]))


def _payload_dtype(codec):
    return {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
            "bf16": torch.bfloat16}[codec]


def _decoded(payload_bytes: np.ndarray, scale, codec) -> np.ndarray:
    """One contribution decoded in float32 from its wire bytes."""
    t = torch.from_numpy(payload_bytes.copy()).view(_payload_dtype(codec))
    out = t.float().numpy()
    return out if scale is None else out * np.float32(scale[0])


def _sum_bound(terms) -> np.ndarray:
    """2 float32 units of the sum of the terms' magnitudes, elementwise."""
    return 2 * EPS32 * np.sum(np.abs(np.stack(terms)), axis=0)


# the reference's primitives as XLA compiles them into its collective
# programs (the port follows that arithmetic: ops/compression.py)
_ref_ef = jax.jit(rcomp.ef_encode, static_argnums=2)
_ref_encode = jax.jit(rcomp.encode, static_argnums=1)


def _mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), ("world",))


# ---------------------------------------------------------------------------
# codec primitives
# ---------------------------------------------------------------------------


def _pair(dtype: str, seed: int, scale: float = 3.0):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    x = (np.random.RandomState(seed).randn(4099) * scale).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    return torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt), xj


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_ef_encode_is_the_references(codec, dtype):
    """Payload and scale bitwise, the new residual bitwise in float32 and
    within one unit of a 16-bit dtype; the in-place form bitwise the
    functional one."""
    x, xj = _pair(dtype, 0)
    r, rj = _pair(dtype, 1, 0.01)
    for res, resj in ((r, rj), (None, None)):
        p, s, nr = comp.ef_encode(x, res, codec)
        pj, sj, nrj = _ref_ef(xj, resj, codec)
        got, want = _tbits(p), _bits(np.asarray(pj))
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (
            f"{codec} {dtype}: payload differs at {bad[:8].tolist()}: "
            f"{got[bad[:8]].tolist()} against {want[bad[:8]].tolist()} "
            f"(inputs {x[bad[:8]].float().tolist()})")
        if codec == "bf16":
            assert s is None and sj is None and nr is None
            continue
        assert _bits(s.numpy()).tolist() == _bits(np.asarray(sj)).tolist()
        if res is None and codec in comp.EF_CODECS:
            assert nrj is not None and nr is not None
        if dtype == "float32":
            np.testing.assert_array_equal(_tbits(nr), _bits(np.asarray(nrj)))
        else:
            unit = torch.finfo(x.dtype).eps
            diff = np.abs(nr.float().numpy()
                          - np.asarray(nrj.astype(jnp.float32)))
            assert (diff <= unit * np.abs(np.asarray(
                nrj.astype(jnp.float32))) + 1e-30).all()
        x2, r2 = x.clone(), None if res is None else res.clone()
        p2, s2 = comp.ef_encode_(x2, r2, codec)
        assert np.array_equal(_tbits(p2), _tbits(p))
        assert torch.equal(s2, s)
        if r2 is not None:
            assert torch.equal(r2, nr)


def test_int8_round_trip_error_bound():
    x = torch.from_numpy(np.random.RandomState(0).randn(512).astype(
        np.float32))
    payload, scale = comp.encode(x, "int8")
    assert payload.dtype == torch.int8 and scale.shape == (1,)
    back = comp.decode(payload, scale, "int8", torch.float32)
    amax = float(x.abs().max())
    assert float((back - x).abs().max()) <= amax / 127 / 2 + 1e-6


def test_fp8_round_trip_error_bound():
    x = torch.from_numpy(np.random.RandomState(1).randn(512).astype(
        np.float32))
    payload, scale = comp.encode(x, "fp8")
    assert payload.dtype == torch.float8_e4m3fn
    back = comp.decode(payload, scale, "fp8", torch.float32)
    assert float((back - x).abs().max()) <= float(x.abs().max()) * 0.07 \
        + 1e-6


def test_bf16_round_trip():
    x = torch.from_numpy(np.random.RandomState(2).randn(512).astype(
        np.float32))
    payload, scale = comp.encode(x, "bf16")
    assert payload.dtype == torch.bfloat16 and scale is None
    back = comp.decode(payload, None, "bf16", torch.float32)
    assert float((back - x).abs().max()) <= float(x.abs().max()) * 2 ** -8


def test_zero_buffer_scale_and_payload():
    """An all-zero bucket (a joined rank's substitute): the scale's floor,
    a zero payload and residual, as the reference."""
    z = torch.zeros(9)
    for codec in comp.EF_CODECS:
        p, s, r = comp.ef_encode(z, torch.zeros(9), codec)
        pj, sj, _ = _ref_ef(jnp.zeros(9), jnp.zeros(9), codec)
        assert _bits(s.numpy()).tolist() == _bits(np.asarray(sj)).tolist()
        assert not p.view(torch.uint8).any() and not r.any()


@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_decode_sum_is_the_references(codec):
    """k stacked contributions decoded with their senders' scales and
    summed in float32, into ``out`` too."""
    k = 4
    xs = [_pair("float32", 10 + i)[0] for i in range(k)]
    enc = [comp.encode(x, codec) for x in xs]
    pay = torch.stack([p for p, _ in enc])
    sc = None if codec == "bf16" else torch.cat([s for _, s in enc])
    got = comp.decode_sum(pay, sc, codec, torch.float32)
    encj = [_ref_encode(jnp.asarray(x.numpy()), codec) for x in xs]
    want = np.asarray(rcomp.decode_sum(
        jnp.stack([p for p, _ in encj]),
        None if codec == "bf16" else jnp.concatenate([s for _, s in encj]),
        codec, jnp.float32))
    terms = [_decoded(p.view(torch.uint8).numpy(),
                      None if s is None else s.numpy(), codec)
             for p, s in enc]
    assert (np.abs(got.numpy() - want) <= _sum_bound(terms)).all()
    out = torch.empty(xs[0].numel())
    assert comp.decode_sum(pay, sc, codec, torch.float32, out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("codec", ("none",) + CODEC_NAMES + ("bogus",))
def test_resolve_codec_and_wire_itemsize_are_the_references(codec):
    for name, (tdt, jdt) in list(DTYPES.items()) + [
            ("int32", (torch.int32, jnp.int32)),
            ("int64", (torch.int64, jnp.int64)),
            ("bool", (torch.bool, jnp.bool_))]:
        assert comp.resolve_codec(codec, tdt) == \
            rcomp.resolve_codec(codec, jdt), (codec, name)
    for itemsize in (1, 2, 4, 8):
        assert comp.wire_itemsize(codec, itemsize) == \
            rcomp.wire_itemsize(codec, itemsize)


def test_fp8_demotes_to_int8_without_float8(monkeypatch):
    monkeypatch.setattr(comp, "_FP8_DTYPE", None)
    monkeypatch.setattr(comp, "_warned_codec", set())
    assert comp.resolve_codec("fp8", torch.float32) == "int8"
    assert comp._warned_codec == {("fp8",)}


@pytest.mark.parametrize("codec", CODEC_NAMES)
@pytest.mark.parametrize("total", (0, 1, 7, 1000, 1001))
@pytest.mark.parametrize("n", (1, 2, 4, 8))
def test_codec_residual_elems_is_the_references_flat_rule(n, total, codec):
    for cls, algo in (("reduce", "flat"), ("sharded", None)):
        assert C.codec_residual_elems(cls, total, n, 4, algo, codec) == \
            RC.codec_residual_elems(cls, total, n, 4, algo, codec)


def test_codec_residual_elems_refuses_an_unknown_class():
    with pytest.raises(ValueError, match="residual class"):
        C.codec_residual_elems("hierarchical", 10, 2, 1, "flat", "int8")


# ---------------------------------------------------------------------------
# compressor surface
# ---------------------------------------------------------------------------


def test_wire_codec_compressors_exported():
    assert hvd.Compression.fp8.wire_codec == "fp8"
    assert hvd.Compression.int8.wire_codec == "int8"
    for name in ("none", "fp16", "bf16"):
        assert getattr(hvd.Compression, name).wire_codec is None
    x = torch.ones(4)
    c, ctx = hvd.Compression.int8.compress(x)
    assert c is x and ctx is None
    assert hvd.Compression.int8.decompress(c, ctx) is x


@pytest.mark.parametrize("name", ["fp16", "bf16"])
def test_cast_compressor_nonfloat_ctx_is_none(name):
    cls = getattr(hvd.Compression, name)
    x = torch.arange(8, dtype=torch.int32)
    c, ctx = cls.compress(x)
    assert ctx is None and c.dtype == torch.int32
    assert cls.decompress(c, ctx) is c


@pytest.mark.parametrize("name,wire", [("fp16", torch.float16),
                                       ("bf16", torch.bfloat16)])
def test_cast_compressor_float_round_trip(name, wire):
    cls = getattr(hvd.Compression, name)
    x = torch.tensor([1.5, -2.25])
    c, ctx = cls.compress(x)
    assert c.dtype == wire and ctx == torch.float32
    assert cls.decompress(c, ctx).dtype == torch.float32


def test_knob_parses(monkeypatch):
    monkeypatch.setenv(env_mod.HOROVOD_TPU_COMPRESSION, "INT8")
    assert env_mod.Config.from_env().compression == "int8"
    monkeypatch.setenv(env_mod.HOROVOD_TPU_COMPRESSION, "bogus")
    assert env_mod.Config.from_env().compression == "none"
    monkeypatch.delenv(env_mod.HOROVOD_TPU_COMPRESSION)
    cfg = env_mod.Config.from_env()
    assert cfg.compression == "none"
    assert cfg.cache_capacity == env_mod.DEFAULT_CACHE_CAPACITY == 1024
    monkeypatch.setenv(env_mod.HOROVOD_CACHE_CAPACITY, "7")
    assert env_mod.Config.from_env().cache_capacity == 7


def test_join_op_field_carries_the_codec():
    for op in (hvd.Sum, hvd.Average, hvd.Min, hvd.Product):
        for codec in comp.CODECS:
            assert _split_op_field(_op_field(op, codec)) == (op, codec)
    # the reference's packing
    assert _op_field(hvd.Sum, "int8") == int(RefOp.SUM) | (3 << 4)


# ---------------------------------------------------------------------------
# the flat codec reduction at 2 and 4 ranks against the reference
# ---------------------------------------------------------------------------


def _ref_flat(n, codec, op, total):
    """The reference's ``ef_allreduce_p`` over CODEC_STEPS steps of the
    world's inputs, each rank's residual fed back: per step the result
    and every rank's new residual (None for bf16)."""
    ef = codec in rcomp.EF_CODECS
    rop = RefOp[op]

    def body(x, r):
        out, nr = RC.ef_allreduce_p(x[0], r[0] if ef else None, "world",
                                    codec, rop)
        return out, (nr if ef else jnp.zeros_like(x[0]))[None]

    fn = jax.jit(shard_map(body, mesh=_mesh(n),
                           in_specs=(P("world"), P("world")),
                           out_specs=(P(), P("world")), check_vma=False))
    res = jnp.zeros((n, total), jnp.float32)
    steps = []
    for step in range(CODEC_STEPS):
        x = np.stack([codec_input(r, step, total) for r in range(n)])
        out, res = fn(jnp.asarray(x), res)
        steps.append((np.asarray(out), np.asarray(res) if ef else None))
    return steps


@pytest.mark.parametrize("total", CODEC_TOTALS)
@pytest.mark.parametrize("op", CODEC_OPS)
@pytest.mark.parametrize("codec", CODEC_NAMES)
@pytest.mark.parametrize("n", SIZES)
def test_flat_codec_reduction_matches_the_reference(worlds, n, codec, op,
                                                    total):
    """Every step of ``codec_allreduce``: each rank's payload and scale
    bitwise the reference's encode of its padded bucket plus its residual,
    the new residuals bitwise (their padding zero), and the result, the
    same on every rank, within 2 float32 units of the sum of the decoded
    contributions' magnitudes of ``ef_allreduce_p``'s."""
    want = _ref_flat(n, codec, op, total)
    padded = C.shard_spec(total, n)[0]
    avg = n if op == "AVERAGE" else 1
    res = [np.zeros(padded, np.float32) for _ in range(n)]
    for step, (w_out, w_res) in enumerate(want):
        terms = []
        for rank, r in enumerate(worlds[n]):
            got = r["flat"][(codec, op, total)][step]
            y = np.zeros(padded, np.float32)
            y[:total] = codec_input(rank, step, total)
            pj, sj, nrj = _ref_ef(
                jnp.asarray(y), jnp.asarray(res[rank]) if w_res is not None
                else None, codec)
            np.testing.assert_array_equal(got["payload"],
                                          _bits(np.asarray(pj)).view(
                                              np.uint8))
            if sj is None:
                assert got["scale"] is None
            else:
                np.testing.assert_array_equal(_bits(got["scale"]),
                                              _bits(np.asarray(sj)))
            if w_res is not None:
                res[rank] = np.asarray(nrj)
                np.testing.assert_array_equal(_bits(got["residual"]),
                                              _bits(res[rank]))
                np.testing.assert_array_equal(got["residual"][:total],
                                              w_res[rank])
                assert not got["residual"][total:].any()
            terms.append(_decoded(got["payload"], got["scale"], codec)[
                :total] / avg)
            np.testing.assert_array_equal(
                got["out"], worlds[n][0]["flat"][(codec, op, total)][step][
                    "out"])
        diff = np.abs(got["out"] - w_out)
        assert (diff <= _sum_bound(terms)).all(), (step, diff.max())


@pytest.mark.parametrize("total", CODEC_TOTALS)
@pytest.mark.parametrize("op", CODEC_OPS)
@pytest.mark.parametrize("codec", CODEC_NAMES)
@pytest.mark.parametrize("n", SIZES)
def test_sharded_rs_leg_matches_the_reference(worlds, n, codec, op, total):
    """ZeRO-1's compressed reduce-scatter (``scatter_shards`` with a
    codec): rank r's shard is chunk r of the decoded sum, within 2 float32
    units of the reference ``_rs_flat_codec``'s; its new residual over
    the whole padded bucket bitwise."""
    ef = codec in rcomp.EF_CODECS
    rop = RefOp[op]
    padded, shard = C.shard_spec(total, n)

    def body(x, r):
        s, nr = RC._rs_flat_codec(x[0], r[0] if ef else None, "world", n,
                                  rop, codec)
        return s[None], (nr if ef else jnp.zeros_like(r[0]))[None]

    fn = jax.jit(shard_map(body, mesh=_mesh(n),
                           in_specs=(P("world"), P("world")),
                           out_specs=(P("world"), P("world")),
                           check_vma=False))
    x = np.stack([codec_input(r, 0, total) for r in range(n)])
    w_shard, w_res = (np.asarray(a) for a in fn(
        jnp.asarray(x), jnp.zeros((n, padded), jnp.float32)))
    terms = []
    for rank in range(n):
        y = np.zeros(padded, np.float32)
        y[:total] = x[rank]
        p, s, _ = _ref_ef(jnp.asarray(y), None, codec)
        terms.append(_decoded(_bits(np.asarray(p)).view(np.uint8),
                              None if s is None else np.asarray(s),
                              codec).reshape(n, shard)
                     / (n if op == "AVERAGE" else 1))
    for rank, r in enumerate(worlds[n]):
        got = r["rs"][(codec, op, total)]
        diff = np.abs(got["shard"] - w_shard[rank])
        assert (diff <= _sum_bound([t[rank] for t in terms])).all()
        if ef:
            np.testing.assert_array_equal(_bits(got["residual"]),
                                          _bits(w_res[rank]))
        else:
            assert got["residual"] is None


# ---------------------------------------------------------------------------
# the engine in the worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_engine_codec_rules(worlds, n):
    """Only Sum and Average take a codec; a non-float bucket is never
    quantized (exact integer sums) while the float bucket beside it is;
    HOROVOD_TPU_COMPRESSION is read per call, its residual keyed by the
    digit-normalised name."""
    for rank, r in enumerate(worlds[n]):
        assert r["call_codec"] == {"AVERAGE": "int8", "SUM": "int8",
                                   "MIN": "none", "MAX": "none",
                                   "PRODUCT": "none"}
        np.testing.assert_array_equal(
            r["mixed"][0], np.arange(6) * sum(range(1, n + 1)))
        assert r["mixed_selections"] == {
            ("grouped_allreduce", "none"): 1,
            ("grouped_allreduce", "int8"): 1}
        padded = C.shard_spec(1001, n)[0]
        key = ("gar", "codec.knob.#", 0, "int8", padded, "torch.float32")
        assert key in r["knob_residuals"]
        np.testing.assert_array_equal(r["knob"], worlds[n][0]["knob"])
    # the knob's result against the reference's primitives
    terms, ys = [], []
    for rank in range(n):
        y = np.zeros(C.shard_spec(1001, n)[0], np.float32)
        y[:1001] = codec_input(rank, 1, 1001)
        p, s, nr = _ref_ef(jnp.asarray(y), None, "int8")
        terms.append(np.asarray(p).astype(np.float32)[:1001]
                     * np.asarray(s)[0])
        np.testing.assert_array_equal(
            worlds[n][rank]["knob_residuals"][key], np.asarray(nr))
    got = worlds[n][0]["knob"]
    assert (np.abs(got - np.sum(terms, axis=0)) <= _sum_bound(terms)).all()
    # and it is a compressed sum: not the plain one
    assert not np.array_equal(got, worlds[n][0]["plain"])


@pytest.mark.parametrize("n", SIZES)
def test_joined_rank_substitute_runs_the_compressed_program(worlds, n):
    """Rank 0 joins while the others run a compressed grouped Sum: its
    substitute reads the codec from the op field and runs the same
    program (its codec selections count int8), so the sums are the
    others' decoded contributions and its zeros, and join returns the
    last rank to join."""
    res = worlds[n]
    assert res[0]["join"]["values"] is None
    assert res[0]["join"]["selections"] == {("grouped_allreduce", "int8"): 2}
    for total, t in ((1001, 0), (7, 1)):
        terms = []
        for rank in range(1, n):
            y = np.zeros(C.shard_spec(total, n)[0], np.float32)
            y[:total] = codec_input(rank, 2 + t, total)
            p, s = _ref_encode(jnp.asarray(y), "int8")
            terms.append(np.asarray(p).astype(np.float32)[:total]
                         * np.asarray(s)[0])
        for r in res[1:]:
            got = r["join"]["values"][t]
            assert (np.abs(got - np.sum(terms, axis=0))
                    <= _sum_bound(terms)).all()
    assert all(r["join"]["last"] == res[0]["join"]["last"] for r in res)


def _ref_bucket_step(grads_by_rank, shapes, n, residuals, key):
    """One compressed Average of every bucket of the MLP's gradients with
    the reference's primitives: per rank ``ef_encode`` of its padded
    bucket and residual, ``decode_sum`` over the ranks, the divide.
    ``residuals[key(b)][rank]`` is carried. Returns the gradients."""
    buckets = bucket_by_size([torch.empty(s) for s in shapes],
                             SHARDED_THRESHOLD)
    out = [None] * len(shapes)
    for b, idxs in enumerate(buckets):
        total = sum(int(np.prod(shapes[i])) for i in idxs)
        padded = C.shard_spec(total, n)[0]
        pays, scales = [], []
        for rank in range(n):
            y = np.zeros(padded, np.float32)
            y[:total] = np.concatenate([grads_by_rank[rank][i].reshape(-1)
                                        for i in idxs])
            r = residuals.setdefault(key(b), [np.zeros(padded, np.float32)
                                              for _ in range(n)])
            p, s, nr = _ref_ef(jnp.asarray(y), jnp.asarray(r[rank]),
                                       "int8")
            r[rank] = np.asarray(nr)
            pays.append(p)
            scales.append(s)
        g = np.asarray(rcomp.decode_sum(jnp.stack(pays),
                                        jnp.concatenate(scales), "int8",
                                        jnp.float32)) / np.float32(n)
        off = 0
        for i in idxs:
            size = int(np.prod(shapes[i]))
            out[i] = g[off:off + size].reshape(shapes[i])
            off += size
    return out


def _check_sgd_run(res, run, n, key_of):
    """The run's parameters after each step are p - lr * g with ``g`` the
    reference's compressed Average of the ranks' gradients, and its
    residuals bitwise the reference's."""
    shapes = [g.shape for g in res[0]["runs"][run]["grads"][0]]
    residuals = {}
    prev = res[0]["runs"][run]["init"]
    for step in range(CODEC_OPT_STEPS):
        grads = [r["runs"][run]["grads"][step] for r in res]
        g = _ref_bucket_step(grads, shapes, n, residuals, lambda b: b)
        for r in res:
            for p0, p1, gi in zip(prev, r["runs"][run]["traj"][step], g):
                np.testing.assert_allclose(p1, p0 - CODEC_SGD_LR * gi,
                                           **OPT_TOL)
        for rank, r in enumerate(res):
            got = r["runs"][run]["residuals"][step]
            for b, buf in residuals.items():
                np.testing.assert_array_equal(got[key_of(got, b)],
                                              buf[rank])
        prev = res[0]["runs"][run]["traj"][step]


def _dense_key(got, b):
    return next(k for k in got if k[:3] == ("gar", "grad.s#", b))


def _sharded_key(got, b):
    return sorted(got, key=lambda k: k[2])[b]


@pytest.mark.parametrize("n", SIZES)
def test_dense_int8_optimizer_matches_the_reference_primitives(worlds, n):
    """DistributedOptimizer(SGD, compression=Compression.int8): every step
    (the warm-up, then replayed) against the reference's primitives on the
    same gradients, residuals bitwise, every rank alike."""
    _check_sgd_run(worlds[n], "dense_on", n, _dense_key)
    for r in worlds[n]:
        for a, b in zip(r["runs"]["dense_on"]["traj"][-1],
                        worlds[n][0]["runs"]["dense_on"]["traj"][-1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", SIZES)
def test_replay_lineage_is_bitwise_across_the_eager_replay_edge(worlds, n):
    """Replay arms on the compressed step (the warm-up, then replayed
    steps reading the engine's residual buffers) and every step's
    parameters and residuals are bitwise those of the run with replay
    off; an armed program holds its residuals: a store past the capacity
    evicts none of them and an invalidation zeroes them in place."""
    for r in worlds[n]:
        on, off = r["runs"]["dense_on"], r["runs"]["dense_off"]
        assert on["replay"] == (1, CODEC_OPT_STEPS - 3, 0)
        assert off["replay"] == (0, 0, 0)
        for a, b in zip(on["traj"], off["traj"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        for a, b in zip(on["residuals"], off["residuals"]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        held = r["held"]
        assert held["held"] and all(k[:2] == ("gar", "grad.s#")
                                    for k in held["held"])
        assert held["nonzero"] and held["kept"]
        assert held["entries_after_store"] == len(held["held"]) + 1
        assert held["zeroed_in_place"] and held["extra_dropped"]


@pytest.mark.parametrize("n", SIZES)
def test_sharded_int8_matches_the_reference_primitives(worlds, n):
    """DistributedOptimizer(sharded=True, compression=int8): its
    compressed reduce-scatter, the update on the shards and the
    all-gather give the reference's math (the residual over each whole
    padded bucket, bitwise), bitwise the dense compressed run (the same
    buckets), replayed after the warm-up."""
    _check_sgd_run(worlds[n], "sharded", n, _sharded_key)
    for r in worlds[n]:
        assert r["runs"]["sharded"]["replay"] == (1, CODEC_OPT_STEPS - 3, 0)
        for a, b in zip(r["runs"]["sharded"]["traj"],
                        r["runs"]["dense_on"]["traj"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", SIZES)
def test_distributed_int8_carries_the_residual_in_its_state(worlds, n):
    """hvd.distributed(SGD, compression=int8): each gradient's compressed
    Average with its residual in ``opt.residuals`` (padded, the
    reference's per-leaf ``ef_allreduce_p``), bitwise the reference's
    residuals every step."""
    res = worlds[n]
    run = res[0]["runs"]["axis"]
    shapes = [g.shape for g in run["grads"][0]]
    resid = {}
    prev = run["init"]
    for step in range(CODEC_OPT_STEPS):
        for i, shape in enumerate(shapes):
            grads = [[r["runs"]["axis"]["grads"][step][i].reshape(-1)]
                     for r in res]
            g = _ref_bucket_step(grads, [(int(np.prod(shape)),)], n, resid,
                                 lambda b, i=i: i)[0]
            for r in res:
                np.testing.assert_allclose(
                    r["runs"]["axis"]["traj"][step][i],
                    prev[i] - CODEC_SGD_LR * g.reshape(shape), **OPT_TOL)
            for rank, r in enumerate(res):
                np.testing.assert_array_equal(
                    r["runs"]["axis"]["residuals"][step][i],
                    resid[i][rank])
        prev = run["traj"][step]


@pytest.mark.parametrize("n", SIZES)
def test_int8_trains_close_to_none(worlds, n):
    """The reference's criterion (``tests/test_compression.py``,
    ``test_int8_trains_close_to_none``): 12 SGD steps at lr 0.05 on its
    16-float problem, through DistributedOptimizer and hvd.distributed,
    within 5e-2 of the uncompressed run, with a nonzero residual."""
    for r in worlds[n]:
        c = r["close"]
        for wrap in ("dense", "axis"):
            err = float(np.abs(c[f"{wrap}_int8"]["w"]
                               - c[f"{wrap}_none"]["w"]).max())
            assert err < 5e-2, (wrap, err)
            assert c[f"{wrap}_int8"]["residual_max"] > 0
            assert c[f"{wrap}_none"]["residual_max"] == 0
            assert c[f"{wrap}_int8"]["w"].shape == (CODEC_CLOSE_DIM,)


# ---------------------------------------------------------------------------
# one process: the residual table, the size-1 rule, replay's knob, refusals
# ---------------------------------------------------------------------------


@pytest.fixture
def world1(monkeypatch):
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_PALLAS_PACK",
                "HOROVOD_TPU_STEP_REPLAY", "HOROVOD_TPU_COMPRESSION",
                "HOROVOD_TPU_WORLD_VERSION", "HOROVOD_CACHE_CAPACITY"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        yield port_engine()
    finally:
        hvd.shutdown()


def test_residual_fetch_store_invalidate(world1):
    eng = world1
    key = ("gar", "t.#", 0, "int8", 64, "torch.float32")
    buf = eng._residual_fetch(key, 64, torch.float32)
    assert buf.shape == (64,) and not buf.any()
    assert eng._residual_fetch(key, 64, torch.float32) is buf
    buf.fill_(1.0)                        # the codec writes it in place
    assert float(eng._residual_fetch(key, 64, torch.float32).min()) == 1.0
    # a shape or dtype drift starts a fresh lineage
    assert not eng._residual_fetch(key, 32, torch.float32).any()
    assert not eng._residual_fetch(key, 32, torch.bfloat16).any()
    before = eng.residual_invalidations
    events = []
    eng.on_replay = lambda e, d: events.append((e, d))
    eng.invalidate_residuals("test")
    assert not eng._residuals
    assert eng.residual_invalidations == before + 1
    assert events == [("residual-invalidate", "test")]
    assert not eng._residual_fetch(key, 64, torch.float32).any()


def test_residual_table_is_bounded(world1):
    eng = world1
    eng.config.cache_capacity = 3
    keys = [("gar", f"k{i}", 0, "int8", 8, "torch.float32") for i in "abcd"]
    for k in keys:
        eng._residual_fetch(k, 8, torch.float32)
    assert list(eng._residuals) == keys[1:]


def test_world_version_bump_sweeps_residuals(world1, monkeypatch):
    eng = world1
    key = ("gar", "wv.#", 0, "int8", 8, "torch.float32")
    eng._residual_fetch(key, 8, torch.float32).fill_(1.0)
    monkeypatch.setenv("HOROVOD_TPU_WORLD_VERSION",
                       str(eng.world_version + 1))
    eng._residual_gc()
    assert key not in eng._residuals
    assert not eng._residual_fetch(key, 8, torch.float32).any()


def test_join_and_a_world_version_bump_drop_residuals(world1):
    """``join()`` and a world-version bump seen at ``step_begin`` drop
    every residual with the armed streams (the reference's :1146-1165)."""
    eng = world1
    key = ("gar", "j.#", 0, "int8", 8, "torch.float32")
    eng._residual_fetch(key, 8, torch.float32)
    assert hvd.join() == 0
    assert key not in eng._residuals
    eng._residual_fetch(key, 8, torch.float32)
    eng.step_begin()
    eng.step_end()
    assert key in eng._residuals
    eng.world_version += 1
    eng.step_begin()
    eng.step_end()
    assert key not in eng._residuals


def test_size1_world_resolves_codec_none(world1):
    """One rank moves no wire: every codec is off, whatever the knob or
    the call says, and a compressed call returns its input."""
    eng = world1
    assert eng._call_codec("int8") == "none"
    eng.config.compression = "int8"
    assert eng._call_codec(None) == "none"
    x = torch.from_numpy(codec_input(0, 0, 1001))
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
    outs = [h.synchronize() for h in eng.grouped_allreduce(
        [x, x[:7]], op=hvd.Sum, codec="int8")]
    assert torch.equal(outs[0], x) and torch.equal(outs[1], x[:7])
    assert not eng._residuals and not eng.codec_selections


def test_bucket_codecs_never_quantize_non_float(world1):
    eng = world1
    got = eng._bucket_codecs("grouped_allreduce",
                             [torch.float32, torch.int32, torch.bfloat16,
                              torch.int64], "int8")
    assert got == ("int8", "none", "int8", "none")
    assert eng._bucket_codecs("grouped_allreduce", [torch.float16],
                              "bf16") == ("none",)
    assert eng.codec_selections == collections.Counter(
        {("grouped_allreduce", "int8"): 2,
         ("grouped_allreduce", "none"): 3})


def test_residual_key_normalises_the_name(world1):
    eng = world1
    a = eng._residual_key("gar", "grad.s17.3", 2, "int8", 64,
                          "torch.float32")
    assert a == ("gar", "grad.s#.#", 2, "int8", 64, "torch.float32")
    assert a == eng._residual_key("gar", "grad.s0.9", 2, "int8", 64,
                                  "torch.float32")


def test_replay_rearms_on_codec_knob_move(world1):
    """A live move of HOROVOD_TPU_COMPRESSION rebuilds the armed program
    before its next launch, as a move of the fusion threshold does."""
    eng = world1
    eng.config.step_replay_warmup = 2
    tensors = [torch.ones(8) for _ in range(2)]

    def step(i):
        eng.step_begin()
        hvd.grouped_allreduce(list(tensors), name=f"cc.{i}", op=hvd.Sum)
        eng.step_end()

    for i in range(3):
        step(i)
    assert eng.replay.replayed_steps >= 1

    def armed():
        return [e["armed"] for e in eng.replay._seen.values()
                if e.get("armed")]

    first = armed()
    assert first and first[0].compression == "none"
    eng.config.compression = "int8"
    step(9)
    rearmed = armed()
    assert rearmed and rearmed[0].compression == "int8"
    assert rearmed[0].program is not first[0].program
    assert eng.replay.fallbacks == 0


def test_refusals_carry_the_references_text():
    p = [torch.nn.Parameter(torch.zeros(3))]

    def sgd():
        return torch.optim.SGD(p, lr=0.1)

    for wire in (hvd.Compression.int8, hvd.Compression.fp8):
        with pytest.raises(ValueError) as e:
            hvd.DistributedOptimizer(sgd(), op=hvd.Adasum, compression=wire)
        assert str(e.value) == WIRE_CODEC_OP_ERROR
        with pytest.raises(ValueError) as e:
            hvd.distributed(sgd(), op=hvd.Adasum, compression=wire)
        assert str(e.value) == WIRE_CODEC_OP_ERROR
        with pytest.raises(ValueError) as e:
            hvd.DistributedDeltaAdasumOptimizer(sgd(), compression=wire)
        assert str(e.value) == DELTA_ADASUM_CODEC_ERROR
        with pytest.raises(ValueError) as e:
            hvd.distributed(sgd(), shard_optimizer=True, compression=wire)
        assert str(e.value) == AXIS_SHARDED_COMPRESSION_ERROR
        # sharded accepts the wire codecs
        hvd.DistributedOptimizer(sgd(), sharded=True, compression=wire)
    for cast in (hvd.Compression.fp16, hvd.Compression.bf16):
        with pytest.raises(ValueError) as e:
            hvd.DistributedOptimizer(sgd(), sharded=True, compression=cast)
        assert str(e.value) == SHARDED_CAST_ERROR
        hvd.DistributedDeltaAdasumOptimizer(sgd(), compression=cast)
    with pytest.raises(ValueError, match="Average|Sum"):
        hvd.DistributedOptimizer(sgd(), op=hvd.Min,
                                 compression=hvd.Compression.int8)
    # the reference's texts, as the reference states them
    assert "supports op=Average|Sum only" in WIRE_CODEC_OP_ERROR
    assert "cast compressors would change" in SHARDED_CAST_ERROR
    assert DELTA_ADASUM_CODEC_ERROR.startswith(
        "delta-Adasum has no wire-codec path")


def test_sharded_knob_takes_a_wire_codec_and_not_a_cast(world1):
    p = [torch.nn.Parameter(torch.zeros(3))]
    world1.config.shard_optimizer = True
    assert hvd.DistributedOptimizer(
        torch.optim.SGD(p, lr=0.1),
        compression=hvd.Compression.int8)._is_sharded()
    assert not hvd.DistributedOptimizer(
        torch.optim.SGD(p, lr=0.1),
        compression=hvd.Compression.bf16)._is_sharded()


def test_allreduce_gradients_one_shot_codec(world1):
    """At size 1 over the world the codec still runs (the reference's
    ``ef_allreduce_p`` has no size-1 rule): each float gradient comes back
    as its quantized self, an integer one untouched, and no residual is
    kept anywhere."""
    g = torch.from_numpy(codec_input(0, 4, 1001)).reshape(7, 143)
    ints = torch.arange(5)
    out = allreduce_gradients([g, ints], compression=hvd.Compression.int8)
    p, s = comp.encode(g.reshape(-1), "int8")
    assert torch.equal(out[0], comp.decode(p, s, "int8",
                                           torch.float32).reshape(7, 143))
    assert torch.equal(out[1], ints)
    assert not world1._residuals


def test_cards_rehearsal_on_gloo(tmp_path):
    """The card scenario (``-k "cards and codec"``) with a tiny bf16 LM on
    4 gloo ranks: every run replayed after the warm-up with no fallback
    (int8 with replay off too, bitwise the replayed run), the ranks
    bitwise alike, losses finite and falling and at every step within 2%
    of the uncompressed run's, each codec selected on every step."""
    res = run_world("codec_cards", 4, tmp_path)
    base = res[0]["none"]["losses"]
    for run, codec, knob, sharded, replay in CODEC_CARD_RUNS:
        assert len({r[run]["digest"] for r in res}) == 1, run
        for r in res:
            got = r[run]
            assert got["replay"] == ((1, 4, 0) if replay else (0, 0, 0)), (
                run, got["replay"])
            assert np.isfinite(got["losses"]).all()
            assert got["losses"][-1] < got["losses"][0]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                          base))
            assert rel < 0.02, (run, rel)
            wire = codec if codec != "none" else knob
            kind = "sharded_step" if sharded else "grouped_allreduce"
            if wire == "none":
                assert got["selections"] == {}
            elif replay:
                assert got["selections"] == {(kind, wire): 3,
                                             ("replay", wire): 4}
            else:
                assert got["selections"] == {(kind, wire): 7}
            assert (got["residual_bytes"] > 0) == (wire in comp.EF_CODECS)
    assert res[0]["int8_eager"]["losses"] == res[0]["int8"]["losses"]
    assert res[0]["int8_eager"]["digest"] == res[0]["int8"]["digest"]
