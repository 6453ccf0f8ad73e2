"""horovod_tpu_torch's topology and collective algorithm selection
(``parallel/mesh.py`` ``Topology``/``detect_topology``, the selection
rules and reducers of ``ops/collectives.py``, the engine's per-bucket
choices, replay's algorithm rows) on gloo/CPU, against the JAX package
(``tests/test_topology.py``'s classes, ``tests/test_compression.py``'s
hierarchical cases, ``tests/test_multiprocess.py``'s algorithm worlds) on
the same numpy-seeded inputs.

Tolerances. The selection rules, link attribution, residual lengths and
group layouts are pure functions: equal. On 4 ranks in nodes of 2 every
sum the tree and the ladder form has two terms, and fp32 addition of two
terms commutes, so both are bitwise the reference's
``build_grouped_allreduce(..., local_size=2, algos=...)`` (and each
other's); gloo's flat ring adds in its own order, so the flat form is held
within 2 float32 units of the sum of the terms' magnitudes
(``_sum_bound``). The two-level allgather and the two-phase alltoall are
routing: bitwise the flat ones and the reference's build functions. The
codec's hierarchical arm: its new residuals bitwise the reference's
``_make_codec_reducer``'s, its results within 2 float32 units of the sum
of the decoded cross contributions' magnitudes.

Worlds (``torch_worker.py``'s ``algo`` scenario): 4 ranks in nodes of 2
(every case), 2 ranks (tree is one pair round, hierarchical demotes), 2
ranks launched with ``HOROVOD_TPU_COLLECTIVE_ALGO`` forced, and 4 ranks
of one node whose first two ranks take a view that factorizes (the
heterogeneous-view regression).
"""

import dataclasses
import logging

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import torch

from horovod_tpu.common.reduce_ops import ReduceOp as RefOp
from horovod_tpu.ops import collectives as RC
from horovod_tpu.ops import compression as rcomp
from horovod_tpu.parallel import mesh as rmesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.core.state import engine as port_engine
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import compression as comp
from horovod_tpu_torch.parallel import mesh as pmesh
from torch_worker import (ALGO_CODEC_STEPS, ALGO_CODECS, ALGO_FORMS,
                          ALGO_JOIN_BIG, ALGO_OPS, ALGO_OPT_STEPS,
                          ALGO_SCALES, ALGO_TOTALS, World, algo_a2a_input,
                          algo_grid, algo_input, algo_split,
                          check_algo_cards)

EPS32 = 2.0 ** -23
# (size, local size) of the topologies the pure rules are held on
TOPOLOGIES = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (6, 1),
              (6, 4), (6, 3), (8, 1), (8, 2), (8, 4), (16, 4)]
KINDS = ("allreduce", "reducescatter", "allgather", "alltoall",
         "broadcast")
NBYTES = (0, 1024, 64 * 1024, 256 * 1024, 256 * 1024 + 4, 8 << 20)


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _sum_bound(terms) -> np.ndarray:
    """2 float32 units of the sum of the terms' magnitudes, elementwise."""
    return 2 * EPS32 * np.sum(np.abs(np.stack(terms)), axis=0)


def _mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), ("world",))


def _stacked(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("world")))


def _pair(size, local, platform="gpu"):
    """The same topology in both packages."""
    ici, dcn = pmesh._NOMINAL_LINK_GBPS[platform]
    kw = dict(size=size, local_size=local, platform=platform,
              source="override", ici_gbps=ici, dcn_gbps=dcn)
    return pmesh.Topology(**kw), rmesh.Topology(**kw)


# ---------------------------------------------------------------------------
# the Topology descriptor and its detection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,local", TOPOLOGIES)
def test_topology_is_the_references(size, local):
    """hierarchical_ok, the island counts, the groups, every roofline,
    describe() and digest() alike (the reference's TestTopology)."""
    t, r = _pair(size, local)
    assert t.hierarchical_ok == r.hierarchical_ok
    assert (t.num_slices, t.is_multislice) == (r.num_slices,
                                               r.is_multislice)
    if t.hierarchical_ok:
        assert t.local_groups() == r.local_groups()
        assert t.cross_groups() == r.cross_groups()
    for kind in ("allreduce", "allgather", "alltoall"):
        for algo in RC.ALGORITHMS:
            assert t.roofline_busbw_gbps(kind, algo) == \
                r.roofline_busbw_gbps(kind, algo), (kind, algo)
    assert t.describe() == r.describe()
    assert t.digest() == r.digest()
    assert not t.calibrated and not r.calibrated


def test_topology_groups_are_contiguous_slice_major():
    t, _ = _pair(8, 4)
    assert t.local_groups() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert t.cross_groups() == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert t.num_slices == 2 and t.is_multislice
    flat = t.roofline_busbw_gbps("allreduce", "flat")
    assert flat == t.dcn_gbps
    assert t.roofline_busbw_gbps("allreduce", "hierarchical") == \
        min(t.ici_gbps, t.dcn_gbps * 4)
    assert t.roofline_busbw_gbps("allreduce", "tree") == \
        pytest.approx(t.dcn_gbps / 3)


def test_nominal_links_hold_no_tpu_row():
    assert set(pmesh._NOMINAL_LINK_GBPS) == {"gpu", "cpu"}
    for name in ("gpu", "cpu"):
        assert pmesh._NOMINAL_LINK_GBPS[name] == \
            rmesh._NOMINAL_LINK_GBPS[name]


@pytest.mark.parametrize("override,size,local", [
    ("4", 8, 2), (None, 8, 2), ("4", 6, None), (None, 8, None),
    ("3", 8, None), (None, 6, 4), ("bogus", 8, 2), ("1", 8, 4)])
def test_detect_topology_is_the_references(monkeypatch, caplog, override,
                                           size, local):
    """The override wins, then the launcher's local size above 1, then flat;
    a local size that does not divide the world falls back to its largest
    divisor with the reference's warning; a bogus override is ignored."""
    if override is None:
        monkeypatch.delenv(env_mod.HOROVOD_TPU_LOCAL_SIZE, raising=False)
    else:
        monkeypatch.setenv(env_mod.HOROVOD_TPU_LOCAL_SIZE, override)
    with caplog.at_level(logging.WARNING):
        got = pmesh.detect_topology(size, local)
        want = rmesh.detect_topology(size=size, local_size=local)
    assert (got.size, got.local_size, got.source, got.hierarchical_ok) == \
        (want.size, want.local_size, want.source, want.hierarchical_ok)
    ported = [r.getMessage() for r in caplog.records
              if r.name == "horovod_tpu_torch"]
    ref = [r.getMessage() for r in caplog.records
           if r.name == "horovod_tpu"]
    assert ported == ref


@pytest.mark.parametrize("hosts,local,source", [
    (["a", "a", "b", "b"], 2, "hosts"),
    (["a"] * 4, 1, "flat"),
    (["a", "b", "a", "b"], 1, "flat"),         # not contiguous
    (["a", "a", "a", "b"], 1, "flat"),         # not uniform
    (["a", "b", "c", "d"], 1, "hosts"),
    (list("aaabbbccc"), 3, "hosts")])
def test_detect_topology_groups_ranks_by_host(monkeypatch, hosts, local,
                                              source):
    """Without the override or a launcher local size, the ranks' host
    names: uniform, contiguous groups of one host are an island (the
    counterpart of the reference's process_index probe); one host is one
    island, i.e. flat."""
    monkeypatch.delenv(env_mod.HOROVOD_TPU_LOCAL_SIZE, raising=False)
    t = pmesh.detect_topology(len(hosts), 1, hosts)
    assert (t.local_size, t.source) == (local, source)


# ---------------------------------------------------------------------------
# the selection rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,local", TOPOLOGIES)
def test_choose_algorithm_is_the_references(size, local):
    """Every kind, payload, forcing and pair of thresholds (the reference's
    TestChooseAlgorithm, on a grid)."""
    t, r = _pair(size, local)
    for kind in KINDS:
        for nbytes in NBYTES:
            for force in env_mod.COLLECTIVE_ALGO_MODES + ("quantum",):
                for tree_thr, hier_thr in ((256 * 1024, 0), (512, 0),
                                           (2048, 1 << 20)):
                    args = (kind, nbytes)
                    kw = dict(force=force, tree_threshold_bytes=tree_thr,
                              hier_threshold_bytes=hier_thr)
                    assert C.choose_algorithm(*args, t, **kw) == \
                        RC.choose_algorithm(*args, r, **kw), (args, kw)
            for algo in RC.ALGORITHMS + ("quantum",):
                assert C.validate_algorithm(kind, algo, size, local) == \
                    RC.validate_algorithm(kind, algo, size, local)


def test_choose_algorithm_cases():
    """The reference's named cases."""
    t, _ = _pair(8, 4)
    assert C.choose_algorithm("allreduce", 64 * 1024, t) == "tree"
    assert C.choose_algorithm("allreduce", 8 << 20, t) == "hierarchical"
    assert C.choose_algorithm("allgather", 8 << 20, t) == "hierarchical"
    assert C.choose_algorithm("allreduce", 8 << 20, _pair(8, 1)[0]) == \
        "flat"
    assert C.choose_algorithm("allreduce", 1024, _pair(2, 1)[0]) == "flat"
    assert C.choose_algorithm("allreduce", 1024, _pair(6, 1)[0]) == "flat"
    assert C.choose_algorithm("reducescatter", 8 << 20, t) == "flat"
    assert C.validate_algorithm("reducescatter", "hierarchical", 8, 4) == \
        "flat"
    assert C.choose_algorithm("allreduce", 10, _pair(6, 4)[0],
                              force="hierarchical") == "flat"
    assert C.choose_algorithm("allreduce", 8 << 20, t, force="tree") == \
        "tree"
    assert C.choose_algorithm("allreduce", 1024, _pair(1, 1)[0]) == "flat"


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_group_layouts_are_the_references(n):
    if C._is_pow2(n):
        assert C.tree_groups(n) == RC.tree_groups(n)
    for local in range(1, n + 1):
        if n % local == 0:
            assert C.slice_groups(n, local) == RC.slice_groups(n, local)
        assert C.ring_edge_is_dcn(n, local) == RC.ring_edge_is_dcn(n, local)


@pytest.mark.parametrize("kind", ("allreduce", "allgather", "alltoall",
                                  "reducescatter"))
def test_link_split_is_the_references(kind):
    """Every algorithm, payload, local size, codec and element size (the
    reference's TestLinkSplit and TestLinkSplitCodec, on a grid)."""
    for algo in RC.ALGORITHMS:
        for nbytes in (0, 7, 1000, 4096, 1 << 20):
            for local in (1, 2, 4):
                for codec in comp.CODECS:
                    for itemsize in (2, 4):
                        for size in (0, 4, 8):
                            kw = dict(kind=kind, codec=codec,
                                      itemsize=itemsize, size=size)
                            assert C.link_split(algo, nbytes, local, **kw) \
                                == RC.link_split(algo, nbytes, local, **kw)


def test_link_split_cases():
    assert C.link_split("flat", 1000, 4) == {"flat": 1000}
    assert C.link_split("tree", 1000, 4) == {"flat": 1000}
    assert C.link_split("hierarchical", 1000, 4) == {"dcn": 250, "ici": 750}
    assert C.link_split("hierarchical", 1000, 4, kind="allgather") == \
        {"dcn": 1000}
    assert C.link_split("hierarchical", 4096, 4, codec="int8",
                        itemsize=4) == {"dcn": 256, "ici": 3072}
    assert C.link_split("flat", 4096, 1, codec="int8", itemsize=4) == \
        {"flat": 2048 // 4 + 2048}
    assert C.link_split("flat", 4096, 1, kind="reducescatter",
                        codec="int8", itemsize=4) == {"flat": 1024}


@pytest.mark.parametrize("codec", comp.CODECS)
def test_codec_residual_elems_is_the_references_hierarchical_rule(codec):
    for cls in ("reduce", "sharded"):
        for total in (0, 1, 7, 1000, 1001):
            for n, local in ((2, 1), (4, 2), (8, 4), (8, 2)):
                for algo in RC.ALGORITHMS + (None,):
                    assert C.codec_residual_elems(
                        cls, total, n, local, algo, codec) == \
                        RC.codec_residual_elems(cls, total, n, local, algo,
                                                codec)
    if codec in comp.EF_CODECS:
        assert C.codec_residual_elems("reduce", 1001, 8, 4, "hierarchical",
                                      codec) == 251


# ---------------------------------------------------------------------------
# knobs and the engine's counters in a world of one
# ---------------------------------------------------------------------------


def test_knobs_parse(monkeypatch, caplog):
    """Every knob of the selection with the reference's names, defaults and
    choices; a bogus choice warns and takes the default."""
    names = (env_mod.HOROVOD_TPU_COLLECTIVE_ALGO,
             env_mod.HOROVOD_TPU_ALLTOALL_ALGO,
             env_mod.HOROVOD_TPU_ALLTOALL_CODEC,
             env_mod.HOROVOD_TPU_ALLTOALL_HIER_THRESHOLD_BYTES,
             env_mod.HOROVOD_TPU_TREE_THRESHOLD_BYTES,
             env_mod.HOROVOD_HIERARCHICAL_ALLGATHER,
             env_mod.HOROVOD_HIERARCHICAL_ALLREDUCE)
    for n in names:
        monkeypatch.delenv(n, raising=False)
    cfg = env_mod.Config.from_env()
    assert (cfg.collective_algo, cfg.tree_threshold_bytes,
            cfg.hier_threshold_bytes, cfg.alltoall_algo, cfg.alltoall_codec,
            cfg.alltoall_hier_threshold_bytes, cfg.hierarchical_allgather) \
        == ("auto", 256 * 1024, 0, "auto", "none", 0, False)
    monkeypatch.setenv(names[0], "Tree")
    monkeypatch.setenv(names[1], "hierarchical")
    monkeypatch.setenv(names[2], "int8")
    monkeypatch.setenv(names[3], "4096")
    monkeypatch.setenv(names[4], "1024")
    monkeypatch.setenv(names[5], "1")
    cfg = env_mod.Config.from_env()
    assert (cfg.collective_algo, cfg.alltoall_algo, cfg.alltoall_codec,
            cfg.alltoall_hier_threshold_bytes, cfg.tree_threshold_bytes,
            cfg.hierarchical_allgather) == ("tree", "hierarchical", "int8",
                                            4096, 1024, True)
    assert env_mod.COLLECTIVE_ALGO_MODES == ("auto", "flat", "tree",
                                             "hierarchical")
    assert env_mod.ALLTOALL_ALGO_MODES == ("auto", "flat", "hierarchical")
    monkeypatch.setenv(names[0], "quantum")
    monkeypatch.setenv(names[1], "tree")
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        cfg = env_mod.Config.from_env()
    assert (cfg.collective_algo, cfg.alltoall_algo) == ("auto", "auto")
    assert sum("is not one of" in r.getMessage()
               for r in caplog.records) == 2


@pytest.fixture
def world1(monkeypatch):
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_PALLAS_PACK",
                "HOROVOD_TPU_STEP_REPLAY", "HOROVOD_TPU_COMPRESSION",
                "HOROVOD_TPU_COLLECTIVE_ALGO", "HOROVOD_TPU_LOCAL_SIZE",
                "HOROVOD_HIERARCHICAL_ALLREDUCE"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        yield port_engine()
    finally:
        hvd.shutdown()


def test_size1_world_counts_flat_selections_and_links(world1):
    """A world of one runs every collective flat and books every byte on
    link "flat" (the reference's counter test, read from the plain
    counters); it holds no process group of its own."""
    eng = world1
    assert eng.topology.size == 1 and not eng._hierarchical_ok()
    assert eng._tree_groups is None and eng._hier_groups is None
    hvd.allreduce(torch.ones(16), name="topo.ar", op=hvd.Sum)
    hvd.grouped_allreduce([torch.ones(4), torch.ones(3)], op=hvd.Sum)
    assert eng.algo_selections == {("allreduce", "flat"): 2}
    assert eng.link_bytes == {"flat": 64 + 28}


def test_engine_link_counter_splits_a_hierarchical_bucket(world1):
    """The reference's wire-counter case: a 1024-byte bucket on the ladder
    of nodes of 4 books 768 bytes on ici and 256 on dcn."""
    eng = world1
    eng.topology = dataclasses.replace(eng.topology, size=8, local_size=4)
    eng._count(eng._selection_counts("allreduce", [1024], [4],
                                     ["hierarchical"]))
    assert eng.link_bytes == {"ici": 768, "dcn": 256}
    assert eng.algo_selections == {("allreduce", "hierarchical"): 1}


@pytest.mark.parametrize("knob,value,kind", [
    ("HOROVOD_TPU_COLLECTIVE_ALGO", "tree", "allreduce"),
    ("HOROVOD_TPU_COLLECTIVE_ALGO", "hierarchical", "allgather"),
    ("HOROVOD_HIERARCHICAL_ALLREDUCE", "1", "allreduce"),
    ("HOROVOD_TPU_ALLTOALL_ALGO", "hierarchical", "alltoall")])
def test_size1_forced_form_warns_once_and_runs_flat(monkeypatch, caplog,
                                                    knob, value, kind):
    """A world of one runs a forced tree or two-level form flat, with the
    right result, and says so once, naming the knob; "flat" and "auto"
    say nothing."""
    from horovod_tpu_torch.core import engine as engine_mod
    monkeypatch.setattr(engine_mod, "_warned_demotions", set())
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    x = torch.arange(6, dtype=torch.float32)
    for setting, warnings in ((value, 1), ("0" if value == "1" else "flat",
                                           0)):
        monkeypatch.setenv(knob, setting)
        hvd.init(device="cpu")
        caplog.clear()
        try:
            with caplog.at_level("WARNING", logger="horovod_tpu_torch"):
                for _ in range(2):
                    if kind == "allreduce":
                        assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
                        assert torch.equal(hvd.grouped_allreduce(
                            [x], op=hvd.Sum)[0], x)
                    elif kind == "allgather":
                        assert torch.equal(hvd.allgather(x), x)
                    else:
                        assert torch.equal(hvd.alltoall(x), x)
            assert set(port_engine().algo_selections) <= {
                (kind, "flat")}
        finally:
            hvd.shutdown()
        got = [r for r in caplog.records if "using flat" in r.getMessage()]
        assert len(got) == warnings, caplog.text
        if warnings:
            assert knob in got[0].getMessage()
            assert "runs flat" not in got[0].getMessage()
        monkeypatch.setattr(engine_mod, "_warned_demotions", set())


def test_replay_rearms_on_collective_algo_knob_move(world1):
    """A live move of the algorithm knob rebuilds the armed program before
    its next launch (the reference's test of the same name,
    tests/test_topology.py:310)."""
    eng = world1
    eng.config.step_replay_warmup = 2
    tensors = [torch.ones(8) for _ in range(3)]

    def step(i):
        eng.step_begin()
        hvd.grouped_allreduce(list(tensors), name=f"ra.{i}", op=hvd.Sum)
        eng.step_end()

    for i in range(3):
        step(i)
    assert eng.replay.replayed_steps >= 1

    def armed():
        return [e["armed"] for e in eng.replay._seen.values()
                if e.get("armed")]

    first = armed()
    assert first and first[0].algo_sig[0] == "auto"
    assert first[0].algo_sig == eng._algo_sig()
    eng.config.collective_algo = "flat"
    step(3)
    rearmed = armed()
    assert rearmed and rearmed[0].algo_sig[0] == "flat"
    assert rearmed[0].program is not first[0].program
    for move in (("tree_threshold_bytes", 1), ("alltoall_codec", "int8"),
                 ("hierarchical_allgather", True)):
        before = armed()[0].program
        setattr(eng.config, *move)
        step(4)
        assert armed()[0].program is not before, move
    assert eng.replay.fallbacks == 0


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

WORLD_SPECS = {
    "l2": (4, dict(local_size=2)),
    "n2": (2, {}),
    "hetero": (4, {}),
    "forced_hier": (2, dict(env={"HOROVOD_TPU_COLLECTIVE_ALGO":
                                 "hierarchical"})),
    "forced_tree": (2, dict(env={"HOROVOD_TPU_COLLECTIVE_ALGO": "tree"})),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of WORLD_SPECS, started together and read after."""
    started = {k: World("algo", n, tmp_path_factory.mktemp(k), **kw)
               for k, (n, kw) in WORLD_SPECS.items()}
    return {k: w.results() for k, w in started.items()}


def _ref_grouped(n, form, op, pre, post, total):
    """The reference's grouped allreduce of one bucket (two tensors) of
    every rank's ``algo_input`` under ``form`` on nodes of 2."""
    shapes = algo_split(total)
    fn = RC.build_grouped_allreduce(
        _mesh(n), "world", RefOp[op], shapes, [jnp.float32] * 2, [[0, 1]],
        pre, post, local_size=2, algos=(form,))
    x = np.stack([algo_input(r, 0, total) for r in range(n)])
    outs = fn(_stacked(_mesh(n), x))
    return np.concatenate([np.asarray(o).reshape(-1) for o in outs]), x


@pytest.mark.parametrize("total", ALGO_TOTALS)
@pytest.mark.parametrize("scale", ALGO_SCALES)
@pytest.mark.parametrize("op", ALGO_OPS)
@pytest.mark.parametrize("form", ALGO_FORMS)
@pytest.mark.parametrize("world", ["l2", "n2"])
def test_reducers_match_the_references_build_functions(worlds, world, form, op,
                                                scale, total):
    """Each forced form of one bucket through the engine against
    ``build_grouped_allreduce(..., local_size=2, algos=(form,))``: the
    tree and the ladder bitwise (at 2 ranks the ladder demotes to the
    flat ring, as the reference's does), the flat ring within 2 float32
    units of the sum of the terms' magnitudes; every rank alike."""
    res = worlds[world]
    n = len(res)
    pre, post = scale
    want, x = _ref_grouped(n, form, op, pre, post, total)
    key = (form, op, pre, total)
    got = res[0]["reduce"][key]
    for r in res:
        np.testing.assert_array_equal(_bits(r["reduce"][key]), _bits(got))
    exact = form == "tree" or (form == "hierarchical" and n == 4) or n == 2
    if exact:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        terms = [xi * pre * post / (n if op == "AVERAGE" else 1) for xi in x]
        assert (np.abs(got - want) <= _sum_bound(terms)).all()
    if world == "l2" and form != "flat":
        # on 4 ranks in nodes of 2 the tree and the ladder both sum
        # (a + b) + (c + d)
        other = "tree" if form == "hierarchical" else "hierarchical"
        np.testing.assert_array_equal(
            _bits(got), _bits(res[0]["reduce"][(other, op, pre, total)]))


def test_reducer_selections(worlds):
    """8 buckets a form, each resolved as forced; at 2 ranks the ladder
    demotes to flat and the tree is one pair round."""
    for r in worlds["l2"]:
        assert r["hier_ok"] and r["tree_rounds"] == 2
        assert r["reduce_selections"] == {
            f: {("allreduce", f): 8} for f in ALGO_FORMS}
    for r in worlds["n2"]:
        assert not r["hier_ok"] and r["tree_rounds"] == 1
        assert r["reduce_selections"]["hierarchical"] == {
            ("allreduce", "flat"): 8}
        assert r["reduce_selections"]["tree"] == {("allreduce", "tree"): 8}


def _ref_codec_hier(codec, op, total):
    """The reference's hierarchical codec reducer over ALGO_CODEC_STEPS
    steps on 4 ranks in nodes of 2, each rank's residual fed back: per
    step the result and every rank's new residual."""
    ef = codec in rcomp.EF_CODECS
    n = 4
    reduce = RC._make_codec_reducer("world", RefOp[op], n, 2,
                                    "hierarchical", codec)

    def body(x, r):
        out, nr = reduce(x[0], r[0] if ef else None)
        return out, (nr if ef else jnp.zeros_like(r[0]))[None]

    fn = jax.jit(shard_map(body, mesh=_mesh(n),
                           in_specs=(P("world"), P("world")),
                           out_specs=(P(), P("world")), check_vma=False))
    res = jnp.zeros((n, C.shard_spec(total, 2)[1]), jnp.float32)
    steps = []
    for step in range(ALGO_CODEC_STEPS):
        x = np.stack([algo_input(r, 1 + step, total) for r in range(n)])
        out, res = fn(jnp.asarray(x), res)
        steps.append((np.asarray(out), np.asarray(res) if ef else None))
    return steps


def _decoded(payload_bytes, scale, codec) -> np.ndarray:
    dt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
          "bf16": torch.bfloat16}[codec]
    out = torch.from_numpy(payload_bytes.copy()).view(dt).float().numpy()
    return out if scale is None else out * np.float32(scale[0])


@pytest.mark.parametrize("total", ALGO_TOTALS)
@pytest.mark.parametrize("op", ALGO_OPS)
@pytest.mark.parametrize("codec", ALGO_CODECS)
def test_codec_hierarchical_arm_matches_the_reference(worlds, codec, op,
                                                      total):
    """``codec_hier_allreduce`` on 4 ranks in nodes of 2: every rank's new
    residual bitwise the reference's; the result the same on every rank
    and within 2 float32 units of the sum of the decoded cross
    contributions' magnitudes of the reference's."""
    res = worlds["l2"]
    want = _ref_codec_hier(codec, op, total)
    part = C.shard_spec(total, 2)[1]
    avg = 4 if op == "AVERAGE" else 1
    for step, (w_out, w_res) in enumerate(want):
        got = [r["codec_hier"][(codec, op, total)][step] for r in res]
        for rank, g in enumerate(got):
            np.testing.assert_array_equal(_bits(g["out"]),
                                          _bits(got[0]["out"]))
            if w_res is None:
                assert g["residual"] is None
            else:
                np.testing.assert_array_equal(_bits(g["residual"]),
                                              _bits(w_res[rank]))
        # chunk l of the result is the decoded sum of the payloads of
        # cross group l (ranks l and 2 + l)
        bound = np.zeros(2 * part, np.float32)
        for l in range(2):
            terms = [_decoded(got[c * 2 + l]["payload"],
                              got[c * 2 + l]["scale"], codec) / avg
                     for c in range(2)]
            bound[l * part:(l + 1) * part] = _sum_bound(terms)
        diff = np.abs(got[0]["out"] - w_out)
        assert (diff <= bound[:total]).all(), (step, diff.max())


def test_codec_hierarchical_arm_is_exact_on_the_grid(worlds):
    """Integer data on the int8 grid through ``codec_hier_allreduce`` on 4
    ranks in nodes of 2: only the cross leg is encoded and its encode is
    exact there, so the result is bitwise the plain sum and the residual
    zero (the reference's test_hierarchical_ici_legs_bit_exact)."""
    res = worlds["l2"]
    want = algo_grid(len(res), 2).sum(0)
    for r in res:
        np.testing.assert_array_equal(r["codec_hier"]["grid"]["out"], want)
        assert not r["codec_hier"]["grid"]["residual"].any()


def test_allgather_two_level_is_bitwise_the_flat_and_the_references(worlds):
    res = worlds["l2"]
    n = len(res)
    evens = [np.random.RandomState(800 + r).randn(3, 4).astype(np.float32)
             for r in range(n)]
    want = np.asarray(RC.build_hierarchical_allgather(_mesh(n), "world", 2)(
        _stacked(_mesh(n), np.stack(evens))))
    ragged = np.concatenate([np.full((r + 1, 2), float(r), np.float32)
                             for r in range(n)])
    for r in res:
        ag = r["allgather"]
        np.testing.assert_array_equal(_bits(ag["hierarchical"]["even"]),
                                      _bits(ag["flat"]["even"]))
        np.testing.assert_array_equal(_bits(ag["hierarchical"]["even"]),
                                      _bits(want))
        np.testing.assert_array_equal(ag["hierarchical"]["ragged"], ragged)
        assert ag["hierarchical"]["selections"] == {
            ("allgather", "hierarchical"): 2}
        assert ag["flat"]["selections"] == {("allgather", "flat"): 2}


@pytest.mark.parametrize("codec", ("none",) + ALGO_CODECS)
def test_alltoall_two_phase_is_the_references(worlds, codec):
    """The two-phase alltoall against the reference's
    ``build_hierarchical_alltoall`` (bitwise, with every codec: the codec
    arithmetic is the reference's as XLA compiles it), and without a
    codec bitwise the flat exchange; the codec counted on hierarchical
    buckets only."""
    res = worlds["l2"]
    n = len(res)
    x = np.stack([algo_a2a_input(r, n) for r in range(n)])
    fn = RC.build_hierarchical_alltoall(_mesh(n), "world", 2, codec)
    want = np.asarray(fn(_stacked(_mesh(n), x)))
    for rank, r in enumerate(res):
        got = r["alltoall"][("hierarchical", codec)]
        assert got["selections"] == {("alltoall", "hierarchical"): 1}
        if codec == "none":
            np.testing.assert_array_equal(
                _bits(got["out"]), _bits(r["alltoall"][("flat", "none")][
                    "out"]))
        np.testing.assert_array_equal(_bits(got["out"]), _bits(want[rank]))
    for r in res:
        # a flat alltoall ignores the codec
        np.testing.assert_array_equal(
            _bits(r["alltoall"][("flat", "int8")]["out"]),
            _bits(r["alltoall"][("flat", "none")]["out"]))
        assert r["alltoall"][("flat", "int8")]["selections"] == {
            ("alltoall", "flat"): 1}


def test_alltoall_uneven_splits_stay_flat(worlds):
    from torch_worker import alltoall_input
    res = worlds["l2"]
    n = len(res)
    ins = [alltoall_input(r, n) for r in range(n)]
    for rank, r in enumerate(res):
        u = r["alltoall"]["uneven"]
        assert u["selections"] == {("alltoall", "flat"): 1}
        want = np.concatenate([
            ins[q][0][sum(ins[q][1][:rank]):sum(ins[q][1][:rank + 1])]
            for q in range(n)])
        np.testing.assert_array_equal(u["out"], want)


@pytest.mark.parametrize("world", ["l2", "n2"])
def test_forced_forms_are_exact(worlds, world):
    """The reference's _worker_algo_parity: exact integer-valued results of
    allreduce, grouped allreduce, allgather and reducescatter under auto
    and each forced form."""
    res = worlds[world]
    n = len(res)
    s = n * (n + 1) // 2
    for r in res:
        for form, got in r["parity"].items():
            np.testing.assert_array_equal(got["allreduce"],
                                          np.arange(8.0) * s)
            np.testing.assert_array_equal(got["grouped"][0],
                                          np.arange(8.0) * s)
            np.testing.assert_array_equal(got["grouped"][1],
                                          np.arange(8.0) * s + n)
            np.testing.assert_array_equal(got["allgather"],
                                          np.arange(float(n)))
            np.testing.assert_array_equal(got["reducescatter"],
                                          np.full((1, 3), float(s)))


def test_auto_and_legacy_choices(worlds):
    """Auto on 4 ranks in nodes of 2: a 64 KiB allreduce takes the tree, a
    1 MiB one the ladder; the legacy HOROVOD_HIERARCHICAL_ALLREDUCE makes
    the small one the ladder too, with no warning; every link of the
    attribution seen. At 2 ranks auto is flat."""
    for r in worlds["l2"]:
        assert r["auto_selections"] == {("allreduce", "tree"): 1,
                                        ("allreduce", "hierarchical"): 1}
        assert r["legacy"]["selections"] == {
            ("allreduce", "hierarchical"): 1}
        assert r["legacy"]["warnings"] == []
        np.testing.assert_array_equal(r["legacy"]["sum"], [4.0] * 4)
        assert set(r["link_bytes"]) == {"flat", "ici", "dcn"}
    for r in worlds["n2"]:
        assert r["auto_selections"] == {("allreduce", "flat"): 2}
        assert r["legacy"]["selections"] == {("allreduce", "flat"): 1}
        assert r["legacy"]["warnings"] == []


def test_joined_rank_substitute_under_tree_and_ladder(worlds):
    """Rank 0 joins while the others reduce a tree bucket and a ladder
    bucket: its substitute picks the same programs from the advertised
    shapes, and the sums are the others' tensors."""
    res = worlds["l2"]
    s = float(sum(range(1, len(res))))
    assert res[0]["join"]["values"] is None
    for r in res:
        assert r["join"]["selections"] == {("allreduce", "tree"): 1,
                                           ("allreduce", "hierarchical"): 1}
        assert r["join"]["last"] == res[0]["join"]["last"]
    for r in res[1:]:
        small, big = r["join"]["values"]
        np.testing.assert_array_equal(small, np.full(16, s, np.float32))
        np.testing.assert_array_equal(big, np.full(ALGO_JOIN_BIG, s,
                                                   np.float32))


def _traj_equal(a, b):
    for x, y in zip(a["traj"], b["traj"]):
        for p, q in zip(x, y):
            np.testing.assert_array_equal(_bits(p), _bits(q))


def test_sharded_step_reduce_scatter_flat_all_gather_hierarchical(worlds):
    """ZeRO-1 on 4 ranks in nodes of 2 under auto: the reduce-scatter stays
    flat, the all-gather goes two-level, and the trajectory is bitwise
    that of every leg flat; both replay after the warm-up."""
    for r in worlds["l2"]:
        auto, flat = r["runs"]["sharded_auto"], r["runs"]["sharded_flat"]
        sel = auto["selections"]
        assert set(sel) == {("reducescatter", "flat"),
                            ("allgather", "hierarchical")}, sel
        assert sel[("reducescatter", "flat")] == \
            sel[("allgather", "hierarchical")]
        assert set(flat["selections"]) == {("reducescatter", "flat"),
                                           ("allgather", "flat")}
        _traj_equal(auto, flat)
        for run in (auto, flat):
            assert run["replay"] == (1, ALGO_OPT_STEPS - 3, 0)


@pytest.mark.parametrize("form", ["tree", "hier", "hier_int8"])
def test_replay_runs_the_bucket_forms(worlds, form):
    """DistributedOptimizer under the forced tree, the ladder and int8 on
    the ladder: replayed after the warm-up and bitwise the run with replay
    off (the residuals too); every rank alike; the tree's and the
    ladder's trajectories the same bits ((a + b) + (c + d) both)."""
    res = worlds["l2"]
    for r in res:
        on, off = r["runs"][f"dense_{form}"], r["runs"][f"dense_{form}_off"]
        assert on["replay"] == (1, ALGO_OPT_STEPS - 3, 0)
        assert off["replay"] == (0, 0, 0)
        _traj_equal(on, off)
        _traj_equal(on, res[0]["runs"][f"dense_{form}"])
        for a, b in zip(on["residuals"], off["residuals"]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]))
        algo = "tree" if form == "tree" else "hierarchical"
        assert set(on["selections"]) == {("allreduce", algo)}
        if form == "hier_int8":
            # the ladder's residual: the local chunk of each padded bucket
            assert on["residuals"][-1] and all(
                k[4] == C.shard_spec(k[4] * 2, 2)[1] for k in
                on["residuals"][-1])
    _traj_equal(res[0]["runs"]["dense_tree"], res[0]["runs"]["dense_hier"])


def test_two_ranks_forced_tree_and_hierarchical(worlds):
    """Launched with HOROVOD_TPU_COLLECTIVE_ALGO: tree at 2 ranks is one
    pair round; hierarchical demotes to flat with the reference's one
    warning a kind; the results are exact."""
    for r in worlds["forced_tree"]:
        assert r["tree_rounds"] == 1
        assert r["selections"] == {("allreduce", "tree"): 2,
                                   ("allgather", "flat"): 1}
        np.testing.assert_array_equal(r["allreduce"], np.arange(8.0) * 3)
    for r in worlds["forced_hier"]:
        assert r["selections"] == {("allreduce", "flat"): 2,
                                   ("allgather", "flat"): 1}
        assert len(r["warnings"]) == 2, r["warnings"]
        assert all("no exact (cross, local) factorization" in w
                   for w in r["warnings"])
        np.testing.assert_array_equal(r["grouped"][1],
                                      np.arange(8.0) * 3 + 2)


def test_heterogeneous_views_agree_on_flat(worlds):
    """Ranks 0-1 see nodes of 2, ranks 2-3 one node of 4: every rank runs
    the agreement again, agrees on no hierarchy and reduces flat, with no
    deadlock (the reference's test_heterogeneous_topology_agrees_on_flat)."""
    res = worlds["hetero"]
    assert sorted(r["local"] for r in res) == [2, 2, 4, 4]
    assert [r["view_ok"] for r in res] == [True, True, False, False]
    for r in res:
        assert r["hier_ok"] is False
        assert r["selections"] == {("allreduce", "flat"): 1}
        np.testing.assert_array_equal(r["sum"], [4.0] * 4)


def test_algo_cards_rehearsal_on_gloo(tmp_path):
    """The card scenario (``-k "cards and algo"``) with a tiny bf16 LM on 4
    gloo ranks in nodes of 2: every form's parameters alike on every rank,
    replayed after the warm-up, its first reduced gradients within 2 fp32
    units of the sum of |terms| of the flat run's, its losses within 0.1%;
    auto picks the ladder for the LM's bucket and the tree for 64 KiB;
    the two-level allgather and alltoall bitwise the flat ones, int8 on
    the alltoall within its error; ZeRO-1 under auto bitwise every leg
    flat; int8 on the ladder finite through replay."""
    res = World("algo_cards", 4, tmp_path, local_size=2).results()
    # the tiny LM's one bucket is within the tree's 256 KiB
    check_algo_cards(res, 4, "tree")
