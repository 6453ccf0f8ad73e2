"""The port's SPMD divergence checker (horovod_tpu_torch/analysis/
divcheck.py) held against the reference's on the reference suite's
fixtures and synthetic sources; its torch.distributed and engine-funnel
vocabulary, each name with a flagged and a clean case; the live port
tree; and the order the lazy kernel build keeps with the replay's CUDA
graph captures (the lint's step-path finding on ops/build.py)."""

import os

import pytest

from horovod_tpu.analysis import divcheck as ref
from horovod_tpu_torch.analysis import divcheck as port

import lint_mirror

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO, "horovod_tpu_torch")


def _key(rep):
    return (sorted((f.check, f.file, f.line, f.func)
                   for f in rep.findings),
            sorted((f.check, f.file, f.line, f.reason)
                   for f in rep.suppressions),
            sorted((a.file, a.line, a.what, a.how) for a in rep.agreed))


@pytest.mark.parametrize(
    "path", lint_mirror.fixture_paths("divcheck"), ids=os.path.basename)
def test_fixture_findings_match_reference(path):
    root = os.path.dirname(path)
    assert _key(port.check_paths([path], root=root)) == \
        _key(ref.check_paths([path], root=root))


_CASES = (lint_mirror.harvest("test_divcheck.py") +
          lint_mirror.harvest("test_divcheck.py", "check_sources"))


@pytest.mark.parametrize("case", [c for _, c in _CASES],
                         ids=[i for i, _ in _CASES])
def test_synthetic_source_matches_reference(case):
    if isinstance(case, dict):
        a, b = ref.check_sources(case), port.check_sources(case)
    else:
        src, rel = case
        a = ref.check_source(src, rel or "m.py")
        b = port.check_source(src, rel or "m.py")
    assert _key(b) == _key(a)


def test_mirror_harvests_every_reference_case():
    assert len(_CASES) >= 12


# ---------------------------------------------------------------------------
# the port's vocabulary
# ---------------------------------------------------------------------------

_ADDED_SEEDS = sorted(port.COLLECTIVE_SEEDS - ref.COLLECTIVE_SEEDS)


def test_vocabulary_only_grows():
    """No reference name was dropped to make the port's tree pass: the
    seeds the port lacks are the reference's XLA program builders, whose
    place the port's launchers take, and the steady-state size cache's
    exchanges, which come with ROADMAP A10."""
    dropped = ref.COLLECTIVE_SEEDS - port.COLLECTIVE_SEEDS
    assert {n for n in dropped if not n.startswith("build_")} == \
        {"_exchange_sizes_cached", "_dispatch_exchange"}
    assert ref.RANK_CALLS <= port.RANK_CALLS
    assert ref.RANK_NAMES <= port.RANK_NAMES
    assert ref.STEP_PATH_ROOTS <= port.STEP_PATH_ROOTS
    assert ref.NO_PROPAGATE == port.NO_PROPAGATE
    for name in ("all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "all_to_all_single", "all_to_all",
                 "batch_isend_irecv", "isend", "irecv",
                 "broadcast_object_list", "all_gather_object",
                 "monitored_barrier", "new_group", "_dispatch_substitute",
                 "_join_sync", "_exchange_sizes"):
        assert name in port.COLLECTIVE_SEEDS, name


def _gated(call: str, gate: str = "hvd.rank() == 0") -> str:
    return ("import horovod_tpu_torch as hvd\n"
            "import torch.distributed as dist\n"
            "def f(x, ops, group):\n"
            f"    if {gate}:\n"
            f"        {call}\n")


@pytest.mark.parametrize("name", _ADDED_SEEDS)
def test_added_seed_rank_gated_is_flagged(name):
    rep = port.check_source(_gated(f"dist.{name}(x)"))
    assert [(f.check, f.line) for f in rep.findings] == \
        [("rank-gated-collective", 5)], rep.findings
    # the reference does not know the name
    assert ref.check_source(_gated(f"dist.{name}(x)")).findings == []


@pytest.mark.parametrize("name", _ADDED_SEEDS)
def test_added_seed_issued_by_reference_is_flagged(name):
    """``_translate_failure(dist.all_reduce, flat)``: a collective passed
    to an invoker issues as surely as a call of it."""
    rep = port.check_source(_gated(f"_translate_failure(dist.{name}, x)"))
    assert [(f.check, f.line) for f in rep.findings] == \
        [("rank-gated-collective", 5)], rep.findings


@pytest.mark.parametrize("name", _ADDED_SEEDS)
def test_added_seed_unconditional_passes(name):
    src = ("import torch.distributed as dist\n"
           "def f(x, ops, group):\n"
           f"    dist.{name}(x)\n"
           f"    _translate_failure(dist.{name}, x)\n")
    assert port.check_source(src).findings == []


@pytest.mark.parametrize("name", _ADDED_SEEDS)
def test_added_seed_in_set_iteration_is_flagged(name):
    src = ("import torch.distributed as dist\n"
           "def f(xs):\n"
           "    for x in set(xs):\n"
           f"        dist.{name}(x)\n")
    rep = port.check_source(src)
    assert [(f.check, f.line) for f in rep.findings] == \
        [("nondeterministic-submission-order", 4)], rep.findings


def test_size_gate_passes_for_torch_collectives():
    """``get_world_size`` is collectively identical: no finding."""
    src = _gated("dist.all_reduce(x)", "dist.get_world_size() > 1")
    assert port.check_source(src).findings == []


def test_get_rank_is_rank_local():
    rep = port.check_source(_gated("dist.all_reduce(x)",
                                   "dist.get_rank(group) == 0"))
    assert [(f.check, f.line) for f in rep.findings] == \
        [("rank-gated-collective", 5)]
    assert "get_rank()" in rep.findings[0].message
    # the clean form: the rank as data (a peer index), no gate
    clean = ("import torch.distributed as dist\n"
             "def f(x, group):\n"
             "    peer = (dist.get_rank(group) + 1) % 2\n"
             "    dist.all_reduce(x)\n"
             "    return peer\n")
    assert port.check_source(clean).findings == []


def test_rank_gated_p2p_hop_with_agreed_pairing_passes():
    """Point-to-point hops are rank-dependent by design: the gated hop is
    blessed by an agreed[...] naming how the schedule pairs it."""
    src = ("import torch.distributed as dist\n"
           "def hop(x, rank):\n"
           "    # divcheck: agreed[even ranks send to rank+1, odd ranks "
           "receive from rank-1: the schedule pairs every send]\n"
           "    if rank % 2 == 0:\n"
           "        dist.isend(x, rank + 1)\n"
           "    else:\n"
           "        dist.irecv(x, rank - 1)\n")
    rep = port.check_source(src)
    assert rep.findings == []
    assert [(a.line, a.what) for a in rep.agreed] == [(3, "condition")]


@pytest.mark.parametrize("root", sorted(port.STEP_PATH_ROOTS -
                                        ref.STEP_PATH_ROOTS))
def test_added_step_path_root(root):
    src = ("import os\n"
           "class Engine:\n"
           f"    def {root}(self, xs):\n"
           "        return os.environ.get('HOROVOD_X')\n"
           "    def off_path(self):\n"
           "        return os.environ.get('HOROVOD_X')\n")
    rep = port.check_source(src)
    assert [(f.check, f.line) for f in rep.findings] == \
        [("capture-impure-read", 4)], rep.findings


# ---------------------------------------------------------------------------
# the live tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live():
    return port.check_package(PKG_ROOT)


def test_port_is_divergence_clean(live):
    assert live.findings == [], "\n".join(map(str, live.findings))
    assert live.issuing_defs >= 100 and live.step_path_defs >= 100


def test_live_annotations_carry_reasons(live):
    assert live.suppressions and live.agreed
    for s in live.suppressions:
        assert s.reason and s.reason.strip().lower() != "todo", s
    for a in live.agreed:
        assert a.how and a.how.strip().lower() != "todo", a


def test_replay_world_version_gate_keeps_the_reference_reason(live):
    agreed = {(a.file, a.what): a.how for a in live.agreed}
    how = agreed[("horovod_tpu_torch/core/replay.py", "condition")]
    assert how.startswith("world-version bumps are rendezvous-stamped")


def test_pack_table_loads_the_kernels_before_any_capture(monkeypatch):
    """The lazy nvcc build is reachable from the dispatch roots, which
    divcheck flags (ops/build.py). It never runs inside a CUDA graph
    capture: the replay programs build their PackTables before
    ``capture_begin``, and the table's constructor is what loads the
    library — ``capture()`` only reads the cached handle."""
    import inspect

    import torch

    from horovod_tpu_torch.core import replay
    from horovod_tpu_torch.ops import kernels

    loads = []

    class _Lib:
        def hvd_pack_tile_bytes(self):
            return 4096

    monkeypatch.setattr(kernels, "_lib", lambda: loads.append(1) or _Lib())
    kernels.PackTable([4, 8], torch.float32, torch.device("cpu"))
    assert loads == [1]
    for cls in (replay._GraphProgram, replay._ShardedGraphProgram):
        src = inspect.getsource(cls.__init__)
        assert src.index("kernels.PackTable(") < \
            src.index("capture_begin("), cls.__name__
