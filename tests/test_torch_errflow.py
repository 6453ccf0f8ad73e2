"""The port's error-flow analyzer (horovod_tpu_torch/analysis/errflow.py)
held against the reference's on the reference suite's fixtures and
synthetic sources; torch.distributed's recovery-class errors, each with a
flagged and a clean case; the live port tree; and the fault it surfaced
in ``Engine.step_end``: the step-complete hook's failure, the recovery
carrier included, was swallowed at DEBUG."""

import logging
import os

import pytest

from horovod_tpu.analysis import errflow as ref
from horovod_tpu_torch.analysis import errflow as port

import lint_mirror

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO, "horovod_tpu_torch")


def _key(rep):
    return (sorted((f.check, f.file, f.line, f.func)
                   for f in rep.findings),
            sorted((f.check, f.file, f.line, f.reason)
                   for f in rep.suppressions),
            sorted((s.file, s.line, s.func, s.how) for s in rep.seams),
            (rep.recovery_defs, rep.handlers, rep.failpoints_declared,
             rep.failpoint_sites))


@pytest.mark.parametrize(
    "path", lint_mirror.fixture_paths("errflow"), ids=os.path.basename)
def test_fixture_findings_match_reference(path):
    root = os.path.dirname(path)
    assert _key(port.check_paths([path], root=root)) == \
        _key(ref.check_paths([path], root=root))


_CASES = (lint_mirror.harvest("test_errflow.py") +
          lint_mirror.harvest("test_errflow.py", "check_sources") +
          lint_mirror.harvest("test_errflow_regressions.py"))


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
    assert len(_CASES) >= 19


# ---------------------------------------------------------------------------
# the port's vocabulary: torch.distributed's recovery-class errors
# ---------------------------------------------------------------------------

_ADDED = sorted(port.RECOVERY_EXC - ref.RECOVERY_EXC)


def test_recovery_vocabulary():
    assert ref.RECOVERY_EXC <= port.RECOVERY_EXC
    assert set(_ADDED) == {"DistError", "DistBackendError",
                           "DistNetworkError", "DistStoreError"}
    for name in ("RECOVERY_ROOTS", "BROAD_EXC", "ESCALATE_CALLS",
                 "NO_PROPAGATE", "RAW_IO_CALLS"):
        assert getattr(ref, name) == getattr(port, name), name


def _handler(exc: str, body: str) -> str:
    return ("import torch.distributed as dist\n"
            "def run_fn(func, reset):\n"
            "    try:\n"
            "        func()\n"
            f"    except {exc}:\n"
            f"        {body}\n")


@pytest.mark.parametrize("exc", _ADDED)
@pytest.mark.parametrize("spelling", ["bare", "dotted", "tuple"])
def test_swallowed_dist_error_is_flagged(exc, spelling):
    clause = {"bare": exc, "dotted": f"dist.{exc}",
              "tuple": f"(ValueError, dist.{exc})"}[spelling]
    src = _handler(clause, "reset()")
    rep = port.check_source(src)
    assert [(f.check, f.line) for f in rep.findings] == \
        [("swallowed-recovery-error", 5)], rep.findings
    assert exc in rep.findings[0].message
    # the reference's vocabulary has no torch errors
    assert ref.check_source(src).findings == []


@pytest.mark.parametrize("exc", _ADDED)
@pytest.mark.parametrize("body", ["raise", "return None",
                                  "escalate(e)"])
def test_propagated_dist_error_passes(exc, body):
    src = _handler(f"dist.{exc} as e", body)
    assert port.check_source(src).findings == []


@pytest.mark.parametrize("exc", _ADDED)
def test_dist_error_off_the_recovery_path_passes(exc):
    src = ("import torch.distributed as dist\n"
           "def helper(func):\n"
           "    try:\n"
           "        func()\n"
           f"    except dist.{exc}:\n"
           "        pass\n")
    assert port.check_source(src).findings == []


# ---------------------------------------------------------------------------
# the live tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live():
    return port.check_package(PKG_ROOT)


def test_port_is_error_flow_clean(live):
    assert live.findings == [], "\n".join(map(str, live.findings))
    assert live.recovery_defs >= 100
    assert live.failpoint_sites >= live.failpoints_declared > 0


def test_live_suppressions_and_seams_carry_reasons(live):
    assert live.suppressions and live.seams
    for s in live.suppressions:
        assert s.reason and s.reason.strip().lower() != "todo", s
    for s in live.seams:
        assert s.how and s.how.strip(), s


def test_watchdog_handlers_keep_the_reference_reasons(live):
    """stall_inspector's escalation and flight-dump handlers carry the
    reference's own suppressions (horovod_tpu/stall_inspector.py)."""
    reasons = {s.func: s.reason for s in live.suppressions
               if s.file == "horovod_tpu_torch/stall_inspector.py"}
    assert reasons["StallInspector._escalate"].startswith(
        "escalation must continue to break_hangs")
    assert reasons["StallInspector._run_flight_dump"].startswith(
        "flight dump is best-effort")


# ---------------------------------------------------------------------------
# regression: Engine.step_end's hook
# ---------------------------------------------------------------------------

@pytest.fixture
def cpu_world():
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd.global_state().engine
    hvd.shutdown()


def test_step_hook_recovery_error_reaches_the_caller(cpu_world):
    """Before the repair the hook's HorovodInternalError died at DEBUG in
    step_end and never reached the elastic run loop."""
    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    def hook(step):
        raise HorovodInternalError("peer lost during the snapshot")

    cpu_world.on_step_complete = hook
    cpu_world.step_begin()
    with pytest.raises(HorovodInternalError, match="peer lost"):
        cpu_world.step_end()


def test_step_hook_failure_is_warned_and_the_step_completes(cpu_world,
                                                            caplog):
    """Any other hook failure (a snapshot the checkpoint manager cannot
    stamp) no longer vanishes at DEBUG: it is a WARNING, and the step
    still counts."""
    def hook(step):
        raise ValueError("a snapshot's CUDA leaves must lie on one device")

    cpu_world.on_step_complete = hook
    before = cpu_world.step_index
    cpu_world.step_begin()
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        cpu_world.step_end()
    assert cpu_world.step_index == before + 1
    assert any("step-complete hook failed" in r.getMessage() and
               r.levelno == logging.WARNING for r in caplog.records)
