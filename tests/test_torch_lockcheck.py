"""The port's lock-discipline checker (horovod_tpu_torch/analysis/
lockcheck.py) held against the reference's on the reference suite's
fixtures and synthetic sources, its torch.distributed work-object
vocabulary, the live port tree, and the checkpoint writer's ownership of
its buffers (the lint's finding on CheckpointManager.close)."""

import os
import textwrap

import pytest

from horovod_tpu.analysis import lockcheck as ref
from horovod_tpu_torch.analysis import lockcheck as port

import lint_mirror

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO, "horovod_tpu_torch")


def _key(findings):
    return sorted((f.check, f.file, f.line, f.cls, f.attr)
                  for f in findings)


def _sup_key(sups):
    return sorted((f.check, f.file, f.line, f.reason) for f in sups)


@pytest.mark.parametrize(
    "path", lint_mirror.fixture_paths("lockcheck"),
    ids=os.path.basename)
def test_fixture_findings_match_reference(path):
    root = os.path.dirname(path)
    a = ref.check_paths([path], root=root)
    b = port.check_paths([path], root=root)
    assert _key(b.findings) == _key(a.findings)
    assert _sup_key(b.suppressions) == _sup_key(a.suppressions)
    assert (b.classes_annotated, b.guarded_attrs) == \
        (a.classes_annotated, a.guarded_attrs)


_CASES = lint_mirror.harvest("test_lockcheck.py")


@pytest.mark.parametrize("case", [c for _, c in _CASES],
                         ids=[i for i, _ in _CASES])
def test_synthetic_source_matches_reference(case):
    src, rel = case
    rel = rel or "m.py"
    fa, sa, na, ga = ref.check_source(src, rel)
    fb, sb, nb, gb = port.check_source(src, rel)
    assert _key(fb) == _key(fa)
    assert _sup_key(sb) == _sup_key(sa)
    assert (nb, gb) == (na, ga)


def test_mirror_harvests_every_reference_case():
    # a harvester that silently found nothing would make the mirror vacuous
    assert len(_CASES) >= 16


# ---------------------------------------------------------------------------
# the port's vocabulary: torch.distributed work objects and CUDA syncs
# ---------------------------------------------------------------------------

# (issue, wait): statement lines, relative indentation by 4 spaces
_WORK_FORMS = {
    "async_op": (["w = dist.all_reduce(t, async_op=True)"], ["w.wait()"]),
    "isend": (["w = dist.isend(t, 1)"], ["w.wait()"]),
    "irecv": (["w = dist.irecv(t, 0)"], ["w.wait()"]),
    "batch_isend_irecv": (["reqs = dist.batch_isend_irecv(ops)"],
                          ["for req in reqs:", "    req.wait()"]),
    "batch_loop": ([], ["for req in dist.batch_isend_irecv(ops):",
                        "    req.wait()"]),
    "appended": (["works = []",
                  "works.append(dist.all_reduce(t, async_op=True))"],
                 ["for w in works:", "    w.wait()"]),
    "self_attr": (["self._work = dist.all_reduce(t, async_op=True)"],
                  ["self._work.wait()"]),
}


def _class_src(under_lock, after=()) -> str:
    lines = ["import threading", "import torch.distributed as dist", "",
             "", "class C:", "    def __init__(self):",
             "        self._lock = threading.Lock()", "",
             "    def step(self, t, ops):", "        with self._lock:"]
    lines += ["            " + ln for ln in (under_lock or ["pass"])]
    lines += ["        " + ln for ln in after]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("form", sorted(_WORK_FORMS))
def test_work_wait_under_lock_is_flagged(form):
    issue, wait = _WORK_FORMS[form]
    src = _class_src(issue + wait)
    findings, *_ = port.check_source(src, "m.py")
    assert [f.check for f in findings] == ["blocking-under-lock"], findings
    assert findings[0].attr == "wait"
    # the reference has no torch vocabulary: the same source passes there
    ref_findings, *_ = ref.check_source(src, "m.py")
    assert ref_findings == []


@pytest.mark.parametrize("form", sorted(_WORK_FORMS))
def test_work_wait_after_the_lock_passes(form):
    # issue under the lock, wait after it: the clean form
    issue, wait = _WORK_FORMS[form]
    findings, *_ = port.check_source(_class_src(issue, wait), "m.py")
    assert findings == [], findings


def test_unrelated_wait_is_not_a_work_wait():
    # a name bound to something else (an Event, a plain call) is not a work
    src = _class_src(["w = make_waiter(t)", "w.wait()"])
    findings, *_ = port.check_source(src, "m.py")
    assert findings == []


@pytest.mark.parametrize("call", [
    "torch.cuda.synchronize()",              # the port's checkpoint path
    "self._ev.synchronize()",                # a CUDA event's
    "stream.synchronize()",                  # a stream's
    "dist.barrier()",
])
def test_cuda_and_barrier_syncs_under_lock_are_flagged(call):
    src = textwrap.dedent(f"""\
    import threading
    import torch
    import torch.distributed as dist


    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._ev = torch.cuda.Event()

        def step(self, stream):
            with self._lock:
                {call}

        def clean(self, stream):
            with self._lock:
                pass
            {call}
    """)
    findings, *_ = port.check_source(src, "m.py")
    assert [(f.check, f.line) for f in findings] == \
        [("blocking-under-lock", 13)], findings


# ---------------------------------------------------------------------------
# the live tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live():
    return port.check_package(PKG_ROOT)


def test_port_is_lock_discipline_clean(live):
    assert live.findings == [], "\n".join(map(str, live.findings))
    assert live.files >= 80


def test_every_live_suppression_carries_a_reason(live):
    assert live.suppressions
    for s in live.suppressions:
        assert s.reason and s.reason.strip() and \
            s.reason.strip().lower() != "todo", s


def test_guard_tables_the_copies_lost_are_restored():
    """The reference's _GUARDED_BY tables of LaunchGroup, HandleManager
    and Engine (core/engine.py) are back on the port's classes, the
    ZeRO-1 prefetch registry's row among them."""
    from horovod_tpu_torch.core import engine
    assert engine.LaunchGroup._GUARDED_BY == {"_done": "_lock"}
    assert engine.HandleManager._GUARDED_BY == {"_next": "_lock",
                                                "_handles": "_lock"}
    assert engine.Engine._GUARDED_BY == {"_outstanding": "_lock",
                                         "_residuals": "_lock",
                                         "_zero1_prefetch": "_lock"}


def test_checkpoint_writer_owns_its_buffers(tmp_path):
    """The lint's finding on CheckpointManager: close() released the
    writer's host buffer, pinned ring and side stream. The writer thread
    now owns them and lets them go as it stops, so close() touches none of
    them and a writer still finishing past close()'s join keeps them."""
    import torch
    from horovod_tpu_torch.checkpoint import CheckpointManager
    m = CheckpointManager(str(tmp_path), rank=0, world_size=1)
    try:
        m.snapshot({"w": torch.arange(8, dtype=torch.float32)}, step=1)
        assert m.wait_idle(30)
        assert m._host_buf is not None
    finally:
        m.close(flush=False)
    assert not m._thread.is_alive()
    assert m._host_buf is None and m._pinned == [] and \
        m._side_stream is None
