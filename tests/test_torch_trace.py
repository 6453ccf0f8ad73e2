"""horovod_tpu_torch's trace recorder and merger (trace.py), against the JAX
package's (``tests/test_trace.py``'s cases that need no KV server).

Parity: the same engine calls at size 1 stamp the same sequence of
(phase, kind, name, bytes, correlation id) events in both packages, and
the pure merge, skew and straggler functions give the same output on the
same segments.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp

import horovod_tpu as ref_hvd
from horovod_tpu import trace as ref_trace
import horovod_tpu_torch as hvd
import torch
from horovod_tpu_torch import trace as trace_mod
from horovod_tpu_torch.core.state import engine as port_engine
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.metrics import Registry
from horovod_tpu_torch.trace import (TraceRecorder, clock_offset,
                                     collective_skew, load_trace_events,
                                     load_trace_file, make_corr,
                                     merge_segments, modal_straggler,
                                     observe_skew, parse_corr,
                                     render_cluster_trace)
from torch_worker import obs_sequence

TOOLS = str(Path(__file__).resolve().parent.parent / "tools")


class _frozen_monotonic:
    """Pin a trace module's ``time.monotonic`` to a fixed value."""

    def __init__(self, value: float, mod=trace_mod):
        self.value = value
        self.mod = mod

    def __enter__(self):
        self._orig = self.mod.time

        class _T:
            monotonic = staticmethod(lambda v=self.value: v)

        self.mod.time = _T
        return self

    def __exit__(self, *exc):
        self.mod.time = self._orig
        return False


def _exercise(rec, names=("g0", "g1"), rounds=3, world_version=0):
    for _ in range(rounds):
        rec.record_step(begin=True)
        for n in names:
            rec.record_enqueue(n, "allreduce", 64, world_version)
            rec.record_dispatch(n, "XLA_DISPATCH", 0.001)
            rec.record_done(n)
        rec.record_step(begin=False)


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------

class TestRecorder:
    def test_correlation_ids_are_deterministic(self):
        a, b = TraceRecorder(rank=0), TraceRecorder(rank=1)
        ids_a = [a.record_enqueue("x", "allreduce", 8, 3) for _ in range(4)]
        ids_b = [b.record_enqueue("x", "allreduce", 8, 3) for _ in range(4)]
        assert ids_a == ids_b == [make_corr("x", 3, i + 1) for i in range(4)]
        assert parse_corr(ids_a[-1]) == ("x", 3, 4)
        assert parse_corr(make_corr("a#b", 1, 2)) == ("a#b", 1, 2)

    def test_live_corr_and_done_guard(self):
        rec = TraceRecorder(rank=0)
        corr = rec.record_enqueue("t", "broadcast", 4, 0)
        assert rec.live_corr("t") == corr
        rec.record_done("t")
        assert rec.live_corr("t") is None
        before = len(rec.segment()["events"])
        rec.record_done("t")
        rec.record_done("never")
        assert len(rec.segment()["events"]) == before

    def test_ring_is_bounded_and_counts_drops(self):
        rec = TraceRecorder(rank=0, capacity=32)
        for i in range(100):
            rec.record_enqueue(f"n{i}", "allreduce", 1, 0)
        seg = rec.segment()
        assert len(seg["events"]) == 32
        assert seg["dropped"] == 68

    def test_segment_byte_cap_drops_oldest(self):
        rec = TraceRecorder(rank=0, capacity=512)
        for i in range(512):
            rec.record_enqueue(f"tensor.name.{i:04d}", "allreduce", 1, 0)
        seg = rec.segment(max_bytes=8192)
        assert len(json.dumps(seg)) <= 8192
        assert seg["events"]
        assert seg["events"][-1]["n"] == "tensor.name.0511"
        assert seg["dropped"] >= 512 - len(seg["events"])


# ---------------------------------------------------------------------------
# merger + clock alignment
# ---------------------------------------------------------------------------

def _segments(mod, late=0.02, names=("s",), beacons=(True, True)):
    """Two ranks' segments of ``mod``'s recorder: each name enqueued,
    rank 1 ``late`` seconds after rank 0, with a beacon where asked."""
    segs = {}
    now = 1000.0
    for r in (0, 1):
        rec = mod.TraceRecorder(rank=r)
        with _frozen_monotonic(now + late * r, mod):
            for n in names:
                rec.record_enqueue(n, "broadcast", 8, 0)
                rec.record_dispatch(n, "XLA_DISPATCH", 0.001)
                rec.record_step(begin=True)
                rec.record_done(n)
                rec.record_step(begin=False)
        if beacons[r]:
            rec.add_beacon(now, 100.0 + now, 0.001)
        segs[r] = rec.segment()
    return segs


class TestMerger:
    def test_pid_remap_and_balance(self):
        segs = {}
        for r in (0, 1):
            rec = TraceRecorder(rank=r)
            _exercise(rec)
            now = time.monotonic()
            rec.add_beacon(now, 1e6 + now, 0.001)
            segs[r] = rec.segment()
        events = merge_segments(segs)
        assert {e["pid"] for e in events} == {0, 1}
        labels = [e["args"]["name"] for e in events
                  if e.get("ph") == "M" and e["name"] == "process_name"]
        assert labels == ["rank 0", "rank 1"]
        for pid in (0, 1):
            per_tid = {}
            for e in events:
                if e["pid"] == pid and e.get("ph") in ("B", "E"):
                    per_tid.setdefault(e["tid"], []).append(e["ph"])
            assert per_tid
            for phases in per_tid.values():
                assert phases.count("B") == phases.count("E")

    def test_clock_alignment_recovers_injected_offset(self):
        offset = 100.0
        segs = {}
        base = time.monotonic()
        for r, (shift, late) in enumerate([(0.0, 0.0), (-offset, 0.010)]):
            rec = TraceRecorder(rank=r)
            with _frozen_monotonic(base + late + shift):
                rec.record_enqueue("g", "allreduce", 8, 0)
            rec.add_beacon(base + shift, 5000.0 + base, 0.002)
            segs[r] = rec.segment()
        (corr, ent), = collective_skew(segs).items()
        assert ent["last_rank"] == 1
        assert abs(ent["skew"] - 0.010) < 0.005, ent

    def test_min_rtt_beacon_wins(self):
        assert clock_offset([(10.0, 1000.0, 0.5),
                             (10.0, 500.0, 0.001)]) == 490.0
        assert clock_offset([]) is None

    def test_truncated_ring_seals_open_spans(self):
        rec = TraceRecorder(rank=2)
        rec.record_enqueue("hung", "allreduce", 8, 0)
        events = merge_segments({2: rec.segment()})
        bs = [e for e in events if e.get("ph") == "B"]
        es = [e for e in events if e.get("ph") == "E"]
        assert len(bs) == len(es) == 1
        assert es[0]["args"]["truncated"] is True
        rec2 = TraceRecorder(rank=3)
        rec2._live["ghost"] = "ghost#0#1"
        rec2.record_done("ghost")
        events2 = merge_segments({3: rec2.segment()})
        assert not [e for e in events2 if e.get("ph") in ("B", "E")]

    def test_render_skips_garbage_payloads_and_observes_skew(self):
        segs = {str(r): json.dumps(s).encode()
                for r, s in _segments(trace_mod).items()}
        segs["9"] = b"not json at all"
        segs["8"] = b'{"no": "events"}'
        reg = Registry(enabled=True)
        obj = json.loads(render_cluster_trace(segs, reg=reg))
        assert obj["otherData"]["ranks"] == [0, 1]
        assert obj["otherData"]["straggler_rank"] == 1
        snap = reg.histogram("hvd_tpu_collective_skew_seconds")._snap()
        assert snap and snap[0][1]["count"] == 1
        assert reg.gauge("hvd_tpu_straggler_rank").value() == 1.0

    def test_unaligned_rank_is_excluded_from_skew(self):
        segs = _segments(trace_mod, beacons=(True, False))
        assert collective_skew(segs) == {}
        labels = {e["pid"]: e["args"]["name"] for e in merge_segments(segs)
                  if e.get("ph") == "M" and e["name"] == "process_name"}
        assert labels == {0: "rank 0", 1: "rank 1 (unaligned)"}

    def test_repeat_scrapes_observe_each_collective_once(self):
        segs = {str(r): json.dumps(s).encode()
                for r, s in _segments(trace_mod, names=("w", "w")).items()}
        reg = Registry(enabled=True)
        watermark = {}
        for _ in range(3):
            render_cluster_trace(segs, reg=reg, watermark=watermark)
        ((_, agg),) = reg.histogram(
            "hvd_tpu_collective_skew_seconds")._snap()
        assert agg["count"] == 2, agg
        assert watermark == {"w": (0, 2)}


@pytest.mark.parametrize("late,names,beacons", [
    (0.02, ("s",), (True, True)),
    (0.0, ("a", "b", "a"), (True, True)),
    (0.05, ("x", "y"), (True, False)),
])
def test_pure_functions_match_the_reference(late, names, beacons):
    """Segments recorded alike by both recorders merge, skew and name a
    straggler alike."""
    ours = _segments(trace_mod, late, names, beacons)
    ref = _segments(ref_trace, late, names, beacons)
    assert ours == ref
    assert merge_segments(ours) == ref_trace.merge_segments(ref)
    skew = collective_skew(ours)
    assert skew == ref_trace.collective_skew(ref)
    assert modal_straggler(skew) == ref_trace.modal_straggler(skew)
    regs = (Registry(enabled=True), ref_trace_registry())
    assert observe_skew(skew, regs[0], {}) == \
        ref_trace.observe_skew(skew, regs[1], {})
    assert regs[0].snapshot()["histograms"] == \
        regs[1].snapshot()["histograms"]
    payloads = {str(r): json.dumps(s) for r, s in ours.items()}
    assert render_cluster_trace(payloads) == \
        ref_trace.render_cluster_trace(payloads)


def ref_trace_registry():
    from horovod_tpu.metrics import Registry as RefRegistry
    return RefRegistry(enabled=True)


class TestTolerantLoader:
    def test_object_array_and_truncated_forms(self):
        events = [{"ph": "B", "ts": 1.0, "pid": 0, "tid": 1},
                  {"ph": "E", "ts": 2.0, "pid": 0, "tid": 1}]
        assert load_trace_events(json.dumps({"traceEvents": events})) \
            == events
        assert load_trace_events(json.dumps(events)) == events
        text = json.dumps(events)
        cut = text.index('{"ph": "E"') + 5
        assert load_trace_events(text[:cut]) == events[:1]
        nd = "\n".join(json.dumps(e) for e in events)
        assert load_trace_events(nd) == events
        assert load_trace_events("") == []


class TestFlightRecorder:
    def test_dump_is_valid_single_rank_chrome_trace(self, tmp_path):
        rec = TraceRecorder(rank=1)
        _exercise(rec)
        rec.record_enqueue("hung.op", "allreduce", 8, 0)
        path = rec.dump(str(tmp_path / "sub" / "flight.json"))
        with open(path) as f:
            obj = json.load(f)
        assert obj["otherData"]["flight_recorder"] is True
        assert obj["otherData"]["rank"] == 1
        evs = obj["traceEvents"]
        assert {e["pid"] for e in evs if "pid" in e} == {1}
        sealed = [e for e in evs if e.get("ph") == "E"
                  and e.get("args", {}).get("truncated")]
        assert len(sealed) == 1
        assert load_trace_file(path) == evs
        sys.path.insert(0, TOOLS)
        try:
            import trace_report
            assert trace_report.check_events(evs) == []
        finally:
            sys.path.remove(TOOLS)


# ---------------------------------------------------------------------------
# engine wiring
# ---------------------------------------------------------------------------

@pytest.fixture
def world(monkeypatch):
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_TPU_TRACE"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        yield global_state()
    finally:
        hvd.shutdown()


class TestEngineWiring:
    def test_engine_records_all_three_phases(self, world):
        assert world.trace_recorder is not None
        assert world.engine.trace is world.trace_recorder
        hvd.allreduce(torch.ones(4), name="wired.a", op=hvd.Sum)
        evs = world.trace_recorder.segment()["events"]
        phases = [e["p"] for e in evs if e.get("n") == "wired.a"]
        assert phases == ["enq", "dis", "done"]
        enq = next(e for e in evs
                   if e.get("n") == "wired.a" and e["p"] == "enq")
        name, wv, seq = parse_corr(enq["c"])
        assert (name, seq) == ("wired.a", 1)
        assert wv == world.engine.world_version

    def test_trace_disabled_leaves_engine_hook_none(self, monkeypatch):
        monkeypatch.setenv("HOROVOD_TPU_TRACE", "0")
        hvd.init(device="cpu")
        try:
            gs = global_state()
            assert gs.engine.trace is None
            assert gs.trace_recorder is None
            out = hvd.allreduce(torch.ones(2), name="off.a", op=hvd.Sum)
            assert float(out[0]) == hvd.size()
        finally:
            hvd.shutdown()

    def test_flight_dump_lands_in_the_dump_dir(self, world, tmp_path):
        world.config.trace_dump_dir = str(tmp_path)
        hvd.allreduce(torch.ones(2), name="fd.a", op=hvd.Sum)
        path = world._dump_flight_ring()
        assert path == str(tmp_path / "hvd_tpu_flight_rank0.json")
        evs = load_trace_file(path)
        assert any(e.get("args", {}).get("tensor") == "fd.a" for e in evs)


def _ref_tensor(x, bf16=False):
    t = jnp.asarray(x)
    return t.astype(jnp.bfloat16) if bf16 else t


def _torch_tensor(x, bf16=False):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if bf16 else t


def test_size1_event_sequences_match_the_reference(monkeypatch):
    """The metrics parity sequence with a fresh recorder in each engine:
    the same (phase, kind, name, bytes, corr) enqueue and dispatch events
    in the same order, and the same completions."""
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_TPU_STEP_REPLAY",
                "HOROVOD_TPU_WORLD_VERSION"):
        monkeypatch.delenv(var, raising=False)
    ref_hvd.init()
    hvd.init(device="cpu")
    ref_eng, eng = ref_hvd._engine(), port_engine()
    saved = (ref_eng.trace, ref_eng.config.fusion_threshold_bytes,
             ref_eng.config.step_replay_warmup, ref_eng.config.step_replay,
             ref_eng.world_version)
    try:
        seqs = []
        for pkg, e, tensor, mod in ((ref_hvd, ref_eng, _ref_tensor,
                                     ref_trace),
                                    (hvd, eng, _torch_tensor, trace_mod)):
            e.config.fusion_threshold_bytes = 64
            e.config.step_replay_warmup = 3
            e.config.step_replay = True
            e.replay.invalidate_all("test isolation")
            e.replay._step_token = 0
            # the corr ids carry the world version: the reference's engine
            # is the process's, and an earlier test may have moved it on
            e.world_version = 0
            e.trace = rec = mod.TraceRecorder(rank=0)
            obs_sequence(pkg, e, tensor, 0, 1)
            evs = rec.segment(max_bytes=1 << 30)["events"]
            ordered = [(ev["p"], ev.get("k"), ev.get("n"), ev.get("b"),
                        ev.get("c")) for ev in evs
                       if ev["p"] in ("enq", "step", "step_end")]
            dispatched = [ev["n"] for ev in evs if ev["p"] == "dis"]
            done = sorted(ev["c"] for ev in evs if ev["p"] == "done")
            seqs.append((ordered, dispatched, done))
        (ref_o, ref_d, ref_done), (o, d, done) = seqs
        assert o == ref_o
        assert d == ref_d
        assert set(done) <= set(ref_done)
        assert any(n and n.startswith("replay.step.") for _, _, n, _, _ in o)
    finally:
        ref_eng.replay.invalidate_all("test isolation")
        (ref_eng.trace, ref_eng.config.fusion_threshold_bytes,
         ref_eng.config.step_replay_warmup, ref_eng.config.step_replay,
         ref_eng.world_version) = saved
        hvd.shutdown()
