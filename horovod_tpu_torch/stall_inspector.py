"""Stall inspector and collective watchdog (the port's copy of
``horovod_tpu/stall_inspector.py``; parity: horovod/common/
stall_inspector.{h,cc}).

The local layer: any op enqueued but not completed past the warning
threshold (``HOROVOD_STALL_CHECK_TIME_SECONDS``, 60 s) is reported once;
past the shutdown threshold (``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``) the
process aborts after a flight dump. With ``HOROVOD_TPU_COLLECTIVE_DEADLINE``
set, an op outstanding past the deadline is escalated instead: a flight
dump, then the ``escalate`` hook (which poisons the engine), then every
armed fault ``hang()`` is broken with the same ``HorovodInternalError``.

The cross-rank layer (when launched with a rendezvous KV): every rank
periodically publishes its stale outstanding set, its step heartbeat and
its replay fallbacks to the KV (``stall/<rank>``), directly or through its
slice aggregator; rank 0 reads every report (O(slices) rollups on a
hierarchical topology), names the ranks missing which tensors and the
ranks that stopped heartbeating or publishing, and, with a deadline set,
escalates on a peer whose heartbeat froze while it kept publishing.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from .common.exceptions import HorovodInternalError
from .faults import DROP, failpoint
from .metrics import registry as metrics_registry

logger = logging.getLogger("horovod_tpu_torch")

KV_SCOPE = "stall"

# consecutive publish failures before the first WARNING; later warnings
# back off exponentially (2x the streak each time) instead of per-tick spam
PUBLISH_FAIL_WARN_AFTER = 3


class StallInspector:
    """Local and cross-rank stall detection, and, when ``collective_deadline`` is set
    (``HOROVOD_TPU_COLLECTIVE_DEADLINE``), the **collective watchdog**: a
    hang that outlives the deadline is escalated instead of merely warned
    about. Escalation poisons the engine (the ``escalate`` hook wired by
    ``GlobalState``) and breaks any armed fault hangs with
    ``HorovodInternalError``, so an infinite stall becomes the exception an
    elastic loop restores and retries from."""

    # every attribute below is written by the user/engine threads
    # (record_*) and read by the watch thread: one lock covers the lot.
    # The streak counters (_pub_fail_*, _cross_warned, _escalated) are
    # watch-thread-private and intentionally unguarded.
    _GUARDED_BY = {
        "_outstanding": "_lock",
        "_warned": "_lock",
        "_heartbeat_step": "_lock",
        "_heartbeat_time": "_lock",
        "_hb_idle": "_lock",
        "replay_fallbacks": "_lock",
        "_replay_reasons": "_lock",
    }

    def __init__(self, warning_seconds: float = 60.0,
                 shutdown_seconds: float = 0.0,
                 check_interval: float = 5.0,
                 kv: Optional[Tuple[str, int]] = None,
                 rank: int = 0, size: int = 1,
                 collective_deadline: float = 0.0,
                 escalate: Optional[Callable[[Exception], None]] = None,
                 flight_dump: Optional[Callable[[], Optional[str]]] = None,
                 route=None, topology=None, agg_interval: float = 5.0):
        self.warning_seconds = warning_seconds
        self.shutdown_seconds = shutdown_seconds
        self.collective_deadline = collective_deadline
        self.escalate = escalate
        # publishes ride the slice aggregator through the shared
        # TelemetryRoute, and rank 0's sweep reads O(slices) stall rollups
        # instead of O(N) rank keys when a hierarchical topology is wired
        # (flat topologies keep the direct path). agg_interval bounds how
        # stale a healthy rollup's per-rank report can legitimately be.
        self.route = route
        self.topology = topology
        self.agg_interval = max(float(agg_interval), 0.05)
        # flight recorder (trace.py, wired by GlobalState): called once,
        # before the escalate hook poisons the engine (and before a
        # shutdown-tier abort), to dump the last-N trace spans to disk
        self.flight_dump = flight_dump
        if collective_deadline > 0:
            # the watchdog must FIRE within the deadline, so the tick must
            # undercut it; disabled-deadline jobs keep the coarse cadence
            check_interval = min(check_interval,
                                 max(collective_deadline / 4.0, 0.05))
        self.check_interval = check_interval
        self.kv = kv
        self.rank = rank
        self.size = size
        self._escalated = False
        self._lock = threading.Lock()
        self._outstanding: Dict[str, float] = {}
        self._warned: set = set()
        # step-capture replay fallbacks (core/replay.py), counted by
        # reason: the count rides the cross-rank liveness report
        self.replay_fallbacks = 0
        self._replay_reasons: Dict[str, int] = {}
        # KV publish health: track the consecutive-failure streak, escalate
        # to WARNING with exponential backoff and count into the registry,
        # so a dead rendezvous never leaves the attribution silently blind
        self._pub_fail_streak = 0
        self._pub_fail_warn_at = PUBLISH_FAIL_WARN_AFTER
        _reg = metrics_registry()
        self._m_pub_failures = _reg.counter(
            "hvd_tpu_stall_publish_failures_total")
        self._m_stalled = _reg.gauge("hvd_tpu_stall_stalled_tensors")
        self._m_escalations = _reg.counter(
            "hvd_tpu_watchdog_escalations_total")
        self._heartbeat_step = -1
        self._heartbeat_time = time.time()
        self._hb_idle = False
        self._cross_warned: set = set()
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._watch, name="hvd-stall",
                                        daemon=True)
        self._thread.start()

    def record_enqueue(self, name: str):
        with self._lock:
            self._outstanding[name] = time.monotonic()

    def record_done(self, name: str):
        with self._lock:
            self._outstanding.pop(name, None)
            self._warned.discard(name)

    def record_replay_fallback(self, reason: str):
        """Count a step-replay fallback (a bounded histogram of reasons)."""
        with self._lock:
            self.replay_fallbacks += 1
            if reason in self._replay_reasons or \
                    len(self._replay_reasons) < 64:
                self._replay_reasons[reason] = \
                    self._replay_reasons.get(reason, 0) + 1

    def replay_fallback_reasons(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._replay_reasons)

    def record_heartbeat(self, step: Optional[int] = None):
        """Liveness signal: call once per train step (``hvd.step_heartbeat``).
        A rank whose heartbeat stops advancing while peers' do is reported
        by rank 0's aggregation (stall_inspector.h:70-92 role)."""
        with self._lock:
            self._heartbeat_step = self._heartbeat_step + 1 if step is None \
                else int(step)
            self._heartbeat_time = time.time()

    def set_heartbeat_idle(self, idle: bool):
        """Mark this rank's frozen heartbeat as INTENTIONAL (parked in
        ``hvd.join()``, a long eval or checkpoint). Published with the
        liveness report; the watchdog's peer leg skips idle peers instead
        of poisoning a healthy world over a rank that ran out of data."""
        with self._lock:
            self._hb_idle = bool(idle)

    def stalled_tensors(self):
        now = time.monotonic()
        with self._lock:
            return [(n, now - t) for n, t in self._outstanding.items()
                    if now - t > self.warning_seconds]

    def stop(self, join: bool = True):
        """Stop the watch thread. With ``join`` (default) also wait for it
        to exit, so no publish or sweep of a stopped inspector races
        whatever comes next (re-init, tests, armed failpoints)."""
        self._stop_evt.set()
        if join and self._thread.is_alive() and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout=10)

    # -- cross-rank attribution via the rendezvous KV -----------------------

    def _publish(self):
        from .runner.http_client import (KVBackpressure, count_shed_bytes,
                                         put_data_into_kvstore)
        now = time.monotonic()
        with self._lock:
            # Publish only tensors already stale locally: an op merely in
            # flight on one rank while completed on another is normal
            # asynchrony, not a stall — the reference likewise warns only
            # past the warning threshold (stall_inspector.h:75).
            stale = sorted(n for n, t in self._outstanding.items()
                           if now - t > self.warning_seconds)
            payload = {"ts": time.time(),
                       "outstanding": stale,
                       "hb_step": self._heartbeat_step,
                       "hb_ts": self._heartbeat_time,
                       "hb_idle": self._hb_idle,
                       "replay_fallbacks": self.replay_fallbacks}
        try:
            # drop() models the insidious silently-lost write; raise()/
            # delay() exercise the retry + WARNING-escalation machinery
            if failpoint("stall.publish") is DROP:
                return
            # one in-call retry (retries=1): publishes are periodic, so a
            # long backoff would just delay the next tick — the streak
            # logic above owns persistent-outage escalation
            encoded = json.dumps(payload).encode()
            try:
                if self.route is not None:
                    self.route.put("stall", KV_SCOPE, str(self.rank),
                                   encoded, timeout=5)
                else:
                    put_data_into_kvstore(self.kv[0], self.kv[1], KV_SCOPE,
                                          str(self.rank), encoded, timeout=5,
                                          retries=1)
            except KVBackpressure:
                # deliberate server shedding (scope byte budget) — not an
                # outage: count the shed bytes, skip this tick, and leave
                # the failure streak alone (the server is alive)
                count_shed_bytes(KV_SCOPE, len(encoded))
                return
        except Exception as e:
            self._pub_fail_streak += 1
            self._m_pub_failures.inc()
            if self._pub_fail_streak >= self._pub_fail_warn_at:
                logger.warning(
                    "stall-inspector KV publish to %s:%s has failed %d "
                    "consecutive times (last: %s); cross-rank stall "
                    "attribution is blind until it recovers.",
                    self.kv[0], self.kv[1], self._pub_fail_streak, e)
                self._pub_fail_warn_at *= 2   # backoff, not per-tick spam
            else:
                logger.debug("stall publish failed: %s", e)
        else:
            self._pub_fail_streak = 0
            self._pub_fail_warn_at = PUBLISH_FAIL_WARN_AFTER

    def _read_reports(self, timeout: float = 1.0) -> Dict[int, dict]:
        """Fetch every rank's liveness report from the KV (best-effort;
        absent/unparseable ranks are skipped).

        Hierarchical path: with a multislice topology and a
        telemetry route wired, read the O(slices) ``agg/stall/<slice>``
        rollups and reconstruct per-rank reports from them — the O(N)
        per-sweep KV load becomes O(slices). Ranks a
        rollup does not cover freshly (fallback ranks, a dead aggregator's
        whole slice) are direct-read individually, so stall detection
        survives the aggregator tier dying; a stale rollup report is still
        kept when the direct read also fails (its old timestamp is exactly
        what the silent-rank warning needs). Flat topologies keep the
        direct O(N) sweep."""
        from .runner.http_client import read_data_from_kvstore
        reports: Dict[int, dict] = {}
        stale: Dict[int, dict] = {}
        topo = self.topology
        if topo is not None and getattr(topo, "hierarchical_ok", False) and \
                self.route is not None:
            # a rollup report is legitimately behind by up to one publish
            # cadence plus one rollup cadence; past 3x that it is stale
            # enough to re-check directly
            stale_after = 3.0 * (self.check_interval + self.agg_interval)
            now = time.time()
            for k in range(topo.num_slices):
                try:
                    # short timeout: a missing rollup key long-polls, and
                    # a degraded tier must not stretch the sweep by
                    # num_slices x timeout
                    raw = read_data_from_kvstore(
                        self.kv[0], self.kv[1], "agg", f"stall/{k}",
                        timeout=min(timeout, 0.3), poll_interval=0.1)
                    roll = json.loads(raw)
                except Exception:
                    continue
                out_map = roll.get("outstanding", {})
                for r_s, rep in roll.get("reports", {}).items():
                    try:
                        r = int(r_s)
                    except ValueError:
                        continue
                    rep = dict(rep)
                    rep["outstanding"] = sorted(
                        n for n, rs in out_map.items() if r in rs)
                    if now - rep.get("ts", 0.0) <= stale_after:
                        reports[r] = rep
                    else:
                        stale[r] = rep
        for r in range(self.size):
            if r in reports:
                continue
            try:
                raw = read_data_from_kvstore(self.kv[0], self.kv[1], KV_SCOPE,
                                             str(r), timeout=timeout,
                                             poll_interval=0.1)
                reports[r] = json.loads(raw)
            except Exception:
                if r in stale:
                    reports[r] = stale[r]
                continue
        return reports

    def _aggregate(self, reports: Dict[int, dict]):
        """Rank 0: attribute stalls to ranks from every rank's report
        (reference: stall_inspector.cc builds 'missing ranks' per tensor)."""
        now = time.time()
        # bound the dedup set: unique per-step tensor names would otherwise
        # grow it for the life of the job
        if len(self._cross_warned) > 4096:
            self._cross_warned.clear()
        # tensors stalled on some ranks but never submitted on others
        all_outstanding: Dict[str, list] = {}
        for r, rep in reports.items():
            for name in rep.get("outstanding", ()):
                all_outstanding.setdefault(name, []).append(r)
        for name, have in sorted(all_outstanding.items()):
            missing = [r for r in reports if r not in have]
            key = ("tensor", name, tuple(missing))
            if missing and key not in self._cross_warned:
                self._cross_warned.add(key)
                logger.warning(
                    "Tensor %s was submitted by ranks %s but is missing on "
                    "ranks %s — those ranks may have stopped contributing "
                    "(stall_inspector.h:75 analog).", name, sorted(have),
                    missing)
        # stale heartbeats: a rank whose step stopped advancing
        active = [r for r, rep in reports.items()
                  if rep.get("hb_step", -1) >= 0]
        if len(active) >= 2:
            newest = max(reports[r]["hb_ts"] for r in active)
            for r in active:
                age = newest - reports[r]["hb_ts"]
                key = ("hb", r, reports[r]["hb_step"])
                if age > self.warning_seconds and key not in self._cross_warned:
                    self._cross_warned.add(key)
                    logger.warning(
                        "Rank %d last advanced its train step (step %d) "
                        "%.0f s before its peers — it may be hung inside the "
                        "jitted step.", r, reports[r]["hb_step"], age)
        # ranks that stopped publishing entirely
        for r, rep in reports.items():
            age = now - rep.get("ts", now)
            key = ("silent", r)
            if age > max(self.warning_seconds, 3 * self.check_interval) and \
                    key not in self._cross_warned:
                self._cross_warned.add(key)
                logger.warning(
                    "Rank %d has not reported liveness for %.0f s — process "
                    "may be dead or wedged.", r, age)

    # -- collective watchdog (HOROVOD_TPU_COLLECTIVE_DEADLINE) --------------

    def _escalate(self, reason: str):
        """One-shot deadline escalation: convert a hang into the exception
        the elastic run-loop already recovers from. Counts + logs, runs the
        ``escalate`` hook (GlobalState wires engine poisoning there), and
        breaks any armed fault-injection hangs with the same error."""
        if self._escalated:
            return
        self._escalated = True
        self._m_escalations.inc()
        self._run_flight_dump()
        err = HorovodInternalError(
            f"collective watchdog: {reason} (HOROVOD_TPU_COLLECTIVE_"
            f"DEADLINE={self.collective_deadline:g}s). Aborting local "
            f"collectives so the elastic run-loop can restore the last "
            f"committed state and re-rendezvous.")
        logger.error("%s", err)
        if self.escalate is not None:
            try:
                self.escalate(err)
            # errflow: ignore[escalation must continue to break_hangs even when the poison hook fails; the failure is WARNING-logged]
            except Exception as e:
                logger.warning("watchdog escalation hook failed: %s", e)
        from . import faults
        faults.break_hangs(err)

    def _run_flight_dump(self):
        """Best-effort flight-recorder dump (never blocks an escalation on
        a disk failure)."""
        if self.flight_dump is None:
            return
        try:
            path = self.flight_dump()
            if path:
                logger.warning("flight recorder: trace ring dumped to %s",
                               path)
        # errflow: ignore[flight dump is best-effort: an escalation is never blocked on a disk failure (WARNING-logged)]
        except Exception as e:
            logger.warning("flight-recorder dump failed: %s", e)

    def _check_collective_deadline(self, items, now: float):
        """Local leg: an op enqueued but not completed past the deadline is
        a wedged collective (this rank, or a peer it is waiting on)."""
        for name, t0 in items:
            age = now - t0
            if age > self.collective_deadline:
                self._escalate(
                    f"tensor {name!r} has been outstanding for {age:.1f}s "
                    f"with no completion")
                return

    def _check_peer_heartbeats(self, reports: Dict[int, dict]):
        """Cross-rank leg: a peer whose step heartbeat stopped advancing
        past the deadline while its publisher kept running is hung inside
        its step. Runs on rank 0 only, off the report sweep it already
        performs for attribution — every rank sweeping would put O(N^2)
        GETs per tick on the one rendezvous server. Rank 0's escalation
        recovers the whole world: its poisoned engine fails its next
        collective, which surfaces on every peer as the usual failed-
        collective HorovodInternalError.

        Skew-safe: a peer's staleness is ``rep["ts"] - rep["hb_ts"]`` —
        both stamped by the SAME remote clock at publish time — never a
        cross-host clock comparison (an NTP-skewed host must not trigger a
        cluster-wide false abort). Gated on local evidence the world is
        ACTIVE, not idle: this rank's own heartbeat is fresh (it is still
        stepping) OR it has ops outstanding (it is blocked waiting on the
        hung peer). A lockstep SPMD world where every rank froze inside
        the same jitted step shows neither signal and cannot be recovered
        in-process anyway (no Python edge left to raise from) — that
        terminal case belongs to HOROVOD_STALL_SHUTDOWN_TIME_SECONDS
        (process abort + driver relaunch)."""
        with self._lock:
            own_active = (bool(self._outstanding) or
                          (self._heartbeat_step >= 0 and
                           time.time() - self._heartbeat_time <=
                           self.collective_deadline))
        if not own_active:
            return
        for r, rep in reports.items():
            if r == self.rank or rep.get("hb_step", -1) < 0 or \
                    rep.get("hb_idle"):
                # hb_idle: the rank declared its frozen heartbeat
                # intentional (parked in join(), eval, checkpoint)
                continue
            age = rep.get("ts", 0.0) - rep.get("hb_ts", 0.0)
            if age > self.collective_deadline:
                self._escalate(
                    f"rank {r} kept publishing liveness but last advanced "
                    f"its heartbeat (step {rep['hb_step']}) {age:.1f}s "
                    f"earlier — it is likely hung inside its step")
                return

    def _watch(self):
        # Event-paced (not time.sleep): stop() wakes the loop immediately,
        # so shutdown never waits out a long check interval
        while not self._stop_evt.wait(self.check_interval):
            now = time.monotonic()
            with self._lock:
                items = list(self._outstanding.items())
                # membership must be read under the same lock that
                # record_done() discards under: an off-lock read races the
                # discard and could re-warn a tensor that had completed
                warned = set(self._warned)
            self._m_stalled.set(sum(
                1 for _, t0 in items if now - t0 > self.warning_seconds))
            for name, t0 in items:
                age = now - t0
                if age > self.warning_seconds and name not in warned:
                    with self._lock:
                        if name not in self._outstanding:
                            # completed while this sweep ran: warning it
                            # now would be noise, and the _warned entry
                            # would leak forever (record_done already did
                            # its discard), suppressing a REAL stall of a
                            # later op reusing the name
                            continue
                        self._warned.add(name)
                    logger.warning(
                        "One or more tensors were submitted to be "
                        "reduced/gathered but have not completed for "
                        "%.0f s: %s. This may indicate a rank that stopped "
                        "contributing (stall_inspector.h:75 analog).", age,
                        name)
                if self.shutdown_seconds > 0 and age > self.shutdown_seconds:
                    logger.error("Stalled tensor %s exceeded shutdown threshold "
                                 "%.0f s; aborting.", name, self.shutdown_seconds)
                    self._run_flight_dump()
                    os._exit(64)
            if self.collective_deadline > 0 and not self._escalated:
                self._check_collective_deadline(items, now)
            if self.kv is not None and self.size > 1:
                self._publish()
                # rank 0 only: ONE report sweep per tick, shared by the
                # watchdog's peer leg and the stall attribution — non-zero
                # ranks never sweep (their watchdog is the local leg), so
                # per-tick KV load stays O(N)
                if self.rank == 0:
                    reports = self._read_reports(timeout=1.0)
                    if self.collective_deadline > 0 and \
                            not self._escalated:
                        self._check_peer_heartbeats(reports)
                    self._aggregate(reports)
