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
The heartbeat (``hvd.step_heartbeat``) and replay's fallback reasons are
kept for the cross-rank layer: publishing liveness reports to the
rendezvous KV, rank 0's attribution of missing tensors and silent ranks,
and the watchdog's peer-heartbeat leg come with ROADMAP A14b.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

from .common.exceptions import HorovodInternalError
from .metrics import registry as metrics_registry

logger = logging.getLogger("horovod_tpu_torch")


class StallInspector:
    """Local stall detection, and, when ``collective_deadline`` is set
    (``HOROVOD_TPU_COLLECTIVE_DEADLINE``), the **collective watchdog**: a
    hang that outlives the deadline is escalated instead of merely warned
    about. Escalation poisons the engine (the ``escalate`` hook wired by
    ``GlobalState``) and breaks any armed fault hangs with
    ``HorovodInternalError``, so an infinite stall becomes the exception an
    elastic loop restores and retries from."""

    # every attribute below is written by the user/engine threads
    # (record_*) and read by the watch thread: one lock covers the lot.
    # _escalated is watch-thread-private.
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
                 collective_deadline: float = 0.0,
                 escalate: Optional[Callable[[Exception], None]] = None,
                 flight_dump: Optional[Callable[[], Optional[str]]] = None):
        self.warning_seconds = warning_seconds
        self.shutdown_seconds = shutdown_seconds
        self.collective_deadline = collective_deadline
        self.escalate = escalate
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
        self._escalated = False
        self._lock = threading.Lock()
        self._outstanding: Dict[str, float] = {}
        self._warned: set = set()
        # step-capture replay fallbacks (core/replay.py), counted by reason
        self.replay_fallbacks = 0
        self._replay_reasons: Dict[str, int] = {}
        _reg = metrics_registry()
        self._m_stalled = _reg.gauge("hvd_tpu_stall_stalled_tensors")
        self._m_escalations = _reg.counter(
            "hvd_tpu_watchdog_escalations_total")
        self._heartbeat_step = -1
        self._heartbeat_time = time.time()
        self._hb_idle = False
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
        The cross-rank layer reads it (ROADMAP A14b)."""
        with self._lock:
            self._heartbeat_step = self._heartbeat_step + 1 if step is None \
                else int(step)
            self._heartbeat_time = time.time()

    def set_heartbeat_idle(self, idle: bool):
        """Mark this rank's frozen heartbeat as INTENTIONAL (parked in
        ``hvd.join()``, a long eval or checkpoint), so the cross-rank
        watchdog leg skips it instead of poisoning a healthy world over a
        rank that ran out of data."""
        with self._lock:
            self._hb_idle = bool(idle)

    def stalled_tensors(self):
        now = time.monotonic()
        with self._lock:
            return [(n, now - t) for n, t in self._outstanding.items()
                    if now - t > self.warning_seconds]

    def stop(self, join: bool = True):
        """Stop the watch thread. With ``join`` (default) also wait for it
        to exit, so no sweep of a stopped inspector races whatever comes
        next (re-init, tests, armed failpoints)."""
        self._stop_evt.set()
        if join and self._thread.is_alive() and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout=10)

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
            # escalation must go on to break_hangs even when the poison
            # hook fails; the failure is logged
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
