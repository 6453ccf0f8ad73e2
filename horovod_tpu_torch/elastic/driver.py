"""Elastic driver: membership polling, rank assignment, worker lifecycle.

The port's copy of ``horovod_tpu/elastic/driver.py``, line for line: plain
Python, no torch.

Parity: reference ``horovod/runner/elastic/driver.py`` (ElasticDriver:
discovery thread at driver.py:176-195, _activate_workers at :169-174,
_handle_worker_exit → record failure → blacklist → resume at :291-307,
worker notification at :197-225) rebuilt on the HTTP KV fabric.

Worker lifecycle (same as reference): worker *processes* survive membership
changes — on a reset they re-rendezvous in-process (``hvd.shutdown();
hvd.init()``) and pick up a new rank. The driver starts processes only for
newly-added slots and records exits.

Resume protocol (replaces the reference's rendezvous versioning):

1. A failure (worker exit ≠ 0) or relevant membership change marks a resume
   *pending*. While pending, ``get_slot_info`` returns None, so re-rendezvous
   GETs long-poll (404) instead of reading the dying world's plan.
2. Live workers hit the rendezvous (READY); dead ones are recorded by their
   process monitors (FAILURE). Once every worker of the old world is
   accounted for, the registry barrier calls ``resume()``.
3. ``resume()`` recomputes assignments from current membership, publishes the
   new plan (clearing the stale coordinator address atomically with it),
   and launches workers for newly-added slots.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..common.env import (HOROVOD_ELASTIC_FAILURE_BACKOFF,
                          HOROVOD_ELASTIC_SLOT_FAILURE_LIMIT, _get_float,
                          _get_int)
from ..faults import failpoint
from ..metrics import registry as metrics_registry
from ..runner.hosts import HostInfo, SlotInfo, get_host_assignments
from .discovery import HostDiscovery, HostManager, HostUpdateResult
from .registration import WorkerStateRegistry

_LOG = logging.getLogger("horovod_tpu_torch.elastic")

DISCOVER_HOSTS_FREQUENCY_SECS = 1.0
ELASTIC_TIMEOUT_SECS = 600.0

# Slot-failure backoff: a slot that fails
# repeatedly within this window is suspended with exponential backoff
# instead of being re-admitted into every rebuilt world (and excluded for
# good past the strike limit). The first failure is always free — that is
# the normal crash-recovery relaunch path.
SLOT_STRIKE_WINDOW_SECS = 600.0
SLOT_BACKOFF_CAP_SECS = 300.0
DEFAULT_SLOT_FAILURE_BACKOFF_SECS = 5.0
DEFAULT_SLOT_FAILURE_LIMIT = 4


class ElasticDriver:
    # lock discipline (tools/check.py lockcheck): world state is written
    # by the discovery thread, resume threads, and the rendezvous/process-
    # monitor callbacks — everything below rides the one RLock. _m_events
    # is a metrics EventLog with its own internal lock.
    _GUARDED_BY = {
        "_assignments": "_lock",
        "_started_slots": "_lock",
        "_pending_resume": "_lock",
        "_results": "_lock",
        "_slot_strikes": "_lock",
        "_error_message": "_lock",
        "_world_version": "_lock",
        "_last_notify": "_lock",
        "_m_events": "<internal>",
    }

    def __init__(self, rendezvous, discovery: HostDiscovery, min_np: int,
                 max_np: Optional[int] = None,
                 timeout: Optional[float] = None,
                 reset_limit: Optional[int] = None, verbose: bool = False):
        self._rendezvous = rendezvous
        self._host_manager = HostManager(discovery)
        self._min_np = min_np
        self._max_np = max_np
        self._timeout = timeout or ELASTIC_TIMEOUT_SECS
        self._verbose = verbose

        self._registry = WorkerStateRegistry(self, self._host_manager,
                                             reset_limit=reset_limit,
                                             verbose=verbose)
        self._create_worker_fn: Optional[Callable] = None
        self._assignments: List[SlotInfo] = []
        self._started_slots: set = set()           # (host, local_rank)
        self._world_version = 0
        self._pending_resume = False
        # last membership notification pushed to workers while a resume
        # was pending — restored on promotion so the new driver keeps
        # re-pushing it (failover.py); (timestamp, update_res) or None
        self._last_notify: Optional[Tuple[int, int]] = None
        # driver-state journal (failover.DriverJournal) — None journals
        # nothing; attach_journal() before start() enables replication
        self._journal = None
        self._results: Dict[str, Tuple[object, int]] = {}
        # per-slot failure strikes: "host:local_rank" -> {count, last,
        # until} (monotonic). until=inf means permanently excluded.
        self._slot_strikes: Dict[str, dict] = {}
        self._failure_backoff = _get_float(
            HOROVOD_ELASTIC_FAILURE_BACKOFF,
            DEFAULT_SLOT_FAILURE_BACKOFF_SECS)
        self._slot_failure_limit = _get_int(
            HOROVOD_ELASTIC_SLOT_FAILURE_LIMIT, DEFAULT_SLOT_FAILURE_LIMIT)

        # membership telemetry (horovod_tpu/metrics.py): the world version
        # as a gauge and rank join/leave/blacklist as a monotonic event log
        _reg = metrics_registry()
        self._m_world_version = _reg.gauge("hvd_tpu_elastic_world_version")
        self._m_events = _reg.event_log("hvd_tpu_elastic_events")

        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        self._finished_event = threading.Event()
        self._error_message: Optional[str] = None
        self._discovery_thread = threading.Thread(
            target=self._discover_hosts, name="elastic-discovery", daemon=True)

    # -- lifecycle ----------------------------------------------------------

    def start(self, np: int, create_worker_fn: Callable[[SlotInfo], None]):
        """Begin the job: wait for ``np`` slots, assign ranks, launch workers.

        ``create_worker_fn(slot_info)`` must start (asynchronously) a worker
        process for the slot and arrange for ``record_worker_exit`` to be
        called when it terminates.
        """
        self._create_worker_fn = create_worker_fn
        self._activate_workers(np)
        self._discovery_thread.start()

    def attach_journal(self, journal):
        """Enable driver-state journaling (failover.DriverJournal). Call
        before ``start()``/``start_restored()`` — every subsequent world
        bump, strike, host delta, pending flag, and worker result commits
        to the replicated ``driver/`` scope before the driver acts on
        it."""
        self._journal = journal

    @classmethod
    def restore_from_ledger(cls, ledger, rendezvous, discovery,
                            min_np: int, max_np: Optional[int] = None,
                            timeout: Optional[float] = None,
                            reset_limit: Optional[int] = None,
                            verbose: bool = False, journal=None
                            ) -> "ElasticDriver":
        """Rebuild a driver from a replayed journal (failover.py
        promotion path): world version, assignments, started slots,
        results, strikes, and discovered-host state all resume where the
        dead driver journaled them. The restored driver is inert until
        ``start_restored``."""
        d = cls(rendezvous, discovery, min_np=min_np, max_np=max_np,
                timeout=timeout, reset_limit=reset_limit, verbose=verbose)
        d._journal = journal
        d._host_manager.restore_state(ledger.hosts, ledger.order,
                                      ledger.blacklist)
        now = time.monotonic()
        with d._lock:
            d._world_version = ledger.version
            d._assignments = ledger.slot_infos()
            d._started_slots = {(h, lr) for h, lr in ledger.started}
            d._results = {k: (None, code)
                          for k, code in ledger.results.items()}
            # finite backoffs from the dead driver's clock are not
            # portable across processes — restore counts (and permanent
            # exclusions), let fresh failures re-earn their backoff
            d._slot_strikes = {
                key: {"count": ent["count"], "last": now,
                      "until": float("inf") if ent["permanent"] else 0.0}
                for key, ent in ledger.strikes.items()}
            d._pending_resume = ledger.pending
            d._last_notify = ledger.notify
        d._registry.reset(list(ledger.expected))
        return d

    def start_restored(self, create_worker_fn: Callable[[SlotInfo], None]):
        """Begin serving a restored world (promotion path): no fresh
        activation — assignments are already published state. Seeds the
        registry with journaled worker results (their processes died
        with the old driver and will never re-report), re-pushes the
        journaled membership notification when a resize was in flight,
        and starts discovery against the restored host state."""
        self._create_worker_fn = create_worker_fn
        with self._lock:
            version = self._world_version
            pending = self._pending_resume
            last_notify = self._last_notify
            results = dict(self._results)
            expected = {f"{s.hostname}:{s.local_rank}"
                        for s in self._assignments}
        self._m_world_version.set(version)
        self._m_events.append(
            "driver_promoted",
            f"v{version} pending={pending} workers={len(expected)}")
        for key, (_, code) in results.items():
            if key not in expected:
                continue
            host, _, lr = key.rpartition(":")
            if code == 0:
                self._registry.record_success(host, int(lr))
            else:
                self._registry.record_failure(host, int(lr))
        if pending and last_notify is not None:
            # live workers may have heard this from the dead driver
            # already (same timestamp ⇒ listeners dedupe); workers that
            # registered since must hear it from us
            self._notify_workers_host_changes(*last_notify)
        self._maybe_finish_on_success()
        self._discovery_thread.start()

    def stop(self, error_message: Optional[str] = None):
        with self._lock:
            if error_message is not None and self._error_message is None:
                self._error_message = error_message
        self._shutdown.set()
        self._finished_event.set()

    def finished(self) -> bool:
        return self._finished_event.is_set()

    def wait_for_finished(self, timeout: Optional[float] = None) -> bool:
        return self._finished_event.wait(timeout)

    def join(self):
        self._shutdown.set()
        if self._discovery_thread.is_alive():
            self._discovery_thread.join(timeout=5)

    @property
    def error_message(self) -> Optional[str]:
        with self._lock:
            return self._error_message

    def get_results(self) -> Dict[str, Tuple[object, int]]:
        with self._lock:
            return dict(self._results)

    @property
    def host_manager(self) -> HostManager:
        return self._host_manager

    @property
    def registry(self) -> WorkerStateRegistry:
        return self._registry

    @property
    def world_version(self) -> int:
        with self._lock:
            return self._world_version

    def world_size(self) -> int:
        with self._lock:
            return len(self._assignments)

    def resume_needed(self) -> bool:
        with self._lock:
            return self._pending_resume

    def wait_for_world(self, version: int, timeout: float = 60.0) -> bool:
        """Block until a world with ``world_version >= version`` is fully
        formed: assignments published, no resume pending, and every assigned
        worker has rendezvoused READY. The event-driven synchronization hook
        for tests and tooling — replaces sleep-margin
        guessing about when a world is up."""
        from .registration import READY
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._shutdown.is_set():
            with self._lock:
                formed = (self._world_version >= version and
                          not self._pending_resume and
                          bool(self._assignments))
                expected = len(self._assignments)
            if formed and self._registry.count(READY) >= expected:
                # the registry count ran OFF the driver lock: a resize
                # landing in that window could have satisfied the count
                # with the PRIOR world's readiness — re-check the world
                # is still the one we counted
                with self._lock:
                    if (self._world_version >= version and
                            not self._pending_resume and
                            len(self._assignments) == expected):
                        return True
            time.sleep(0.05)
        return False

    def get_slot_info(self, host: str, local_rank: int) -> Optional[SlotInfo]:
        """Current assignment for a worker, or None while a resume is
        pending (the rendezvous turns None into a long-polled 404)."""
        state, slot, _ = self.get_slot_state(host, local_rank)
        return slot

    def get_slot_state(self, host: str, local_rank: int,
                       min_version: int = 0):
        """(state, slot, world_version), state ∈ {'pending','assigned',
        'removed'}.

        'pending' → the world is being rebuilt, ask again (404/long-poll);
        'assigned' → here is your SlotInfo;
        'removed' → this slot is not part of the current world: the worker
        should exit (reference gloo_context.cc:157-204 removed-host throw).

        ``min_version`` is the world version the caller last belonged to: a
        re-rendezvousing worker must NOT be handed the plan of the world it
        just left (its peer may be dead but unreported yet — the reference
        avoids this with rendezvous versioning), so anything ≤ min_version
        is served as 'pending'.
        """
        with self._lock:
            version = self._world_version
            if self._pending_resume or version <= min_version:
                return "pending", None, version
            found = None
            for s in self._assignments:
                if s.hostname == host and s.local_rank == local_rank:
                    found = s
                    break
            # Re-read under the SAME lock hold: the
            # lock is an RLock, so a reentrant resume on this thread (a
            # registry barrier fired by the record_ready that preceded
            # this lookup) can swap _assignments/_world_version between
            # the version check above and the scan — handing the caller
            # a slot from the PRIOR world. A version mismatch (or a
            # freshly-pending resume) is served as 'pending': the worker
            # long-polls and reads the new world's plan instead.
            if self._world_version != version or self._pending_resume:
                return "pending", None, self._world_version
            if found is not None:
                return "assigned", found, version
            return "removed", None, version

    # -- membership / activation --------------------------------------------

    def _usable_hosts(self) -> Tuple[List[HostInfo], int]:
        """Current membership with slot-failure suspensions applied: each
        host's CAPACITY is reduced by its number of backing-off slots (the
        assignment always numbers local ranks densely from 0, so this
        shrinks the host's contribution rather than pinning a particular
        device — device-bound failures converge via the host blacklist at
        the strike limit, see ``_record_slot_strike``). If the reduction
        would drop the total below ``min_np``, suspensions are re-admitted
        early — keeping the job alive outranks quarantining a flaky
        slot."""
        with self._lock:
            hosts = self._host_manager.current_hosts()
            now = time.monotonic()
            suspended: Dict[str, int] = {}
            for key, ent in list(self._slot_strikes.items()):
                if ent["until"] > now:
                    host = key.rsplit(":", 1)[0]
                    suspended[host] = suspended.get(host, 0) + 1
            if not suspended:
                return hosts, sum(h.slots for h in hosts)
            adjusted = [HostInfo(h.hostname,
                                 max(h.slots - suspended.get(h.hostname, 0),
                                     0))
                        for h in hosts]
            adjusted = [h for h in adjusted if h.slots > 0]
            total = sum(h.slots for h in adjusted)
            if total < self._min_np:
                _LOG.warning(
                    "suspending %d failing slot(s) would leave %d < "
                    "min_np=%d; re-admitting them early to keep the job "
                    "alive", sum(suspended.values()), total, self._min_np)
                return hosts, sum(h.slots for h in hosts)
            return adjusted, total

    def wait_for_available_slots(self, np: int,
                                 min_np: Optional[int] = None) -> int:
        """Block until discovery reports at least ``np`` usable slots
        (reference driver.py:118-134); returns the usable count.

        Degraded-world semantics: with ``min_np`` set, a timeout
        with ``min_np <= usable < np`` *continues degraded* at the smaller
        world instead of aborting — only ``usable < min_np`` at the
        deadline is a hard TimeoutError."""
        min_np = np if min_np is None else min(min_np, np)
        deadline = time.monotonic() + self._timeout
        avail = 0
        while not self._shutdown.is_set():
            self._host_manager.update_available_hosts()
            _, avail = self._usable_hosts()
            if avail >= np:
                return avail
            if time.monotonic() > deadline:
                if avail >= min_np:
                    _LOG.warning(
                        "timed out waiting for %d slots after %.0fs; "
                        "continuing DEGRADED with %d slot(s) "
                        "(>= min_np=%d)", np, self._timeout, avail, min_np)
                    self._m_events.append(
                        "degraded_world", f"requested={np} usable={avail}")
                    return avail
                raise TimeoutError(
                    f"Timed out waiting for {min_np} slots "
                    f"(have {avail}) after {self._timeout}s — cannot "
                    f"continue even degraded. Check that your discovery "
                    f"script reports enough healthy hosts.")
            time.sleep(DISCOVER_HOSTS_FREQUENCY_SECS)
        return avail

    def _activate_workers(self, np: int):
        self.wait_for_available_slots(np, min_np=self._min_np)
        with self._lock:
            hosts, total = self._usable_hosts()
            if total < self._min_np:
                # membership shrank between the wait and activation
                raise ValueError(
                    f"only {total} usable slots at activation, below "
                    f"min_np={self._min_np}")
            assignments = get_host_assignments(hosts, min(np, total),
                                               self._max_np)
            self._world_version += 1
            self._assignments = assignments
            self._pending_resume = False
            self._last_notify = None
            if self._journal is not None:
                # commit the world bump to the replicated journal BEFORE
                # publishing it: a standby that promotes mid-activation
                # must resume THIS version, never re-serve the old one.
                # The host snapshot rides along: the initial membership
                # is consumed by wait_for_available_slots before the
                # discovery thread (the usual "hosts" journaler) exists,
                # and a standby must never replay an empty host view.
                current, order, blacklist = self._host_manager.state()
                self._journal.append("hosts", current=current, order=order,
                                     blacklist=sorted(blacklist))
                self._journal.append(
                    "world", version=self._world_version,
                    assignments=[s.to_response_string()
                                 for s in assignments],
                    expected=[f"{s.hostname}:{s.local_rank}"
                              for s in assignments])
            self._rendezvous.init(assignments)
            # a new world re-numbers ranks: published trace segments from
            # the previous world would merge two different processes under
            # one pid in GET /trace — drop them (segments re-publish on
            # each worker's next trace tick; correlation ids also carry
            # the world version, so even a racing stale publish stays
            # distinguishable)
            if hasattr(self._rendezvous, "clear_scope"):
                self._rendezvous.clear_scope("trace")
                # stale aggregator registrations and rollups likewise
                # belong to the old rank numbering; dropping the scope
                # forces re-hosting workers to re-register and peers'
                # TelemetryRoute.resolve to wait for the NEW world's
                # aggregator instead of latching a dead address
                self._rendezvous.clear_scope("agg")
            self._registry.reset(
                [f"{s.hostname}:{s.local_rank}" for s in assignments])
            pending = [s for s in assignments
                       if (s.hostname, s.local_rank) not in self._started_slots]
            for s in pending:
                self._started_slots.add((s.hostname, s.local_rank))
                # a restarted slot's result belongs to a previous world —
                # it must not satisfy this world's completion check
                self._results.pop(f"{s.hostname}:{s.local_rank}", None)
            if pending and self._journal is not None:
                self._journal.append(
                    "started", slots=[[s.hostname, s.local_rank]
                                      for s in pending])
            _LOG.info("world v%d: %d workers (%d newly started)",
                      self._world_version, len(assignments), len(pending))
            self._m_world_version.set(self._world_version)
            self._m_events.append(
                "world_activated",
                f"v{self._world_version} workers={len(assignments)} "
                f"started={len(pending)}")
        for s in pending:
            # lockcheck: ignore[_create_worker_fn is assigned once in start() before any driver thread exists]
            self._create_worker_fn(s)

    def resume(self):
        """Rebuild the world (reference driver.py:108-116). Runs in a fresh
        thread because it is called from registry barriers."""
        # errflow: ignore[resume continuation: joining here would deadlock the registry barrier that triggered it; its failure path calls stop(error), which wait_for_finished() observes]
        threading.Thread(target=self._resume_inner, daemon=True).start()

    def _resume_inner(self):
        try:
            self._activate_workers(self._min_np)
        except Exception as e:  # timeout waiting for slots, etc.
            self.stop(error_message=str(e))

    # -- discovery thread ---------------------------------------------------

    def _discover_hosts(self):
        while not self._shutdown.is_set():
            # lockcheck: ignore[_journal is assigned once (attach_journal/restore_from_ledger) before the discovery thread exists; DriverJournal serializes its own writes]
            if self._journal is not None:
                # liveness lease for the standby's election restriction
                # (failover.DriverStandby defers while this stays fresh)
                self._journal.heartbeat()
            try:
                failpoint("elastic.discovery")
                res = self._host_manager.update_available_hosts()
            except Exception as e:
                _LOG.warning("host discovery failed: %s", e)
                res = HostUpdateResult.NO_UPDATE
            if res != HostUpdateResult.NO_UPDATE and \
                    self._journal is not None:
                current, order, blacklist = self._host_manager.state()
                self._journal.append("hosts", current=current, order=order,
                                     blacklist=sorted(blacklist))
            if res != HostUpdateResult.NO_UPDATE and \
                    self._membership_matters(res):
                notify = (int(time.time() * 1e6), res)
                with self._lock:
                    self._pending_resume = True
                    self._last_notify = notify
                if self._journal is not None:
                    # pending committed BEFORE workers hear of it: a
                    # promotion landing inside this resize must re-push
                    # the same (timestamp, res) so listeners dedupe
                    self._journal.append("pending", pending=True,
                                         timestamp=notify[0],
                                         update_res=notify[1])
                self._registry.invalidate_ready()
                self._notify_workers_host_changes(*notify)
            else:
                with self._lock:
                    notify = self._last_notify if self._pending_resume \
                        else None
                if notify is not None:
                    # Keep re-sending while the resume is pending: a
                    # worker that registered its notification address
                    # *after* the change was first pushed (slow startup)
                    # would otherwise never hear of it and the old world
                    # would run to completion under a pending resume.
                    # Same timestamp ⇒ already-notified listeners dedupe
                    # (state.py on_hosts_updated).
                    self._notify_workers_host_changes(*notify)
            self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_SECS)

    def _membership_matters(self, res: int) -> bool:
        """Growth matters only below max_np; removal matters only if a host
        of the current world went away."""
        with self._lock:
            assigned_hosts = {s.hostname for s in self._assignments}
            current = {h.hostname for h in self._host_manager.current_hosts()}
            if res & HostUpdateResult.REMOVED and (
                    not assigned_hosts <= current or
                    self._host_manager.available_slots() <
                    len(self._assignments)):
                return True
            if res & HostUpdateResult.ADDED:
                if self._max_np is not None and \
                        len(self._assignments) >= self._max_np:
                    return False
                return self._host_manager.available_slots() > \
                    len(self._assignments)
        return False

    def _notify_workers_host_changes(self, timestamp: int, update_res: int):
        """Push a hosts-updated event to every registered worker
        (reference driver.py:197-225); workers raise HostsUpdatedInterrupt at
        their next commit()."""
        from .worker import WorkerNotificationClient

        def _notify(rank, addr):
            try:
                WorkerNotificationClient(addr).notify_hosts_updated(
                    timestamp, update_res)
            except Exception as e:
                _LOG.debug("could not notify worker %s at %s: %s",
                           rank, addr, e)

        # One thread per worker: an unreachable worker costs its own connect
        # timeout, not 5s x N serialized inside the discovery loop
        #.
        threads = [threading.Thread(target=_notify, args=(rank, addr),
                                    daemon=True)
                   for rank, addr in self._worker_addresses().items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)

    def _worker_addresses(self) -> Dict[str, str]:
        store = getattr(self._rendezvous, "worker_addresses", None)
        if callable(store):
            return store()
        return {}

    # -- worker events (called by rendezvous handler / process monitors) ----

    def record_ready(self, host: str, local_rank: int):
        self._m_events.append("rank_join", f"{host}:{local_rank}")
        self._registry.record_ready(host, local_rank)

    def record_worker_exit(self, host: str, local_rank: int, exit_code: int,
                           result=None):
        """Called by the launcher's process monitor on worker termination."""
        key = f"{host}:{local_rank}"
        # under the lock: process monitors run on their own threads, and
        # an unguarded dict write here raced _maybe_finish_on_success /
        # _activate_workers reading the results table (lockcheck
        # off-lock-access regression, tests/test_race_regressions.py)
        with self._lock:
            self._results[key] = (result, exit_code)
            if self._journal is not None:
                # the exit commits before any recovery acts on it: a
                # promoted standby must know which workers already
                # finished (their monitors died with this process and
                # will never re-report)
                self._journal.append("result", key=key,
                                     exit_code=exit_code)
        self._m_events.append("rank_leave", f"{key} exit={exit_code}")
        if exit_code == 0:
            with self._lock:
                # the process is gone either way; a future resume that
                # reassigns this slot must start a fresh one
                self._started_slots.discard((host, local_rank))
                self._slot_strikes.pop(key, None)   # clean exit clears strikes
            self._registry.record_success(host, local_rank)
            self._maybe_finish_on_success()
        else:
            with self._lock:
                self._started_slots.discard((host, local_rank))
                in_world = any(s.hostname == host and
                               s.local_rank == local_rank
                               for s in self._assignments)
                if in_world:
                    self._pending_resume = True
                    if self._journal is not None:
                        self._journal.append("pending", pending=True)
                    self._record_slot_strike(key)
            if in_world:
                # READY states recorded when the (now dying) world was
                # activated are stale: live workers must re-rendezvous
                # before the barrier may fire (registry docstring).
                self._registry.invalidate_ready()
            if not in_world:
                # a worker of a *previous* world died after being scaled
                # out — not a failure of the current world
                _LOG.info("stale worker %s exited %d; ignoring",
                          key, exit_code)
                return
            # Liveness probe runs the user's discovery script — never under
            # self._lock (it can take seconds and would wedge the rendezvous
            # mid-recovery). A failing host that discovery no longer reports
            # is permanently excluded (reference driver.py:136-139).
            if not self._host_still_alive(host):
                self._host_manager.blacklist(host)
                self._m_events.append("blacklist", host)
                if self._journal is not None:
                    self._journal.append("blacklist", host=host)
            self._registry.record_failure(host, local_rank)

    # requires: _lock
    def _record_slot_strike(self, key: str):
        """Failure accounting for graceful degradation (called under
        ``self._lock``): the first failure in the strike window is free
        (normal crash-recovery relaunch); repeats earn exponential-backoff
        *capacity* suspension — the host offers that many fewer slots to
        the rebuilt world (which physical local_rank sits idle is the
        assignment's choice, so this quarantines churn, not a specific
        device); past the limit the whole HOST is blacklisted (reference
        driver.py:136-139 behavior) — the only exclusion that converges
        when the failure is bound to one device. Workers that exit cleanly
        clear their strikes."""
        now = time.monotonic()
        ent = self._slot_strikes.get(key)
        if ent is None or now - ent["last"] > SLOT_STRIKE_WINDOW_SECS:
            ent = {"count": 0, "last": now, "until": 0.0}
        ent["count"] += 1
        ent["last"] = now
        if self._journal is not None:
            # the strike commits before the suspension/blacklist acts:
            # a promoted standby restores the count so a flapping slot
            # cannot reset its strikes by killing the driver
            self._journal.append(
                "strike", key=key, count=ent["count"],
                permanent=ent["count"] >= self._slot_failure_limit)
        if ent["count"] >= self._slot_failure_limit:
            ent["until"] = float("inf")
            host = key.rsplit(":", 1)[0]
            _LOG.error("slot %s has failed %d times; blacklisting host %s "
                       "(HOROVOD_ELASTIC_SLOT_FAILURE_LIMIT=%d)",
                       key, ent["count"], host, self._slot_failure_limit)
            self._host_manager.blacklist(host)
            if self._journal is not None:
                self._journal.append("blacklist", host=host)
            self._m_events.append("slot_excluded",
                                  f"{key} strikes={ent['count']} "
                                  f"host_blacklisted={host}")
        elif ent["count"] >= 2:
            backoff = min(
                self._failure_backoff * (2.0 ** (ent["count"] - 2)),
                SLOT_BACKOFF_CAP_SECS)
            ent["until"] = now + backoff
            _LOG.warning("slot %s failed %d times within %.0fs; suspending "
                         "re-admission for %.1fs", key, ent["count"],
                         SLOT_STRIKE_WINDOW_SECS, backoff)
            self._m_events.append(
                "slot_backoff",
                f"{key} strikes={ent['count']} backoff={backoff:.1f}s")
        self._slot_strikes[key] = ent

    def slot_strikes(self, key: str) -> int:
        """Failure-strike count for ``host:local_rank`` (tests/tooling)."""
        with self._lock:
            ent = self._slot_strikes.get(key)
            return ent["count"] if ent else 0

    def _host_still_alive(self, host: str) -> bool:
        try:
            found = \
                self._host_manager._discovery.find_available_hosts_and_slots()
        except Exception as e:
            # A transiently failing discovery script must not blacklist a
            # healthy host forever — assume alive, like the polling thread
            # treats the same failure as NO_UPDATE.
            _LOG.warning("discovery probe failed (%s); assuming host %s "
                         "is still alive", e, host)
            return True
        return host in found

    def _maybe_finish_on_success(self):
        with self._lock:
            expected = {f"{s.hostname}:{s.local_rank}"
                        for s in self._assignments}
            done = {k for k, (_, code) in self._results.items() if code == 0}
            if expected and expected <= done:
                self._finished_event.set()
