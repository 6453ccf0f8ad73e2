"""Worker state registry for the elastic driver.

The port's copy of ``horovod_tpu/elastic/registration.py``, line for line:
plain Python, no torch.

Parity: reference ``horovod/runner/elastic/registration.py`` —
``WorkerStateRegistry`` counts READY / SUCCESS / FAILURE transitions per
worker per world version, fires ``driver.resume()`` once every worker of the
current world has reported while a resume is pending, and enforces
``reset_limit``.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Set

_LOG = logging.getLogger("horovod_tpu_torch.elastic")

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    """Barrier-style accounting of worker states within one world version.

    States:
    - READY: the worker (re-)requested rank assignment from the rendezvous —
      it is alive and waiting for the next world.
    - SUCCESS / FAILURE: the worker process exited.

    When the driver has a pending resume (a failure happened or membership
    changed), the barrier fires once every expected worker of the current
    world has reported *any* state — at that point the world can be rebuilt
    without abandoning a live worker (reference registration.py:72-140).
    """

    def __init__(self, driver, host_manager, reset_limit: Optional[int] = None,
                 verbose: bool = False):
        self._driver = driver
        self._host_manager = host_manager
        self._reset_limit = reset_limit
        self._verbose = verbose
        self._lock = threading.Lock()
        self._states: Dict[str, str] = {}
        self._workers: Dict[str, Set[str]] = {READY: set(), SUCCESS: set(),
                                              FAILURE: set()}
        self._expected: Set[str] = set()
        self._barrier_fired = False
        self._reset_count = 0

    # -- round lifecycle ----------------------------------------------------

    def reset(self, expected_keys):
        """Start a new world version expecting workers ``host:local_rank``."""
        with self._lock:
            self._states = {}
            self._workers = {READY: set(), SUCCESS: set(), FAILURE: set()}
            self._expected = set(expected_keys)
            self._barrier_fired = False
            _LOG.debug("registry reset: expecting %d workers",
                       len(self._expected))

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._expected)

    @property
    def reset_count(self) -> int:
        return self._reset_count

    # -- worker transitions -------------------------------------------------

    def record_ready(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, READY)

    def record_success(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, SUCCESS)

    def record_failure(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, FAILURE)

    def _record_state(self, host: str, slot: int, state: str) -> int:
        key = f"{host}:{slot}"
        with self._lock:
            prev = self._states.get(key)
            if prev != state:
                if prev is not None:
                    self._workers[prev].discard(key)
                self._states[key] = state
                self._workers[state].add(key)
                if self._verbose or state != READY:
                    _LOG.info("worker %s -> %s", key, state)
            all_reported = bool(self._expected) and \
                self._expected <= set(self._states)
            # A world whose every expected worker exited SUCCESS is a
            # *finished* job, not a resumable one — resuming would relaunch
            # fresh workers for already-completed ranks (observed flake:
            # duplicate done-results after a pending membership change raced
            # job completion).
            all_success = bool(self._expected) and \
                self._expected <= self._workers[SUCCESS]
            candidate = all_reported and not all_success and \
                not self._barrier_fired
        # Lock-order discipline: driver.resume_needed() takes driver._lock,
        # and _activate_workers (driver._lock held) calls our reset() — so
        # never query the driver while holding self._lock (AB-BA deadlock).
        fire = False
        if candidate and self._driver.resume_needed():
            with self._lock:
                if not self._barrier_fired:
                    self._barrier_fired = True
                    fire = True
        if fire:
            self._on_barrier()
        return self._reset_count

    def count(self, state: str) -> int:
        with self._lock:
            return len(self._workers[state])

    def invalidate_ready(self):
        """Drop READY states recorded before a resume became pending: every
        worker GETs rank_and_size at world activation, so without this the
        first FAILURE would satisfy the barrier instantly instead of waiting
        for live workers to re-rendezvous."""
        with self._lock:
            for key in list(self._workers[READY]):
                self._workers[READY].discard(key)
                self._states.pop(key, None)

    def _on_barrier(self):
        if self._reset_limit is not None and \
                self._reset_count >= self._reset_limit:
            _LOG.error("reset limit of %d reached; stopping job",
                       self._reset_limit)
            self._driver.stop(error_message=(
                f"Job has been reset {self._reset_count} times, which "
                f"exceeds the reset limit of {self._reset_limit}. This "
                f"usually indicates a non-recoverable failure."))
            return
        self._reset_count += 1
        _LOG.info("all %d workers reported (failures=%d); resuming driver "
                  "(reset #%d)", len(self._expected),
                  len(self._workers[FAILURE]), self._reset_count)
        self._driver.resume()
