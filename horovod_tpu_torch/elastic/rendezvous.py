"""Elastic rendezvous server: assignment lookups record worker readiness.

The port's copy of ``horovod_tpu/elastic/rendezvous.py``, line for line:
plain Python, no torch.

Parity: reference ``horovod/runner/elastic/rendezvous.py`` —
``ElasticRendezvousHandler``: GET ``rank_and_size/<host>:<slot>`` records the
worker READY with the driver and returns its current SlotInfo
(rendezvous.py:37-42); PUT ``worker_addresses/<rank>`` registers the worker's
notification channel (rendezvous.py:44-55).
"""

from __future__ import annotations

import logging
from typing import Dict

from ..faults import DROP, failpoint
from ..runner.http_server import OK, RendezvousServer, _normalize

_LOG = logging.getLogger("horovod_tpu_torch.elastic")


class ElasticRendezvousServer(RendezvousServer):
    """RendezvousServer wired to an ElasticDriver.

    Differences from the static server:
    - ``init(assignments)`` *versions* the plan: the coordinator address from
      the previous world is cleared so re-rendezvousing workers long-poll for
      the new rank-0's address instead of reading a stale one.
    - rank_and_size GETs notify the driver (readiness barrier accounting).
    """

    SCOPE_WORKER_ADDRS = "worker_addresses"
    # Worker result self-reports: the launcher's process
    # monitors die with the driver process, so across a driver failover
    # nobody would ever record a surviving worker's exit — workers
    # report their own completion here (PUT worker_results/<host>:<lr>
    # = exit code, riding the Endpoints failover set) and the attached
    # driver records it through the same journaled accounting path.
    SCOPE_WORKER_RESULTS = "worker_results"

    def __init__(self, addr=("0.0.0.0", 0)):
        super().__init__(addr)
        self._driver = None

    def set_driver(self, driver):
        self._driver = driver

    def init(self, host_assignments, coordinator_addr=None):
        slots = {f"{s.hostname}:{s.local_rank}": s
                 for s in host_assignments}
        if self._repl is not None:
            # Replicated set: standbys serve every read, so the new-world
            # clears must ride the journaled write path or a worker GET
            # against a standby could fetch the PREVIOUS world's
            # coordinator/addrs. client_write nests coordinator->server
            # locks, so it runs OUTSIDE self._lock; the clears land (and
            # replicate, quorum-acked) BEFORE the plan swap below, so on
            # every replica the clears reached, a GET that sees the new
            # plan sees a cleared (or re-seeded) coordinator. clear_scope
            # warns loudly when the replication tier refuses (e.g. this
            # server is itself a standby).
            self.clear_scope(self.SCOPE_COORD)
            self.clear_scope(self.SCOPE_WORKER_ADDRS)
            if coordinator_addr is not None:
                code = _normalize(self._repl.client_write(
                    "put", self.SCOPE_COORD, "addr",
                    coordinator_addr.encode()))[0]
                if code != OK:
                    _LOG.warning(
                        "replicated coordinator seed refused (HTTP %d): "
                        "workers will long-poll until rank 0 republishes "
                        "the address", code)
            with self._lock:
                self._slots_by_key = slots
            return self.port
        with self._lock:
            self._slots_by_key = slots
            # New world ⇒ a new rank 0 store; drop the stale address so
            # non-zero ranks block until the new rank 0 republishes it
            # (ordering guaranteed by this lock: any GET that sees the new
            # plan also sees the cleared coordinator scope). Mutations go
            # through the locked core so scope byte totals track the
            # store.
            self._store_apply_locked("clear", self.SCOPE_COORD, "", None)
            # stale notification endpoints would each cost a 5s connect
            # timeout on every membership push; workers reregister after
            # reset anyway
            self._store_apply_locked("clear", self.SCOPE_WORKER_ADDRS, "",
                                     None)
            if coordinator_addr is not None:
                self._store_apply_locked("put", self.SCOPE_COORD, "addr",
                                         coordinator_addr.encode())
        return self.port

    def handle_get(self, scope: str, key: str, handler):
        if scope == self.SCOPE_RANK and self._driver is not None:
            # drop() long-polls the worker (a rank that cannot complete its
            # rendezvous); raise()/hang() model a wedged rendezvous server
            if failpoint("elastic.rendezvous.get") is DROP:
                return None
            # key = "<host>:<local_rank>[:<last_world_version>]" — the
            # version lets a resetting worker refuse the plan of the world
            # it just left (driver.get_slot_state docstring).
            min_version = 0
            parts = key.split(":")
            try:
                if len(parts) >= 3:
                    min_version = int(parts[-1])
                    parts = parts[:-1]
                local_rank = int(parts[-1])
                host = ":".join(parts[:-1])
            except (ValueError, IndexError):
                return None
            self._driver.record_ready(host, local_rank)
            state, slot, version = self._driver.get_slot_state(
                host, local_rank, min_version)
            if state == "pending":
                return None                 # 404 → client long-polls
            if state == "removed":
                # serve INVALID_SLOT_INFO: the worker exits cleanly
                from ..runner.hosts import INVALID_SLOT_INFO
                return (f"{version}|" +
                        INVALID_SLOT_INFO.to_response_string()).encode()
            return (f"{version}|" + slot.to_response_string()).encode()
        return super().handle_get(scope, key, handler)

    def handle_put(self, scope: str, key: str, value: bytes, handler):
        if scope == self.SCOPE_WORKER_RESULTS and self._driver is not None:
            try:
                host, _, lr = key.rpartition(":")
                local_rank = int(lr)
                exit_code = int(value.decode().strip() or "0")
            except (ValueError, UnicodeDecodeError) as e:
                _LOG.warning("rejecting malformed worker result %r=%r "
                             "(%s)", key, value[:64], e)
                return 400
            if not host:
                return 400
            # feeds the journaled exit accounting (results table,
            # completion check) — idempotent with the process monitor's
            # record_worker_exit when both observe the same exit
            self._driver.record_worker_exit(host, local_rank, exit_code)
            return OK
        return super().handle_put(scope, key, value, handler)

    def worker_addresses(self) -> Dict[str, str]:
        """rank → ``host:port`` of each worker's notification service."""
        with self._lock:
            return {k: v.decode()
                    for k, v in self._store.get(self.SCOPE_WORKER_ADDRS,
                                                {}).items()}
