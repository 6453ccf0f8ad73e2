"""Worker-side notification channel for host-membership updates.

The port's copy of ``horovod_tpu/elastic/worker.py``, line for line: plain
Python, no torch.

Parity: reference ``horovod/runner/elastic/worker.py`` —
``WorkerNotificationManager/Service/Client``: the driver pushes a
"hosts updated" event into a tiny in-worker HTTP service; registered
listeners (elastic ``State`` objects) pick it up and raise
``HostsUpdatedInterrupt`` at the next ``commit()`` boundary.

Transport here is the same HTTP KV fabric as the rendezvous (PUT
``/notify/hosts_updated`` with ``"<timestamp> <update_result>"``), replacing
the reference's HMAC-pickled socket RPC.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
from typing import List, Optional

from ..common import env as env_mod
from ..common.retry import retrying
from ..faults import failpoint
from ..metrics import registry as metrics_registry
from ..runner.http_server import KVStoreServer
from ..runner.http_client import put_data_into_kvstore, resolve_endpoints

_LOG = logging.getLogger("horovod_tpu_torch.elastic")

SCOPE_NOTIFY = "notify"
KEY_HOSTS_UPDATED = "hosts_updated"
SCOPE_WORKER_ADDRS = "worker_addresses"
SCOPE_WORKER_RESULTS = "worker_results"


class WorkerNotificationService(KVStoreServer):
    """In-worker HTTP endpoint the driver pushes membership events to."""

    def __init__(self, manager: "WorkerNotificationManager"):
        super().__init__(("0.0.0.0", 0))
        self._manager = manager

    def handle_put(self, scope: str, key: str, value: bytes, handler) -> int:
        if scope == SCOPE_NOTIFY and key == KEY_HOSTS_UPDATED:
            try:
                ts_s, res_s = value.decode().split()
                self._manager.handle_hosts_updated(int(ts_s), int(res_s))
                return 200
            except (ValueError, UnicodeDecodeError) as e:
                # A malformed payload used to vanish into a bare 400: a
                # driver/worker version skew then looked like a *lost*
                # membership event and the worker ran the old world to
                # completion. Loud + counted.
                _LOG.warning(
                    "rejecting malformed hosts-updated notification %r "
                    "(%s) — likely a driver/worker version skew; this "
                    "worker did NOT observe the membership change",
                    value[:64], e)
                metrics_registry().counter(
                    "hvd_tpu_notify_rejects_total").inc()
                return 400
        return super().handle_put(scope, key, value, handler)


class WorkerNotificationManager:
    """Singleton-ish per-process manager: starts the service on demand,
    registers the worker's address with the rendezvous, and fans events out
    to registered listeners (reference worker.py:24-83)."""

    _GUARDED_BY = {"_reg_epoch": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        # Serializes the registration PUTs of init()/reregister() without
        # holding the manager lock through network I/O: a slow rendezvous
        # must not wedge listener registration or the driver's membership
        # push (manager-lock users). Serialization alone cannot ORDER the
        # PUTs, so each registration bumps _reg_epoch and a PUT holding
        # _put_lock first re-checks its epoch is still current — a
        # delayed init PUT superseded by a reregister skips instead of
        # re-advertising a stale rank key.
        self._put_lock = threading.Lock()
        self._reg_epoch = 0
        self._service: Optional[WorkerNotificationService] = None
        self._listeners: List[object] = []
        self._rdv: Optional[tuple] = None       # (addr, port)
        self._my_addr: Optional[str] = None

    def _registration_put(self, epoch: int, addr, port, rank, my_addr,
                          **kw) -> bool:
        """The advertisement PUT, skipped when ``epoch`` has been
        superseded by a newer registration (see ``_put_lock`` above).
        Returns whether the PUT ran."""
        with self._put_lock:
            with self._lock:
                if self._reg_epoch != epoch:
                    _LOG.debug(
                        "skipping stale registration PUT for rank %s "
                        "(epoch %d superseded by %d)", rank, epoch,
                        self._reg_epoch)
                    return False
            # lockcheck: ignore[dedicated I/O-ordering lock: serializes registration PUTs only; the manager lock is NOT held here]
            put_data_into_kvstore(addr, port, SCOPE_WORKER_ADDRS,
                                  str(rank), my_addr.encode(), **kw)
            return True

    def init(self, rendezvous_addr: Optional[str] = None,
             rendezvous_port: Optional[int] = None,
             rank: Optional[int] = None, hostname: Optional[str] = None):
        """Start the service and advertise ``host:port`` under
        ``worker_addresses/<rank>`` in the rendezvous KV. No-ops when not
        running under an elastic driver (no rendezvous in env)."""
        with self._lock:
            if self._service is not None:
                return
            addr = rendezvous_addr or os.environ.get(
                env_mod.HOROVOD_GLOO_RENDEZVOUS_ADDR)
            if not addr:
                return
            port = rendezvous_port if rendezvous_port is not None else \
                int(os.environ.get(env_mod.HOROVOD_GLOO_RENDEZVOUS_PORT, "0"))
            if rank is None:
                rank = int(os.environ.get(env_mod.HOROVOD_RANK, "0"))
            self._service = WorkerNotificationService(self)
            self._service.start()
            host = hostname or os.environ.get(env_mod.HOROVOD_HOSTNAME) or \
                socket.gethostname()
            # Every driver RPC rides the Endpoints set:
            # the rendezvous addr may be a replica-set comma spec — the
            # shared Endpoints instance gives registration PUTs sticky-
            # primary ordering, epoch-aware redirects, and per-endpoint
            # circuit breakers instead of a single pinned address.
            try:
                self._rdv = (resolve_endpoints(addr, port), None)
            except ValueError:
                self._rdv = (addr, port)       # resolved lazily per PUT
            self._my_addr = f"{host}:{self._service.port}"
            my_addr = self._my_addr
            self._reg_epoch += 1
            epoch = self._reg_epoch
        # The registration PUT runs OFF the manager lock (the lockcheck
        # blocking-under-lock fix, the same bug class as the reregister
        # move): holding the manager lock through a network call wedged
        # any concurrent reregister() — and with it the driver's
        # membership push — behind a slow/hung rendezvous for the full KV
        # timeout. The epoch check inside keeps the one ordering that
        # matters: an init PUT delayed past a reregister is skipped, never
        # re-advertised under a stale rank key.
        self._registration_put(epoch, addr, port, rank, my_addr)
        _LOG.debug("worker notification service at %s (rank %s)",
                   my_addr, rank)

    def reregister(self, rank: Optional[int] = None):
        """Re-advertise this worker's address after a reset: the global rank
        may have changed with the new world, and the old rank's key may have
        been claimed by another worker.

        A failed re-registration used to be swallowed at debug level — the
        driver could then never push membership events to this worker again
        (it would only learn of changes at its next failed collective).
        Now: bounded retries via :func:`retrying`, and final failure is a
        WARNING plus ``hvd_tpu_kv_gave_up_total{op="reregister"}``."""
        with self._lock:
            if self._service is None or self._rdv is None:
                return
            if rank is None:
                rank = int(os.environ.get(env_mod.HOROVOD_RANK, "0"))
            addr, port = self._rdv
            my_addr = self._my_addr
            self._reg_epoch += 1
            epoch = self._reg_epoch

        def _attempt():
            failpoint("elastic.reregister")
            # retries=0: retrying() owns the schedule, one layer of backoff
            self._registration_put(epoch, addr, port, rank, my_addr,
                                   timeout=10, retries=0)

        try:
            retrying(_attempt, attempts=4, base_delay=0.1, max_delay=2.0,
                     deadline=30.0, op="reregister")
        # errflow: ignore[final-failure degraded mode by design: WARNING + the retrying() gave-up counter; the worker trains on and re-advertises at the next reset]
        except Exception as e:
            _LOG.warning(
                "notification re-registration for rank %s at %s failed "
                "after retries: %s — the driver cannot push membership "
                "events to this worker until a future reset re-advertises "
                "it", rank, my_addr, e)

    def shutdown(self):
        with self._lock:
            if self._service is not None:
                self._service.stop()
                self._service = None

    @property
    def port(self) -> Optional[int]:
        with self._lock:
            return self._service.port if self._service else None

    # -- listeners ----------------------------------------------------------

    def register_listener(self, listener):
        with self._lock:
            if listener not in self._listeners:
                self._listeners.append(listener)

    def remove_listener(self, listener):
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def handle_hosts_updated(self, timestamp: int, update_res: int):
        with self._lock:
            listeners = list(self._listeners)
        for l in listeners:
            l.on_hosts_updated(timestamp, update_res)


class WorkerNotificationClient:
    """Driver-side push client (reference worker.py:86-110)."""

    def __init__(self, addr: str):
        host, _, port = addr.rpartition(":")
        self._host = host
        self._port = int(port)

    def notify_hosts_updated(self, timestamp: int, update_res: int):
        failpoint("elastic.notify")
        # one-shot (retries=0): the driver re-pushes every discovery tick
        # while the resume is pending and workers reregister after reset,
        # so a newer notify always supersedes this one — retrying here
        # would only keep notify threads to dead endpoints lingering past
        # the driver's 10s join.
        put_data_into_kvstore(self._host, self._port, SCOPE_NOTIFY,
                              KEY_HOSTS_UPDATED,
                              f"{timestamp} {update_res}".encode(),
                              timeout=5, retries=0)


def report_worker_result(exit_code: int = 0):
    """Self-report this worker's completion to the elastic driver
   : PUT ``worker_results/<host>:<local_rank>`` riding the
    Endpoints failover set. The launcher's process monitor records exits
    too — but the monitor dies with the driver process, so across a
    driver failover this is the ONLY way a surviving worker's completion
    reaches the promoted driver's finish accounting. Best-effort:
    failure is a WARNING, never an error in the worker's exit path."""
    if not os.environ.get(env_mod.HOROVOD_ELASTIC):
        return
    addr = os.environ.get(env_mod.HOROVOD_GLOO_RENDEZVOUS_ADDR)
    if not addr:
        return
    port = int(os.environ.get(env_mod.HOROVOD_GLOO_RENDEZVOUS_PORT, "0"))
    host = os.environ.get(env_mod.HOROVOD_HOSTNAME) or socket.gethostname()
    local_rank = os.environ.get(env_mod.HOROVOD_LOCAL_RANK, "0")
    try:
        put_data_into_kvstore(resolve_endpoints(addr, port or None), None,
                              SCOPE_WORKER_RESULTS,
                              f"{host}:{local_rank}",
                              str(exit_code).encode(), timeout=20)
    # errflow: ignore[best-effort by design: the self-report is redundant with the launcher's process monitor except across a driver failover; failure is a WARNING and must never turn a clean worker exit into an error]
    except Exception as e:
        _LOG.warning(
            "worker result self-report for %s:%s failed: %s — the driver "
            "will rely on its local process monitor for this exit",
            host, local_rank, e)


_manager: Optional[WorkerNotificationManager] = None
_manager_lock = threading.Lock()


def notification_manager() -> WorkerNotificationManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = WorkerNotificationManager()
        return _manager
