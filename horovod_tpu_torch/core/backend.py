"""Process/world state on ``torch.distributed``.

The port's counterpart of ``horovod_tpu/core/backend.py``. It reads the same
launch contract:

- ``HOROVOD_TPU_COORDINATOR`` (``host:port`` of rank 0's store, or
  ``@rendezvous``: rank 0 takes a free port and publishes it to the
  launcher's KV), ``HOROVOD_TPU_NUM_PROCESSES`` and
  ``HOROVOD_TPU_PROCESS_ID`` (or ``HOROVOD_RANK``) join a multi-process
  world;
- ``HOROVOD_LOCAL_RANK``/``HOROVOD_LOCAL_SIZE`` and
  ``HOROVOD_CROSS_RANK``/``HOROVOD_CROSS_SIZE`` place the process on its host;
- ``HOROVOD_ELASTIC`` makes the process an elastic worker: its identity is
  ``(HOROVOD_HOSTNAME, HOROVOD_LOCAL_RANK)``, and every ``init()`` fetches
  its rank and the world's size and version from the elastic rendezvous,
  so ``shutdown(); init()`` joins the next world.

Without a coordinator the world has size 1 (an in-process store, no socket).
The process group is NCCL on ``cuda`` and gloo on ``cpu``. The device is
``cuda`` unless the caller asks for the CPU (``init(device="cpu")``, or
``HOROVOD_TPU_PLATFORM=cpu``, the reference's test override, when the
caller names none); a missing GPU is an error, never a silent move to the
CPU. The card of a process is its local rank's for its whole life: an
elastic reset re-inits on the device of the world it leaves.

Elastic worlds on NCCL (where the reference turns on jax's recoverable
mode, ``horovod_tpu/core/backend.py``:113-131), with torch 2.11's means:

- the process group's timeout is ``HOROVOD_TPU_SHUTDOWN_TIMEOUT``, 30 s
  by default in an elastic world (300 otherwise), as the reference's;
- ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` defaults to 2 (clean up only): on a
  collective that outlives the timeout the NCCL watchdog aborts the
  communicators instead of tearing the process down, so a survivor of a
  dead peer sees an exception, not an abort. ``TORCH_NCCL_ENABLE_MONITORING``
  and ``TORCH_NCCL_DUMP_ON_TIMEOUT`` default to 0: the heartbeat monitor
  and the dump signal read and write the world's store, which is gone
  once a world with a dead peer is torn down, and a survivor's exit then
  waited over a minute on each group's monitor (4 cards). The engine's completion
  waits block the host with a bound of nine tenths of the timeout
  (``wait_timeout``: the flat path's ``Work.wait(timeout)``, an
  event polled for the tree's and the ladder's rounds), so the dead peer
  surfaces as ``HorovodInternalError`` at the wait, before the watchdog
  would end the collective with a partial result; step replay is off
  unless ``HOROVOD_TPU_STEP_REPLAY`` asks for it (a collective inside a
  CUDA graph is invisible to the watchdog);
- before its groups are destroyed, the world's communicators are aborted
  (``_abort_process_group``, else each NCCL backend's ``abort()``):
  destroying a communicator with a collective pending can block; the
  aborted groups' objects are never freed (``_abort_world``);
- teardown order: rank 0 hosts the world's TCP store, and the peers' NCCL
  heartbeat monitors read it while their groups live. So rank 0 destroys
  last: the other ranks post a flag to the launcher's KV once their groups
  are gone, and rank 0 waits for the flags, bounded by
  ``HOROVOD_TPU_SHUTDOWN_ORDER_TIMEOUT`` (10 s; a dead peer never posts).
  Gloo reads no store after init, so a gloo world needs no order.
"""

from __future__ import annotations

import ctypes
import datetime
import logging
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..common import env as env_mod
from ..common.exceptions import HorovodInternalError, WorkerRemovedError

logger = logging.getLogger("horovod_tpu_torch")

# the launcher's HOROVOD_TPU_COORDINATOR sentinel (runner/launch.py)
COORDINATOR_VIA_RENDEZVOUS = "@rendezvous"

# torch's NCCL settings of an elastic world, where the caller set none
_ELASTIC_NCCL_ENV = (("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2"),
                     ("TORCH_NCCL_ENABLE_MONITORING", "0"),
                     ("TORCH_NCCL_DUMP_ON_TIMEOUT", "0"))


def resolve_device(device=None) -> torch.device:
    """The device a world runs on: the argument, else
    ``HOROVOD_TPU_PLATFORM``, else ``cuda``. ``cuda`` picks the card of the
    process's local rank."""
    name = device if device is not None else (
        os.environ.get(env_mod.HOROVOD_TPU_PLATFORM) or "cuda")
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise HorovodInternalError(
                "no CUDA device is visible; pass device='cpu' to run on the "
                "CPU")
        if dev.index is None:
            local = int(os.environ.get(env_mod.HOROVOD_LOCAL_RANK, "0"))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    return dev


def new_group(ranks):
    """``dist.new_group`` with the running world's timeout. torch gives a
    new group its backend's default (30 minutes), not the default group's,
    so a subgroup's collective with a dead peer would outwait the bound the
    world was given (``HOROVOD_TPU_SHUTDOWN_TIMEOUT``)."""
    from .state import global_state
    return dist.new_group(ranks, timeout=global_state().backend.timeout)


def _kv_addr():
    return (os.environ[env_mod.HOROVOD_GLOO_RENDEZVOUS_ADDR],
            int(os.environ[env_mod.HOROVOD_GLOO_RENDEZVOUS_PORT]))


class Backend:
    """World/topology state and the process group of the eager collectives."""

    def __init__(self):
        self._initialized = False
        self._removed = False
        self._elastic = False
        self._rank = 0
        self._size = 1
        self._local_rank = 0
        self._local_size = 1
        self._cross_rank = 0
        self._cross_size = 1
        self.device: Optional[torch.device] = None
        # the process group's timeout, which also bounds the engine's
        # completion waits in an elastic world
        self.timeout: Optional[datetime.timedelta] = None

    def init(self, device=None):
        if self._initialized:
            return
        self._removed = False
        slot = None
        self._elastic = elastic = bool(
            os.environ.get(env_mod.HOROVOD_ELASTIC))
        if elastic:
            # identity is (hostname, local_rank); rank and size come from
            # the rendezvous at every init, so a reset joins the new world
            try:
                slot = self._fetch_elastic_slot()
            except WorkerRemovedError:
                # scaled out before ever joining a world: an inert, removed
                # backend; the run wrapper checks `removed` and returns
                self._removed = True
                self._initialized = True
                return
            os.environ[env_mod.HOROVOD_TPU_NUM_PROCESSES] = str(slot.size)
            os.environ[env_mod.HOROVOD_TPU_PROCESS_ID] = str(slot.rank)
            os.environ[env_mod.HOROVOD_RANK] = str(slot.rank)
        self.device = resolve_device(device)
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        coord = os.environ.get(env_mod.HOROVOD_TPU_COORDINATOR)
        nprocs = int(os.environ.get(env_mod.HOROVOD_TPU_NUM_PROCESSES) or 1)
        self.timeout = datetime.timedelta(
            seconds=float(os.environ.get(env_mod.HOROVOD_TPU_SHUTDOWN_TIMEOUT,
                                         "30" if elastic else "300")))
        if dist.is_initialized():
            raise HorovodInternalError(
                "torch.distributed already has a default process group; "
                "call hvd.shutdown() (or destroy it) before hvd.init()")
        if elastic and backend == "nccl":
            # module docstring: the watchdog cleans up instead of killing
            # the process; no heartbeat monitor and no dump signal, which
            # read and write the world's store, gone with a dead world
            for knob, value in _ELASTIC_NCCL_ENV:
                os.environ.setdefault(knob, value)
        if coord and nprocs > 1:
            rank = int(os.environ.get(env_mod.HOROVOD_TPU_PROCESS_ID,
                                      os.environ.get(env_mod.HOROVOD_RANK,
                                                     "0")))
            if coord == COORDINATOR_VIA_RENDEZVOUS:
                coord = self._resolve_coordinator(rank)
            dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                    world_size=nprocs, rank=rank,
                                    timeout=self.timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0,
                                    timeout=self.timeout)
        self._rank = dist.get_rank()
        self._size = dist.get_world_size()
        if slot is not None:
            self._local_rank = slot.local_rank
            self._local_size = slot.local_size
            self._cross_rank = slot.cross_rank
            self._cross_size = slot.cross_size
        else:
            env = os.environ
            self._local_rank = int(env.get(env_mod.HOROVOD_LOCAL_RANK, "0"))
            self._local_size = int(env.get(env_mod.HOROVOD_LOCAL_SIZE, "1"))
            per_host = max(self._local_size, 1)
            self._cross_rank = int(env.get(env_mod.HOROVOD_CROSS_RANK,
                                           str(self._rank // per_host)))
            self._cross_size = int(env.get(
                env_mod.HOROVOD_CROSS_SIZE,
                str(max(1, self._size // per_host))))
        self._initialized = True

    def _fetch_elastic_slot(self):
        """Long-poll the elastic rendezvous for this worker's SlotInfo
        (the reference's ``Backend._fetch_elastic_slot``).

        Blocks (404 long-poll) while the driver rebuilds the world, so a
        resetting worker waits for the new assignment; the key carries the
        world version this process last belonged to, so the rendezvous
        never re-serves the world it is leaving. Raises WorkerRemovedError
        if this slot was removed from the job."""
        from ..runner.http_client import read_data_from_kvstore
        from ..runner.hosts import SlotInfo
        rdv_addr, rdv_port = _kv_addr()
        # a resume legitimately takes up to the driver's elastic timeout
        # (waiting for replacement hosts), much longer than the plain
        # rendezvous timeout
        timeout = float(os.environ.get(
            env_mod.HOROVOD_ELASTIC_TIMEOUT,
            os.environ.get(env_mod.HOROVOD_GLOO_TIMEOUT_SECONDS, "600")))
        host = os.environ.get(env_mod.HOROVOD_HOSTNAME, "localhost")
        local_rank = os.environ.get(env_mod.HOROVOD_LOCAL_RANK, "0")
        last_version = int(os.environ.get(
            env_mod.HOROVOD_TPU_WORLD_VERSION, "0"))
        try:
            data = read_data_from_kvstore(
                rdv_addr, rdv_port, "rank_and_size",
                f"{host}:{local_rank}:{last_version}", timeout=timeout)
        except TimeoutError as e:
            raise HorovodInternalError(
                f"elastic rendezvous did not assign {host}:{local_rank} a "
                f"rank within {timeout}s (job stopped?): {e}")
        text = data.decode()
        version = 0
        if "|" in text:
            version_s, text = text.split("|", 1)
            version = int(version_s)
        slot = SlotInfo.from_response_string(text)
        if slot.rank < 0:
            raise WorkerRemovedError(
                f"slot {host}:{local_rank} was removed from the elastic job")
        os.environ[env_mod.HOROVOD_TPU_WORLD_VERSION] = str(version)
        return slot

    def _resolve_coordinator(self, proc_id: int) -> str:
        """Resolve the ``@rendezvous`` coordinator sentinel (the
        reference's ``Backend._resolve_coordinator``): rank 0 takes a free
        port, publishes ``host:port`` under a key of this world's version
        (a previous world's rank 0 can never satisfy a newer world's read)
        and hosts the store there; everyone else long-polls the key."""
        from ..runner.http_client import (put_data_into_kvstore,
                                          read_data_from_kvstore)
        rdv_addr, rdv_port = _kv_addr()
        timeout = float(os.environ.get(
            env_mod.HOROVOD_GLOO_TIMEOUT_SECONDS, "120"))
        version = os.environ.get(env_mod.HOROVOD_TPU_WORLD_VERSION, "0")
        key = f"addr.v{version}"
        if proc_id == 0:
            from ..runner.http_server import find_free_port
            port = find_free_port()
            host = os.environ.get(env_mod.HOROVOD_HOSTNAME, "127.0.0.1")
            if host in ("localhost", "::1"):
                host = "127.0.0.1"
            addr = f"{host}:{port}"
            put_data_into_kvstore(rdv_addr, rdv_port, "coordinator", key,
                                  addr.encode(), timeout=timeout)
            # the store binds every interface: the advertised name only
            # has to reach this host
            return addr
        return read_data_from_kvstore(rdv_addr, rdv_port, "coordinator",
                                      key, timeout=timeout).decode()

    def _abort_world(self):
        """Abort the world's NCCL communicators (every group's): a
        collective left pending by a dead peer would hold
        ``destroy_process_group`` otherwise.

        The groups' objects are then kept for the life of the process (one
        reference each that nothing drops): torch's group destructor joins
        the group's watchdog thread, and after a dead peer's error that
        join blocked the survivors' exit for good (4 cards: every survivor
        stuck in the interpreter's last garbage collection). The process's
        end reclaims them."""
        world = getattr(dist.distributed_c10d, "_world", None)
        groups = list(getattr(world, "pg_map", {}) or {})
        abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
        if abort is not None:
            abort()
        else:
            for pg in groups:
                try:
                    pg._get_backend(self.device).abort()
                except (RuntimeError, AttributeError):  # not NCCL, or gone
                    pass
        for pg in groups:
            ctypes.pythonapi.Py_IncRef(ctypes.py_object(pg))

    def _ordered_teardown(self):
        """Destroy the process group, rank 0 last in a multi-rank elastic
        NCCL world (module docstring)."""
        ordered = (self._elastic and self._size > 1
                   and self.device is not None
                   and self.device.type == "cuda"
                   and os.environ.get(env_mod.HOROVOD_GLOO_RENDEZVOUS_ADDR)
                   and os.environ.get(env_mod.HOROVOD_GLOO_RENDEZVOUS_PORT))
        if self._elastic and self.device is not None and \
                self.device.type == "cuda":
            try:
                self._abort_world()
            except Exception as e:  # noqa: BLE001  the destroy still runs
                logger.warning("aborting the NCCL communicators failed: %r",
                               e)
        if not ordered:
            self._destroy()
            return
        from ..runner.http_client import (put_data_into_kvstore,
                                          read_data_from_kvstore)
        rdv_addr, rdv_port = _kv_addr()
        version = os.environ.get(env_mod.HOROVOD_TPU_WORLD_VERSION, "0")
        scope = f"shutdown.v{version}"
        if self._rank != 0:
            try:
                self._destroy()
            finally:
                try:
                    put_data_into_kvstore(rdv_addr, rdv_port, scope,
                                          str(self._rank), b"1", timeout=5)
                except Exception:  # noqa: BLE001  rank 0's wait is bounded
                    pass
            return
        deadline = time.monotonic() + float(os.environ.get(
            env_mod.HOROVOD_TPU_SHUTDOWN_ORDER_TIMEOUT, "10"))
        # short rounds over every pending rank: one dead peer must not
        # starve the wait for the live ones
        pending = set(range(1, self._size))
        while pending and time.monotonic() < deadline:
            for r in sorted(pending):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    read_data_from_kvstore(rdv_addr, rdv_port, scope,
                                           str(r),
                                           timeout=min(1.0, remaining))
                    pending.discard(r)
                except Exception:  # noqa: BLE001  not posted yet, or dead
                    pass
        self._destroy()

    @staticmethod
    def _destroy():
        # an abort of the default group may have destroyed it already
        if dist.is_initialized():
            dist.destroy_process_group()

    def shutdown(self):
        if dist.is_initialized():
            self._ordered_teardown()
        self._initialized = False

    @property
    def initialized(self) -> bool:
        return self._initialized

    @property
    def removed(self) -> bool:
        """True when this worker was scaled out of the elastic job at init
        and never joined a world (see ``init``)."""
        return self._removed

    @property
    def wait_timeout(self) -> Optional[datetime.timedelta]:
        """The bound on the engine's completion waits: nine tenths of the
        group timeout in an elastic NCCL world (module docstring), so a
        wait gives up before the watchdog would abort the communicators
        and end the collective with a partial result; None elsewhere."""
        if self._elastic and self._initialized and not self._removed \
                and self.device is not None and self.device.type == "cuda":
            return self.timeout * 0.9
        return None

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._size

    def local_rank(self) -> int:
        return self._local_rank

    def local_size(self) -> int:
        return self._local_size

    def cross_rank(self) -> int:
        return self._cross_rank

    def cross_size(self) -> int:
        return self._cross_size

    def is_homogeneous(self) -> bool:
        return self._size % max(self._local_size, 1) == 0
