"""Elastic run-loop wrapper.

The port of ``horovod_tpu/elastic/run.py``. Parity: reference
``horovod/common/elastic.py:147-168`` (``run_fn``) +
``torch/elastic.py:31-49`` (``run``/``reset``): wrap the user's training
function so that

- ``HorovodInternalError`` (a failed collective — a peer died) restores the
  last committed state, resets the runtime, and retries;
- ``HostsUpdatedInterrupt`` (driver saw membership change) resets and
  continues without restore.

``reset`` tears down and re-initializes the whole runtime
(``hvd.shutdown(); hvd.init()``) — a full re-rendezvous, new world size,
new process groups and a new engine, whose replay graphs start empty —
as the reference re-inits its C++ core (torch/elastic.py:46,
gloo_context.cc:157-204). Where torch requires it, the port differs:

- the re-init runs on the device of the world it leaves (``hvd.init()``
  alone would pick ``cuda``, and a CPU world would come back on a card);
- a world with no elastic rendezvous (no ``HOROVOD_ELASTIC``) numbers its
  own versions: its reset moves ``HOROVOD_TPU_WORLD_VERSION`` forward,
  as the rendezvous does for a launched worker, so nothing armed in the
  world it leaves is taken for the new one's;
- the raw errors recovered a bounded number of times are
  ``torch.distributed``'s (``DistError``: ``DistBackendError``,
  ``DistNetworkError``, ``DistStoreError``), where the reference's are
  ``jax.errors.JaxRuntimeError``; any other ``RuntimeError`` (a CUDA
  out-of-memory error among them) is not a peer's crash and propagates.
"""

from __future__ import annotations

import functools
import logging
import os

import torch

from ..common import env as env_mod
from ..common.exceptions import (HorovodInternalError, HostsUpdatedInterrupt,
                                 WorkerRemovedError)
from ..metrics import registry as metrics_registry
from .worker import notification_manager, report_worker_result

_LOG = logging.getLogger("horovod_tpu_torch.elastic")

# Raw torch.distributed errors are ambiguous: a peer crash surfaces as one
# where no engine wait saw it, but so do deterministic failures (a
# misconfigured group, a store that is gone for good). The reference only
# ever recovers HorovodInternalError (common/elastic.py:147-168), so
# unbounded retry on raw errors would loop forever on a persistent bug. We
# recover them a bounded number of CONSECUTIVE times — the counter resets
# whenever training proves progress via state.commit() — then escalate to
# the user.
_MAX_RUNTIME_ERROR_RETRIES = int(os.environ.get(
    env_mod.HOROVOD_ELASTIC_MAX_RUNTIME_RETRIES, "3"))


def _dump_on_restore():
    """Write a rate-limited flight-recorder dump on the restore path, so
    the trace of the failed collective survives the engine rebuild."""
    try:
        from ..core.state import global_state
        dumper = global_state().flight_dumper
        if dumper is not None:
            dumper(trigger="elastic_restore")
    except Exception:  # errflow: ignore[a telemetry dump must never delay or fail elastic recovery]
        _LOG.debug("restore-path flight dump failed", exc_info=True)


def _recoverable_errors():
    """Exception classes the run-loop treats as a collective failure: a
    peer crash that surfaces outside an engine wait (a user's own
    ``torch.distributed`` call, a store read) is a raw ``DistError`` that
    no ``_translate_failure`` wrapper saw."""
    errs = [HorovodInternalError]
    dist_error = getattr(torch.distributed, "DistError", None)
    if dist_error is not None:
        errs.append(dist_error)
    return tuple(errs)


def _reset():
    import horovod_tpu_torch as hvd
    from ..core.state import global_state
    device = global_state().backend.device
    hvd.shutdown()
    if not os.environ.get(env_mod.HOROVOD_ELASTIC):
        version = int(os.environ.get(env_mod.HOROVOD_TPU_WORLD_VERSION,
                                     "0") or 0)
        os.environ[env_mod.HOROVOD_TPU_WORLD_VERSION] = str(version + 1)
    hvd.init(device=device)


def run(func):
    """Decorator for elastic training functions: ``@hvd.elastic.run`` over
    ``def train(state, ...)``. The first argument must be the elastic
    ``State``."""
    return run_fn(func, _reset)


def _is_removed() -> bool:
    """Whether this worker was scaled out of the job at (re-)init time.

    ``Backend.init`` absorbs a removal that races the *initial* ``hvd.init()``
    (before any world was joined) into this flag instead of raising from
    module-level user code (the un-catchable spot outside this wrapper)."""
    from ..core.state import global_state
    st = global_state()
    return (st.backend is not None and st.backend.initialized and
            st.backend.removed)


def _maybe_restore_durable(state, recoveries_counter) -> None:
    """Recovery tier 2 (docs/checkpointing.md): a process with
    no in-memory commit — a host restarted after preemption — restores
    from the last durable checkpoint generation before the first sync,
    so rank 0's subsequent broadcast carries the recovered state instead
    of freshly-initialized parameters. No-op without a configured
    ``CheckpointManager`` (HOROVOD_TPU_CHECKPOINT_DIR) or once the state
    has committed in-memory."""
    from ..core.state import global_state
    if global_state().checkpoint_manager is None:
        return
    if getattr(state, "_commit_count", 0) > 0:
        return
    before = getattr(state, "_durable_step", 0)
    try:
        state.restore()
    except Exception as e:
        _LOG.warning("durable-restore probe failed: %s", e)
        return
    if getattr(state, "_durable_step", 0) > before:
        recoveries_counter.inc(kind="durable")


def run_fn(func, reset):
    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        if _is_removed():
            _LOG.info("worker was removed from the job before it joined a "
                      "world; exiting cleanly")
            return None
        notification_manager().init()
        notification_manager().register_listener(state)
        skip_sync = False
        raw_failures = 0  # consecutive raw-runtime-error recoveries
        # recovery telemetry: rate()-able evidence of an unstable world
        # (internal = failed collective, raw_runtime = a raw
        # torch.distributed error, hosts_updated = membership)
        _m_recoveries = metrics_registry().counter(
            "hvd_tpu_elastic_recoveries_total")
        _maybe_restore_durable(state, _m_recoveries)
        try:
            while True:
                if not skip_sync:
                    state.sync()
                commits_before = getattr(state, "_commit_count", 0)
                try:
                    ret = func(state, *args, **kwargs)
                    # Self-report the clean completion: the
                    # launcher-side process monitor that normally records
                    # this exit dies with the driver process, so across a
                    # driver failover this PUT is how the promoted driver
                    # learns the worker finished. Best-effort, rides the
                    # Endpoints failover set.
                    report_worker_result(0)
                    return ret
                except _recoverable_errors() as e:
                    if isinstance(e, HorovodInternalError):
                        raw_failures = 0  # definitely a collective failure
                        _m_recoveries.inc(kind="internal")
                    else:
                        if getattr(state, "_commit_count", 0) > commits_before:
                            raw_failures = 0  # progress since last failure
                        raw_failures += 1
                        if raw_failures > _MAX_RUNTIME_ERROR_RETRIES:
                            _LOG.error(
                                "%d consecutive runtime errors with no "
                                "intervening state.commit(); this looks like "
                                "a deterministic failure, not a peer crash — "
                                "escalating (HOROVOD_ELASTIC_MAX_RUNTIME_"
                                "RETRIES=%d)", raw_failures,
                                _MAX_RUNTIME_ERROR_RETRIES)
                            raise
                        _m_recoveries.inc(kind="raw_runtime")
                    _LOG.info("collective failure; restoring last committed "
                              "state and re-initializing")
                    # flight dump: capture the trace ring
                    # BEFORE reset() tears the engine down — the spans
                    # explaining why the world died are still in it.
                    # Rate-limited (shared FlightDumper), best-effort.
                    _dump_on_restore()
                    state.restore()
                    skip_sync = False
                except HostsUpdatedInterrupt as e:
                    _LOG.info("hosts updated (skip_sync=%s); "
                              "re-initializing", e.skip_sync)
                    _m_recoveries.inc(kind="hosts_updated")
                    skip_sync = e.skip_sync
                try:
                    reset()
                except WorkerRemovedError:
                    # this worker was scaled out of the job: a clean exit
                    _LOG.info("worker removed from job; exiting")
                    return None
                if _is_removed():
                    _LOG.info("worker removed from job; exiting")
                    return None
                # ranks shift with the new world: re-advertise the
                # notification address under the new rank
                notification_manager().reregister()
                state.on_reset()
        finally:
            notification_manager().remove_listener(state)
    return wrapper
