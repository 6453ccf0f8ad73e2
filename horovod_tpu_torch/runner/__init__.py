"""Launcher package: the ``tpurun`` CLI (``python -m
horovod_tpu_torch.runner``), the programmatic ``run()`` and
``run_elastic()``, and the rendezvous KV: its HTTP client
(``http_client``: endpoint sets with failover and a circuit breaker,
long-poll reads, retried writes, the chunked large-value transfer
checkpoint shards ride) and its servers (``http_server.KVStoreServer``,
``RendezvousServer``).

The port's copy of ``horovod_tpu/runner/__init__.py``. Parity: reference
``horovod/runner/`` (SURVEY.md §2.5). ``run()`` mirrors ``horovod.run()``
(reference runner/__init__.py:89): execute a Python function on ``np``
distributed worker processes and return the per-rank results in rank order.
Workers run ``horovod_tpu_torch.runner.run_task``, on the card unless the
``env`` given says ``HOROVOD_TPU_PLATFORM=cpu``. ``cloudpickle`` carries the
function where it is installed, ``pickle`` otherwise. Replication and the
slice aggregator come with ROADMAP A14b.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable, Dict, List, Optional

from .hosts import HostInfo, parse_hosts
from .launch import launch_static
from .http_client import (Endpoints, KVBackpressure,  # noqa: F401
                          delete_data_from_kvstore, delete_large_value,
                          put_data_into_kvstore, put_large_value,
                          read_data_from_kvstore, read_large_value,
                          resolve_endpoints)
from .http_server import KVStoreServer, RendezvousServer  # noqa: F401


def _dumps_payload(fn, args, kwargs) -> bytes:
    try:
        import cloudpickle
    except ImportError:
        return pickle.dumps((fn, args, kwargs))
    # Functions from __main__ are pickled by value automatically; functions
    # from any other non-installed module (e.g. a user script imported under
    # its file name) must be explicitly registered by value or the worker
    # will fail to import the module.
    import sys
    mod = sys.modules.get(getattr(fn, "__module__", ""))
    registered = False
    if mod is not None and getattr(mod, "__name__", "__main__") != "__main__":
        try:
            cloudpickle.register_pickle_by_value(mod)
            registered = True
        except Exception:
            pass
    try:
        return cloudpickle.dumps((fn, args, kwargs))
    finally:
        if registered:
            cloudpickle.unregister_pickle_by_value(mod)


import contextlib


def _check_shared_fs(host_infos, env: Optional[Dict[str, str]]) -> None:
    """The programmatic APIs move the pickled fn + results through a local
    tempdir; remote hosts need that path on a shared filesystem."""
    from .launch import is_local_host
    remote = [h.hostname for h in host_infos if not is_local_host(h.hostname)]
    ack = (env or {}).get("HOROVOD_TPU_SHARED_FS",
                          os.environ.get("HOROVOD_TPU_SHARED_FS"))
    if remote and ack != "1":
        raise ValueError(
            f"programmatic run with remote hosts {remote} passes the pickled "
            "function and collects results through a temporary directory, "
            "which must be on a filesystem shared by every host. Set "
            "HOROVOD_TPU_SHARED_FS=1 to acknowledge, or use tpurun with a "
            "script instead.")


@contextlib.contextmanager
def _worker_bootstrap(fn, args, kwargs, env: Optional[Dict[str, str]],
                      use_current_interpreter: bool = True):
    """Shared run()/run_elastic() plumbing: serialized payload in a tempdir,
    the run_task command line, and the merged worker env."""
    import sys
    with tempfile.TemporaryDirectory(prefix="hvd_tpu_run_") as tmp:
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            f.write(_dumps_payload(fn, args, kwargs))
        interpreter = sys.executable if use_current_interpreter else "python3"
        command = [interpreter, "-m", "horovod_tpu_torch.runner.run_task",
                   payload, tmp]
        base_env = dict(os.environ)
        if env:
            base_env.update(env)
        yield tmp, command, base_env


def _collect_results(tmp: str, expected: int) -> List[Any]:
    results = []
    for rank in range(expected):
        path = os.path.join(tmp, f"result_{rank}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {rank} produced no result")
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        np: int = 1, hosts: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        use_current_interpreter: bool = True,
        verbose: bool = False) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``np`` workers; return results by rank.

    Reference semantics (runner/__init__.py:89): the function runs after
    ``hvd.init()`` on every worker; the returned list has one entry per rank.
    """
    kwargs = kwargs or {}
    host_infos = parse_hosts(hosts) if hosts else [HostInfo("localhost", np)]
    _check_shared_fs(host_infos, env)
    with _worker_bootstrap(fn, args, kwargs, env,
                           use_current_interpreter) as (tmp, command,
                                                        base_env):
        launch_static(host_infos, np, command, base_env, verbose=verbose)
        return _collect_results(tmp, np)


def run_elastic(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
                np: int = 2, min_np: Optional[int] = None,
                max_np: Optional[int] = None,
                discovery=None, discovery_script: Optional[str] = None,
                hosts: Optional[str] = None,
                env: Optional[Dict[str, str]] = None,
                reset_limit: Optional[int] = None,
                timeout: Optional[float] = None,
                verbose: bool = False) -> List[Any]:
    """Elastic counterpart of :func:`run` (parity:
    ``horovod.spark.run_elastic``, reference spark/runner.py:303, over the
    gloo-elastic flow of launch.py:574).

    ``fn`` runs on every worker under the elastic runtime; wrap its training
    loop with ``@hvd.elastic.run`` + a committed state to survive membership
    changes. Membership comes from ``discovery`` (a HostDiscovery), a
    ``discovery_script`` (path whose stdout lists ``host:slots``), or a
    static ``hosts`` string. Returns the final world's results in rank
    order; workers scaled out mid-run are excluded.
    """
    kwargs = kwargs or {}
    from ..elastic.discovery import FixedHosts, HostDiscoveryScript
    from ..elastic.launcher import launch_elastic_job
    if discovery is None:
        if discovery_script:
            discovery = HostDiscoveryScript(discovery_script)
        elif hosts:
            host_infos = parse_hosts(hosts)
            _check_shared_fs(host_infos, env)
            discovery = FixedHosts({h.hostname: h.slots
                                    for h in host_infos})
        else:
            discovery = FixedHosts({"localhost": max_np or np})
    with _worker_bootstrap(fn, args, kwargs, env) as (tmp, command,
                                                      base_env):
        driver = launch_elastic_job(discovery, np, command,
                                    base_env=base_env,
                                    min_np=min_np or np, max_np=max_np,
                                    reset_limit=reset_limit, timeout=timeout,
                                    verbose=verbose)
        # validate against the FINAL world size (a truncated scan would
        # silently return partial results)
        return _collect_results(tmp, driver.world_size())


__all__ = ["run", "run_elastic", "launch_static", "HostInfo", "parse_hosts"]
