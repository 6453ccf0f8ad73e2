"""Elastic launch path for ``tpurun``.

The port's copy of ``horovod_tpu/elastic/launcher.py``, line for line: plain
Python, no torch.

Parity: reference ``horovod/runner/gloo_run.py:276-324`` (launch_gloo_elastic):
wire an ElasticRendezvousServer + ElasticDriver + host discovery, start
worker processes whose env points at the rendezvous (rank is *fetched*, not
fixed), and monitor exits.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Dict, List, Optional

from ..common import env as env_mod
from ..runner import safe_shell_exec
from ..runner.hosts import SlotInfo
from ..runner.launch import (COORDINATOR_VIA_RENDEZVOUS, _driver_ip,
                             is_local_host, slot_command)
from .discovery import FixedHosts, HostDiscoveryScript
from .driver import ElasticDriver
from .rendezvous import ElasticRendezvousServer

_LOG = logging.getLogger("horovod_tpu_torch.elastic")


def make_elastic_worker_env(slot: SlotInfo, rendezvous_addr: str,
                            rendezvous_port: int,
                            base_env: Optional[Dict[str, str]] = None,
                            rendezvous_endpoints: Optional[str] = None
                            ) -> Dict[str, str]:
    """Worker env for elastic mode: identity is (hostname, local_rank); the
    global rank/size are *not* pinned — the worker re-fetches its SlotInfo
    from the rendezvous on every (re-)init.

    ``rendezvous_endpoints``: a replica-set comma spec
    (``"h1:p1,h2:p2"``) advertised INSTEAD of the single address when the
    control plane is replicated — every worker KV consumer resolves it
    onto the shared Endpoints failover set (sticky primary, epoch-aware
    redirects, circuit breakers), so a driver failover never strands a
    worker on a dead address."""
    env = dict(base_env if base_env is not None else os.environ)
    env.update({
        env_mod.HOROVOD_ELASTIC: "1",
        env_mod.HOROVOD_HOSTNAME: slot.hostname,
        env_mod.HOROVOD_LOCAL_RANK: str(slot.local_rank),
        env_mod.HOROVOD_TPU_COORDINATOR: COORDINATOR_VIA_RENDEZVOUS,
        env_mod.HOROVOD_GLOO_RENDEZVOUS_ADDR:
            rendezvous_endpoints or rendezvous_addr,
        env_mod.HOROVOD_GLOO_RENDEZVOUS_PORT: str(rendezvous_port),
    })
    return env


def launch_elastic_job(discovery, np: int, command: List[str],
                       base_env: Optional[Dict[str, str]] = None,
                       min_np: Optional[int] = None,
                       max_np: Optional[int] = None,
                       reset_limit: Optional[int] = None,
                       ssh_port: Optional[int] = None,
                       identity_file: Optional[str] = None,
                       timeout: Optional[float] = None,
                       network_interfaces: Optional[List[str]] = None,
                       verbose: bool = False,
                       driver_callback=None) -> ElasticDriver:
    """Start the rendezvous + driver and run ``command`` elastically.

    Blocks until the job finishes; raises on error. Returns the driver (for
    tests, which may prefer driver.wait_for_finished themselves).
    ``driver_callback(driver)``, if given, fires as soon as the driver
    exists — the hook tests use to synchronize on ``wait_for_world``.
    """
    min_np = min_np or np
    server = ElasticRendezvousServer()
    server.start()
    driver = ElasticDriver(server, discovery, min_np=min_np, max_np=max_np,
                           timeout=timeout, reset_limit=reset_limit,
                           verbose=verbose)
    server.set_driver(driver)
    if driver_callback is not None:
        driver_callback(driver)

    def _rdv_addr_for(slot: SlotInfo) -> str:
        # per-slot, not once at startup: a remote host added later must get
        # the routable driver address, not loopback
        if is_local_host(slot.hostname):
            return "127.0.0.1"
        from ..runner.hosts import HostInfo
        return _driver_ip([HostInfo(slot.hostname, 1)],
                          network_interfaces)

    def _create_worker(slot: SlotInfo):
        env = make_elastic_worker_env(slot, _rdv_addr_for(slot), server.port,
                                      base_env)
        cmd = slot_command(command, env, slot, ssh_port, identity_file)

        def _monitor():
            code = safe_shell_exec.execute(cmd, env=env,
                                           index=slot.local_rank)
            driver.record_worker_exit(slot.hostname, slot.local_rank, code)

        # errflow: ignore[worker-monitor lifetime equals the worker process; record_worker_exit feeds the driver accounting that wait_for_finished()/join() gate shutdown on]
        threading.Thread(target=_monitor, daemon=True,
                         name=f"worker-{slot.hostname}:{slot.local_rank}"
                         ).start()

    try:
        driver.start(np, _create_worker)
        driver.wait_for_finished()
    finally:
        driver.join()
        server.stop()
    # wait_for_finished returns either on all-success or on stop(error);
    # failures along the way are fine as long as the final world succeeded
    if driver.error_message:
        raise RuntimeError(f"tpurun elastic: {driver.error_message}")
    return driver


def launch_elastic(args, command: List[str],
                   base_env: Dict[str, str]) -> int:
    """CLI entry (reference launch.py:574 _run_elastic)."""
    np = args.num_proc or args.min_np
    if np is None:
        print("tpurun: elastic mode needs -np or --min-np", file=sys.stderr)
        return 2
    if args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script,
                                        default_slots=args.slots_per_host)
    elif args.hosts:
        from ..runner.hosts import parse_hosts
        discovery = FixedHosts({h.hostname: h.slots
                                for h in parse_hosts(args.hosts)})
    else:
        print("tpurun: elastic mode needs --host-discovery-script or -H",
              file=sys.stderr)
        return 2
    from ..runner.launch import _parse_interfaces
    try:
        launch_elastic_job(discovery, np, command, base_env,
                           min_np=args.min_np or np, max_np=args.max_np,
                           reset_limit=args.reset_limit,
                           ssh_port=args.ssh_port,
                           identity_file=args.ssh_identity_file,
                           network_interfaces=_parse_interfaces(args),
                           verbose=args.verbose)
    except (RuntimeError, TimeoutError) as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0
