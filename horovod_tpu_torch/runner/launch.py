"""``tpurun`` — the launcher CLI (``python -m horovod_tpu_torch.runner``).

The port's copy of ``horovod_tpu/runner/launch.py``. Parity: reference
``horovod/runner/launch.py`` (horovodrun arg surface, launch.py:216-483;
static run at :485, elastic at :574) and ``horovod/runner/gloo_run.py``
(rendezvous server + per-slot env + exec threads, gloo_run.py:69-260).

Every launch is "gloo-style": start a rendezvous/KV HTTP server on the
driver, compute slot assignments, and spawn workers (local subprocess or
ssh) whose env carries both the Horovod-style topology
(HOROVOD_RANK/SIZE/LOCAL_RANK/...) and the world bootstrap
(HOROVOD_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID). Rank 0 hosts the
``torch.distributed`` store of the world.

Changed from the reference where torch requires it: the environment an
ssh launch forwards names the CUDA and NCCL variables
(``CUDA_VISIBLE_DEVICES``, ``NCCL_SOCKET_IFNAME``, ``GLOO_SOCKET_IFNAME``)
where the reference forwards the JAX and XLA ones (``_FORWARDED_ENV``).
``--elastic`` asks for the elastic launch by name (the reference infers
it from ``--min-np`` or ``--host-discovery-script``, as this one still
does). ``--config-file`` imports ``yaml`` when it is given, as the
reference does.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
from typing import Dict, List, Optional

from ..common import env as env_mod
from . import safe_shell_exec
from .hosts import HostInfo, SlotInfo, get_host_assignments, parse_hosts, \
    parse_host_files
from .http_server import RendezvousServer, find_free_port

LOCAL_HOSTNAMES = {"localhost", "127.0.0.1", "::1"}

# Sentinel for HOROVOD_TPU_COORDINATOR: rank 0 allocates the port on its own
# host and publishes the real address to the rendezvous KV store.
COORDINATOR_VIA_RENDEZVOUS = "@rendezvous"

# what a remote (ssh or task-agent) worker inherits besides HOROVOD_*
_FORWARDED_ENV = ("PATH", "PYTHONPATH", "LD_LIBRARY_PATH",
                  "CUDA_VISIBLE_DEVICES", "NCCL_SOCKET_IFNAME",
                  "GLOO_SOCKET_IFNAME")


def is_local_host(hostname: str) -> bool:
    return (hostname in LOCAL_HOSTNAMES
            or hostname == socket.gethostname()
            or hostname == socket.getfqdn())


def make_worker_env(slot: SlotInfo, coordinator_addr: str,
                    rendezvous_addr: str, rendezvous_port: int,
                    base_env: Optional[Dict[str, str]] = None,
                    elastic: bool = False) -> Dict[str, str]:
    """Build the env block a worker boots from (gloo_run.py:77-97 parity)."""
    env = dict(base_env if base_env is not None else os.environ)
    env.update({
        env_mod.HOROVOD_RANK: str(slot.rank),
        env_mod.HOROVOD_SIZE: str(slot.size),
        env_mod.HOROVOD_LOCAL_RANK: str(slot.local_rank),
        env_mod.HOROVOD_LOCAL_SIZE: str(slot.local_size),
        env_mod.HOROVOD_CROSS_RANK: str(slot.cross_rank),
        env_mod.HOROVOD_CROSS_SIZE: str(slot.cross_size),
        env_mod.HOROVOD_HOSTNAME: slot.hostname,
        env_mod.HOROVOD_TPU_COORDINATOR: coordinator_addr,
        env_mod.HOROVOD_TPU_NUM_PROCESSES: str(slot.size),
        env_mod.HOROVOD_TPU_PROCESS_ID: str(slot.rank),
        env_mod.HOROVOD_GLOO_RENDEZVOUS_ADDR: rendezvous_addr,
        env_mod.HOROVOD_GLOO_RENDEZVOUS_PORT: str(rendezvous_port),
    })
    if elastic:
        env[env_mod.HOROVOD_ELASTIC] = "1"
    return env


def get_ssh_command(command: str, host: str, port: Optional[int] = None,
                    identity_file: Optional[str] = None) -> str:
    opts = "-o StrictHostKeyChecking=no -o BatchMode=yes"
    if port:
        opts += f" -p {port}"
    if identity_file:
        opts += f" -i {identity_file}"
    import shlex
    return f"ssh {opts} {host} {shlex.quote(command)}"


def slot_command(command: List[str], env: Dict[str, str], slot: SlotInfo,
                 ssh_port: Optional[int] = None,
                 identity_file: Optional[str] = None) -> str:
    """Full shell command to start one worker (local or via ssh)."""
    import shlex
    cmd = " ".join(shlex.quote(c) for c in command)
    if is_local_host(slot.hostname):
        return cmd
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items())
                       if k.startswith("HOROVOD") or k in _FORWARDED_ENV)
    remote = f"cd {shlex.quote(os.getcwd())} > /dev/null 2>&1 ; {exports} {cmd}"
    return get_ssh_command(remote, slot.hostname, ssh_port, identity_file)


def launch_static(hosts: List[HostInfo], np: int, command: List[str],
                  base_env: Optional[Dict[str, str]] = None,
                  ssh_port: Optional[int] = None,
                  identity_file: Optional[str] = None,
                  network_interfaces: Optional[List[str]] = None,
                  verbose: bool = False) -> None:
    """Static (fixed world) launch — reference gloo_run.py:215-260.

    Starts the rendezvous server, assigns slots, spawns one thread per worker
    running it under :mod:`safe_shell_exec`, and fails the whole job (tearing
    down every other worker) as soon as any worker exits non-zero.
    """
    assignments = get_host_assignments(hosts, np, np)

    server = RendezvousServer()
    server.start()
    driver_ip = _driver_ip(hosts, network_interfaces)
    # The world's store lives inside rank 0's process, on rank 0's host —
    # the driver cannot pick a race-free port for it. Rank 0 binds a free
    # port itself and publishes host:port to the rendezvous KV; every other
    # worker long-polls it (Backend.init handles both sides).
    coordinator_addr = COORDINATOR_VIA_RENDEZVOUS
    server.init(assignments, None)
    if verbose:
        print(f"[tpurun] rendezvous {driver_ip}:{server.port} "
              f"coordinator via rendezvous", file=sys.stderr)

    failure = threading.Event()
    exit_codes: Dict[int, int] = {}

    def _work(slot: SlotInfo):
        env = make_worker_env(slot, coordinator_addr, driver_ip, server.port,
                              base_env)
        cmd = slot_command(command, env, slot, ssh_port, identity_file)
        code = safe_shell_exec.execute(cmd, env=env, index=slot.rank,
                                       events=[failure])
        exit_codes[slot.rank] = code
        if code != 0:
            failure.set()

    threads = [threading.Thread(target=_work, args=(s,), daemon=True)
               for s in assignments]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.stop()

    bad = {r: c for r, c in exit_codes.items() if c != 0}
    if bad:
        raise RuntimeError(
            f"tpurun: {len(bad)} worker(s) exited non-zero: {bad}")


def _parse_interfaces(args) -> Optional[List[str]]:
    """--network-interfaces > HOROVOD_GLOO_IFACE (reference NIC pin knob);
    whitespace-tolerant ("eth0, eth1")."""
    iface_s = getattr(args, "network_interfaces", None) or \
        os.environ.get(env_mod.HOROVOD_GLOO_IFACE)
    if not iface_s:
        return None
    return [t.strip() for t in iface_s.split(",") if t.strip()] or None


def _driver_ip(hosts: List[HostInfo],
               interfaces: Optional[List[str]] = None) -> str:
    if all(is_local_host(h.hostname) for h in hosts):
        return "127.0.0.1"
    # candidate enumeration (+ optional interface pinning) from the NIC
    # discovery layer; full cross-host intersection needs task agents
    # (launch_via_task_agents / resolve_driver_ip)
    from .service import candidate_driver_ips
    cands = candidate_driver_ips(interfaces)
    return cands[0]


def launch_via_task_agents(agent_addrs: List[str], key: bytes, np: int,
                           command: List[str],
                           base_env: Optional[Dict[str, str]] = None,
                           interfaces: Optional[List[str]] = None,
                           timeout: float = 600.0,
                           verbose: bool = False) -> None:
    """Static launch through pre-started task agents instead of ssh
    (reference flow: driver_service.py:48 task servers on every host +
    :135-204 NIC intersection + task_service RunCommand). One agent = one
    slot; the driver address every host can reach is chosen by probing the
    rendezvous port through each agent."""
    import time as _time
    from .service import TaskClient, resolve_driver_ip
    if np > len(agent_addrs):
        raise ValueError(f"need {np} agents, have {len(agent_addrs)}")
    clients = [TaskClient(a, key, timeout=30) for a in agent_addrs[:np]]

    # Agents on the same host share that host's local-rank space: aggregate
    # per-host slot counts so two agents on h1 become local ranks 0 and 1
    # instead of two colliding (h1, 0) slots.
    host_order: List[str] = []
    host_slots: Dict[str, int] = {}
    agent_of_slot: Dict[tuple, TaskClient] = {}
    for a, c in zip(agent_addrs[:np], clients):
        host = a.rsplit(":", 1)[0]
        if host not in host_slots:
            host_slots[host] = 0
            host_order.append(host)
        agent_of_slot[(host, host_slots[host])] = c
        host_slots[host] += 1
    hosts = [HostInfo(h, host_slots[h]) for h in host_order]

    server = RendezvousServer()
    server.start()
    try:
        assignments = get_host_assignments(hosts, np, np)
        server.init(assignments, None)
        driver_ip = resolve_driver_ip(clients, server.port,
                                      interfaces=interfaces)
        if verbose:
            print(f"[tpurun] task-agent launch; driver {driver_ip}:"
                  f"{server.port}", file=sys.stderr)
        slot_clients = [(s, agent_of_slot[(s.hostname, s.local_rank)])
                        for s in assignments]
        for slot, client in slot_clients:
            # base_env is the caller's explicit worker env (the CLI path
            # pre-filters os.environ); the job secret must never ride along
            # — the RPC channel is authenticated, not encrypted.
            env = make_worker_env(slot, COORDINATOR_VIA_RENDEZVOUS,
                                  driver_ip, server.port, base_env or {})
            env.pop("HOROVOD_TASK_SECRET", None)
            res = client.run_command(command, env=env)
            if not res.get("started"):
                for _, other in slot_clients:
                    try:
                        other.abort_command()
                    except Exception:
                        pass
                raise RuntimeError(
                    f"tpurun: agent for rank {slot.rank} refused the "
                    f"command: {res.get('error')}")
        # shared deadline + failure fan-out: first non-zero exit aborts the
        # rest (launch_static's failure-Event behavior, gloo_run.py:254-260)
        deadline = _time.monotonic() + timeout
        codes: Dict[int, int] = {}
        pending = {s.rank: c for s, c in slot_clients}
        failed = None
        while pending and _time.monotonic() < deadline:
            for rank, client in list(pending.items()):
                st = client.command_exit_code()
                if st["running"] or st["exit_code"] is None:
                    continue
                if st.get("error"):
                    codes[rank] = 127
                else:
                    codes[rank] = int(st["exit_code"])
                del pending[rank]
                if codes[rank] != 0 and failed is None:
                    failed = rank
            if failed is not None:
                break
            _time.sleep(0.5)
        if pending:
            for rank, client in pending.items():
                try:
                    client.abort_command()
                    codes[rank] = client.wait_for_command_exit_code(
                        timeout=15)
                except Exception:
                    codes[rank] = -1
        bad = {r: c for r, c in codes.items() if c != 0}
        if bad:
            raise RuntimeError(
                f"tpurun: {len(bad)} worker(s) exited non-zero: {bad}")
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpurun",
        description="Launch a horovod_tpu_torch distributed job "
                    "(parity: horovodrun, reference runner/launch.py:216)")
    p.add_argument("-v", "--version", action="store_true")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="number of worker processes")
    p.add_argument("-H", "--hosts", default=None,
                   help='host list, e.g. "h1:4,h2:4"; default localhost:np')
    p.add_argument("--network-interfaces", default=None,
                   help="comma-separated NICs the driver may advertise "
                        "(reference --network-interface); candidates are "
                        "intersected across hosts when task agents are used")
    p.add_argument("--task-agents", default=None,
                   help="comma-separated pre-started task-agent addresses "
                        "(host:port); launches through the signed RPC "
                        "channel instead of ssh. Requires "
                        "HOROVOD_TASK_SECRET (hex) in the environment.")
    p.add_argument("--hostfile", default=None,
                   help="hostfile with one 'host slots=N' per line")
    p.add_argument("-p", "--ssh-port", type=int, default=None)
    p.add_argument("-i", "--ssh-identity-file", default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--config-file", default=None,
                   help="YAML config mirroring CLI flags "
                        "(reference common/util/config_parser.py)")

    g = p.add_argument_group("elastic")
    g.add_argument("--elastic", action="store_true",
                   help="run elastically (implied by --min-np or "
                        "--host-discovery-script)")
    g.add_argument("--min-np", type=int, default=None)
    g.add_argument("--max-np", type=int, default=None)
    g.add_argument("--host-discovery-script", default=None)
    g.add_argument("--slots-per-host", type=int, default=1)
    g.add_argument("--reset-limit", type=int, default=None)

    t = p.add_argument_group("tuning/observability (exported as env)")
    t.add_argument("--fusion-threshold-mb", type=float, default=None)
    t.add_argument("--cycle-time-ms", type=float, default=None)
    t.add_argument("--cache-capacity", type=int, default=None)
    t.add_argument("--timeline-filename", default=None)
    t.add_argument("--timeline-mark-cycles", action="store_true")
    t.add_argument("--autotune", action="store_true")
    t.add_argument("--autotune-log-file", default=None)
    t.add_argument("--no-stall-check", action="store_true")
    t.add_argument("--stall-check-warning-time-seconds", type=float,
                   default=None)
    t.add_argument("--stall-check-shutdown-time-seconds", type=float,
                   default=None)

    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command to run on every worker")
    args = p.parse_args(argv)
    if args.config_file:
        _merge_config_file(p, args, argv if argv is not None else sys.argv[1:])
    return args


def _merge_config_file(parser: argparse.ArgumentParser,
                       args: argparse.Namespace, argv: List[str]):
    """Fill flags NOT given on the command line from a YAML config
    (kebab-case keys, nested groups flattened) — reference
    config_parser.py:199 behavior: explicit CLI always wins, including
    explicit falsy values like ``--cycle-time-ms 0``."""
    import yaml
    with open(args.config_file) as f:
        cfg = yaml.safe_load(f) or {}

    # Which dests were explicitly set on the command line?
    explicit = set()
    given = set()
    for tok in argv:
        if tok == "--":
            break
        given.add(tok.split("=", 1)[0])
    for action in parser._actions:  # noqa: SLF001
        if any(opt in given for opt in action.option_strings):
            explicit.add(action.dest)

    def _flat(d, out):
        for k, v in d.items():
            if isinstance(v, dict):
                _flat(v, out)
            else:
                out[k.replace("-", "_")] = v
        return out

    for key, value in _flat(cfg, {}).items():
        if hasattr(args, key) and key not in explicit:
            setattr(args, key, value)


def env_from_args(args: argparse.Namespace) -> Dict[str, str]:
    """Translate CLI flags to HOROVOD_* env (reference launch.py:158-214
    make_override_action)."""
    env: Dict[str, str] = {}
    if args.fusion_threshold_mb is not None:
        env[env_mod.HOROVOD_FUSION_THRESHOLD] = \
            str(int(args.fusion_threshold_mb * 1024 * 1024))
    if args.cycle_time_ms is not None:
        env[env_mod.HOROVOD_CYCLE_TIME] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env[env_mod.HOROVOD_CACHE_CAPACITY] = str(args.cache_capacity)
    if args.timeline_filename:
        env[env_mod.HOROVOD_TIMELINE] = args.timeline_filename
    if args.timeline_mark_cycles:
        env[env_mod.HOROVOD_TIMELINE_MARK_CYCLES] = "1"
    if args.autotune:
        env[env_mod.HOROVOD_AUTOTUNE] = "1"
        if args.autotune_log_file:
            env[env_mod.HOROVOD_AUTOTUNE_LOG] = args.autotune_log_file
    if args.no_stall_check:
        env[env_mod.HOROVOD_STALL_CHECK_DISABLE] = "1"
    if args.stall_check_warning_time_seconds is not None:
        env[env_mod.HOROVOD_STALL_CHECK_TIME_SECONDS] = \
            str(args.stall_check_warning_time_seconds)
    if args.stall_check_shutdown_time_seconds is not None:
        env[env_mod.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS] = \
            str(args.stall_check_shutdown_time_seconds)
    return env


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.version:
        from ..version import __version__
        print(__version__)
        return 0
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("tpurun: no command given", file=sys.stderr)
        return 2

    base_env = dict(os.environ)
    base_env.update(env_from_args(args))

    elastic = (args.elastic or args.host_discovery_script is not None
               or args.min_np is not None)
    if elastic:
        try:
            from ..elastic.launcher import launch_elastic
        except ImportError as e:
            print(f"tpurun: elastic mode unavailable: {e}", file=sys.stderr)
            return 2
        return launch_elastic(args, command, base_env)

    if args.num_proc is None:
        print("tpurun: -np required for static runs", file=sys.stderr)
        return 2
    if args.hostfile:
        hosts = parse_host_files(args.hostfile)
    elif args.hosts:
        hosts = parse_hosts(args.hosts)
    else:
        hosts = [HostInfo("localhost", args.num_proc)]
    ifaces = _parse_interfaces(args)
    if args.task_agents:
        key_hex = os.environ.get("HOROVOD_TASK_SECRET")
        if not key_hex:
            print("tpurun: --task-agents needs HOROVOD_TASK_SECRET (hex)",
                  file=sys.stderr)
            return 2
        # ship only what workers need, never the driver's whole environment
        # (it contains HOROVOD_TASK_SECRET; the RPC is signed, not encrypted)
        agent_env = {k: v for k, v in base_env.items()
                     if k.startswith("HOROVOD") or k in _FORWARDED_ENV}
        agent_env.pop("HOROVOD_TASK_SECRET", None)
        launch_via_task_agents(args.task_agents.split(","),
                               bytes.fromhex(key_hex), args.num_proc,
                               command, agent_env, interfaces=ifaces,
                               verbose=args.verbose)
        return 0
    launch_static(hosts, args.num_proc, command, base_env,
                  ssh_port=args.ssh_port,
                  identity_file=args.ssh_identity_file,
                  network_interfaces=ifaces,
                  verbose=args.verbose)
    return 0


if __name__ == "__main__":
    sys.exit(main())
