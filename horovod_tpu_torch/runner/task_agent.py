"""Task-agent entry point: ``python -m horovod_tpu_torch.runner.task_agent``.

The port's copy of ``horovod_tpu/runner/task_agent.py``, line for line:
plain Python, no torch.

Started on each worker host (via ssh or a cluster scheduler) before the job
launches when ssh-per-worker isn't viable or NIC discovery is required
(reference driver/driver_service.py:48 launches task servers on every host).
The agent:

1. reads the job secret from ``HOROVOD_TASK_SECRET`` (hex),
2. starts the signed :class:`~horovod_tpu_torch.runner.service.TaskService`,
3. registers ``host:port`` under ``task_addresses/<index>`` in the driver's
   rendezvous KV,
4. serves until killed.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading

from .http_client import put_data_into_kvstore
from .service import TaskService

SCOPE_TASK_ADDRS = "task_addresses"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="horovod_tpu_torch.runner.task_agent")
    ap.add_argument("--index", default="0", help="host index in the job")
    ap.add_argument("--driver-addr", default=None,
                    help="optional KV server to register with; the agent "
                         "keeps retrying in the background, so agents may "
                         "start before the driver")
    ap.add_argument("--driver-port", default=0, type=int)
    ap.add_argument("--hostname", default=None)
    ap.add_argument("--port", default=0, type=int,
                    help="fixed service port (0 = ephemeral)")
    args = ap.parse_args(argv)

    key_hex = os.environ.get("HOROVOD_TASK_SECRET")
    if not key_hex:
        print("task_agent: HOROVOD_TASK_SECRET is not set", file=sys.stderr)
        return 2
    service = TaskService(bytes.fromhex(key_hex), addr=("0.0.0.0", args.port))
    service.start()
    host = args.hostname or socket.gethostname()
    # the operator collects this address for `tpurun --task-agents ...`
    print(f"task_agent: serving at {host}:{service.port}", flush=True)
    stop = threading.Event()

    if args.driver_addr:
        def _register():
            # best-effort, retried: the launcher-side KV may not exist yet
            # (agents typically start first), and --task-agents doesn't
            # depend on registration at all
            while not stop.is_set():
                try:
                    put_data_into_kvstore(
                        args.driver_addr, args.driver_port, SCOPE_TASK_ADDRS,
                        str(args.index), f"{host}:{service.port}".encode(),
                        timeout=5)
                    return
                except Exception:
                    stop.wait(2.0)

        # errflow: ignore[best-effort bounded advertisement retry; exits on the agent stop event that also gates process exit]
        threading.Thread(target=_register, daemon=True).start()

    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
