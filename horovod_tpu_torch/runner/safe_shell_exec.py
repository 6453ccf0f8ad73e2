"""Safe subprocess execution with process-group cleanup.

The port's copy of ``horovod_tpu/runner/safe_shell_exec.py``, line for line:
plain Python, no torch.

Parity: reference ``horovod/runner/common/util/safe_shell_exec.py:162``
(``execute`` with own process group, event-driven termination, stdout/err
pumping threads). The launcher uses this for every worker it spawns so that a
failed or aborted job never leaves orphan workers holding the TPU.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import IO, Optional

GRACEFUL_TERMINATION_TIME_S = 5


def _pump(src: IO[bytes], dst, prefix: Optional[str] = None):
    try:
        for line in iter(src.readline, b""):
            text = line.decode("utf-8", errors="replace")
            if prefix is not None:
                text = f"[{prefix}]{text if text.startswith(':') else ':' + text}"
            dst.write(text)
            dst.flush()
    except ValueError:
        pass  # stream closed during shutdown
    finally:
        try:
            src.close()
        except Exception:
            pass


def terminate_process_group(proc: subprocess.Popen,
                            grace_s: float = GRACEFUL_TERMINATION_TIME_S):
    """SIGTERM the whole group, then SIGKILL whatever survives."""
    if proc.poll() is not None:
        return
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return
        time.sleep(0.1)
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def execute(command, env: Optional[dict] = None,
            stdout=None, stderr=None, index: Optional[int] = None,
            events=None, prefix_output_with_timestamp: bool = False,
            shell: Optional[bool] = None, on_start=None) -> int:
    """Run ``command`` in its own process group; returns the exit code.

    ``events`` is an optional list of ``threading.Event``s — when any is set,
    the process group is terminated (the reference uses this to fan a single
    "job failed" event out to every ssh thread, gloo_run.py:254-260).
    ``on_start(pid)`` is invoked once the process exists (the task service
    uses it to support abort, task_service.py:25-111 role).
    """
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    if shell is None:
        shell = isinstance(command, str)
    proc = subprocess.Popen(
        command, shell=shell, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    if on_start is not None:
        on_start(proc.pid)

    prefix = str(index) if index is not None else None
    pumps = [
        threading.Thread(target=_pump, args=(proc.stdout, stdout, prefix),
                         daemon=True),
        threading.Thread(target=_pump, args=(proc.stderr, stderr, prefix),
                         daemon=True),
    ]
    for t in pumps:
        t.start()

    stop_watch = threading.Event()
    watcher = None
    if events:
        def _watch():
            while not stop_watch.is_set():
                if any(e.is_set() for e in events):
                    terminate_process_group(proc)
                    return
                time.sleep(0.1)
        watcher = threading.Thread(target=_watch, daemon=True)
        watcher.start()

    try:
        proc.wait()
    except KeyboardInterrupt:
        terminate_process_group(proc)
        raise
    finally:
        stop_watch.set()
        for t in pumps:
            t.join(timeout=2)
        if watcher is not None:
            watcher.join(timeout=2)
    return proc.returncode
