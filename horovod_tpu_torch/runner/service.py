"""Authenticated task RPC: driver⇄task-agent command channel.

The port's copy of ``horovod_tpu/runner/service.py``, line for line: plain
Python, no torch.

Parity: the reference's service layer (common/service/task_service.py:25-111
BasicTaskService handles RunCommand/AbortCommand/WaitForCommandExitCode over
HMAC-signed pickled socket messages; common/util/network.py BasicService).
TPU-native redesign: JSON-over-HTTP on the same fabric as the rendezvous KV,
authenticated with HMAC-SHA256 over the request body — no pickle on the wire
(the reference's pickled RPC is an RCE hazard the signature merely gates;
JSON removes the class entirely).

The task agent runs on each worker host when ssh isn't available or NIC
discovery is needed (reference driver_service.py:48): it executes launcher
commands, reports exit codes, and answers connectivity probes (the
driver-address intersection of driver_service.py:135-204).
"""

from __future__ import annotations

import hashlib
import hmac
import http.server
import json
import logging
import os
import secrets as _secrets
import signal
import socket
import threading
import urllib.request
from typing import Dict, List, Optional

from . import safe_shell_exec

_LOG = logging.getLogger("horovod_tpu_torch.runner")

SIG_HEADER = "X-HVD-Signature"
TS_HEADER = "X-HVD-Timestamp"
MAX_CLOCK_SKEW_S = 300.0


def make_secret_key() -> bytes:
    """Shared job secret (reference runner/common/secret.py)."""
    return _secrets.token_bytes(32)


def _sign(key: bytes, verb: str, ts: str, body: bytes) -> str:
    """MAC binds the verb and a timestamp, not just the body: a captured
    request can be neither replayed after the freshness window nor re-routed
    to a different verb (e.g. an empty-body exit-code probe re-sent as
    abort_command)."""
    msg = verb.encode() + b"\n" + ts.encode() + b"\n" + body
    return hmac.new(key, msg, hashlib.sha256).hexdigest()


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def do_POST(self):
        service: "TaskService" = self.server.service  # type: ignore
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        verb = self.path.strip("/")
        sig = self.headers.get(SIG_HEADER, "")
        ts = self.headers.get(TS_HEADER, "")
        import time as _time
        try:
            fresh = abs(_time.time() - float(ts)) <= MAX_CLOCK_SKEW_S
        except ValueError:
            fresh = False
        if not fresh or not hmac.compare_digest(
                sig, _sign(service.key, verb, ts, body)):
            self._respond(401, {"error": "bad or stale signature"})
            return
        # Replay protection: a captured request is valid for the
        # whole freshness window unless its exact (timestamp, signature) is
        # remembered and rejected on re-use.
        if not service.note_signature(ts, sig):
            self._respond(401, {"error": "replayed request"})
            return
        try:
            payload = json.loads(body) if body else {}
            result = service.handle(verb, payload)
            self._respond(200, result)
        except KeyError:
            self._respond(404, {"error": f"unknown verb {verb!r}"})
        except Exception as e:
            self._respond(500, {"error": f"{type(e).__name__}: {e}"})

    def _respond(self, code: int, obj: dict):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class TaskService:
    """Per-host agent: executes launcher commands, reports exit codes,
    answers connectivity probes. All requests must be HMAC-signed with the
    job secret."""

    def __init__(self, key: bytes, addr=("0.0.0.0", 0)):
        self.key = key
        self._httpd = http.server.ThreadingHTTPServer(addr, _Handler)
        self._httpd.service = self  # type: ignore
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._proc_pid: Optional[int] = None
        self._exit_code: Optional[int] = None
        self._error: Optional[str] = None
        self._cmd_thread: Optional[threading.Thread] = None
        # replay cache: signatures seen inside the freshness window (bounded
        # well above any legitimate request rate for a 300 s window)
        self._seen_sigs: Dict[str, float] = {}
        self._seen_cap = 4096
        self._cap_logged = False

    def note_signature(self, ts: str, sig: str) -> bool:
        """Record a (timestamp, signature) pair; False if already seen
        (replay). An entry must outlive its *request timestamp's* freshness
        window, not its arrival time: a future-skewed request (ts up to
        MAX_CLOCK_SKEW_S ahead) stays replayable until `now - ts` exceeds
        the window, so expiring by arrival time would reopen it."""
        import time as _time
        now = _time.time()
        try:
            req_ts = float(ts)
        except ValueError:
            return False
        key = f"{ts}:{sig}"
        with self._lock:
            for k, t in list(self._seen_sigs.items()):
                if now - t > MAX_CLOCK_SKEW_S:
                    del self._seen_sigs[k]
            if key in self._seen_sigs:
                return False
            if len(self._seen_sigs) >= self._seen_cap:
                # Fail CLOSED: every cached signature is still
                # inside its freshness window (expired ones were dropped
                # above), so evicting one would silently re-open the replay
                # hole for it. A burst past the cap — far above any
                # legitimate launcher rate (4096 entries over a ~330 s
                # window is >12 req/s sustained) — is rejected instead,
                # and LOUDLY (once per episode, so the burst that caused
                # the lockout can't also flood the log at its own rate):
                # operators must be able to tell capacity lockout from
                # replay rejection.
                if not self._cap_logged:
                    self._cap_logged = True
                    _LOG.error(
                        "task-service replay cache full (%d unexpired "
                        "signatures); rejecting NEW requests for capacity, "
                        "not replay. A crash-looping launcher or clock "
                        "skew can cause this; service recovers as entries "
                        "age out of the %ds freshness window.",
                        len(self._seen_sigs), MAX_CLOCK_SKEW_S)
                return False
            self._cap_logged = False  # room again: next episode logs anew
            # remember until the request's own window closes
            self._seen_sigs[key] = max(now, req_ts)
            return True

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="hvd-task-service", daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        # join the serve thread so no zombie handler races whatever the
        # agent does next (errflow leak-on-raise audit)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- verbs --------------------------------------------------------------

    def handle(self, verb: str, payload: dict) -> dict:
        return {
            "run_command": self._run_command,
            "command_exit_code": self._command_exit_code,
            "abort_command": self._abort_command,
            "probe": self._probe,
        }[verb](payload)

    def _run_command(self, payload: dict) -> dict:
        cmd: List[str] = payload["command"]
        env: Dict[str, str] = dict(os.environ)
        env.update(payload.get("env") or {})
        with self._lock:
            if self._cmd_thread is not None and self._cmd_thread.is_alive():
                return {"started": False, "error": "a command is running"}
            self._exit_code = None
            self._error = None

            def _runner():
                try:
                    code = safe_shell_exec.execute(
                        cmd, env=env,
                        on_start=self._record_pid)
                except Exception as e:   # e.g. FileNotFoundError
                    with self._lock:
                        self._exit_code = 127
                        self._error = f"{type(e).__name__}: {e}"
                        self._proc_pid = None
                    return
                with self._lock:
                    self._exit_code = code
                    self._proc_pid = None

            # errflow: ignore[the command deliberately outlives the RPC that started it; abort_command owns termination and exit codes are polled via command_exit_code]
            self._cmd_thread = threading.Thread(target=_runner, daemon=True,
                                                name="hvd-task-cmd")
            self._cmd_thread.start()
        return {"started": True}

    def _record_pid(self, pid: int):
        with self._lock:
            self._proc_pid = pid

    def _command_exit_code(self, payload: dict) -> dict:
        with self._lock:
            running = (self._cmd_thread is not None and
                       self._cmd_thread.is_alive())
            return {"running": running, "exit_code": self._exit_code,
                    "error": self._error}

    def _abort_command(self, payload: dict) -> dict:
        with self._lock:
            pid = self._proc_pid
        if pid is None:
            return {"aborted": False}
        try:
            os.killpg(os.getpgid(pid), signal.SIGTERM)
            return {"aborted": True}
        except ProcessLookupError:
            return {"aborted": False}

    def _probe(self, payload: dict) -> dict:
        """Which of the driver's candidate addresses can this host reach?
        (reference driver_service.py:135-204 interface intersection)."""
        reachable = []
        port = int(payload["port"])
        for addr in payload.get("addresses", []):
            try:
                with socket.create_connection((addr, port), timeout=2):
                    reachable.append(addr)
            except OSError:
                continue
        return {"reachable": reachable}


class TaskClient:
    """Driver-side signed-RPC client (reference task_service.py:187-260)."""

    def __init__(self, addr: str, key: bytes, timeout: float = 10.0):
        host, _, port = addr.rpartition(":")
        self._base = f"http://{host}:{int(port)}"
        self._key = key
        self._timeout = timeout

    def _call(self, verb: str, payload: dict) -> dict:
        import time as _time
        body = json.dumps(payload).encode()
        ts = repr(_time.time())
        req = urllib.request.Request(
            f"{self._base}/{verb}", data=body, method="POST",
            headers={SIG_HEADER: _sign(self._key, verb, ts, body),
                     TS_HEADER: ts,
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self._timeout) as resp:
            return json.loads(resp.read())

    def run_command(self, command: List[str],
                    env: Optional[Dict[str, str]] = None) -> dict:
        return self._call("run_command", {"command": command, "env": env})

    def command_exit_code(self) -> dict:
        return self._call("command_exit_code", {})

    def wait_for_command_exit_code(self, timeout: float = 300.0,
                                   poll: float = 0.5) -> int:
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.command_exit_code()
            if not st["running"] and st["exit_code"] is not None:
                if st.get("error"):
                    raise RuntimeError(
                        f"task command failed to launch: {st['error']}")
                return int(st["exit_code"])
            time.sleep(poll)
        raise TimeoutError("command did not finish in time")

    def abort_command(self) -> dict:
        return self._call("abort_command", {})

    def probe(self, addresses: List[str], port: int) -> List[str]:
        return self._call("probe", {"addresses": addresses,
                                    "port": port})["reachable"]


# ---------------------------------------------------------------------------
# NIC discovery (reference driver/driver_service.py:135-204)
# ---------------------------------------------------------------------------


def candidate_driver_ips(interfaces: Optional[List[str]] = None) -> List[str]:
    """This host's candidate IPs a worker might reach the driver on."""
    cands: List[str] = []

    def _add(ip):
        if ip and ip not in cands and not ip.startswith("127."):
            cands.append(ip)

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))  # route lookup only, nothing is sent
        _add(s.getsockname()[0])
    except OSError:
        pass
    finally:
        s.close()
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       socket.AF_INET):
            _add(info[4][0])
    except OSError:
        pass
    if interfaces:
        # restrict to the addresses of the named interfaces (reference
        # --network-interface flag); needs per-iface lookup
        try:
            import fcntl
            import struct
            allowed = []
            for iface in interfaces:
                sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:
                    ip = socket.inet_ntoa(fcntl.ioctl(
                        sk.fileno(), 0x8915,  # SIOCGIFADDR
                        struct.pack("256s", iface.encode()[:15]))[20:24])
                    allowed.append(ip)
                except OSError:
                    pass
                finally:
                    sk.close()
            if not allowed:
                raise ValueError(
                    f"none of the requested network interfaces {interfaces} "
                    f"exist or have an IPv4 address")
            cands[:] = [c for c in cands if c in allowed] or allowed
        except ImportError:
            pass
    cands.append("127.0.0.1")  # last resort (single-host)
    return cands


def resolve_driver_ip(clients: List[TaskClient], port: int,
                      interfaces: Optional[List[str]] = None) -> str:
    """Ask every host's task agent which candidate driver addresses it can
    reach; return the first address reachable by ALL hosts (the reference's
    interface intersection, driver_service.py:135-204)."""
    cands = candidate_driver_ips(interfaces)
    if not clients:
        return cands[0]
    reach_sets = [set(c.probe(cands, port)) for c in clients]
    for cand in cands:  # preserve preference order
        if all(cand in rs for rs in reach_sets):
            return cand
    raise RuntimeError(
        f"no driver address in {cands} is reachable by every worker host; "
        f"check firewalls or pass --network-interfaces")
