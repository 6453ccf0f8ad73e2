"""Failpoint fault injection (the port's copy of ``horovod_tpu/faults.py``).

``failpoint("name")`` markers sit where the engine can fail in the field
(submission, launch, completion, the compressed legs) and compile down to
a single ``is None`` check when no faults are armed. A test or a chaos run
arms them with ``HOROVOD_TPU_FAULTS`` (read at import) or :func:`arm`; the
spec grammar is the reference's::

    spec    := clause (';' clause)*
    clause  := name ['@' rank] '=' chain
    chain   := term ('->' term)*
    term    := [count '*'] action        # count: int, or '*' = forever
    action  := delay(DUR) | raise(EXC) | drop() | hang([DUR]) | noop()
    DUR     := float seconds, optional 's'/'ms' suffix

Each term consumes ``count`` hits (default 1); when every term of a chain
is exhausted the failpoint falls through to a no-op. ``@rank`` targets one
rank (``HOROVOD_RANK`` at hit time). ``raise(Exc)`` resolves ``Exc`` from
the builtins, then ``horovod_tpu_torch.common.exceptions``; ``hang()``
blocks until :func:`break_hangs` (the collective watchdog's escalation
path), :func:`disarm`, or its duration. Every fired action increments
``hvd_tpu_fault_injections_total`` (labels ``name``, ``action``).

Every call site uses a name declared in :data:`FAULT_SPECS`, and
:func:`arm` rejects clauses for undeclared names; names beginning with
``test.`` are exempt. :func:`arm_from_kv` arms every worker from one spec
in the rendezvous KV.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from .common.env import HOROVOD_TPU_FAULTS  # single source of knob names

logger = logging.getLogger("horovod_tpu_torch.faults")

NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")

# Every failpoint the port places, name -> help (the reference's table
# for the sites the port has; tests/test_torch_faults.py holds each
# failpoint("...") call site under horovod_tpu_torch/ to it).
FAULT_SPECS: Dict[str, str] = {
    # core/engine.py
    "engine.enqueue": "Before an op is registered in the outstanding table "
                      "(every collective submission funnels through here)",
    "engine.dispatch": "Before the collective launch of an engine call — a "
                       "hang here models a peer that stopped contributing "
                       "mid-step",
    "engine.complete": "At the top of Handle.synchronize, before the "
                       "completion wait — the user-visible completion edge",
    "compression.encode": "Before a compressed collective is dispatched "
                          "(eager grouped/single allreduce, the sharded "
                          "step's rs legs, and armed replay launches "
                          "when any bucket carries a wire codec): "
                          "raise() models an encode failure — it must "
                          "surface as HorovodInternalError for the "
                          "elastic loop, with residual buffers "
                          "invalidated (never poisoned) on the restore",
    # runner/http_client.py
    "kv.put": "Inside each PUT attempt of put_data_into_kvstore (before "
              "the HTTP request) — transient KV-fabric write outages",
    "kv.read": "Inside each GET attempt of read_data_from_kvstore — "
               "transient KV-fabric read outages",
    # runner/http_server.py
    "kv.server.get": "In the KV server's GET handler; hang() models a hung "
                     "server connection, drop() serves a 404",
    "kv.server.put": "In the KV server's PUT handler; drop() silently "
                     "discards the write (acks 200 without storing)",
    # runner/replication.py (the replicated control plane)
    "kv.replicate": "Before each per-peer journal-stream send on the "
                    "primary's replication path; raise() models a peer "
                    "send failure (write may miss its ack quorum), "
                    "delay() a slow standby, hang() a wedged stream",
    "kv.promote": "At the top of a standby's promotion (lease-expiry or "
                  "manual); delay() widens the failover window, raise() "
                  "models a promotion that must surface loudly",
    "kv.journal_gap": "Inside the promotion-time journal replay/audit; "
                      "drop() injects a synthetic sequence gap so the "
                      "gap-detection path (ERROR + "
                      "hvd_tpu_kv_journal_gaps_total) is exercisable "
                      "deterministically",
    # elastic/
    "elastic.rendezvous.get": "In the elastic rendezvous rank_and_size "
                              "lookup; drop() long-polls the worker",
    "elastic.discovery": "Inside the driver's host-discovery poll",
    "elastic.reregister": "Inside each attempt of the worker notification "
                          "re-registration after a world reset",
    "elastic.notify": "Inside the driver->worker hosts-updated push",
    # elastic/failover.py
    "driver.journal": "Inside every driver-journal append, before the "
                      "replicated write: drop() models a lost journal "
                      "entry (WARNING + skipped, driver keeps running); "
                      "raise() a journal fabric error",
    "driver.promote": "At the top of standby promotion, before the "
                      "live-driver deferral check: hang()/raise() model "
                      "a wedged or failed promotion",
    "driver.discovery": "Inside each attempt of the hardened host-"
                        "discovery probe: drop() fails the attempt "
                        "(retried with backoff, then last-known-good)",
    # checkpoint/manager.py
    "checkpoint.write": "At the top of the background generation write "
                        "(after device_get, before any file/KV I/O): "
                        "drop() models a lost snapshot — no files, no "
                        "manifest, the generation never commits; raise() "
                        "a failed write (counted, training unaffected)",
    "checkpoint.restore": "At the top of restore_latest, before "
                          "generation discovery — hang()/raise() model a "
                          "restore that must surface to the elastic "
                          "run-loop instead of wedging recovery",
    # stall_inspector.py
    "stall.publish": "Inside the stall inspector's KV liveness publish",
    # metrics.py
    "metrics.publish": "Inside the metrics snapshot KV publish",
    # trace.py
    "trace.publish": "Inside the trace-segment KV publish "
                     "(trace.publish_segment); drop() models a silently "
                     "lost segment — the merged /trace must degrade "
                     "gracefully, never fail",
    # runner/aggregator.py (the hierarchical telemetry)
    "agg.rollup": "At the top of a slice aggregator's rollup pass; "
                  "drop() skips the whole interval (stale rollups at "
                  "the root — the stall sweep's staleness fallback "
                  "must kick in), hang() models a wedged aggregator",
    "agg.publish": "Before each per-stream rollup push to the root KV; "
                   "drop() silently loses that stream's rollup for the "
                   "interval while the others land",
    # observability/monitor.py
    "observability.dump": "Inside the rate-limited flight dumper, before "
                          "the trace-ring dump is written; raise() models "
                          "a dump failure (full disk) — it must be "
                          "swallowed, never fail the step that "
                          "triggered it",
}


class _Drop:
    """Sentinel returned by failpoint() when a drop() action fires."""

    __slots__ = ()

    def __repr__(self):
        return "<faults.DROP>"


DROP = _Drop()

_DUR_RE = re.compile(r"^([0-9]*\.?[0-9]+)(ms|s)?$")


def _parse_duration(text: str) -> float:
    m = _DUR_RE.match(text.strip())
    if not m:
        raise ValueError(f"bad duration {text!r} (want e.g. '2s', '250ms')")
    val = float(m.group(1))
    return val / 1000.0 if m.group(2) == "ms" else val


def _resolve_exception(name: str) -> type:
    import builtins
    exc = getattr(builtins, name, None)
    if not (isinstance(exc, type) and issubclass(exc, BaseException)):
        from .common import exceptions as hvd_exc
        exc = getattr(hvd_exc, name, None)
    if not (isinstance(exc, type) and issubclass(exc, BaseException)):
        raise ValueError(f"unknown exception {name!r} in fault spec (looked "
                         f"in builtins, horovod_tpu_torch.common."
                         f"exceptions)")
    return exc


_TERM_RE = re.compile(r"^(?:(\d+)\s*\*\s*|(\*)\s*)?([a-z]+)\((.*)\)$")
_ACTIONS = ("delay", "raise", "drop", "hang", "noop")


class _Term:
    """One ``[count *] action(args)`` unit of a chain."""

    __slots__ = ("action", "count", "arg")

    def __init__(self, action: str, count: Optional[int], arg):
        self.action = action
        self.count = count          # None = forever ('*'), else remaining hits
        self.arg = arg

    @classmethod
    def parse(cls, text: str) -> "_Term":
        m = _TERM_RE.match(text.strip())
        if not m:
            raise ValueError(
                f"bad fault term {text!r} (want '[N*]action(args)')")
        count_s, star, action, arg_s = m.groups()
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(known: {', '.join(_ACTIONS)})")
        count: Optional[int]
        if star is not None:
            count = None
        elif count_s is None:
            count = 1
        else:
            count = int(count_s)
            if count <= 0:
                raise ValueError(f"fault term count must be positive: {text!r}")
        arg_s = arg_s.strip()
        arg = None
        if action == "delay":
            arg = _parse_duration(arg_s)
        elif action == "hang":
            arg = _parse_duration(arg_s) if arg_s else None
        elif action == "raise":
            if not arg_s:
                raise ValueError(f"raise() needs an exception name: {text!r}")
            arg = _resolve_exception(arg_s)
        elif arg_s:
            raise ValueError(f"{action}() takes no argument: {text!r}")
        return cls(action, count, arg)


class _Clause:
    """One armed ``name[@rank]=chain`` entry."""

    __slots__ = ("name", "rank", "terms", "hits")

    def __init__(self, name: str, rank: Optional[int], terms: List[_Term]):
        self.name = name
        self.rank = rank
        self.terms = terms
        self.hits = 0

    def next_term(self) -> Optional[_Term]:
        for t in self.terms:
            if t.count is None or t.count > 0:
                return t
        return None


def _current_rank() -> int:
    try:
        # divcheck: ignore[failpoint @rank targeting reads the launcher-pinned rank id — constant for the process lifetime, not a tunable knob; inert unless HOROVOD_TPU_FAULTS is armed]
        return int(os.environ.get("HOROVOD_RANK", "0") or 0)
    except ValueError:
        return 0


class FaultRegistry:
    """Parsed, armed fault spec: name -> clauses, with hit accounting and
    the shared hang-break event. Built by :func:`arm`; not constructed
    directly outside tests."""

    def __init__(self, spec: str):
        self._lock = threading.Lock()
        self._clauses: Dict[str, List[_Clause]] = {}
        self._hits: Dict[str, int] = {}
        # hang() parks on the CURRENT event; break_hangs swaps in a fresh
        # one, so only already-parked hangs wake — a later hang() parks
        # again instead of inheriting a stale break (multi-round chaos)
        self._break_event = threading.Event()
        self.spec = spec
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if "=" not in raw:
                raise ValueError(f"bad fault clause {raw!r} (want "
                                 f"'name[@rank]=chain')")
            target, chain = raw.split("=", 1)
            target = target.strip()
            rank: Optional[int] = None
            if "@" in target:
                target, _, rank_s = target.partition("@")
                target = target.strip()
                rank = int(rank_s)
            if not NAME_RE.match(target):
                raise ValueError(f"fault name {target!r} must match "
                                 f"{NAME_RE.pattern}")
            if target not in FAULT_SPECS and not target.startswith("test."):
                raise ValueError(
                    f"fault name {target!r} is not declared in "
                    f"horovod_tpu_torch.faults.FAULT_SPECS ('test.*' "
                    f"names are exempt)")
            terms = [_Term.parse(t) for t in chain.split("->")]
            if not terms:
                raise ValueError(f"empty chain in fault clause {raw!r}")
            self._clauses.setdefault(target, []).append(
                _Clause(target, rank, terms))

    # -- hit path -----------------------------------------------------------

    def hit(self, name: str):
        clauses = self._clauses.get(name)
        if not clauses:
            return None
        rank = _current_rank()
        with self._lock:
            term = None
            for c in clauses:
                if c.rank is not None and c.rank != rank:
                    continue
                term = c.next_term()
                if term is not None:
                    c.hits += 1
                    if term.count is not None:
                        term.count -= 1
                    break
            if term is None:
                return None
            self._hits[name] = self._hits.get(name, 0) + 1
        return self._fire(name, term)

    def _fire(self, name: str, term: _Term):
        from .metrics import registry as metrics_registry
        metrics_registry().counter("hvd_tpu_fault_injections_total").inc(
            name=name, action=term.action)
        logger.debug("failpoint %s fired: %s", name, term.action)
        if term.action == "noop":
            return None
        if term.action == "delay":
            time.sleep(term.arg)
            return None
        if term.action == "raise":
            raise term.arg(f"injected fault at failpoint {name!r}")
        if term.action == "drop":
            return DROP
        # hang: block until break_hangs()/disarm() or the optional duration
        with self._lock:
            evt = self._break_event
        broke = evt.wait(timeout=term.arg)
        exc = getattr(evt, "exc", None)
        if broke and exc is not None:
            raise exc
        return None

    # -- control ------------------------------------------------------------

    def break_hangs(self, exc: Optional[BaseException] = None):
        with self._lock:
            evt = self._break_event
            self._break_event = threading.Event()
        evt.exc = exc
        evt.set()

    def hits(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)


_active: Optional[FaultRegistry] = None
_arm_lock = threading.Lock()


def failpoint(name: str):
    """Fault-injection marker. A no-op (single global read) when no faults
    are armed; when armed, runs the next pending action of any matching
    clause. Returns :data:`DROP` when a drop() fired (cooperating call
    sites discard the operation), ``None`` otherwise; raise() actions raise
    from here."""
    reg = _active
    if reg is None:
        return None
    return reg.hit(name)


def enabled() -> bool:
    """Whether any fault spec is currently armed."""
    return _active is not None


def arm(spec: str) -> FaultRegistry:
    """Parse ``spec`` and arm it process-wide (replacing any armed spec).
    Raises ValueError on grammar errors or undeclared names."""
    global _active
    reg = FaultRegistry(spec)
    with _arm_lock:
        old = _active
        _active = reg
        if old is not None:
            old.break_hangs(None)   # release anything parked in old hangs
    logger.warning("fault injection armed: %s", spec)
    return reg


def disarm():
    """Drop the armed spec; parked hang() actions resume (return None)."""
    global _active
    with _arm_lock:
        old = _active
        _active = None
        if old is not None:
            old.break_hangs(None)


def break_hangs(exc: Optional[BaseException] = None):
    """Release every parked hang() action. With ``exc``, they raise it —
    the collective watchdog passes ``HorovodInternalError`` here so an
    injected hang surfaces exactly like an aborted collective."""
    reg = _active
    if reg is not None:
        reg.break_hangs(exc)


def hits(name: str) -> int:
    """How many times ``name`` has fired since arming (0 when disarmed)."""
    reg = _active
    return reg.hits(name) if reg is not None else 0


def arm_from_kv(addr, port: Optional[int] = None, scope: str = "faults",
                key: str = "spec", timeout: float = 5.0) -> bool:
    """Fetch a fault spec from the rendezvous KV and arm it — the
    one-place-arms-every-worker path for real np>1 chaos runs (the launcher
    PUTs ``faults/spec``; each worker calls this after init). ``addr``
    accepts the full endpoint-set forms of the KV client — an
    :class:`..runner.http_client.Endpoints`, a ``"h1:p1,h2:p2"`` spec, or
    the legacy ``(addr, port)`` — so chaos scripts can arm faults through
    a surviving replica after a root kill. Returns False
    (with a WARNING, staying disarmed) only when the key never appeared
    within ``timeout``; any other failure — bad spec, undeclared name,
    non-404 HTTP error — raises, so a chaos run can never silently proceed
    with one worker unarmed."""
    from .runner.http_client import read_data_from_kvstore, resolve_endpoints
    eps = resolve_endpoints(addr, port)
    try:
        raw = read_data_from_kvstore(eps, None, scope, key, timeout=timeout)
    except TimeoutError as e:
        logger.warning("no fault spec at %s/%s/%s within %.0fs; "
                       "running fault-free (%s)", eps.spec, scope, key,
                       timeout, e)
        return False
    spec = raw.decode().strip()
    if not spec:
        logger.warning("fault spec at %s/%s/%s is empty; running "
                       "fault-free", eps.spec, scope, key)
        return False
    arm(spec)
    return True


def _arm_from_env():
    spec = os.environ.get(HOROVOD_TPU_FAULTS)
    if spec and spec.strip():
        arm(spec.strip())


_arm_from_env()
