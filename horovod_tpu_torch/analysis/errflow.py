"""Exception-propagation & resource-lifecycle analyzer: an AST pass over
the recovery invariant.

The whole fault-tolerance story rests on one contract no tool enforced
until now: ``HorovodInternalError`` is the ONE exception the elastic
run-loop (``elastic/run.py``) restores-and-retries from, and everything
— watchdog escalation, chaos failpoints, the replicated control plane —
funnels into it. That contract has two halves:

1. **Propagation**: a recovery-class exception raised anywhere on the
   step/KV/elastic path must *reach* the run-loop. A broad ``except``
   that swallows it silently converts a recoverable fault into a hang.
2. **Lifecycle**: every resource acquired on those paths (threads,
   files, sockets) must be released on the *exception* edge too, or the
   recovery leaves zombies racing the next world.

errflow is the static guardrail: a pure-AST, cross-file call-graph pass
(no scanned module imported — the lockcheck/divcheck architecture) with
five finding classes:

``swallowed-recovery-error``
    An ``except Exception`` / ``except BaseException`` / bare ``except``
    — or an explicit ``except HorovodInternalError`` — in a def
    name-reachable from the elastic run-loop (``run_fn``), the engine
    dispatch/synchronize funnel, or the watchdog escalation path, whose
    handler neither re-raises, returns (an error-signaling value the
    caller can observe), escalates (``poison``/``break_hangs``/
    ``os._exit``), nor stores the error for a later ``raise`` in the
    same def. This is the bug class that turns a recoverable fault into
    a silent hang.
``unretried-kv-io``
    A direct transport call (``urllib.request.urlopen``,
    ``socket.create_connection``, ``http.client.HTTPConnection``...)
    that is neither wrapped by ``common/retry.retrying()`` nor carries a
    ``timeout=``/``deadline=`` argument. A deadline-less raw socket can
    eat an entire long-poll budget on one hung connection; the KV
    client's endpoint failover makes this discipline load-bearing.
``leak-on-raise``
    A resource acquired on a path where an exception edge escapes
    without ``try/finally``, a context manager, or a registered close:
    ``open()``/``socket()`` results released only on the success path
    (or never), threads started with no ``join()`` on any shutdown
    path (``StallInspector.stop()``-style audit: a zombie publisher
    from a torn-down world races whatever comes next).
``silent-error-path``
    An ``except`` block on a *declared seam* — a def containing a
    ``failpoint()`` marker, or one annotated ``# errflow: seam[why]`` —
    that neither propagates, logs at WARNING+, nor increments a metrics
    counter. Every degraded mode must be observable.
``failpoint-drift``
    ``FAULT_SPECS`` names vs ``failpoint()`` call sites, both
    directions: an undeclared name at a call site, a declared name with
    no call site left, and non-literal failpoint arguments (the
    call-site half of :mod:`.faultcheck`, with the reverse direction
    added).

Annotation conventions (see docs/static_analysis.md):

- ``# errflow: ignore[reason]`` — suppresses findings on the line (or
  the line below a standalone comment), lockcheck's suppression grammar
  exactly: reason mandatory (a reasonless suppression is itself a
  ``bad-suppression`` finding), every active suppression surfaced in
  the report with file:line+reason, dead ones reported
  ``stale-suppression``.
- ``# errflow: seam[why]`` — on (or standalone directly above) a
  ``def`` line: declares the def an error-handling seam whose degraded
  modes must be observable, even without a failpoint marker. Defs
  containing a ``failpoint("name")`` call are seams implicitly (a
  failpoint IS the declaration that faults are expected there). Every
  seam is enumerated in the report.

Scope and soundness: the call graph is name-resolved with the divcheck
precision rules — ``self.X()`` resolves to the exact owning class
method (same-file bases merged), and ultra-common names never propagate
reachability — so the recovery footprint over-approximates without
drowning. Handler analysis never descends into nested ``def``/
``lambda`` bodies (they run later, elsewhere); a handler that binds the
exception and re-raises it after the ``try`` (the bounded-retry idiom)
is recognized as propagating.

Pure stdlib; no module under scan is imported.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import comments_by_line as _comments_by_line
from . import parse_tag as _parse_tag

# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

# Def names anchoring the recovery-path footprint: everything
# name-reachable from these must let recovery-class exceptions through.
# ``run_fn`` is the elastic run-loop (its nested ``wrapper`` is walked as
# part of it); ``_dispatch``/``synchronize``/``intercept`` are the engine
# submission/completion/replay funnels; ``_escalate`` is the watchdog's
# hang-to-exception conversion.
RECOVERY_ROOTS: Set[str] = {
    "run_fn", "_dispatch", "synchronize", "intercept", "_escalate",
}

# Names NEVER used as propagation edges in the call graph (the divcheck
# discipline): a bare call site of one of these is too ambiguous to
# treat as reaching every same-named def.
NO_PROPAGATE: Set[str] = {
    "__init__", "__call__", "__enter__", "__exit__", "get", "put", "pop",
    "add", "append", "extend", "update", "remove", "discard", "clear",
    "items", "keys", "values", "join", "run", "main", "start", "stop",
    "close", "wait", "send", "recv", "read", "write", "open", "next",
    "copy", "index", "count", "sort", "split", "strip", "format", "info",
    "debug", "warning", "error", "exception", "log", "inc", "set",
    "observe", "record", "wrapper", "wrapped", "inner", "fn", "callback",
    "apply", "step", "poll", "flush", "result", "submit", "register",
    "fit", "predict", "_validate", "validate", "transform", "evaluate",
}

# Exception classes whose except-clause is broad enough to swallow a
# recovery-class error (HorovodInternalError inherits from Exception),
# plus the recovery-class errors caught explicitly: the carrier itself and
# torch.distributed's failures, which the port's elastic loop recovers
# from as it does from the carrier (elastic/run.py).
BROAD_EXC: Set[str] = {"Exception", "BaseException"}
RECOVERY_EXC: Set[str] = {"HorovodInternalError", "DistError",
                          "DistBackendError", "DistNetworkError",
                          "DistStoreError"}

# Handler calls that count as escalation (the error still surfaces —
# engine poisoned, hangs broken, process aborted).
ESCALATE_CALLS: Set[str] = {
    "_escalate", "escalate", "poison", "break_hangs", "_exit", "abort",
}

# WARNING+ logging terminals (a ``.log(level, ...)`` with a variable
# level is NOT counted — it may be DEBUG).
LOG_OBSERVABLE: Set[str] = {"warning", "error", "exception", "critical"}
# metrics-instrument increments (counter.inc / histogram.observe ride
# the registry — the metrics lint owns name validity; count_shed_bytes
# is the KV publishers' shed-counter helper)
METRIC_OBSERVABLE: Set[str] = {"inc", "observe", "count_shed_bytes"}

# Raw transport terminals for the unretried-kv-io pass.
RAW_IO_CALLS: Set[str] = {
    "urlopen", "create_connection", "HTTPConnection", "HTTPSConnection",
    "urlretrieve",
}
DEADLINE_KWARGS: Set[str] = {"timeout", "deadline"}
# ``timeout`` is also an ordinary positional parameter of most of these
# (0-based index below): ``create_connection(addr, 5.0)`` is deadlined.
# urlretrieve has no timeout parameter at all — only retrying() excuses
# it.
RAW_IO_TIMEOUT_POS: Dict[str, int] = {
    "urlopen": 2, "create_connection": 1,
    "HTTPConnection": 2, "HTTPSConnection": 2,
}

# Resource acquisition terminals for the leak pass.
ACQUIRE_FILE: Set[str] = {"open"}
ACQUIRE_SOCK: Set[str] = {"socket", "create_connection"}
ACQUIRE_THREAD: Set[str] = {"Thread"}
RELEASE_ATTRS: Set[str] = {"close", "shutdown", "server_close", "stop"}

_IGNORE_TAG = "errflow: ignore"
_SEAM_TAG = "errflow: seam"


# ---------------------------------------------------------------------------
# report model
# ---------------------------------------------------------------------------

@dataclass
class Finding:
    check: str
    file: str
    line: int
    message: str
    func: str = ""
    suppressed: bool = False
    reason: Optional[str] = None

    def to_dict(self) -> dict:
        return {"check": self.check, "file": self.file, "line": self.line,
                "func": self.func, "message": self.message,
                "suppressed": self.suppressed, "reason": self.reason}

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.check}] {self.message}"


@dataclass
class SeamSite:
    file: str
    line: int
    func: str
    how: str  # "failpoint <name>" or the seam-tag payload

    def to_dict(self) -> dict:
        return {"file": self.file, "line": self.line, "func": self.func,
                "how": self.how}


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    suppressions: List[Finding] = field(default_factory=list)
    seams: List[SeamSite] = field(default_factory=list)
    files: int = 0
    defs: int = 0
    recovery_defs: int = 0
    handlers: int = 0
    failpoints_declared: int = 0
    failpoint_sites: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {"ok": self.ok, "files": self.files, "defs": self.defs,
                "recovery_defs": self.recovery_defs,
                "handlers": self.handlers,
                "failpoints_declared": self.failpoints_declared,
                "failpoint_sites": self.failpoint_sites,
                "findings": [f.to_dict() for f in self.findings],
                "suppressions": [s.to_dict() for s in self.suppressions],
                "seams": [s.to_dict() for s in self.seams]}


# ---------------------------------------------------------------------------
# annotation index (comment harvester and tag grammar shared with
# lockcheck/divcheck — the package's comments_by_line / parse_tag)
# ---------------------------------------------------------------------------

class _Annotations:
    def __init__(self, rel: str, comments: Dict[int, Tuple[str, bool]]):
        self.rel = rel
        # line -> (payload, standalone)
        self.ignores: Dict[int, Tuple[str, bool]] = {}
        self.seams: Dict[int, Tuple[str, bool]] = {}
        for line, (text, standalone) in comments.items():
            i = _parse_tag(text, _IGNORE_TAG)
            if i is not None:
                self.ignores[line] = (i, standalone)
            s = _parse_tag(text, _SEAM_TAG)
            if s is not None:
                self.seams[line] = (s, standalone)

    def seam_at(self, line: int) -> Optional[str]:
        """The seam annotation covering a ``def`` at ``line``: trailing
        on the line itself, or standalone directly above."""
        ent = self.seams.get(line)
        if ent is not None:
            return ent[0]
        ent = self.seams.get(line - 1)
        if ent is not None and ent[1]:
            return ent[0]
        return None


# ---------------------------------------------------------------------------
# phase 1: per-module collection
# ---------------------------------------------------------------------------

def _terminal(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


@dataclass
class _DefInfo:
    rel: str
    qualname: str       # Class.method or function
    name: str           # terminal name
    node: ast.AST
    cls: Optional[str] = None
    # resolved call tokens (the divcheck precision rule: self.X() with X
    # defined on the class records the qualified ``rel::Class.X`` token;
    # everything else records the bare terminal)
    calls: Set[str] = field(default_factory=set)
    cls_methods: Optional[Dict[str, str]] = None
    # failpoint literals called inside this def
    failpoints: List[Tuple[int, Optional[str]]] = field(default_factory=list)

    @property
    def qual_token(self) -> str:
        return f"{self.rel}::{self.qualname}"


class _Module:
    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.source = source
        self.comments = _comments_by_line(source)
        self.ann = _Annotations(rel, self.comments)
        self.defs: List[_DefInfo] = []
        # class name -> {attr: set of release terminals applied to
        # self.<attr> anywhere in the class} (join/close/stop/...)
        self.cls_released: Dict[str, Dict[str, Set[str]]] = {}
        # FAULT_SPECS literal keys declared at module top level
        self.fault_specs: Dict[str, int] = {}
        # names of defs/lambdas passed to retrying(...) in this module
        self.retry_wrapped: Set[str] = set()
        self.parse_error: Optional[Finding] = None
        try:
            self.tree = ast.parse(source)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = Finding("parse-error", rel, e.lineno or 0,
                                       str(e))
            return
        self._collect()

    def _collect(self):
        classes = [n for n in self.tree.body if isinstance(n, ast.ClassDef)]
        methods: Dict[str, Dict[str, str]] = {}
        bases: Dict[str, List[str]] = {}
        for cls in classes:
            methods[cls.name] = {
                item.name: cls.name for item in cls.body
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))}
            bases[cls.name] = [
                b.attr if isinstance(b, ast.Attribute)
                else (b.id if isinstance(b, ast.Name) else "")
                for b in cls.bases]
        changed = True
        while changed:
            changed = False
            for cls in classes:
                for b in bases[cls.name]:
                    if b == cls.name:
                        continue
                    for name, owner in methods.get(b, {}).items():
                        if name not in methods[cls.name]:
                            methods[cls.name][name] = owner
                            changed = True
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self.cls_released[node.name] = self._released_attrs(node)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._add_def(f"{node.name}.{item.name}", item,
                                      cls=node.name,
                                      cls_methods=methods[node.name])
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_def(node.name, node)
            self._scan_fault_specs(node)
        # same-file base classes contribute their release methods (a
        # subclass of a server that joins in stop() is covered)
        for cls in classes:
            for b in bases[cls.name]:
                for attr, terms in self.cls_released.get(b, {}).items():
                    self.cls_released[cls.name].setdefault(
                        attr, set()).update(terms)

    def _scan_fault_specs(self, node: ast.stmt):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            return
        if not any(isinstance(t, ast.Name) and t.id == "FAULT_SPECS"
                   for t in targets):
            return
        if isinstance(value, ast.Dict):
            for k in value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    self.fault_specs[k.value] = k.lineno

    @staticmethod
    def _released_attrs(cls: ast.ClassDef) -> Dict[str, Set[str]]:
        """attr -> release terminals called on ``self.<attr>`` anywhere
        in the class body (``self._thread.join()`` -> {_thread: {join}})."""
        out: Dict[str, Set[str]] = {}
        for node in ast.walk(cls):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Attribute) and \
                    isinstance(node.func.value.value, ast.Name) and \
                    node.func.value.value.id == "self":
                out.setdefault(node.func.value.attr,
                               set()).add(node.func.attr)
        return out

    def _add_def(self, qualname: str, node: ast.AST,
                 cls: Optional[str] = None,
                 cls_methods: Optional[Dict[str, str]] = None):
        info = _DefInfo(self.rel, qualname, node.name, node, cls=cls,
                        cls_methods=cls_methods)
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            t = _terminal(sub.func)
            if not t:
                continue
            if cls_methods and isinstance(sub.func, ast.Attribute) and \
                    isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id == "self" and t in cls_methods:
                info.calls.add(f"{self.rel}::{cls_methods[t]}.{t}")
            else:
                info.calls.add(t)
            if t == "failpoint":
                arg = sub.args[0] if sub.args else None
                name = arg.value if isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str) else None
                info.failpoints.append((sub.lineno, name))
            if t == "retrying":
                for a in list(sub.args) + [k.value for k in sub.keywords]:
                    if isinstance(a, ast.Name):
                        self.retry_wrapped.add(a.id)
                    elif isinstance(a, ast.Attribute):
                        self.retry_wrapped.add(a.attr)
        self.defs.append(info)


# ---------------------------------------------------------------------------
# cross-file resolution: the recovery-path footprint
# ---------------------------------------------------------------------------

def _recovery_defs(modules: List["_Module"]) -> Set[int]:
    """ids of defs name-reachable from the recovery roots over the
    resolved call graph (qualified self-call edges followed directly;
    bare edges fan out to every same-named def except NO_PROPAGATE)."""
    by_token: Dict[str, List[_DefInfo]] = {}
    for mod in modules:
        for d in mod.defs:
            by_token.setdefault(d.name, []).append(d)
            by_token.setdefault(d.qual_token, []).append(d)
    seen: Set[int] = set()
    frontier: List[_DefInfo] = []
    for mod in modules:
        for d in mod.defs:
            if d.name in RECOVERY_ROOTS:
                frontier.append(d)
    while frontier:
        d = frontier.pop()
        if id(d) in seen:
            continue
        seen.add(id(d))
        for callee in d.calls:
            if "::" not in callee and callee in NO_PROPAGATE:
                continue
            for nxt in by_token.get(callee, ()):
                if id(nxt) not in seen:
                    frontier.append(nxt)
    return seen


# ---------------------------------------------------------------------------
# handler analysis (swallowed-recovery-error / silent-error-path)
# ---------------------------------------------------------------------------

def _walk_no_nested(node: ast.AST):
    """Walk ``node``'s subtree without descending into nested def/lambda
    bodies (they run later, elsewhere — a raise inside one does not
    propagate from this handler)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.Lambda, ast.FunctionDef,
                          ast.AsyncFunctionDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _unguarded_children(n: ast.AST) -> List[ast.AST]:
    """Children of ``n`` whose raises actually escape ``n``: for a
    ``try`` that has except clauses, only ``orelse``/``finalbody`` — a
    raise in the guarded body may be swallowed by those very clauses
    (``while True: try: ... except Exception: pass`` must NOT count as
    signaling, or the retry-loop shape the tool targets is exempt), and
    a raise in a *sibling* except clause only runs for that clause's
    exception type, so it cannot vouch for a broad handler next to it.
    A handler-less ``try``/``finally`` hides nothing."""
    if isinstance(n, ast.Try) and n.handlers:
        return list(n.orelse) + list(n.finalbody)
    return list(ast.iter_child_nodes(n))


def _walk_unguarded(node: ast.AST):
    """:func:`_walk_no_nested`, minus try-guarded regions (see
    :func:`_unguarded_children`) — the walk behind the tail/loop-tail
    ``_signals`` test."""
    stack = _unguarded_children(node)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.Lambda, ast.FunctionDef,
                          ast.AsyncFunctionDef)):
            continue
        yield n
        stack.extend(_unguarded_children(n))


def _handler_breadth(h: ast.ExceptHandler) -> Optional[str]:
    """Why this except clause can swallow a recovery-class error, or
    None when it is narrower (OSError, KVBackpressure, ...)."""
    if h.type is None:
        return "bare except"
    elts = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    for e in elts:
        t = _terminal(e)
        if t in BROAD_EXC:
            return f"except {t}"
        if t in RECOVERY_EXC:
            return f"except {t} (the recovery carrier itself)"
    return None


def _handler_bound_names(h: ast.ExceptHandler) -> Set[str]:
    """The exception binding plus every name assigned inside the handler
    body — candidates for a later ``raise <name>`` in the same def."""
    names: Set[str] = set()
    if h.name:
        names.add(h.name)
    for n in _walk_no_nested(h):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _raised_names(def_node: ast.AST) -> Set[str]:
    """Names raised anywhere in the def (``raise last_err`` after a
    bounded-retry loop — the retrying() idiom)."""
    out: Set[str] = set()
    for n in ast.walk(def_node):
        if isinstance(n, ast.Raise) and isinstance(n.exc, ast.Name):
            out.add(n.exc.id)
    return out


def _handler_propagates(h: ast.ExceptHandler,
                        raised_later: Set[str]) -> bool:
    for n in _walk_no_nested(h):
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, ast.Return):
            return True
        if isinstance(n, (ast.Continue, ast.Break)):
            # loop flow control: the retry/skip idiom — the loop's own
            # deadline/raise owns the failure, not this handler
            return True
        if isinstance(n, ast.Call) and _terminal(n.func) in ESCALATE_CALLS:
            return True
    bound = _handler_bound_names(h)
    return bool(bound & raised_later)


def _is_import_probe(try_stmt: ast.Try, h: ast.ExceptHandler) -> bool:
    """The availability-probe idiom: ``try: import x; ... except: pass``
    — a missing optional dependency is not a swallowed error."""
    if len(h.body) != 1 or not isinstance(h.body[0], ast.Pass):
        return False
    return any(isinstance(n, (ast.Import, ast.ImportFrom))
               for s in try_stmt.body for n in ast.walk(s))


def _handler_observable(h: ast.ExceptHandler) -> bool:
    for n in _walk_no_nested(h):
        if isinstance(n, ast.Call):
            t = _terminal(n.func)
            if t in LOG_OBSERVABLE or t in METRIC_OBSERVABLE:
                return True
    return False


# ---------------------------------------------------------------------------
# per-def checks
# ---------------------------------------------------------------------------

class _DefChecker:
    def __init__(self, mod: _Module, info: _DefInfo, on_recovery: bool,
                 findings: List[Finding]):
        self.mod = mod
        self.info = info
        self.on_recovery = on_recovery
        self.findings = findings
        self.raised_later = _raised_names(info.node)
        self.seam_how: Optional[str] = None
        how = mod.ann.seam_at(info.node.lineno)
        if how is not None:
            self.seam_how = how or ""
        elif info.failpoints:
            named = [n for _, n in info.failpoints if n]
            self.seam_how = f"failpoint {named[0]}" if named else "failpoint"

    def _emit(self, check: str, line: int, message: str):
        self.findings.append(Finding(check, self.mod.rel, line, message,
                                     func=self.info.qualname))

    # -- handlers ----------------------------------------------------------
    #
    # The block walk carries a ``tail_signals`` flag: True when a later
    # sibling statement (at this block level or any enclosing one inside
    # the def) is an explicit ``return``/``raise`` — a handler that
    # falls through to one still signals the caller. The long-poll
    # while-loop idiom (swallow, sleep, loop; ``raise TimeoutError``
    # after the loop) is propagating under this rule.

    def check_handlers(self) -> int:
        return self._visit_block(getattr(self.info.node, "body", []), False)

    @staticmethod
    def _signals(stmt: ast.stmt) -> bool:
        """Whether control flowing through ``stmt`` can hit an explicit
        ``return``/``raise`` (conditional ones count — the long-poll
        ``if past_deadline: raise`` idiom); nested defs excluded, and so
        are try-guarded regions: a raise inside a ``try`` body whose own
        broad handler would swallow it again (or inside a sibling except
        clause) is no signal at all."""
        if isinstance(stmt, (ast.Return, ast.Raise)):
            return True
        return any(isinstance(n, (ast.Return, ast.Raise))
                   for n in _walk_unguarded(stmt))

    def _visit_block(self, stmts: List[ast.stmt], tail: bool) -> int:
        count = 0
        for i, stmt in enumerate(stmts):
            t = tail or any(self._signals(s) for s in stmts[i + 1:])
            count += self._visit_stmt(stmt, t)
        return count

    def _visit_stmt(self, stmt: ast.stmt, tail: bool) -> int:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: its own body context (a raise after the outer
            # try does not catch a swallow inside the closure)
            return self._visit_block(stmt.body, False)
        count = 0
        if isinstance(stmt, ast.Try):
            for h in stmt.handlers:
                count += 1
                self._check_handler(stmt, h, tail)
                count += self._visit_block(h.body, tail)
            count += self._visit_block(stmt.body, tail)
            count += self._visit_block(stmt.orelse, tail)
            count += self._visit_block(stmt.finalbody, tail)
            return count
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            # the loop back-edge makes EVERY top-level statement of the
            # body reachable after a handler falls through — the
            # ``while True: if past_deadline: raise ...; try: ...``
            # long-poll idiom signals via the next iteration
            loop_tail = tail or any(self._signals(s) for s in stmt.body)
            count += self._visit_block(stmt.body, loop_tail)
            count += self._visit_block(stmt.orelse, tail)
            return count
        for attr in ("body", "orelse", "finalbody"):
            b = getattr(stmt, attr, None)
            if b:
                count += self._visit_block(b, tail)
        if hasattr(ast, "Match") and isinstance(stmt, ast.Match):
            for case in stmt.cases:
                count += self._visit_block(case.body, tail)
        return count

    def _check_handler(self, try_stmt: ast.Try, h: ast.ExceptHandler,
                       tail: bool):
        propagates = (tail or _handler_propagates(h, self.raised_later) or
                      _is_import_probe(try_stmt, h))
        breadth = _handler_breadth(h)
        if self.on_recovery and breadth is not None and not propagates:
            self._emit(
                "swallowed-recovery-error", h.lineno,
                f"{self.info.qualname}: {breadth} on the recovery path "
                f"(name-reachable from the elastic run-loop / engine "
                f"dispatch / watchdog escalation) neither re-raises, "
                f"returns, nor escalates — a recovery-class error dies "
                f"here and the fault becomes a silent hang")
        if self.seam_how is not None and not propagates and \
                not _handler_observable(h):
            self._emit(
                "silent-error-path", h.lineno,
                f"{self.info.qualname}: except block on a declared seam "
                f"({self.seam_how}) neither logs at WARNING+ nor "
                f"increments a metrics counter — this degraded mode is "
                f"invisible to operators")

    # -- raw transport I/O -------------------------------------------------

    def check_raw_io(self):
        # (nested def name stack, node) so a call inside a closure passed
        # to retrying() is exempt
        self._walk_io(self.info.node, wrapped=(
            self.info.name in self.mod.retry_wrapped))

    def _walk_io(self, node: ast.AST, wrapped: bool):
        for child in ast.iter_child_nodes(node):
            w = wrapped
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                w = wrapped or child.name in self.mod.retry_wrapped
            if isinstance(child, ast.Call):
                t = _terminal(child.func)
                if t in RAW_IO_CALLS and not wrapped and \
                        not any(k.arg in DEADLINE_KWARGS
                                for k in child.keywords) and \
                        len(child.args) <= RAW_IO_TIMEOUT_POS.get(t, 1 << 30):
                    self._emit(
                        "unretried-kv-io", child.lineno,
                        f"{self.info.qualname}: raw transport call {t}() "
                        f"with no timeout=/deadline= argument and outside "
                        f"common/retry.retrying() — one hung connection "
                        f"blocks forever")
            self._walk_io(child, w)


class _LeakScanner:
    """Resource-lifecycle half: files/sockets released on the exception
    edge, threads joined on some shutdown path."""

    def __init__(self, mod: _Module, info: _DefInfo,
                 findings: List[Finding]):
        self.mod = mod
        self.info = info
        self.findings = findings
        node = info.node
        self.with_items: Set[int] = set()      # id() of ctx-managed calls
        self.assigned: Dict[int, Tuple[str, str, int, str]] = {}
        # id(call) -> (kind, target kind 'local'|'self'|'list', line, name)
        self.closed_names: Set[str] = set()
        self.finally_closed: Set[str] = set()
        self.joined_names: Set[str] = set()
        self.any_join = False
        self.returned_names: Set[str] = set()
        self.started_names: Set[str] = set()
        self._index(node)

    def _emit(self, line: int, message: str):
        self.findings.append(Finding("leak-on-raise", self.mod.rel, line,
                                     message, func=self.info.qualname))

    @staticmethod
    def _acquire_kind(call: ast.Call) -> Optional[str]:
        t = _terminal(call.func)
        if t in ACQUIRE_FILE:
            return "file"
        if t in ACQUIRE_SOCK:
            return "socket"
        if t in ACQUIRE_THREAD:
            return "thread"
        return None

    def _index(self, def_node: ast.AST):
        def visit(node: ast.AST, in_finally: bool):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call):
                        self.with_items.add(id(item.context_expr))
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                kind = self._acquire_kind(node.value)
                if kind is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.assigned[id(node.value)] = (
                                kind, "local", node.lineno, t.id)
                        elif isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            self.assigned[id(node.value)] = (
                                kind, "self", node.lineno, t.attr)
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, (ast.List, ast.ListComp)):
                elts = node.value.elts \
                    if isinstance(node.value, ast.List) \
                    else [node.value.elt]
                for e in elts:
                    if isinstance(e, ast.Call) and \
                            self._acquire_kind(e) is not None:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                self.assigned[id(e)] = (
                                    self._acquire_kind(e), "list",
                                    node.lineno, t.id)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                recv = node.func.value
                attr = node.func.attr
                name = None
                if isinstance(recv, ast.Name):
                    name = recv.id
                elif isinstance(recv, ast.Attribute) and \
                        isinstance(recv.value, ast.Name) and \
                        recv.value.id == "self":
                    name = f"self.{recv.attr}"
                if name is not None:
                    if attr in RELEASE_ATTRS:
                        self.closed_names.add(name)
                        if in_finally:
                            self.finally_closed.add(name)
                    if attr == "join":
                        self.joined_names.add(name)
                    if attr == "start":
                        self.started_names.add(name)
                if attr == "join":
                    self.any_join = True
            if isinstance(node, ast.Return) and node.value is not None:
                for n in ast.walk(node.value):
                    if isinstance(n, ast.Name):
                        self.returned_names.add(n.id)
            for child in ast.iter_child_nodes(node):
                child_in_finally = in_finally
                if isinstance(node, ast.Try) and \
                        child in node.finalbody:
                    child_in_finally = True
                visit(child, child_in_finally)

        visit(def_node, False)

    def run(self):
        for call_id, (kind, tgt, line, name) in self.assigned.items():
            if call_id in self.with_items:
                continue
            if kind == "thread":
                self._check_thread(tgt, line, name)
            else:
                self._check_handle(kind, tgt, line, name)
        # fire-and-forget: Thread(...).start() never bound to a name
        for node in ast.walk(self.info.node):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "start" and \
                    isinstance(node.func.value, ast.Call) and \
                    self._acquire_kind(node.func.value) == "thread":
                self._emit(
                    node.lineno,
                    f"{self.info.qualname}: fire-and-forget "
                    f"threading.Thread(...).start() — nothing can ever "
                    f"join it; a zombie from a torn-down world races "
                    f"whatever comes next")

    def _cls_release(self, attr: str) -> Set[str]:
        if self.info.cls is None:
            return set()
        return self.mod.cls_released.get(self.info.cls, {}).get(attr, set())

    def _check_thread(self, tgt: str, line: int, name: str):
        if tgt == "self":
            if name not in self.started_names and \
                    f"self.{name}" not in self.started_names:
                return
            if "join" not in self._cls_release(name):
                self._emit(
                    line,
                    f"{self.info.qualname}: thread self.{name} is "
                    f"started but no method of the class ever joins it "
                    f"— missing join/close on the shutdown path "
                    f"(StallInspector.stop()-style audit)")
            return
        if tgt == "list":
            if not self.any_join:
                self._emit(
                    line,
                    f"{self.info.qualname}: threads in {name!r} are "
                    f"never joined in this def")
            return
        if name not in self.started_names:
            return
        if name not in self.joined_names:
            self._emit(
                line,
                f"{self.info.qualname}: thread {name!r} is started but "
                f"never joined in this def — an exception (or plain "
                f"return) leaks a running thread")

    def _check_handle(self, kind: str, tgt: str, line: int, name: str):
        if tgt == "self":
            if not (self._cls_release(name) & RELEASE_ATTRS):
                self._emit(
                    line,
                    f"{self.info.qualname}: {kind} self.{name} is never "
                    f"closed by any method of the class — missing "
                    f"lifecycle close")
            return
        if tgt == "list":
            return
        if name in self.returned_names:
            return  # ownership transferred to the caller
        if name in self.finally_closed:
            return
        if name in self.closed_names:
            self._emit(
                line,
                f"{self.info.qualname}: {kind} {name!r} is closed only "
                f"on the success path — an exception between acquire "
                f"and close leaks it (use 'with' or try/finally)")
        else:
            self._emit(
                line,
                f"{self.info.qualname}: {kind} {name!r} is never closed "
                f"in this def (use 'with', try/finally, or store it on "
                f"an object with a close method)")


# ---------------------------------------------------------------------------
# failpoint drift (cross-module, both directions)
# ---------------------------------------------------------------------------

def _check_failpoint_drift(modules: List[_Module], raw: List[Finding],
                           rep: Report):
    specs: Dict[str, Tuple[str, int]] = {}
    for mod in modules:
        for name, line in mod.fault_specs.items():
            specs[name] = (mod.rel, line)
    sites: List[Tuple[str, int, Optional[str], str]] = []
    for mod in modules:
        for d in mod.defs:
            for line, name in d.failpoints:
                sites.append((mod.rel, line, name, d.qualname))
    rep.failpoints_declared = len(specs)
    rep.failpoint_sites = len(sites)
    if not specs and not sites:
        return  # fixtures/single modules without a registry: pass silently
    placed: Set[str] = set()
    for rel, line, name, qual in sites:
        if name is None:
            raw.append(Finding(
                "failpoint-drift", rel, line,
                f"{qual}: failpoint() name must be a string literal — a "
                f"computed name cannot be linted against FAULT_SPECS",
                func=qual))
            continue
        placed.add(name)
        if name.startswith("test."):
            raw.append(Finding(
                "failpoint-drift", rel, line,
                f"{qual}: failpoint({name!r}) — the test. prefix is "
                f"reserved for suite-local failpoints and must not "
                f"appear in framework code", func=qual))
        elif specs and name not in specs:
            raw.append(Finding(
                "failpoint-drift", rel, line,
                f"{qual}: failpoint({name!r}) is not declared in "
                f"FAULT_SPECS", func=qual))
    for name, (rel, line) in sorted(specs.items()):
        if name not in placed:
            raw.append(Finding(
                "failpoint-drift", rel, line,
                f"FAULT_SPECS declares {name!r} but no failpoint() call "
                f"site uses it — dead declaration (remove it or restore "
                f"the marker)"))


# ---------------------------------------------------------------------------
# suppression accounting
# ---------------------------------------------------------------------------

def _apply_annotations(raw: List[Finding], modules: List[_Module]
                       ) -> Tuple[List[Finding], List[Finding]]:
    ann_by_file = {m.rel: m.ann for m in modules}
    used: Set[Tuple[str, int]] = set()
    findings: List[Finding] = []
    suppressions: List[Finding] = []
    for f in raw:
        ann = ann_by_file.get(f.file)
        reason = None
        if ann is not None:
            ent = ann.ignores.get(f.line)
            if ent is not None:
                reason = ent[0]
                used.add((f.file, f.line))
            else:
                ent = ann.ignores.get(f.line - 1)
                if ent is not None and ent[1]:
                    reason = ent[0]
                    used.add((f.file, f.line - 1))
        if reason is None:
            findings.append(f)
            continue
        if not reason:
            findings.append(Finding(
                "bad-suppression", f.file, f.line,
                f"suppression without a reason on a [{f.check}] finding: "
                f"every 'errflow: ignore' needs [reason]", func=f.func))
            continue
        f.suppressed = True
        f.reason = reason
        suppressions.append(f)
    for mod in modules:
        for line, (reason, _standalone) in sorted(mod.ann.ignores.items()):
            if (mod.rel, line) not in used:
                findings.append(Finding(
                    "stale-suppression", mod.rel, line,
                    f"'errflow: ignore[{reason}]' suppresses nothing — "
                    f"remove it (the code it excused has changed)"))
    return findings, suppressions


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _check_modules(modules: List[_Module]) -> Report:
    rep = Report(files=len(modules))
    raw: List[Finding] = []
    for mod in modules:
        if mod.parse_error is not None:
            raw.append(mod.parse_error)
    live = [m for m in modules if m.tree is not None]
    recovery = _recovery_defs(live)
    for mod in live:
        for info in mod.defs:
            rep.defs += 1
            on_recovery = id(info) in recovery
            if on_recovery:
                rep.recovery_defs += 1
            chk = _DefChecker(mod, info, on_recovery, raw)
            rep.handlers += chk.check_handlers()
            chk.check_raw_io()
            _LeakScanner(mod, info, raw).run()
            if chk.seam_how is not None:
                rep.seams.append(SeamSite(mod.rel, info.node.lineno,
                                          info.qualname, chk.seam_how))
    _check_failpoint_drift(live, raw, rep)
    findings, suppressions = _apply_annotations(raw, modules)
    rep.findings = sorted(findings, key=lambda f: (f.file, f.line, f.check))
    rep.suppressions = suppressions
    return rep


def check_paths(paths: List[str], root: Optional[str] = None) -> Report:
    """Check every ``.py`` file under ``paths`` as ONE program: the
    recovery footprint and the failpoint registry resolve across all
    files of the run (a helper defined in runner/ and reached from
    elastic/ is still on the recovery path)."""
    from . import iter_py_files
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(iter_py_files(p))
        else:
            files.append(p)
    root = root or os.getcwd()
    modules = []
    for path in files:
        rel = os.path.relpath(path, root)
        with open(path, encoding="utf-8", errors="replace") as f:
            modules.append(_Module(rel, f.read()))
    return _check_modules(modules)


def check_source(source: str, rel: str = "m.py") -> Report:
    """Check one module's source in isolation (unit tests)."""
    return _check_modules([_Module(rel, source)])


def check_sources(sources: Dict[str, str]) -> Report:
    """Check several in-memory modules as one program (unit tests for
    the cross-file pass)."""
    return _check_modules([_Module(rel, src)
                           for rel, src in sorted(sources.items())])


def check_package(pkg_root: str) -> Report:
    return check_paths([pkg_root], root=os.path.dirname(pkg_root))


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Exception-propagation & resource-lifecycle analyzer "
                    "(see docs/static_analysis.md)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to check "
                         "(default: horovod_tpu_torch/)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)
    paths = args.paths
    if not paths:
        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        paths = [os.path.join(here, "horovod_tpu_torch")]
    rep = check_paths(paths)
    if args.format == "json":
        print(json.dumps(rep.to_dict(), indent=2))
    else:
        for f in rep.findings:
            print(f)
        for s in rep.suppressions:
            print(f"{s.file}:{s.line}: suppressed [{s.check}] — {s.reason}")
        for s in rep.seams:
            print(f"{s.file}:{s.line}: seam {s.func} — {s.how}")
        print(f"{rep.files} file(s), {rep.defs} def(s), "
              f"{rep.recovery_defs} on the recovery path, "
              f"{rep.handlers} handler(s), {len(rep.seams)} seam(s), "
              f"{rep.failpoints_declared} failpoint(s) declared / "
              f"{rep.failpoint_sites} site(s); "
              f"{len(rep.findings)} finding(s), "
              f"{len(rep.suppressions)} suppression(s)")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
