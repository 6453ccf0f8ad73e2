"""Lock-discipline (GUARDED_BY) checker: an AST pass over the runtime.

The model is Clang's Thread Safety Analysis brought to the Python
runtime's conventions. A class annotates which lock guards which
attributes; the checker walks every method tracking which locks are held
(``with self._lock:`` scopes, linear ``acquire()``/``release()`` pairs,
and ``# requires: _lock`` helper contracts) and reports:

``off-lock-access``
    A read or write of a guarded attribute at a point where the
    required lock is not held.
``requires-unheld``
    A call of a ``# requires: <lock>`` helper method from a context
    that does not hold the lock.
``lock-order``
    Acquiring lock B while holding lock A when some other code path
    acquires A while holding B (a cycle in the observed nesting graph),
    or re-acquiring a non-reentrant ``threading.Lock`` already held.
``blocking-under-lock``
    A known-blocking call (``time.sleep``, KV/network I/O, thread joins,
    event waits, ``torch.cuda.synchronize`` and a CUDA event's or
    stream's ``synchronize``, ``barrier``, the ``wait()`` of a
    ``torch.distributed`` work object) made while holding a lock.
``unannotated-thread-shared``
    A ``threading.Thread`` target (or ``run()`` of a ``Thread``
    subclass) that touches an attribute which is written outside
    ``__init__`` and also accessed by methods outside the thread's own
    call footprint, with no ``_GUARDED_BY`` annotation for it.
``stale-suppression`` / ``bad-suppression``
    A ``# lockcheck: ignore[...]`` comment that no longer suppresses
    any finding, or one without a reason string.

Annotation conventions (see docs/static_analysis.md):

- ``_GUARDED_BY = {"_attr": "_lock", ...}`` class attribute (a literal
  dict; merged over same-file base classes), and/or a trailing
  ``# guarded_by: _lock`` comment on the ``self._attr = ...``
  assignment. The value ``"<internal>"`` marks an attribute whose
  object is internally synchronized (metrics instruments, queues):
  annotated for the thread-share pass, exempt from the held-lock check.
- ``# requires: _lock`` on (or directly above/under) a helper method's
  ``def`` line: the method may only be called while holding the lock,
  and its body is checked as if the lock were held.
- ``# lockcheck: ignore[reason]`` on the offending line — or as a
  standalone comment on the line directly above — suppresses findings
  there; the suppression is counted and surfaced in the report, and an
  empty reason is itself an error.

Scope and soundness: only ``self.<attr>`` accesses are tracked (the
repo's shared state is instance state); accesses through other
receivers, and cross-class lock ordering, are out of scope. ``__init__``
/ ``__new__`` / ``__del__`` bodies are exempt from ``off-lock-access``
(the object is thread-private during construction). Nested functions
and lambdas are analyzed with an empty lock set — they may run later on
any thread.

The rules and the annotation grammar are the reference's
(``horovod_tpu/analysis/lockcheck.py``); the port adds the
``torch.distributed`` work objects to the blocking vocabulary (see
``_WORK_CALLS``).

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

# threading/queue constructors recognized when classifying attributes
# assigned in methods (``self.x = threading.Lock()`` ...)
_LOCK_CTORS = ("Lock", "RLock")
_COND_CTORS = ("Condition",)
_SYNC_CTORS = ("Lock", "RLock", "Condition", "Event", "Semaphore",
               "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue",
               "LifoQueue", "PriorityQueue")
_THREAD_CTORS = ("Thread",)

# attribute-call names treated as blocking anywhere; receiver-independent
_BLOCKING_NAMES = {
    "sleep", "block_until_ready", "urlopen", "getaddrinfo",
    "create_connection", "put_data_into_kvstore", "read_data_from_kvstore",
    "fetch_server_clock", "synchronize", "barrier",
}
# blocking only when called on a self attribute classified as a sync or
# thread primitive (``self._thread.join()``, ``self._evt.wait()``) — a
# bare ``"".join(...)`` or an unrelated ``wait`` must not trip the check
_BLOCKING_SYNC_METHODS = {"join", "wait", "get", "acquire_and_wait"}
# torch.distributed work objects: the result of a collective issued with
# ``async_op=True``, of ``isend``/``irecv`` and of ``batch_isend_irecv`` (a
# list of them). Their ``wait()`` blocks until the peers arrive. A name or
# self attribute bound to one (``w = dist.all_reduce(t, async_op=True)``,
# ``for req in dist.batch_isend_irecv(ops)``) is a work name; its
# ``wait()`` under a lock is blocking-under-lock.
_WORK_CALLS = {"batch_isend_irecv", "isend", "irecv"}
_WORK_METHODS = {"wait"}

_EXEMPT_METHODS = ("__init__", "__new__", "__del__")

# _GUARDED_BY value for attributes that are internally synchronized (the
# object carries its own lock — e.g. metrics instruments, queue.Queue):
# annotated for the thread-share pass, exempt from the held-lock check
INTERNALLY_SYNCED = "<internal>"

_IGNORE_TAG = "lockcheck: ignore"
_GUARDED_TAG = "guarded_by:"
_REQUIRES_TAG = "requires:"


@dataclass
class Finding:
    check: str
    file: str
    line: int
    message: str
    cls: str = ""
    attr: str = ""
    suppressed: bool = False
    reason: Optional[str] = None
    # lock-order inversions span two acquisition sites; either may carry
    # the suppression comment
    alt_file: Optional[str] = None
    alt_line: int = 0

    def to_dict(self) -> dict:
        return {"check": self.check, "file": self.file, "line": self.line,
                "class": self.cls, "attr": self.attr,
                "message": self.message, "suppressed": self.suppressed,
                "reason": self.reason}

    def __str__(self) -> str:
        loc = f"{self.file}:{self.line}"
        return f"{loc}: [{self.check}] {self.message}"


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    suppressions: List[Finding] = field(default_factory=list)
    files: int = 0
    classes_annotated: int = 0
    guarded_attrs: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {"ok": self.ok,
                "files": self.files,
                "classes_annotated": self.classes_annotated,
                "guarded_attrs": self.guarded_attrs,
                "findings": [f.to_dict() for f in self.findings],
                "suppressions": [s.to_dict() for s in self.suppressions]}


# ---------------------------------------------------------------------------
# comment harvesting (the harvester and tag grammar are shared with
# divcheck — the package's comments_by_line / parse_tag)
# ---------------------------------------------------------------------------

def _parse_ignore(comment: str) -> Optional[str]:
    """``lockcheck: ignore[reason]`` -> reason ('' when missing)."""
    return _parse_tag(comment, _IGNORE_TAG)


# ---------------------------------------------------------------------------
# per-class info collection
# ---------------------------------------------------------------------------

def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _call_root_name(func: ast.AST) -> Optional[str]:
    """Terminal name of a call target: ``a.b.c()`` -> ``c``;
    ``f()`` -> ``f``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_ctor_of(call: ast.AST, names: Tuple[str, ...]) -> bool:
    if not isinstance(call, ast.Call):
        return False
    n = _call_root_name(call.func)
    return n in names


def _is_work_expr(expr: Optional[ast.AST]) -> bool:
    """Whether ``expr`` produces torch.distributed work objects: a call of
    one of ``_WORK_CALLS``, or any call given ``async_op=True`` (lambda
    bodies excluded: they run later)."""
    if expr is None:
        return False
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.Call):
            if _call_root_name(node.func) in _WORK_CALLS:
                return True
            for kw in node.keywords:
                if kw.arg == "async_op" and \
                        isinstance(kw.value, ast.Constant) and \
                        kw.value.value is True:
                    return True
        stack.extend(ast.iter_child_nodes(node))
    return False


def _target_names(target: ast.AST) -> List[str]:
    """Plain names bound by an assignment or ``for`` target."""
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


class _ClassInfo:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.name = node.name
        self.bases = [b.attr if isinstance(b, ast.Attribute) else
                      (b.id if isinstance(b, ast.Name) else "")
                      for b in node.bases]
        self.guarded: Dict[str, str] = {}      # attr -> lock attr
        self.lock_attrs: Dict[str, str] = {}   # lock attr -> kind
        self.sync_attrs: Set[str] = set()
        self.thread_attrs: Set[str] = set()
        self.work_attrs: Set[str] = set()      # torch.distributed works
        self.requires: Dict[str, str] = {}     # method -> lock attr
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.thread_targets: Set[str] = set()
        # per-method attribute access/call maps for the thread-share pass
        self.reads: Dict[str, Set[str]] = {}
        self.writes: Dict[str, Set[str]] = {}
        self.calls: Dict[str, Set[str]] = {}
        self.access_line: Dict[Tuple[str, str], int] = {}

    def is_thread_subclass(self) -> bool:
        return any("Thread" in b for b in self.bases)


def _collect_class(cls: ast.ClassDef,
                   comments: Dict[int, Tuple[str, bool]],
                   findings: List[Finding], rel: str) -> _ClassInfo:
    info = _ClassInfo(cls)
    # class-level _GUARDED_BY literal (plain or annotated assignment —
    # a routine `: Dict[str, str]` typing cleanup must not silently turn
    # the checks off)
    for stmt in cls.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            target = stmt.target
        if target is not None and isinstance(target, ast.Name) and \
                target.id == "_GUARDED_BY":
            if not isinstance(stmt.value, ast.Dict):
                findings.append(Finding(
                    "bad-annotation", rel, stmt.lineno,
                    f"{cls.name}._GUARDED_BY must be a literal dict of "
                    f"attr -> lock strings", cls=cls.name))
                continue
            for k, v in zip(stmt.value.keys, stmt.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                        and isinstance(v, ast.Constant) \
                        and isinstance(v.value, str):
                    info.guarded[k.value] = v.value
                else:
                    findings.append(Finding(
                        "bad-annotation", rel, stmt.lineno,
                        f"{cls.name}._GUARDED_BY keys and values must be "
                        f"string literals", cls=cls.name))
    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        info.methods[fn.name] = fn
        # `# requires: <lock>` on the def line or between it and the first
        # real (non-docstring) statement
        first = fn.body[0]
        end = first.lineno
        if isinstance(first, ast.Expr) and \
                isinstance(first.value, ast.Constant) and \
                isinstance(first.value.value, str):
            end = (fn.body[1].lineno if len(fn.body) > 1
                   else (first.end_lineno or first.lineno))
        # the comment may sit directly above the def (decorator style) or
        # between the def line and the first real statement
        start = fn.lineno - 1
        if fn.decorator_list:
            start = min(d.lineno for d in fn.decorator_list) - 1
        for line in range(start, end + 1):
            c = comments.get(line, ("", False))[0]
            if c.startswith(_REQUIRES_TAG):
                info.requires[fn.name] = c[len(_REQUIRES_TAG):].strip()
        # attribute classification + trailing guarded_by comments — on
        # plain AND annotated assignments (`self._x: int = 0  # guarded_by:`
        # must not silently lose its guard to a typing cleanup)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) or \
                    (isinstance(node, ast.AnnAssign)
                     and node.value is not None):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr is None:
                        continue
                    if _is_ctor_of(node.value, _LOCK_CTORS):
                        info.lock_attrs[attr] = "Lock" \
                            if _call_root_name(node.value.func) == "Lock" \
                            else "RLock"
                        info.sync_attrs.add(attr)
                    elif _is_ctor_of(node.value, _COND_CTORS):
                        info.lock_attrs[attr] = "Condition"
                        info.sync_attrs.add(attr)
                    elif _is_ctor_of(node.value, _SYNC_CTORS):
                        info.sync_attrs.add(attr)
                    elif _is_ctor_of(node.value, _THREAD_CTORS):
                        info.thread_attrs.add(attr)
                    elif _is_work_expr(node.value):
                        info.work_attrs.add(attr)
                    c = comments.get(node.lineno, ("", False))[0]
                    if c.startswith(_GUARDED_TAG):
                        info.guarded[attr] = c[len(_GUARDED_TAG):].strip()
            if isinstance(node, ast.Call) and \
                    _call_root_name(node.func) in _THREAD_CTORS:
                for kw in node.keywords:
                    if kw.arg == "target":
                        t = _self_attr(kw.value)
                        if t is not None:
                            info.thread_targets.add(t)
    if info.is_thread_subclass() and "run" in info.methods:
        info.thread_targets.add("run")
    return info


def _merge_bases(classes: Dict[str, _ClassInfo]):
    """Single-file inheritance: fold base classes' annotations, lock and
    sync attribute sets into subclasses, iterating to a fixpoint so
    arbitrarily deep (or reverse-declared) chains settle — a partially
    propagated chain would silently disarm inherited guards."""
    changed = True
    while changed:
        changed = False
        for info in classes.values():
            for b in info.bases:
                base = classes.get(b)
                if base is None or base is info:
                    continue
                for k, v in base.guarded.items():
                    if k not in info.guarded:
                        info.guarded[k] = v
                        changed = True
                for k, v in base.lock_attrs.items():
                    if k not in info.lock_attrs:
                        info.lock_attrs[k] = v
                        changed = True
                if not base.sync_attrs <= info.sync_attrs:
                    info.sync_attrs |= base.sync_attrs
                    changed = True
                if not base.thread_attrs <= info.thread_attrs:
                    info.thread_attrs |= base.thread_attrs
                    changed = True
                if not base.work_attrs <= info.work_attrs:
                    info.work_attrs |= base.work_attrs
                    changed = True
                for k, v in base.requires.items():
                    if k not in info.requires:
                        info.requires[k] = v
                        changed = True


# ---------------------------------------------------------------------------
# the per-method lock-tracking walk
# ---------------------------------------------------------------------------

class _MethodChecker:
    def __init__(self, info: _ClassInfo, rel: str,
                 findings: List[Finding],
                 order_edges: Dict[Tuple[str, str], Tuple[str, int]]):
        self.info = info
        self.rel = rel
        self.findings = findings
        self.order_edges = order_edges
        self.method = ""
        self.exempt_access = False
        # local names bound to torch.distributed work objects
        self.work_names: Set[str] = set()

    # -- helpers -----------------------------------------------------------

    def _is_lock_attr(self, attr: str) -> bool:
        return attr in self.info.lock_attrs or attr.endswith("lock")

    def _lock_kind(self, attr: str) -> str:
        return self.info.lock_attrs.get(attr, "Lock")

    def _emit(self, check: str, node: ast.AST, message: str, attr: str = ""):
        self.findings.append(Finding(
            check, self.rel, getattr(node, "lineno", 0), message,
            cls=self.info.name, attr=attr))

    # -- entry -------------------------------------------------------------

    def check_method(self, name: str, fn: ast.FunctionDef):
        self.method = name
        self.exempt_access = name in _EXEMPT_METHODS
        self.work_names = set()
        held: Set[str] = set()
        req = self.info.requires.get(name)
        if req:
            held.add(req)
        self._visit_block(fn.body, held)

    # -- statement walk ----------------------------------------------------

    def _visit_block(self, stmts: List[ast.stmt], held: Set[str]):
        held = set(held)
        for stmt in stmts:
            self._visit_stmt(stmt, held)

    def _note_work_names(self, stmt: ast.stmt):
        """Bind work names: ``w = <work call>``, ``ws.append(<work
        call>)``, and ``for w in <work call or work name>``."""
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            work = _is_work_expr(stmt.value)
            for t in targets:
                for n in _target_names(t):
                    if work:
                        self.work_names.add(n)
                    else:
                        self.work_names.discard(n)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = stmt.iter
            if _is_work_expr(it) or (isinstance(it, ast.Name) and
                                     it.id in self.work_names):
                self.work_names.update(_target_names(stmt.target))
        elif isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Call) and \
                isinstance(stmt.value.func, ast.Attribute) and \
                stmt.value.func.attr in ("append", "extend") and \
                isinstance(stmt.value.func.value, ast.Name) and \
                any(_is_work_expr(a) for a in stmt.value.args):
            self.work_names.add(stmt.value.func.value.id)

    def _visit_stmt(self, stmt: ast.stmt, held: Set[str]):
        self._note_work_names(stmt)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            # items acquire left to right: later items nest under earlier
            # ones, so `with self._a_lock, self._b_lock:` records the same
            # A -> B edge (and the same re-acquire hazard) as the nested
            # form
            eff = set(held)
            for item in stmt.items:
                self._visit_expr(item.context_expr, eff,
                                 skip_lock_attr=True)
                attr = self._with_lock_attr(item.context_expr)
                if attr is not None:
                    self._note_acquire(attr, eff, stmt)
                    eff.add(attr)
            self._visit_block(stmt.body, eff)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested function: may run later on any thread — empty lock set
            self._visit_block(stmt.body, set())
        elif isinstance(stmt, (ast.If,)):
            self._visit_expr(stmt.test, held)
            self._visit_block(stmt.body, held)
            self._visit_block(stmt.orelse, held)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._visit_expr(stmt.iter, held)
            self._visit_expr(stmt.target, held)
            self._visit_block(stmt.body, held)
            self._visit_block(stmt.orelse, held)
        elif isinstance(stmt, ast.While):
            self._visit_expr(stmt.test, held)
            self._visit_block(stmt.body, held)
            self._visit_block(stmt.orelse, held)
        elif hasattr(ast, "Match") and isinstance(stmt, ast.Match):
            # match statements (3.10+): case bodies are ordinary blocks
            self._visit_expr(stmt.subject, held)
            for case in stmt.cases:
                if case.guard is not None:
                    self._visit_expr(case.guard, held)
                self._visit_block(case.body, held)
        elif isinstance(stmt, ast.Try):
            self._visit_block(stmt.body, held)
            for h in stmt.handlers:
                self._visit_block(h.body, held)
            self._visit_block(stmt.orelse, held)
            # the finally block runs on every path out of the try, so its
            # acquire()/release() effects PROPAGATE to the statements after
            # the try — `acquire(); try: ... finally: release()` leaves the
            # lock released for the rest of the enclosing block
            for sub in stmt.finalbody:
                self._visit_stmt(sub, held)
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            # linear acquire()/release() discipline within one block
            call = stmt.value
            if isinstance(call.func, ast.Attribute):
                recv = _self_attr(call.func.value)
                if recv is not None and self._is_lock_attr(recv):
                    if call.func.attr == "acquire":
                        self._note_acquire(recv, held, stmt)
                        held.add(recv)
                        return
                    if call.func.attr == "release":
                        held.discard(recv)
                        return
            self._visit_expr(stmt.value, held)
        else:
            for node in ast.iter_child_nodes(stmt):
                if isinstance(node, ast.expr):
                    self._visit_expr(node, held)

    def _with_lock_attr(self, expr: ast.expr) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and self._is_lock_attr(attr):
            return attr
        return None

    def _note_acquire(self, attr: str, held: Set[str], node: ast.AST):
        if attr in held and self._lock_kind(attr) == "Lock":
            self._emit("lock-order", node,
                       f"{self.info.name}.{self.method} re-acquires "
                       f"non-reentrant lock self.{attr} already held "
                       f"(self-deadlock)", attr=attr)
        # edge ids are qualified by file so two unrelated classes that
        # happen to share a name never merge their nesting graphs (no
        # thread can hold both classes' locks through `self`)
        me = f"{self.rel}::{self.info.name}.{attr}"
        for h in held:
            if h == attr:
                continue
            edge = (f"{self.rel}::{self.info.name}.{h}", me)
            self.order_edges.setdefault(edge, (self.rel,
                                               getattr(node, "lineno", 0)))

    # -- expression walk ---------------------------------------------------

    def _visit_expr(self, expr: ast.expr, held: Set[str],
                    skip_lock_attr: bool = False):
        if expr is None:
            return
        for node in self._walk_no_nested(expr):
            if isinstance(node, (ast.Lambda,)):
                self._visit_expr(node.body, set())
                continue
            if isinstance(node, ast.Call):
                self._check_call(node, held)
            attr = _self_attr(node) if isinstance(node, ast.Attribute) \
                else None
            if attr is None:
                continue
            if skip_lock_attr and self._is_lock_attr(attr):
                continue
            self._check_attr_access(node, attr, held)

    def _walk_no_nested(self, expr: ast.expr):
        """ast.walk that does not descend into Lambda bodies (they run
        later, with no locks held — handled separately)."""
        stack = [expr]
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, ast.Lambda):
                continue
            stack.extend(ast.iter_child_nodes(node))

    def _check_attr_access(self, node: ast.Attribute, attr: str,
                           held: Set[str]):
        info = self.info
        if attr in info.lock_attrs or attr in info.sync_attrs:
            return
        lock = info.guarded.get(attr)
        if lock == INTERNALLY_SYNCED:
            # annotated as internally thread-safe (its own lock inside):
            # exempt from the held-lock check, still counts as annotated
            # for the thread-share pass
            return
        if lock is not None and lock not in held and \
                not self.exempt_access:
            what = "write of" if isinstance(node.ctx,
                                            (ast.Store, ast.Del)) \
                else "access to"
            self._emit(
                "off-lock-access", node,
                f"{info.name}.{self.method}: {what} guarded attribute "
                f"self.{attr} without holding self.{lock} "
                f"(guarded_by: {lock})", attr=attr)

    def _check_call(self, call: ast.Call, held: Set[str]):
        info = self.info
        name = _call_root_name(call.func)
        if name is None:
            return
        # requires-annotated helper called without its lock
        if isinstance(call.func, ast.Attribute) and \
                isinstance(call.func.value, ast.Name) and \
                call.func.value.id == "self" and name in info.requires:
            req = info.requires[name]
            if req not in held:
                self._emit(
                    "requires-unheld", call,
                    f"{info.name}.{self.method} calls self.{name}() which "
                    f"requires self.{req}, without holding it", attr=name)
        if not held:
            return
        # blocking call while holding a lock — either called directly or
        # passed by reference into an invoker wrapper
        # (``_translate_failure(event.synchronize)``)
        blocking = name in _BLOCKING_NAMES
        if not blocking:
            for a in call.args:
                if isinstance(a, ast.Attribute) and \
                        a.attr in _BLOCKING_NAMES:
                    blocking = True
                    name = a.attr
                    break
        if not blocking and name in _BLOCKING_SYNC_METHODS and \
                isinstance(call.func, ast.Attribute):
            recv = _self_attr(call.func.value)
            if recv is not None and \
                    (recv in info.sync_attrs or recv in info.thread_attrs):
                # Condition.wait on the held lock releases it — not a hang
                blocking = recv not in held
        if not blocking and name in _WORK_METHODS and \
                isinstance(call.func, ast.Attribute):
            # a torch.distributed work object's wait(): the peers' arrival
            recv_node = call.func.value
            blocking = (isinstance(recv_node, ast.Name) and
                        recv_node.id in self.work_names) or \
                _self_attr(recv_node) in info.work_attrs
        if blocking:
            self._emit(
                "blocking-under-lock", call,
                f"{info.name}.{self.method}: blocking call {name}() while "
                f"holding {{{', '.join('self.' + h for h in sorted(held))}}}",
                attr=name)


# ---------------------------------------------------------------------------
# access maps + thread-share pass
# ---------------------------------------------------------------------------

# in-place container mutators: ``self._warned.add(...)`` and
# ``self._outstanding[k] = ...`` are writes to shared state even though the
# attribute node itself is a Load
_MUTATOR_METHODS = {
    "add", "append", "appendleft", "clear", "discard", "extend", "insert",
    "pop", "popitem", "popleft", "remove", "setdefault", "update",
}


def _collect_accesses(info: _ClassInfo):
    for mname, fn in info.methods.items():
        reads: Set[str] = set()
        writes: Set[str] = set()
        calls: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                recv = _self_attr(node.func.value)
                if isinstance(node.func.value, ast.Name) and \
                        node.func.value.id == "self":
                    calls.add(node.func.attr)
                elif recv is not None and \
                        node.func.attr in _MUTATOR_METHODS:
                    writes.add(recv)
                    info.access_line.setdefault((mname, recv), node.lineno)
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                recv = _self_attr(node.value)
                if recv is not None:
                    writes.add(recv)
                    info.access_line.setdefault((mname, recv), node.lineno)
            attr = _self_attr(node) if isinstance(node, ast.Attribute) \
                else None
            if attr is None:
                continue
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                writes.add(attr)
            else:
                reads.add(attr)
            info.access_line.setdefault((mname, attr), node.lineno)
        info.reads[mname] = reads
        info.writes[mname] = writes
        info.calls[mname] = calls


def _footprint(info: _ClassInfo, root: str) -> Set[str]:
    seen: Set[str] = set()
    stack = [root]
    while stack:
        m = stack.pop()
        if m in seen or m not in info.methods:
            continue
        seen.add(m)
        stack.extend(info.calls.get(m, ()))
    return seen


def _thread_share_pass(info: _ClassInfo, rel: str,
                       findings: List[Finding]):
    if not info.thread_targets:
        return
    _collect_accesses(info)
    skip = (info.sync_attrs | info.thread_attrs |
            set(info.lock_attrs) | set(info.guarded) | set(info.methods))
    # attrs written anywhere outside __init__ (an attr only ever assigned
    # during construction is immutable config, not shared mutable state)
    mutated = set()
    for m, w in info.writes.items():
        if m not in _EXEMPT_METHODS:
            mutated |= w
    reported: Set[str] = set()
    for target in sorted(info.thread_targets):
        foot = _footprint(info, target)
        outside = [m for m in info.methods
                   if m not in foot and m not in _EXEMPT_METHODS]
        for m in sorted(foot):
            for attr in sorted(info.reads.get(m, set()) |
                               info.writes.get(m, set())):
                if attr in skip or attr in reported or attr not in mutated:
                    continue
                shared = [o for o in outside
                          if attr in info.reads.get(o, set()) or
                          attr in info.writes.get(o, set())]
                if not shared:
                    continue
                reported.add(attr)
                line = info.access_line.get((m, attr), info.node.lineno)
                findings.append(Finding(
                    "unannotated-thread-shared", rel, line,
                    f"{info.name}.{m} (reached from thread target "
                    f"{target}()) touches self.{attr}, also accessed by "
                    f"{', '.join(sorted(shared))}, but {attr!r} has no "
                    f"_GUARDED_BY annotation", cls=info.name, attr=attr))


# ---------------------------------------------------------------------------
# lock-order cycle detection (over the whole run)
# ---------------------------------------------------------------------------

def _order_findings(order_edges: Dict[Tuple[str, str], Tuple[str, int]]
                    ) -> List[Finding]:
    out = []
    seen = set()
    for (a, b), (rel, line) in sorted(order_edges.items()):
        if (b, a) in order_edges and (b, a) not in seen:
            seen.add((a, b))
            rel2, line2 = order_edges[(b, a)]
            # display without the file qualifier (the finding carries
            # both locations already)
            da, db = a.split("::", 1)[-1], b.split("::", 1)[-1]
            out.append(Finding(
                "lock-order", rel, line,
                f"inconsistent lock order: {da} -> {db} here, but "
                f"{db} -> {da} at {rel2}:{line2} (deadlock risk)",
                attr=db.rsplit(".", 1)[-1], alt_file=rel2, alt_line=line2))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _check_raw(source: str, rel: str,
               order_edges: Dict[Tuple[str, str], Tuple[str, int]]
               ) -> Tuple[List[Finding], Dict[int, Tuple[str, bool]],
                          int, int]:
    """One module's raw findings (no suppression applied, no order-cycle
    detection — edges accumulate into ``order_edges``). Returns
    (raw findings, comment map, annotated_class_count,
    guarded_attr_count)."""
    raw: List[Finding] = []
    comments = _comments_by_line(source)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        raw.append(Finding("parse-error", rel, e.lineno or 0, str(e)))
        return raw, comments, 0, 0
    classes: Dict[str, _ClassInfo] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            classes[node.name] = _collect_class(node, comments, raw, rel)
    _merge_bases(classes)
    for info in classes.values():
        checker = _MethodChecker(info, rel, raw, order_edges)
        for mname, fn in info.methods.items():
            checker.check_method(mname, fn)
        _thread_share_pass(info, rel, raw)
    n_classes = sum(1 for c in classes.values() if c.guarded)
    n_guarded = sum(len(c.guarded) for c in classes.values())
    return raw, comments, n_classes, n_guarded


def check_source(source: str, rel: str) -> Tuple[List[Finding],
                                                 List[Finding], int, int]:
    """Check one module's source in isolation. Returns (findings,
    suppressions, annotated_class_count, guarded_attr_count); findings
    exclude the suppressed ones, which are returned separately with
    their reasons."""
    order_edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    raw, comments, n_classes, n_guarded = _check_raw(source, rel,
                                                     order_edges)
    raw.extend(_order_findings(order_edges))
    findings, suppressions = _apply_suppressions(raw, {rel: comments})
    return findings, suppressions, n_classes, n_guarded


def _suppression_sites(f: Finding):
    """Locations whose ignore comment may suppress ``f``: its own line
    (trailing or standalone), the standalone line directly above — and,
    for a lock-order inversion, the same for the OTHER edge of the cycle
    (either acquisition site may carry the excuse)."""
    sites = [(f.file, f.line, False), (f.file, f.line - 1, True)]
    if f.alt_file is not None:
        sites += [(f.alt_file, f.alt_line, False),
                  (f.alt_file, f.alt_line - 1, True)]
    return sites


def _apply_suppressions(raw: List[Finding],
                        comments_by_file: Dict[str, Dict[int,
                                                         Tuple[str, bool]]]
                        ) -> Tuple[List[Finding], List[Finding]]:
    # (file, line) -> (reason, standalone) for every ignore comment
    ignores: Dict[Tuple[str, int], Tuple[str, bool]] = {}
    for rel, comments in comments_by_file.items():
        for line, (text, standalone) in comments.items():
            reason = _parse_ignore(text)
            if reason is not None:
                ignores[(rel, line)] = (reason, standalone)
    used: Set[Tuple[str, int]] = set()
    findings: List[Finding] = []
    suppressions: List[Finding] = []
    for f in raw:
        reason = None
        for file, line, need_standalone in _suppression_sites(f):
            ent = ignores.get((file, line))
            if ent is None:
                continue
            # a comment on the line above only applies when it stands
            # alone — a TRAILING ignore must never bleed onto the next
            # line's findings
            if need_standalone and not ent[1]:
                continue
            if reason is None:
                reason = ent[0]
            # mark EVERY matching site used: an inversion documented at
            # both acquisition sites must not turn the second comment
            # into a stale-suppression failure
            used.add((file, line))
        if reason is None:
            findings.append(f)
            continue
        if not reason:
            findings.append(Finding(
                "bad-suppression", f.file, f.line,
                f"suppression without a reason on a [{f.check}] finding: "
                f"every 'lockcheck: ignore' needs [reason]",
                cls=f.cls, attr=f.attr))
            continue
        f.suppressed = True
        f.reason = reason
        suppressions.append(f)
    for (rel, line), (reason, _standalone) in sorted(ignores.items()):
        if (rel, line) not in used:
            findings.append(Finding(
                "stale-suppression", rel, line,
                f"'lockcheck: ignore[{reason}]' suppresses nothing — "
                f"remove it (the code it excused has changed)"))
    return findings, suppressions


def check_paths(paths: List[str], root: Optional[str] = None) -> Report:
    """Check every ``.py`` file in ``paths`` (files or directories).
    Lock-order edges accumulate across all files of one run, and
    suppressions/stale detection are applied once at the end so an
    ignore comment excusing a cross-file inversion is neither missed nor
    reported stale."""
    from . import iter_py_files
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(iter_py_files(p))
        else:
            files.append(p)
    root = root or os.getcwd()
    rep = Report()
    raw: List[Finding] = []
    comments_by_file: Dict[str, Dict[int, Tuple[str, bool]]] = {}
    order_edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for path in files:
        rel = os.path.relpath(path, root)
        with open(path, encoding="utf-8", errors="replace") as f:
            source = f.read()
        file_raw, comments, n_cls, n_grd = _check_raw(source, rel,
                                                      order_edges)
        raw.extend(file_raw)
        comments_by_file[rel] = comments
        rep.classes_annotated += n_cls
        rep.guarded_attrs += n_grd
        rep.files += 1
    raw.extend(_order_findings(order_edges))
    findings, suppressions = _apply_suppressions(raw, comments_by_file)
    rep.findings = sorted(findings, key=lambda f: (f.file, f.line, f.check))
    rep.suppressions = suppressions
    return rep


def check_package(pkg_root: str) -> Report:
    return check_paths([pkg_root], root=os.path.dirname(pkg_root))


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="GUARDED_BY lock-discipline checker "
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
        print(f"{rep.files} file(s), {rep.guarded_attrs} guarded attr(s) "
              f"across {rep.classes_annotated} annotated class(es); "
              f"{len(rep.findings)} finding(s), "
              f"{len(rep.suppressions)} suppression(s)")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
