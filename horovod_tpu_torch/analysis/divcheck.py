"""SPMD divergence & dispatch-determinism checker: an AST pass over the
lockstep-submission invariant, over the port.

The port, like the reference, has no coordinator: every rank issues the
same collectives, in the same order, from collectively-agreed inputs. A
collective one rank skips hangs the others in NCCL or gloo; a
``new_group`` one rank skips hangs every later ``new_group``; the per-name
correlation id (``name#world_version#seq``) and the step-replay signature
are only joinable across ranks under that invariant. divcheck is the
static guardrail: a pure-AST, cross-file call-graph pass (no scanned
module imported) with four finding classes:

``rank-gated-collective``
    A collective-issuing call (the engine's face and its internal
    funnels, ``ops/collectives``'s launchers, ``torch.distributed``'s
    issuing calls, ``new_group`` and the point-to-point hops, and
    barrier-like agreement exchanges such as ``_hierarchical_ok``)
    reachable under control flow conditioned on rank-local state
    (``hvd.rank()``, ``local_rank``, elastic ``world_version``
    comparisons) — the classic SPMD deadlock: some ranks enter the
    collective, the rest never arrive. Point-to-point hops are
    rank-dependent by design: each rank-gated hop carries a
    ``# divcheck: agreed[how]`` saying how the schedule pairs every send
    with its receive.
``nondeterministic-submission-order``
    A collective issued inside iteration over a ``set`` / ``frozenset``
    / ``os.listdir()`` / ``glob()`` result — the per-name ``seq`` that
    tracing and replay keying assume lockstep is only deterministic when
    the submission *order* is.
``unagreed-selection-input``
    A rank-local value (env read, ``time.*`` measurement, hostname)
    flowing into a decision that must be collectively identical
    (algorithm forcing, fusion thresholds, bucket layout) without
    passing through an annotated ``# divcheck: agreed[how]`` exchange
    point.
``capture-impure-read``
    An ``os.environ``/knob read or host-I/O call reachable from the
    step path after engine init. Knobs must resolve at init or take part
    in re-arming replay (the engine's ``_algo_sig`` is the sanctioned
    pattern): a host read on the step path makes a captured CUDA graph
    diverge from the eager stream it was armed from.

The rules and the annotation grammar are the reference's
(``horovod_tpu/analysis/divcheck.py``); the vocabulary is the port's. A
collective passed by reference to an invoker
(``_translate_failure(dist.all_reduce, flat)``, the port's way of issuing
one) counts as a call of it, the rule lockcheck applies to blocking
calls.

Annotation conventions (see docs/static_analysis.md):

- ``# divcheck: agreed[how]`` — on (or standalone directly above) an
  ``if``/``while`` test, an assignment, a ``for``, or a decision call:
  the condition / value / iteration order is collectively agreed, and
  ``how`` documents the exchange (broadcast, launcher env contract,
  KV agreement, derived from step count, ...). Every active agreed
  site is enumerated in the report; an empty ``how`` is itself a
  finding, and one that excuses nothing is reported stale.
- ``# divcheck: ignore[reason]`` — suppresses findings on the line
  (or the line below a standalone comment), lockcheck's suppression
  grammar exactly: reason mandatory, every active suppression surfaced
  in the report, dead ones reported stale.
- Init-phase exemption: ``__init__`` / ``init`` / ``from_env`` bodies
  are exempt from ``capture-impure-read`` — resolving knobs while an
  object is constructed *is* the sanctioned pattern.

Scope and soundness: the call graph is name-resolved (a call's terminal
name edges to every scanned def sharing it), which over-approximates;
ultra-common names are excluded from propagation so ``.get()`` cannot
make the whole tree "collective-issuing". Only same-function dataflow
is tracked for selection inputs. ``if``/``while`` gating is detected by
direct nesting plus the guard-return form (``if rank()...: return``
taints the rest of the block). Device code is data, not Python control
flow: ``torch.where(idx == root_rank, ...)`` never trips the checker.

Pure stdlib; no module under scan is imported.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import comments_by_line as _comments_by_line
from . import is_environ as _is_environ
from . import parse_tag as _parse_tag

# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

# Terminal call names that directly submit (or agree on) a collective:
# the engine face / hvd face, the functions.py object helpers,
# torch.distributed's issuing calls, the engine-internal submission
# funnels and agreement exchanges, and the ops/collectives launchers the
# engine issues through (the port's counterpart of the reference's
# build_* program builders).
COLLECTIVE_SEEDS: Set[str] = {
    # engine / hvd face
    "allreduce", "allreduce_async", "grouped_allreduce",
    "allgather", "allgather_async", "grouped_allgather",
    "broadcast", "broadcast_async", "grouped_broadcast",
    "reducescatter", "reducescatter_async", "alltoall", "grouped_alltoall",
    "sharded_step", "barrier",
    # functions.py object helpers
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_object", "allgather_object", "allreduce_sparse",
    # torch.distributed: the collectives, the point-to-point hops (each
    # rank-gated hop carries an agreed[...] on how the schedule pairs it)
    # and new_group, which every rank must call in the same order
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce_scatter_tensor", "all_to_all_single", "all_to_all",
    "batch_isend_irecv", "isend", "irecv", "broadcast_object_list",
    "all_gather_object", "monitored_barrier", "new_group",
    # engine-internal submission funnels + agreement exchanges
    "_register", "_register_many", "_join_sync", "_join_loop",
    "_dispatch_substitute", "_hierarchical_ok", "_exchange_sizes",
    "_exchange_rows", "_post_exchange", "_root_flag", "_make_groups",
    "hierarchical_groups", "_warm_groups",
    # the engine's launchers and ops/collectives' (one collective, or a
    # ladder of them, per bucket)
    "_reduce_launch", "_bucket_launch", "_codec_launch", "_a2a_launch",
    "_gather_shards", "tree_allreduce", "hier_allreduce", "hier_all_gather",
    "hier_alltoall", "reduce_scatter", "rs_flat", "ag_flat",
    "scatter_shards", "gather_shards", "rs_flat_codec", "codec_allreduce",
    "codec_hier_allreduce", "ef_allreduce",
}

# Names NEVER used as propagation edges in the call graph: a def with
# one of these names may well be collective-issuing (and is then checked
# internally), but a *call site* of the bare name is too ambiguous to
# treat as reaching it (dict.get, str.join, Thread.run, list.pop, ...).
NO_PROPAGATE: Set[str] = {
    "__init__", "__call__", "__enter__", "__exit__", "get", "put", "pop",
    "add", "append", "extend", "update", "remove", "discard", "clear",
    "items", "keys", "values", "join", "run", "main", "start", "stop",
    "close", "wait", "send", "recv", "read", "write", "open", "next",
    "copy", "index", "count", "sort", "split", "strip", "format", "info",
    "debug", "warning", "error", "exception", "log", "inc", "set",
    "observe", "record", "wrapper", "wrapped", "inner", "fn", "callback",
    "apply", "step", "poll", "flush", "result", "submit", "register",
    # sklearn-style model verbs: the GP's fit()/predict() must not alias
    # Estimator.fit / TrainedModel.predict, nor _validate the estimator's
    "fit", "predict", "_validate", "validate", "transform", "evaluate",
}

# Rank-local state: call terminals and attribute/name identifiers whose
# value differs per rank (torch.distributed's ``get_rank`` among them).
# ``size``/``world_size``/``root_rank`` are collectively identical and
# deliberately absent.
RANK_CALLS: Set[str] = {
    "rank", "local_rank", "process_index", "slice_index", "node_rank",
    "cross_rank", "gethostname", "get_rank",
}
RANK_NAMES: Set[str] = {
    "rank", "local_rank", "process_index", "slice_index", "my_rank",
    "cross_rank",
}
# elastic world-version comparisons: the *comparison* of a cached local
# world_version against another is rank-local (a lagging rank disagrees)
WORLD_VERSION_NAMES: Set[str] = {"world_version", "_world_version"}

# Unordered producers: iterating one of these and issuing a collective
# per element breaks the per-name submission ``seq``.
UNORDERED_CALLS: Set[str] = {
    "set", "frozenset", "listdir", "scandir", "glob", "iglob",
    "union", "intersection", "difference", "symmetric_difference",
}

# Rank-local value sources for the selection-input pass.
ENV_READ_FUNCS: Set[str] = {"getenv", "_get_bool", "_get_int",
                            "_get_float", "_get_choice"}
TIME_FUNCS: Set[str] = {"time", "monotonic", "perf_counter",
                        "process_time", "thread_time", "gethostname"}

# Decisions that must be collectively identical: algorithm selection,
# fusion/bucket layout, topology resolution, overlap scheduling.
DECISION_SINKS: Set[str] = {
    "choose_algorithm", "_choose_algo", "_bucket_algos",
    "validate_algorithm", "bucket_by_size", "detect_topology",
    "shard_spec", "_overlap_mode",
}

# Step-path roots for the capture-impure pass: defs with these names are
# the dispatch-path entries; everything name-reachable from them runs
# after engine init, inside (or under) a capturable step.
STEP_PATH_ROOTS: Set[str] = {
    "allreduce", "grouped_allreduce", "allgather", "broadcast",
    "grouped_broadcast", "reducescatter", "alltoall", "grouped_alltoall",
    "sharded_step", "step_begin", "step_end", "intercept", "barrier",
}

# Host-I/O terminals for the capture-impure pass (reads that can differ
# per host / per run, or mutate host state mid-step).
HOST_IO_CALLS: Set[str] = {
    "listdir", "scandir", "glob", "iglob", "makedirs", "rename",
    "replace", "unlink",
}

INIT_PHASE_NAMES: Set[str] = {"__init__", "__new__", "init", "from_env"}

_IGNORE_TAG = "divcheck: ignore"
_AGREED_TAG = "divcheck: agreed"


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
class AgreedSite:
    file: str
    line: int
    how: str
    what: str  # condition | value | order | selection

    def to_dict(self) -> dict:
        return {"file": self.file, "line": self.line, "how": self.how,
                "what": self.what}


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    suppressions: List[Finding] = field(default_factory=list)
    agreed: List[AgreedSite] = field(default_factory=list)
    files: int = 0
    defs: int = 0
    issuing_defs: int = 0
    step_path_defs: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {"ok": self.ok, "files": self.files, "defs": self.defs,
                "issuing_defs": self.issuing_defs,
                "step_path_defs": self.step_path_defs,
                "findings": [f.to_dict() for f in self.findings],
                "suppressions": [s.to_dict() for s in self.suppressions],
                "agreed": [a.to_dict() for a in self.agreed]}


# ---------------------------------------------------------------------------
# annotation index (the comment harvester and tag grammar are shared with
# lockcheck — the package's comments_by_line / parse_tag)
# ---------------------------------------------------------------------------

class _Annotations:
    """Per-file agreed/ignore comment index with usage tracking."""

    def __init__(self, rel: str, comments: Dict[int, Tuple[str, bool]]):
        self.rel = rel
        # line -> (payload, standalone)
        self.agreed: Dict[int, Tuple[str, bool]] = {}
        self.ignores: Dict[int, Tuple[str, bool]] = {}
        self.agreed_used: Dict[int, str] = {}   # line -> what it excused
        for line, (text, standalone) in comments.items():
            a = _parse_tag(text, _AGREED_TAG)
            if a is not None:
                self.agreed[line] = (a, standalone)
            i = _parse_tag(text, _IGNORE_TAG)
            if i is not None:
                self.ignores[line] = (i, standalone)

    def agreed_at(self, line: int) -> Optional[Tuple[int, str]]:
        """The agreed annotation covering ``line``: trailing on the line
        itself, or standalone directly above. Returns (site line, how)."""
        ent = self.agreed.get(line)
        if ent is not None:
            return line, ent[0]
        ent = self.agreed.get(line - 1)
        if ent is not None and ent[1]:
            return line - 1, ent[0]
        return None

    def use_agreed(self, line: int, what: str) -> Optional[str]:
        """Consume the agreed annotation covering ``line`` (if any):
        marks it live and returns its ``how``."""
        hit = self.agreed_at(line)
        if hit is None:
            return None
        site, how = hit
        self.agreed_used.setdefault(site, what)
        return how


# ---------------------------------------------------------------------------
# phase 1: per-module collection
# ---------------------------------------------------------------------------

def _terminal(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _invoked_seed(call: ast.Call) -> Optional[str]:
    """A collective seed passed by reference as a positional argument —
    ``_translate_failure(dist.all_reduce, flat)`` issues ``all_reduce``
    as surely as calling it."""
    for a in call.args:
        if isinstance(a, (ast.Attribute, ast.Name)):
            t = _terminal(a)
            if t in COLLECTIVE_SEEDS:
                return t
    return None


def _is_env_read(node: ast.AST) -> bool:
    """``os.environ.get/[...]``, ``os.getenv``, or a typed env helper."""
    if isinstance(node, ast.Call):
        t = _terminal(node.func)
        if t in ENV_READ_FUNCS:
            return True
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("get", "pop", "setdefault") and \
                _is_environ(node.func.value):
            return True
    if isinstance(node, ast.Subscript) and _is_environ(node.value):
        return True
    return False


@dataclass
class _DefInfo:
    rel: str
    qualname: str       # Class.method or function
    name: str           # terminal name
    node: ast.AST
    # resolved call tokens: a ``self.X()`` call whose class defines X
    # (same file, bases merged) records the unambiguous qualified token
    # ``rel::Class.X``; every other call records the bare terminal name.
    # This is the precision that keeps one ``Registry._validate`` from
    # aliasing an ``Estimator._validate`` that happens to allreduce.
    calls: Set[str] = field(default_factory=set)
    set_attrs: Set[str] = field(default_factory=set)  # class-level view
    # method name -> owning class, for resolving self-calls at check time
    cls_methods: Optional[Dict[str, str]] = None

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
        # class -> {method name -> owning class} (same-file bases merged
        # to a fixpoint, the lockcheck _merge_bases discipline) for
        # self-call resolution
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
        # class -> attrs assigned a set()/set literal anywhere (the
        # receiver classification for unordered iteration over
        # ``self._pending_ranks``-style state)
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                set_attrs = self._class_set_attrs(node)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._add_def(f"{node.name}.{item.name}", item,
                                      set_attrs,
                                      cls_methods=methods[node.name])
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_def(node.name, node, set())

    @staticmethod
    def _class_set_attrs(cls: ast.ClassDef) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                val = node.value
                is_set = isinstance(val, (ast.Set, ast.SetComp)) or \
                    (isinstance(val, ast.Call) and
                     _terminal(val.func) in ("set", "frozenset"))
                if not is_set:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        out.add(tgt.attr)
        return out

    def _add_def(self, qualname: str, node: ast.AST, set_attrs: Set[str],
                 cls_methods: Optional[Dict[str, str]] = None):
        info = _DefInfo(self.rel, qualname, node.name, node,
                        set_attrs=set_attrs, cls_methods=cls_methods)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                ref = _invoked_seed(sub)
                if ref is not None:
                    info.calls.add(ref)
                t = _terminal(sub.func)
                if not t:
                    continue
                if cls_methods and isinstance(sub.func, ast.Attribute) and \
                        isinstance(sub.func.value, ast.Name) and \
                        sub.func.value.id == "self" and t in cls_methods:
                    info.calls.add(f"{self.rel}::{cls_methods[t]}.{t}")
                else:
                    info.calls.add(t)
        self.defs.append(info)


# ---------------------------------------------------------------------------
# cross-file resolution: collective-issuing set + step-path footprint
# ---------------------------------------------------------------------------

def _issuing_tokens(modules: List[_Module]) -> Set[str]:
    """Fixpoint over the resolved call graph: a def issues a collective
    if its name is a seed or it calls an issuing token. An issuing def
    always contributes its unambiguous qualified token; its bare name
    propagates only when distinctive enough (NO_PROPAGATE keeps
    ``.get()`` from making the whole tree collective-issuing)."""
    issuing = set(COLLECTIVE_SEEDS)
    changed = True
    while changed:
        changed = False
        for mod in modules:
            for d in mod.defs:
                if d.qual_token in issuing:
                    continue
                if d.name in COLLECTIVE_SEEDS or d.calls & issuing:
                    issuing.add(d.qual_token)
                    if d.name not in NO_PROPAGATE and d.name not in issuing:
                        issuing.add(d.name)
                    changed = True
    return issuing


def _issuing_def_count(modules: List[_Module], issuing: Set[str]) -> int:
    return sum(1 for mod in modules for d in mod.defs
               if d.qual_token in issuing)


def _step_path_defs(modules: List[_Module]) -> Set[int]:
    """ids of defs reachable from the step-path roots over the resolved
    call graph (qualified self-call edges are followed directly; bare
    edges fan out to every same-named def except NO_PROPAGATE)."""
    by_token: Dict[str, List[_DefInfo]] = {}
    for mod in modules:
        for d in mod.defs:
            by_token.setdefault(d.name, []).append(d)
            by_token.setdefault(d.qual_token, []).append(d)
    seen: Set[int] = set()
    frontier: List[_DefInfo] = []
    for mod in modules:
        for d in mod.defs:
            if d.name in STEP_PATH_ROOTS:
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
# phase 2: the per-def context walk
# ---------------------------------------------------------------------------

def _expr_has(expr: ast.AST, pred) -> Optional[ast.AST]:
    """First node under ``expr`` satisfying ``pred`` (not descending into
    lambda/def bodies — they run later, elsewhere)."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            continue
        if pred(node):
            return node
        stack.extend(ast.iter_child_nodes(node))
    return None


def _rank_source(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        t = _terminal(node.func)
        if t in RANK_CALLS:
            return True
    if isinstance(node, ast.Attribute) and node.attr in RANK_NAMES:
        return True
    if isinstance(node, ast.Name) and node.id in RANK_NAMES:
        return True
    return False


def _world_version_compare(node: ast.AST) -> bool:
    """A Compare with world_version on either side — the elastic
    'my cached world vs the observed one' divergence source."""
    if not isinstance(node, ast.Compare):
        return False

    def _is_wv(e: ast.AST) -> bool:
        if isinstance(e, ast.Attribute) and e.attr in WORLD_VERSION_NAMES:
            return True
        if isinstance(e, ast.Name) and e.id in WORLD_VERSION_NAMES:
            return True
        if isinstance(e, ast.Subscript) and \
                isinstance(e.slice, ast.Constant) and \
                e.slice.value in WORLD_VERSION_NAMES:
            return True
        return False
    return any(_is_wv(e) for e in [node.left] + list(node.comparators))


def _rank_local_test(test: ast.expr) -> Optional[str]:
    """A human-readable description of why ``test`` is rank-local, or
    None when it is collectively agreed."""
    hit = _expr_has(test, _rank_source)
    if hit is not None:
        if isinstance(hit, ast.Call):
            return f"{_terminal(hit.func)}()"
        if isinstance(hit, ast.Attribute):
            return f".{hit.attr}"
        return getattr(hit, "id", "rank")
    hit = _expr_has(test, _world_version_compare)
    if hit is not None:
        return "world_version comparison"
    return None


def _time_source(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _terminal(node.func) in TIME_FUNCS


@dataclass
class _Ctx:
    line: int
    desc: str


class _DefChecker:
    """Walks one def tracking rank-gated regions, unordered-iteration
    regions, and same-function selection-input taint."""

    def __init__(self, mod: _Module, info: _DefInfo, issuing: Set[str],
                 findings: List[Finding]):
        self.mod = mod
        self.info = info
        self.issuing = issuing
        self.findings = findings
        self.rank_ctx: List[_Ctx] = []
        self.order_ctx: List[_Ctx] = []
        # name -> (line, desc) of the rank-local source it carries
        self.taint: Dict[str, Tuple[int, str]] = {}
        # local names bound to set()/frozenset()/set literals
        self.set_names: Set[str] = set()

    def run(self):
        node = self.info.node
        body = getattr(node, "body", [])
        self._visit_block(body)

    # -- helpers -----------------------------------------------------------

    def _emit(self, check: str, node: ast.AST, message: str):
        self.findings.append(Finding(
            check, self.mod.rel, getattr(node, "lineno", 0), message,
            func=self.info.qualname))

    def _unordered_iter(self, it: ast.expr) -> Optional[str]:
        if isinstance(it, (ast.Set, ast.SetComp)):
            return "a set literal"
        if isinstance(it, ast.Call):
            t = _terminal(it.func)
            if t in UNORDERED_CALLS:
                return f"{t}()"
        if isinstance(it, ast.Name):
            if it.id in self.set_names:
                return f"set-typed local {it.id!r}"
        if isinstance(it, ast.Attribute) and \
                isinstance(it.value, ast.Name) and it.value.id == "self" and \
                it.attr in self.info.set_attrs:
            return f"set-typed attribute self.{it.attr}"
        return None

    def _classify_assign(self, stmt):
        """Track set-typed locals and rank-local taint through simple
        ``name = expr`` assignments."""
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
            value = stmt.value
        else:
            return
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if not names:
            return
        is_set = isinstance(value, (ast.Set, ast.SetComp)) or \
            (isinstance(value, ast.Call) and
             _terminal(value.func) in ("set", "frozenset"))
        for n in names:
            if is_set:
                self.set_names.add(n)
            else:
                self.set_names.discard(n)
        src = _expr_has(value, _is_env_read)
        desc = None
        if src is not None:
            desc = "env read"
        else:
            src = _expr_has(value, _time_source)
            if src is not None:
                desc = f"{_terminal(src.func)}()"
        if desc is None:
            for n in names:
                self.taint.pop(n, None)
            return
        how = self.mod.ann.use_agreed(stmt.lineno, "value")
        if how is not None:
            for n in names:
                self.taint.pop(n, None)
            return
        for n in names:
            self.taint[n] = (stmt.lineno, desc)

    # -- statement walk ----------------------------------------------------

    def _visit_block(self, stmts: List[ast.stmt]):
        i = 0
        while i < len(stmts):
            stmt = stmts[i]
            # guard-return: ``if <rank-local>: return`` gates the REST of
            # this block on rank-local state
            if isinstance(stmt, ast.If) and not stmt.orelse and \
                    stmt.body and \
                    isinstance(stmt.body[-1], (ast.Return, ast.Raise,
                                               ast.Continue, ast.Break)):
                desc = self._test_rank_desc(stmt)
                self._visit_stmt(stmt)
                if desc is not None:
                    self.rank_ctx.append(_Ctx(stmt.lineno,
                                              f"guard return on {desc}"))
                    self._visit_block(stmts[i + 1:])
                    self.rank_ctx.pop()
                    return
                i += 1
                continue
            self._visit_stmt(stmt)
            i += 1

    def _test_rank_desc(self, stmt) -> Optional[str]:
        """Rank-local description of an if/while test, honoring an
        agreed annotation on the statement line."""
        desc = _rank_local_test(stmt.test)
        if desc is None:
            return None
        how = self.mod.ann.use_agreed(stmt.lineno, "condition")
        if how is not None:
            return None
        return desc

    def _visit_stmt(self, stmt: ast.stmt):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: conservatively inherits the region (defined —
            # hence later callable — only where the region executes)
            self._visit_block(stmt.body)
            return
        if isinstance(stmt, ast.If):
            self._visit_expr(stmt.test)
            desc = self._test_rank_desc(stmt)
            if desc is not None:
                self.rank_ctx.append(_Ctx(stmt.lineno, desc))
                self._visit_block(stmt.body)
                self._visit_block(stmt.orelse)
                self.rank_ctx.pop()
            else:
                self._visit_block(stmt.body)
                self._visit_block(stmt.orelse)
            return
        if isinstance(stmt, ast.While):
            self._visit_expr(stmt.test)
            desc = self._test_rank_desc(stmt)
            if desc is not None:
                self.rank_ctx.append(_Ctx(stmt.lineno, desc))
                self._visit_block(stmt.body)
                self.rank_ctx.pop()
            else:
                self._visit_block(stmt.body)
            self._visit_block(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._visit_expr(stmt.iter)
            unordered = self._unordered_iter(stmt.iter)
            if unordered is not None and \
                    self.mod.ann.use_agreed(stmt.lineno, "order") is not None:
                unordered = None
            if unordered is not None:
                self.order_ctx.append(_Ctx(stmt.lineno, unordered))
                self._visit_block(stmt.body)
                self.order_ctx.pop()
            else:
                self._visit_block(stmt.body)
            self._visit_block(stmt.orelse)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._visit_expr(item.context_expr)
            self._visit_block(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self._visit_block(stmt.body)
            for h in stmt.handlers:
                self._visit_block(h.body)
            self._visit_block(stmt.orelse)
            self._visit_block(stmt.finalbody)
            return
        if hasattr(ast, "Match") and isinstance(stmt, ast.Match):
            self._visit_expr(stmt.subject)
            for case in stmt.cases:
                if case.guard is not None:
                    self._visit_expr(case.guard)
                self._visit_block(case.body)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            self._classify_assign(stmt)
            if getattr(stmt, "value", None) is not None:
                self._visit_expr(stmt.value)
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._visit_expr(node)

    # -- expression walk ---------------------------------------------------

    def _visit_expr(self, expr: ast.expr):
        if expr is None:
            return
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                # runs later, elsewhere: region context does not apply,
                # but an issuing call inside still belongs to this def's
                # region (it is only *created* where the region runs) —
                # keep walking for call checks with current context.
                stack.extend(ast.iter_child_nodes(node))
                continue
            if isinstance(node, ast.Call):
                self._check_call(node)
            stack.extend(ast.iter_child_nodes(node))

    def _resolve_token(self, call: ast.Call, t: str) -> str:
        cm = self.info.cls_methods
        if cm and isinstance(call.func, ast.Attribute) and \
                isinstance(call.func.value, ast.Name) and \
                call.func.value.id == "self" and t in cm:
            return f"{self.mod.rel}::{cm[t]}.{t}"
        return t

    def _check_call(self, call: ast.Call):
        t = _terminal(call.func)
        if t is None:
            return
        ref = _invoked_seed(call)
        if ref is not None and \
                self._resolve_token(call, t) not in self.issuing:
            t = ref
        if self._resolve_token(call, t) in self.issuing:
            if self.rank_ctx:
                ctx = self.rank_ctx[-1]
                self._emit(
                    "rank-gated-collective", call,
                    f"{self.info.qualname}: collective-issuing call {t}() "
                    f"is gated on rank-local state ({ctx.desc}, line "
                    f"{ctx.line}) — ranks that skip it deadlock the ones "
                    f"that enter")
            if self.order_ctx:
                ctx = self.order_ctx[-1]
                self._emit(
                    "nondeterministic-submission-order", call,
                    f"{self.info.qualname}: collective-issuing call {t}() "
                    f"inside iteration over {ctx.desc} (line {ctx.line}) — "
                    f"submission order differs across ranks/runs, breaking "
                    f"the per-name seq lockstep")
        if t in DECISION_SINKS:
            self._check_selection_inputs(call, t)

    def _check_selection_inputs(self, call: ast.Call, sink: str):
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            bad: Optional[str] = None
            if _expr_has(arg, _is_env_read) is not None:
                bad = "an env read"
            elif _expr_has(arg, _time_source) is not None:
                bad = "a local time measurement"
            else:
                name_hit = _expr_has(
                    arg, lambda n: isinstance(n, ast.Name) and
                    n.id in self.taint)
                if name_hit is not None:
                    line, desc = self.taint[name_hit.id]
                    bad = f"{name_hit.id!r} ({desc} at line {line})"
            if bad is None:
                continue
            if self.mod.ann.use_agreed(call.lineno, "selection") is not None:
                continue
            self._emit(
                "unagreed-selection-input", call,
                f"{self.info.qualname}: {bad} flows into {sink}() — a "
                f"decision that must be collectively identical — without "
                f"a 'divcheck: agreed[how]' exchange point")


def _check_capture_impure(mod: _Module, info: _DefInfo,
                          findings: List[Finding]):
    """Env reads / host I/O inside a step-path def (init-phase names
    exempt: resolving knobs at construction is the sanctioned pattern;
    the typed env helpers themselves are the registry parsers — their
    *callers* on the step path are the findings)."""
    if info.name in INIT_PHASE_NAMES or info.name in ENV_READ_FUNCS:
        return
    for node in ast.walk(info.node):
        if _is_env_read(node):
            findings.append(Finding(
                "capture-impure-read", mod.rel,
                getattr(node, "lineno", 0),
                f"{info.qualname}: env read on the step path (reachable "
                f"from the dispatch-path roots) — knobs must resolve at "
                f"init or re-arm replay (the algo_sig pattern)",
                func=info.qualname))
        elif isinstance(node, ast.Call):
            t = _terminal(node.func)
            if t in HOST_IO_CALLS:
                findings.append(Finding(
                    "capture-impure-read", mod.rel, node.lineno,
                    f"{info.qualname}: host-I/O call {t}() on the step "
                    f"path — host state read mid-step diverges captured "
                    f"programs from the stream they were armed from",
                    func=info.qualname))


# ---------------------------------------------------------------------------
# suppression / agreed accounting
# ---------------------------------------------------------------------------

def _apply_annotations(raw: List[Finding], modules: List[_Module]
                       ) -> Tuple[List[Finding], List[Finding],
                                  List[AgreedSite]]:
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
                f"every 'divcheck: ignore' needs [reason]", func=f.func))
            continue
        f.suppressed = True
        f.reason = reason
        suppressions.append(f)
    agreed_sites: List[AgreedSite] = []
    for mod in modules:
        ann = mod.ann
        for line, (how, _standalone) in sorted(ann.ignores.items()):
            if (mod.rel, line) not in used:
                findings.append(Finding(
                    "stale-suppression", mod.rel, line,
                    f"'divcheck: ignore[{how}]' suppresses nothing — "
                    f"remove it (the code it excused has changed)"))
        for line, (how, _standalone) in sorted(ann.agreed.items()):
            what = ann.agreed_used.get(line)
            if what is None:
                findings.append(Finding(
                    "stale-agreed", mod.rel, line,
                    f"'divcheck: agreed[{how}]' marks nothing rank-local "
                    f"— remove it (the condition/value it blessed has "
                    f"changed)"))
            elif not how:
                findings.append(Finding(
                    "bad-annotation", mod.rel, line,
                    "'divcheck: agreed' needs [how]: document the "
                    "exchange that makes this collectively identical"))
            else:
                agreed_sites.append(AgreedSite(mod.rel, line, how, what))
    return findings, suppressions, agreed_sites


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
    issuing = _issuing_tokens(live)
    step_defs = _step_path_defs(live)
    for mod in live:
        for info in mod.defs:
            rep.defs += 1
            _DefChecker(mod, info, issuing, raw).run()
            if id(info) in step_defs:
                rep.step_path_defs += 1
                _check_capture_impure(mod, info, raw)
    rep.issuing_defs = _issuing_def_count(live, issuing)
    findings, suppressions, agreed = _apply_annotations(raw, modules)
    rep.findings = sorted(findings, key=lambda f: (f.file, f.line, f.check))
    rep.suppressions = suppressions
    rep.agreed = agreed
    return rep


def check_paths(paths: List[str], root: Optional[str] = None) -> Report:
    """Check every ``.py`` file under ``paths`` as ONE program: the
    collective-issuing set and the step-path footprint resolve across
    all files of the run (a helper defined in ops/ and rank-gated in
    elastic/ is still a finding)."""
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
        description="SPMD divergence & dispatch-determinism checker "
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
        for a in rep.agreed:
            print(f"{a.file}:{a.line}: agreed[{a.what}] — {a.how}")
        print(f"{rep.files} file(s), {rep.defs} def(s), "
              f"{rep.issuing_defs} collective-issuing, "
              f"{rep.step_path_defs} on the step path; "
              f"{len(rep.findings)} finding(s), "
              f"{len(rep.suppressions)} suppression(s), "
              f"{len(rep.agreed)} agreed site(s)")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
