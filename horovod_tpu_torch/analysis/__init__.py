"""The port's static-analysis suite (ROADMAP A18).

The port is a background-thread system like the reference: the engine,
step replay, the stall inspector and collective watchdog, the checkpoint
writer, the KV replicas, the slice aggregator, the elastic driver and its
standby, all sharing mutable state through ``threading.Lock``-guarded
attributes, and all relying on every rank submitting the same collectives
in the same order. These passes are the reference's
(``horovod_tpu/analysis/``), pointed at ``horovod_tpu_torch/`` and taught
PyTorch's vocabulary:

- :mod:`.lockcheck` — a Clang Thread-Safety-Analysis-style GUARDED_BY
  checker: classes declare which attributes a lock guards (``_GUARDED_BY``
  class attribute or ``# guarded_by:`` trailing comments), and an AST pass
  reports every off-lock access, lock-order inversion, blocking call made
  under a lock (``torch.cuda.synchronize``, a store's ``wait``, a
  ``Work.wait()`` among them), and thread target touching unannotated
  shared state. Suppressions are inline (``# lockcheck: ignore[reason]``),
  counted, and must carry a reason.
- :mod:`.divcheck` — the SPMD divergence & dispatch-determinism checker:
  no collective (an engine funnel or a ``torch.distributed`` call,
  ``new_group`` and point-to-point hops included) gated on rank-local
  state, none submitted in unordered iteration, no rank-local value
  steering a collectively-identical decision without a
  ``# divcheck: agreed[how]`` exchange point, and no env/host reads on the
  step path after engine init (a CUDA-graph replay must not diverge from
  the eager stream it was armed from).
- :mod:`.knobcheck` — the configuration-knob registry lint: every
  ``HOROVOD_*`` environment variable read under ``horovod_tpu_torch/`` is
  declared in :data:`horovod_tpu_torch.common.knobs.KNOB_SPECS` (and every
  declared knob is read), defaults agree with their types and choices,
  choice knobs are read through the registry parser, and the declared,
  ``OWED`` and ``NOT_OWED`` tables are disjoint.
- :mod:`.errflow` — the exception-propagation & resource-lifecycle
  analyzer: no broad ``except``, and no ``except`` of
  ``HorovodInternalError`` or of ``torch.distributed``'s ``DistError``
  family, may swallow a recovery-class error on the
  elastic/dispatch/watchdog path; raw transport calls carry deadlines or
  ride ``retrying()``; resources are released on the exception edge;
  declared error seams stay observable; and ``FAULT_SPECS`` never drifts
  from the ``failpoint()`` call sites.
- :mod:`.faultcheck` / :mod:`.metriccheck` — the failpoint- and
  metric-namespace lints.
- :mod:`.traceschema` — the merged-trace schema rules the trace-schema
  self-check holds the port's recorder to.

All are pure-stdlib AST passes (no runtime import of the modules they
scan; the name lints import only the registry tables they validate).
:mod:`.check` is the unified driver that runs them next to the
trace-schema and checkpoint-manifest self-checks as one command with one
machine-readable report: ``python -m horovod_tpu_torch.analysis.check``.
The annotation grammar is the reference's exactly; its account is
``docs/static_analysis.md``.
"""

import ast
import io
import os
import tokenize
from typing import Dict, Iterator, Optional, Tuple


def iter_py_files(root: str) -> Iterator[str]:
    """Every ``.py`` file under ``root`` (sorted, ``__pycache__``
    skipped) — the one traversal every analysis pass shares, so
    encoding/ordering semantics can't drift between lints."""
    for dirpath, _dirs, names in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def comments_by_line(source: str) -> Dict[int, Tuple[str, bool]]:
    """line -> (comment text, standalone) for one module's source —
    the one comment harvester lockcheck and divcheck share, so the
    annotation grammars cannot drift. ``standalone`` means the comment
    is the only thing on its line: only those may also cover the line
    directly BELOW them (a trailing comment must never bleed onto the
    next line's findings)."""
    out: Dict[int, Tuple[str, bool]] = {}
    lines = source.splitlines()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                lineno = tok.start[0]
                text = lines[lineno - 1] if lineno <= len(lines) else ""
                standalone = text.lstrip().startswith("#")
                out[lineno] = (tok.string.lstrip("#").strip(), standalone)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def parse_tag(comment: str, tag: str) -> Optional[str]:
    """``<tag>[payload]`` -> payload (``''`` when the brackets are
    missing or empty; ``None`` when the tag is absent) — the shared
    grammar behind ``lockcheck: ignore[...]``, ``divcheck: ignore[...]``
    and ``divcheck: agreed[...]``."""
    idx = comment.find(tag)
    if idx < 0:
        return None
    rest = comment[idx + len(tag):].strip()
    if rest.startswith("[") and "]" in rest:
        return rest[1:rest.index("]")].strip()
    return ""


def is_environ(node: ast.expr) -> bool:
    """``os.environ`` / bare ``environ`` / ``_os.environ`` — the shared
    receiver predicate behind every env-read scan."""
    return (isinstance(node, ast.Attribute) and node.attr == "environ") or \
        (isinstance(node, ast.Name) and node.id == "environ")
