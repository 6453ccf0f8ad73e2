"""Unified static-analysis driver of the port: every lint, one command,
one report (the reference's ``tools/check.py``, over
``horovod_tpu_torch/``).

Runs the eight passes in the reference's order:

- ``lockcheck``     — GUARDED_BY lock-discipline checker (:mod:`.lockcheck`)
- ``divcheck``      — SPMD divergence & dispatch-determinism checker:
                      rank-gated collectives, nondeterministic
                      submission order, unagreed selection inputs,
                      capture-impure reads (:mod:`.divcheck`)
- ``knobs``         — configuration-knob registry lint: env reads vs
                      KNOB_SPECS, declared choices/types vs defaults,
                      raw reads of choice knobs, the KNOB_SPECS / OWED /
                      NOT_OWED partition (:mod:`.knobcheck`)
- ``metrics``       — METRIC_SPECS namespace lint (:mod:`.metriccheck`)
- ``faults``        — FAULT_SPECS + failpoint call-site lint
                      (:mod:`.faultcheck`)
- ``trace_schema``  — trace-schema contract self-check: a synthetic
                      2-rank trace from the port's ``TraceRecorder`` and
                      ``merge_segments`` must pass :mod:`.traceschema`'s
                      ``check_events``, and a deliberately-broken event
                      list must fail it
- ``ckpt_manifest`` — checkpoint-manifest contract self-check: a live
                      2-rank generation of the port's CheckpointManager
                      (CPU tensors) must validate, and the commit barrier
                      must reject mismatched checksums / stale
                      world_versions / partial generations
- ``errflow``       — exception-propagation & resource-lifecycle
                      analyzer (:mod:`.errflow`)

Usage (from the repo root)::

    python -m horovod_tpu_torch.analysis.check                # all lints
    python -m horovod_tpu_torch.analysis.check --format=json  # the report
    python -m horovod_tpu_torch.analysis.check --format=github
    python -m horovod_tpu_torch.analysis.check --only lockcheck,knobs
    python -m horovod_tpu_torch.analysis.check --changed      # dev loop
    python -m horovod_tpu_torch.analysis.check --list

Exit code 0 iff every selected lint passed. The JSON report carries, per
lint, ``ok`` / ``errors`` / ``stats`` — and for lockcheck, divcheck and
errflow the full suppression (and agreed-site, and seam) lists with their
reasons, so "zero unexplained suppressions" is auditable from the report
alone. tests/test_torch_check.py runs it in tier-1 (``pytest -m lint``).

``--changed`` is the dev-loop fast mode: it runs only the pure-AST lints
(lockcheck, divcheck, knobs, errflow), scanning the WHOLE package so the
cross-file passes stay sound, but filtering the lockcheck/divcheck/errflow
findings to files changed vs ``main`` (git diff --name-only + working-tree
changes). The full scan stays the tier-1 default.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Callable, Dict, List, Optional, Tuple

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG_ROOT)


def _file_scoped(report, changed: Optional[set], extra: dict
                 ) -> Tuple[List[str], dict]:
    findings = report.findings
    if changed is not None:
        findings = [f for f in findings if f.file in changed]
    stats = {"files": report.files, **extra,
             "suppressions": [s.to_dict() for s in report.suppressions]}
    if changed is not None:
        stats["changed_files"] = len(changed)
    return [str(f) for f in findings], stats


def run_lockcheck(changed: Optional[set] = None) -> Tuple[List[str], dict]:
    from . import lockcheck
    rep = lockcheck.check_package(PKG_ROOT)
    return _file_scoped(rep, changed, {
        "classes_annotated": rep.classes_annotated,
        "guarded_attrs": rep.guarded_attrs})


def run_divcheck(changed: Optional[set] = None) -> Tuple[List[str], dict]:
    """SPMD divergence checker. The whole package is always scanned — the
    collective-issuing set and step-path footprint are cross-file — but
    ``--changed`` filters the *findings* to the files being worked on."""
    from . import divcheck
    rep = divcheck.check_package(PKG_ROOT)
    errors, stats = _file_scoped(rep, changed, {
        "defs": rep.defs, "issuing_defs": rep.issuing_defs,
        "step_path_defs": rep.step_path_defs})
    stats["agreed_sites"] = [a.to_dict() for a in rep.agreed]
    return errors, stats


def run_knobs() -> Tuple[List[str], dict]:
    from . import knobcheck
    return knobcheck.run(PKG_ROOT)


def run_metrics() -> Tuple[List[str], dict]:
    from . import metriccheck
    return metriccheck.run(PKG_ROOT)


def run_faults() -> Tuple[List[str], dict]:
    from . import faultcheck
    return faultcheck.run(PKG_ROOT)


def run_errflow(changed: Optional[set] = None) -> Tuple[List[str], dict]:
    """Exception-propagation & resource-lifecycle analyzer. The whole
    package is always scanned — the recovery footprint and the failpoint
    registry are cross-file — but ``--changed`` filters the *findings* to
    the files being worked on."""
    from . import errflow
    rep = errflow.check_package(PKG_ROOT)
    errors, stats = _file_scoped(rep, changed, {
        "defs": rep.defs, "recovery_defs": rep.recovery_defs,
        "handlers": rep.handlers,
        "failpoints_declared": rep.failpoints_declared,
        "failpoint_sites": rep.failpoint_sites})
    stats["seams"] = [s.to_dict() for s in rep.seams]
    return errors, stats


def run_trace_schema() -> Tuple[List[str], dict]:
    """Trace-schema contract self-check: events produced by the port's
    live recorder/merger pass the schema rules, and the rules still
    reject each known violation class (so a green run can't mean a gutted
    checker)."""
    from .. import trace as live_trace
    from . import traceschema
    errors: List[str] = []
    if live_trace.CORR_SEP != traceschema.CORR_SEP:
        errors.append(f"traceschema.CORR_SEP ({traceschema.CORR_SEP!r}) "
                      f"drifted from horovod_tpu_torch.trace.CORR_SEP "
                      f"({live_trace.CORR_SEP!r})")
    segments = {}
    for rank in (0, 1):
        rec = live_trace.TraceRecorder(rank=rank, capacity=64)
        rec.add_beacon(0.0, 1000.0, 0.001)
        for _ in range(2):
            rec.record_step(begin=True)
            rec.record_enqueue("grad", "allreduce", 1024, 0)
            rec.record_dispatch("grad", "XLA_DISPATCH", 0.001)
            rec.record_done("grad")
            rec.record_step(begin=False)
        segments[rank] = rec.segment()
    events = live_trace.merge_segments(segments)
    for e in traceschema.check_events(events):
        errors.append(f"clean merged trace failed the schema lint: {e}")
    bad = [{"ph": "E", "ts": 1.0, "pid": 0, "tid": 3},
           {"ph": "B", "ts": 2.0, "pid": 0, "tid": 4,
            "args": {"corr": "missing-separators"}}]
    bad_errs = traceschema.check_events(bad)
    if not any("dangling E" in e for e in bad_errs):
        errors.append("schema lint no longer detects dangling E events")
    if not any("malformed correlation id" in e for e in bad_errs):
        errors.append("schema lint no longer detects malformed "
                      "correlation ids")
    if not any("unclosed B" in e for e in bad_errs):
        errors.append("schema lint no longer detects unclosed B spans")
    return errors, {"merged_events": len(events),
                    "violation_classes_proven": 3}


def run_ckpt_manifest() -> Tuple[List[str], dict]:
    """Checkpoint-manifest contract self-check: a LIVE generation written
    by two CheckpointManager ranks (CPU tensors) must round-trip through
    the schema validator and the commit barrier — and the barrier must
    still reject each known violation class (mismatched shard checksum,
    stale world_version, missing rank), so a green run can't mean a
    gutted validator."""
    import copy
    import tempfile

    import torch

    from ..checkpoint import (CheckpointManager, generation_complete,
                              validate_manifest)
    errors: List[str] = []
    tree = {"w": torch.arange(40, dtype=torch.float32),
            "b": torch.ones(3, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        mgrs = [CheckpointManager(d, rank=r, world_size=2, redundancy=1)
                for r in range(2)]
        try:
            for m in mgrs:
                m.snapshot(tree, step=1)
            for m in mgrs:
                if not m.wait_idle(60):
                    errors.append("checkpoint write did not finish")
            manifests = mgrs[0]._disk_manifests(1)
        finally:
            for m in mgrs:
                m.close(flush=False)
    if sorted(manifests) != [0, 1]:
        return errors + [f"round-trip produced manifests for ranks "
                         f"{sorted(manifests)}, expected [0, 1]"], {}
    for r, m in manifests.items():
        # re-parse through JSON: the validator must accept exactly what
        # lands on disk/KV, not the in-memory dict
        for e in validate_manifest(json.loads(json.dumps(m))):
            errors.append(f"live manifest rank {r} failed schema: {e}")
    ok, errs = generation_complete(manifests)
    if not ok:
        errors += [f"live generation failed the commit barrier: {e}"
                   for e in errs]
    # violation class 1: corrupted shard checksum
    bad = copy.deepcopy(manifests)
    bad[1]["shard_checksums"]["1"] = "0" * 64
    ok, errs = generation_complete(bad)
    if ok or not any("checksum mismatch" in e for e in errs):
        errors.append("barrier no longer rejects a mismatched shard "
                      "checksum")
    # violation class 2: stale world_version (generation spans a reset)
    bad = copy.deepcopy(manifests)
    bad[1]["world_version"] += 1
    ok, errs = generation_complete(bad)
    if ok or not any("stale world_version" in e for e in errs):
        errors.append("barrier no longer rejects a stale world_version")
    # violation class 3: partial generation (a rank never committed)
    ok, errs = generation_complete({0: manifests[0]})
    if ok or not any("missing manifests" in e for e in errs):
        errors.append("barrier no longer rejects a partial generation")
    return errors, {"manifests": len(manifests),
                    "violation_classes_proven": 3}


CHECKS: Dict[str, Callable[[], Tuple[List[str], dict]]] = {
    "lockcheck": run_lockcheck,
    "divcheck": run_divcheck,
    "knobs": run_knobs,
    "metrics": run_metrics,
    "faults": run_faults,
    "trace_schema": run_trace_schema,
    "ckpt_manifest": run_ckpt_manifest,
    "errflow": run_errflow,
}

# lints whose findings carry file:line and can be filtered to a changed
# subset; also the pure-AST set --changed runs (knobs is pure-AST too
# but registry-global: dead-knob detection needs the whole package either
# way, and it is cheap)
FILE_SCOPED = ("lockcheck", "divcheck", "errflow")
CHANGED_MODE_LINTS = ("lockcheck", "divcheck", "knobs", "errflow")


def changed_files(base: str = "main") -> set:
    """Repo-relative paths this branch is working on: commits since the
    merge-base with ``base`` (``base...HEAD``), plus staged/working-tree
    edits vs HEAD, plus untracked files — as the lint reports spell them
    (relative to the repo root)."""
    import subprocess
    out: set = set()
    for args in (["git", "diff", "--name-only", f"{base}...HEAD"],
                 ["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(args, cwd=REPO, capture_output=True,
                                 text=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            continue
        if res.returncode == 0:
            out.update(line.strip() for line in res.stdout.splitlines()
                       if line.strip())
    return out


def run_checks(only: Optional[List[str]] = None,
               changed: Optional[set] = None) -> dict:
    """Run the selected lints; returns the machine-readable report dict
    ``{"ok": bool, "checks": {name: {"ok", "errors", "stats"}}}``.
    ``changed`` (a repo-relative path set) switches the file-scoped
    lints to filtered findings — the ``--changed`` dev loop."""
    if changed is not None and not only:
        names = list(CHANGED_MODE_LINTS)
    else:
        names = list(CHECKS) if not only else only
    unknown = [n for n in names if n not in CHECKS]
    if unknown:
        raise ValueError(f"unknown lint(s): {', '.join(unknown)} "
                         f"(valid: {', '.join(CHECKS)})")
    report: dict = {"ok": True, "checks": {}}
    for name in names:
        try:
            if changed is not None and name in FILE_SCOPED:
                errors, stats = CHECKS[name](changed=changed)
            else:
                errors, stats = CHECKS[name]()
        except Exception as e:  # a crashed lint is a failed lint, loudly
            errors, stats = [f"lint crashed: {type(e).__name__}: {e}"], {}
        report["checks"][name] = {"ok": not errors, "errors": errors,
                                  "stats": stats}
        if errors:
            report["ok"] = False
    return report


def _print_text(report: dict):
    for name, res in report["checks"].items():
        mark = "OK  " if res["ok"] else "FAIL"
        stats = res["stats"]
        summary = ", ".join(
            f"{k}={v}" for k, v in stats.items()
            if not isinstance(v, (list, dict)))
        print(f"[{mark}] {name}" + (f" ({summary})" if summary else ""))
        for e in res["errors"]:
            print(f"       - {e}")
        for s in stats.get("suppressions", []):
            print(f"       suppressed [{s['check']}] {s['file']}:"
                  f"{s['line']} — {s['reason']}")
        for a in stats.get("agreed_sites", []):
            print(f"       agreed[{a['what']}] {a['file']}:{a['line']} "
                  f"— {a['how']}")
        for s in stats.get("seams", []):
            print(f"       seam {s['file']}:{s['line']} {s['func']} "
                  f"— {s['how']}")
    n_fail = sum(1 for r in report["checks"].values() if not r["ok"])
    total = len(report["checks"])
    print(f"{total - n_fail}/{total} lints passed")


_LOC_RE = re.compile(r"^([\w./-]+\.py):(\d+):\s*(.*)$", re.S)


def _gh_escape(msg: str) -> str:
    # workflow-command message encoding: % first, then the line breaks
    return (msg.replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A"))


def _print_github(report: dict):
    """GitHub Actions workflow-command emitter: one ``::error`` per
    finding, annotated onto the file/line when the error string carries
    a ``path:line:`` prefix."""
    for name, res in report["checks"].items():
        for e in res["errors"]:
            m = _LOC_RE.match(e)
            if m:
                msg = _gh_escape(f"[{name}] {m.group(3)}")
                print(f"::error file={m.group(1)},line={m.group(2)}::{msg}")
            else:
                print("::error::" + _gh_escape(f"[{name}] {e}"))
    n_fail = sum(1 for r in report["checks"].values() if not r["ok"])
    total = len(report["checks"])
    print(f"{total - n_fail}/{total} lints passed")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="The port's unified static-analysis driver "
                    "(docs/static_analysis.md for the rules)")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of lints to run")
    ap.add_argument("--changed", action="store_true",
                    help="fast dev loop: pure-AST lints only, findings "
                         "filtered to files changed vs --base")
    ap.add_argument("--base", default="main",
                    help="git ref --changed diffs against (default: main)")
    ap.add_argument("--list", action="store_true",
                    help="list available lints and exit")
    args = ap.parse_args(argv)
    if args.list:
        for name in CHECKS:
            print(name)
        return 0
    only = [s.strip() for s in args.only.split(",")] if args.only else None
    changed = changed_files(args.base) if args.changed else None
    try:
        report = run_checks(only, changed=changed)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(report, indent=2))
    elif args.format == "github":
        _print_github(report)
    else:
        if changed is not None:
            touched = sorted(f for f in changed if f.endswith(".py"))
            print(f"[--changed] {len(touched)} changed .py file(s) vs "
                  f"{args.base}; the full scan remains the tier-1 default")
        _print_text(report)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
