"""The port's unified analysis driver (``python -m
horovod_tpu_torch.analysis.check``), mirroring tests/test_check.py: each
of the eight lints clean on the live tree, the registered lints, the
CLI's JSON and GitHub forms, ``--only``, ``--changed``, the single-lint
entry points, and every suppression, agreed site and seam explained."""

import json
import os
import subprocess
import sys

import pytest

from horovod_tpu_torch.analysis import check

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LINTS = ("lockcheck", "divcheck", "knobs", "metrics", "faults",
         "trace_schema", "ckpt_manifest", "errflow")


@pytest.fixture(scope="module")
def report():
    """The full driver through its CLI entry, once for the module: the
    JSON report every live-tree test below reads."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check.main(["--format=json"])
    return rc, json.loads(buf.getvalue())


@pytest.mark.parametrize("lint", LINTS)
def test_lint_passes(report, lint):
    res = report[1]["checks"][lint]
    assert res["ok"], "\n".join(res["errors"])
    assert res["errors"] == []


def test_all_lints_registered():
    assert tuple(check.CHECKS) == LINTS


def test_cli_json_report(report):
    rc, rep = report
    assert rc == 0
    assert rep["ok"] is True
    assert set(rep["checks"]) == set(LINTS)
    for name, res in rep["checks"].items():
        assert res["ok"] and res["errors"] == [], name


def _bad_reason(text) -> bool:
    return not text or not text.strip() or text.strip().lower() == "todo"


@pytest.mark.parametrize("lint", ("lockcheck", "divcheck", "errflow"))
def test_suppressions_all_explained(report, lint):
    """Zero unexplained ``<lint>: ignore`` suppressions under
    horovod_tpu_torch/ — the JSON report carries each with its reason,
    so the audit needs nothing but the report."""
    sups = report[1]["checks"][lint]["stats"]["suppressions"]
    assert sups, "the annotated tree is expected to carry suppressions"
    for s in sups:
        assert not _bad_reason(s["reason"]), s


def test_divcheck_agreed_sites_all_documented(report):
    agreed = report[1]["checks"]["divcheck"]["stats"]["agreed_sites"]
    assert agreed, "the annotated tree is expected to carry agreed sites"
    for a in agreed:
        assert not _bad_reason(a["how"]), a


def test_errflow_seams_all_documented(report):
    seams = report[1]["checks"]["errflow"]["stats"]["seams"]
    assert seams, "the live tree is expected to carry declared seams"
    for s in seams:
        assert not _bad_reason(s["how"]), s


def test_faults_does_not_double_report_site_drift(report):
    """errflow owns failpoint call-site drift; the faults lint surfaces
    sites only as stats."""
    from horovod_tpu_torch.analysis import faultcheck
    errs = faultcheck.validate_call_sites(
        {"ok.name": "declared"}, [("x.py", 3, "engine.bogus")])
    assert errs and "engine.bogus" in errs[0]   # the rule still exists...
    stats = report[1]["checks"]["faults"]["stats"]
    assert stats["site_drift"] == []            # ...but a clean run
    assert report[1]["checks"]["faults"]["ok"]  # demotes it to a stat


def test_changed_mode_runs_pure_ast_lints():
    """``--changed`` selects the pure-AST subset and filters file-scoped
    findings to the changed set; the scan stats still prove the whole
    package was analyzed."""
    rep = check.run_checks(changed={"horovod_tpu_torch/faults.py"})
    assert set(rep["checks"]) == set(check.CHANGED_MODE_LINTS)
    assert "errflow" in rep["checks"]
    for lint in ("lockcheck", "divcheck", "errflow"):
        res = rep["checks"][lint]
        assert res["ok"] and res["errors"] == []
        assert res["stats"]["files"] >= 60     # whole package, not subset
        assert res["stats"]["changed_files"] == 1


def test_changed_mode_filters_findings_to_changed_files(monkeypatch):
    """A finding outside the changed set is filtered; inside, it is kept
    — proven on a synthetic finding in place of the package scan."""
    from horovod_tpu_torch.analysis import divcheck

    def with_finding(root):
        return divcheck.Report(findings=[divcheck.Finding(
            "rank-gated-collective", "horovod_tpu_torch/faults.py", 7,
            "synthetic")], files=90)

    monkeypatch.setattr(divcheck, "check_package", with_finding)
    errors, stats = check.run_divcheck(changed=set())
    assert errors == [] and stats["changed_files"] == 0
    errors, stats = check.run_divcheck(
        changed={"horovod_tpu_torch/faults.py"})
    assert errors == ["horovod_tpu_torch/faults.py:7: "
                      "[rank-gated-collective] synthetic"]
    assert stats["changed_files"] == 1


def test_changed_files_names_untracked_and_edited_paths():
    """``changed_files`` reads git: commits since the base, edits vs HEAD
    and untracked files, as repo-relative paths."""
    files = check.changed_files("HEAD")
    assert all(not os.path.isabs(f) for f in files)


def test_github_format_emits_error_annotations(capsys):
    rep = {"ok": False, "checks": {"divcheck": {
        "ok": False, "stats": {},
        "errors": ["horovod_tpu_torch/core/engine.py:42: "
                   "[rank-gated-collective] boom",
                   "lint crashed: something with no location"]}}}
    check._print_github(rep)
    out = capsys.readouterr().out
    assert "::error file=horovod_tpu_torch/core/engine.py,line=42::" in out
    assert "[divcheck]" in out
    assert "::error::[divcheck] lint crashed" in out


def test_cli_only_subset_and_unknown(capsys):
    rc = check.main(["--only", "knobs,metrics"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "knobs" in out and "lockcheck" not in out
    rc = check.main(["--only", "bogus"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "unknown lint" in err


def test_cli_list(capsys):
    assert check.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list(LINTS)


def test_a_failing_lint_fails_the_driver(monkeypatch, capsys):
    monkeypatch.setitem(check.CHECKS, "metrics",
                        lambda: (["x.py:1: seeded"], {}))
    assert check.main(["--only", "metrics"]) == 1
    assert "seeded" in capsys.readouterr().out


def test_single_lint_entry_points_still_work():
    """``python -m horovod_tpu_torch.analysis.<lint>`` for the three
    file-scoped analyzers, and the driver itself, as real subprocesses
    (launched together: each pays its own interpreter start)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {m: subprocess.Popen(
        [sys.executable, "-m", f"horovod_tpu_torch.analysis.{m}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
        for m in ("lockcheck", "divcheck", "errflow")}
    procs["check"] = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.check",
         "--only", "metrics,faults,trace_schema", "--format=github"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    for m, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{m}: {out}{err}"
    # the analyzers never import the reference or jax
    code = ("import sys, horovod_tpu_torch.analysis.check as c\n"
            "import horovod_tpu_torch.analysis.lockcheck, "
            "horovod_tpu_torch.analysis.divcheck, "
            "horovod_tpu_torch.analysis.errflow, "
            "horovod_tpu_torch.analysis.traceschema\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'horovod_tpu', 'tools')]\n"
            "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "", res
