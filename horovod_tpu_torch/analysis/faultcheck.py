"""The port's failpoint-namespace lint (the reference's
``horovod_tpu/analysis/faultcheck.py``, over the port's registry).

One rule class: every entry in
:data:`horovod_tpu_torch.faults.FAULT_SPECS` must match the fault name regex
and carry a non-empty help string (``test.*`` names are reserved for
suites and must not appear in the table).

The *call sites* — an undeclared/computed name at a ``failpoint()``
call, or a declared name with no call site left — are errflow's
``failpoint-drift`` finding class (:mod:`.errflow` subsumes the
call-site half of this lint, both directions); here they are surfaced
as stats, not errors, so the two lints never double-report a drift.
The call-site scan is AST-based (docstring examples never match) and is
kept exported for single-rule use.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from . import iter_py_files

# must match horovod_tpu_torch.faults.NAME_RE (asserted by run()
# against the live import; redeclared here so the scan itself stays
# importable without the runtime package)
NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")


def validate_specs(specs: Dict[str, str]) -> List[str]:
    """Return a list of error strings; empty means the table is clean."""
    errors = []
    for name, help_str in sorted(specs.items()):
        if not NAME_RE.match(name):
            errors.append(f"{name}: does not match {NAME_RE.pattern}")
        if name.startswith("test."):
            errors.append(f"{name}: the test. prefix is reserved for "
                          f"suite-local failpoints")
        if not isinstance(help_str, str) or not help_str.strip():
            errors.append(f"{name}: missing help string")
    return errors


def scan_call_sites(pkg_root: str) -> List[Tuple[str, int, Optional[str]]]:
    """Every real ``failpoint(...)`` call under ``pkg_root``:
    (relpath, lineno, literal name or None for a computed one). Pure
    AST — docstring examples never match, so no file is special-cased."""
    sites: List[Tuple[str, int, Optional[str]]] = []
    for path in iter_py_files(pkg_root):
        rel = os.path.relpath(path, pkg_root)
        with open(path, encoding="utf-8", errors="replace") as f:
            try:
                tree = ast.parse(f.read())
            except SyntaxError:
                continue  # the AST lints report parse errors themselves
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None)
            if name != "failpoint":
                continue
            arg = node.args[0] if node.args else None
            lit = arg.value if isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str) else None
            sites.append((rel, node.lineno, lit))
    return sites


def validate_call_sites(specs: Dict[str, str],
                        sites: List[Tuple[str, int, Optional[str]]]
                        ) -> List[str]:
    errors = []
    for rel, lineno, name in sites:
        if name is None:
            errors.append(
                f"{rel}:{lineno}: failpoint() name must be a string "
                f"literal — a computed name cannot be linted against "
                f"FAULT_SPECS")
        elif name not in specs:
            errors.append(
                f"{rel}:{lineno}: failpoint({name!r}) is not declared in "
                f"horovod_tpu_torch.faults.FAULT_SPECS")
    return errors


def run(pkg_root: Optional[str] = None) -> Tuple[List[str], dict]:
    """The full lint: (errors, stats) — the shared report shape all
    eight lints of ``analysis/check.py`` use."""
    if pkg_root is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from ..faults import FAULT_SPECS
    from ..faults import NAME_RE as _live_re
    errors: List[str] = []
    if _live_re.pattern != NAME_RE.pattern:
        errors.append(
            f"faultcheck.NAME_RE ({NAME_RE.pattern}) drifted from "
            f"horovod_tpu_torch.faults.NAME_RE ({_live_re.pattern})")
    errors += validate_specs(FAULT_SPECS)
    sites = scan_call_sites(pkg_root)
    if not sites:
        errors.append("no failpoint call sites found under horovod_tpu_torch/ "
                      "— the scan is broken")
    placed = {name for _, _, name in sites if name}
    # call-site drift is errflow's failpoint-drift finding (the single
    # owner — one violation, one red lint); surfaced here as stats only
    stats = {"declared": len(FAULT_SPECS), "call_sites": len(sites),
             "site_drift": validate_call_sites(FAULT_SPECS, sites),
             "unplaced": sorted(set(FAULT_SPECS) - placed)}
    return errors, stats
