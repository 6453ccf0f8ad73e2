"""The port's configuration-knob registry lint: every ``HOROVOD_*``
environment variable read under ``horovod_tpu_torch/`` must be declared in
:data:`horovod_tpu_torch.common.knobs.KNOB_SPECS`, every declared knob must
be read somewhere (or be an ``export`` the launcher only writes), declared
defaults must agree with their types and choices, and declared ``choice``
knobs must be read through the registry parser (``common/env.py``'s
``_get_choice``), never re-parsed at the read site. The rules are the
reference's lint (``horovod_tpu/analysis/knobcheck.py``).

One rule is the port's own: the declared knobs, :data:`OWED` (a reference
knob a ROADMAP item will port) and :data:`NOT_OWED` (a reference knob with
no meaning on CUDA) are pairwise disjoint, every ``OWED`` entry names a
ROADMAP item and every ``NOT_OWED`` entry gives a reason. A knob the
launcher writes for its workers but no module reads yet (``HOROVOD_AUTOTUNE``)
stays ``OWED`` and is not dead: the dead-knob rule covers declared knobs
only. The lint never reads the reference; that the three tables cover the
reference's registry is a test's business (tests/test_torch_knobs.py).

The scan is a pure-AST pass (no module under scan is imported). A "read"
is the first argument of:

- ``os.environ.get(...)`` / ``os.environ[...]`` (Load context) /
  ``os.getenv(...)``
- the ``common/env.py`` typed helpers ``_get_bool`` / ``_get_int`` /
  ``_get_float`` / ``_get_choice``

where the argument is a string literal or a name/attribute resolvable
through the constants table in ``horovod_tpu_torch/common/env.py`` (the
``HOROVOD_X = "HOROVOD_X"`` block). Arguments that stay symbolic (e.g.
the ``name`` parameter inside the helpers themselves) are ignored. Each
site records the reader form so the choice-knob discipline can tell a
``_get_choice`` read from a raw ``environ.get``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from . import is_environ as _is_environ  # shared receiver predicate

KNOB_NAME_RE = re.compile(r"^HOROVOD(_TPU)?(_[A-Z0-9]+)+$")
VALID_TYPES = ("bool", "int", "float", "str", "choice", "spec")

_READ_HELPERS = ("_get_bool", "_get_int", "_get_float", "_get_choice")


def _const_table(env_py_path: str) -> Dict[str, str]:
    """``HOROVOD_X = "HOROVOD_X"`` module-level assignments in
    common/env.py — the indirection every ``env_mod.HOROVOD_X`` read
    site goes through."""
    with open(env_py_path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    table: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            table[node.targets[0].id] = node.value.value
    return table


def _resolve(arg: ast.expr, consts: Dict[str, str]) -> Optional[str]:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.Name):
        return consts.get(arg.id)
    if isinstance(arg, ast.Attribute):       # env_mod.HOROVOD_X
        return consts.get(arg.attr)
    return None




def scan_env_reads(pkg_root: str,
                   errors: Optional[List[str]] = None
                   ) -> List[Tuple[str, int, str, str]]:
    """Every resolvable env-var read under ``pkg_root``:
    (relpath, lineno, var name, reader form). The reader form is the
    call that performed the read (``environ.get`` / ``getenv`` /
    ``_get_bool`` / ... / ``subscript``) so the choice-knob discipline
    can tell the registry parser apart from an ad-hoc parse. Only
    ``HOROVOD*`` names are returned. Files that fail to parse are
    reported into ``errors`` (when given) instead of silently dropping
    their read sites — a skipped file would turn an undeclared read
    invisible and a declared one "dead"."""
    consts = _const_table(os.path.join(pkg_root, "common", "env.py"))
    sites: List[Tuple[str, int, str, str]] = []
    # paths are reported relative to the package's PARENT (repo root for
    # the live tree: "horovod_tpu_torch/faults.py"), matching lockcheck/
    # divcheck so path:line findings anchor in --format=github
    rel_root = os.path.dirname(os.path.abspath(pkg_root))

    def note(rel: str, node: ast.AST, arg: ast.expr, reader: str):
        name = _resolve(arg, consts)
        if name and name.startswith("HOROVOD"):
            sites.append((rel, node.lineno, name, reader))

    from . import iter_py_files
    for path in iter_py_files(pkg_root):
        rel = os.path.relpath(path, rel_root)
        with open(path, encoding="utf-8", errors="replace") as f:
            try:
                tree = ast.parse(f.read())
            except SyntaxError as e:
                if errors is not None:
                    errors.append(
                        f"{rel}:{e.lineno or 0}: could not parse "
                        f"({e.msg}) — its env reads are invisible "
                        f"to this lint")
                continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute) and \
                        func.attr in ("get", "getenv", "pop",
                                      "setdefault") and \
                        (_is_environ(func.value) or
                         (func.attr == "getenv" and
                          isinstance(func.value, ast.Name))):
                    if node.args:
                        note(rel, node, node.args[0],
                             "getenv" if func.attr == "getenv"
                             else f"environ.{func.attr}")
                elif isinstance(func, ast.Name) and \
                        func.id in ("getenv",) + _READ_HELPERS:
                    if node.args:
                        note(rel, node, node.args[0], func.id)
                elif isinstance(func, ast.Attribute) and \
                        func.attr in _READ_HELPERS:
                    if node.args:
                        note(rel, node, node.args[0], func.attr)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    _is_environ(node.value):
                note(rel, node, node.slice, "subscript")
    return sites


def validate_specs(specs: Dict[str, dict]) -> List[str]:
    """Registry shape lint: names match the knob regex, every entry has a
    valid type and a non-empty help string."""
    errors = []
    for name, spec in sorted(specs.items()):
        if not KNOB_NAME_RE.match(name):
            errors.append(f"{name}: does not match {KNOB_NAME_RE.pattern}")
        if not isinstance(spec, dict):
            errors.append(f"{name}: spec must be a dict "
                          f"(type/default/help)")
            continue
        if spec.get("type") not in VALID_TYPES:
            errors.append(f"{name}: unknown knob type {spec.get('type')!r} "
                          f"(valid: {', '.join(VALID_TYPES)})")
        help_str = spec.get("help")
        if not isinstance(help_str, str) or not help_str.strip():
            errors.append(f"{name}: missing help string")
        if spec.get("type") == "choice" and not spec.get("choices"):
            errors.append(f"{name}: choice knobs must list choices")
    return errors


def validate_defaults(specs: Dict[str, dict]) -> List[str]:
    """Declared defaults must be consistent with the declared type and
    choices: a choice default outside its own
    choices, or an int default that parses as nothing, is registry rot
    waiting to become a runtime surprise. ``default`` is a *display*
    string, so the typed checks accept the documented display forms:
    empty (launcher-set), ``derived``, and a leading numeric token with
    a parenthesized qualifier (``"100 (10 when elastic)"``)."""
    errors = []
    _BOOLISH = ("0", "1", "true", "false", "yes", "no", "on", "off", "")
    for name, spec in sorted(specs.items()):
        if not isinstance(spec, dict):
            continue  # shape error already reported by validate_specs
        default = spec.get("default")
        if not isinstance(default, str):
            errors.append(f"{name}: default must be a display string, "
                          f"got {type(default).__name__}")
            continue
        ktype = spec.get("type")
        if ktype == "choice":
            choices = spec.get("choices") or ()
            bad = [c for c in choices if not isinstance(c, str)]
            if bad:
                errors.append(f"{name}: choices must be strings "
                              f"(got {bad})")
            elif choices and default not in choices:
                errors.append(
                    f"{name}: default {default!r} is not one of its own "
                    f"choices {tuple(choices)}")
        elif ktype == "bool":
            if default.strip().lower() not in _BOOLISH:
                errors.append(f"{name}: bool default {default!r} is not "
                              f"a recognized boolean token")
        elif ktype in ("int", "float"):
            tok = default.strip().split(" ")[0] if default.strip() else ""
            if tok in ("", "derived"):
                continue
            try:
                int(tok) if ktype == "int" else float(tok)
            except ValueError:
                errors.append(f"{name}: {ktype} default {default!r} does "
                              f"not parse (leading token {tok!r})")
    return errors


def validate_choice_reads(specs: Dict[str, dict],
                          sites: List[Tuple[str, int, str, str]]
                          ) -> List[str]:
    """Declared-``choice`` knobs must be read through ``_get_choice``
    (the registry parser: one accepted-token set, one warn-and-default
    path) — a raw ``environ.get`` re-parse is exactly how accepted
    values drift away from the declared choices."""
    errors = []
    choice_knobs = {n for n, s in specs.items()
                    if isinstance(s, dict) and s.get("type") == "choice"}
    for site in sites:
        rel, lineno, name = site[0], site[1], site[2]
        reader = site[3] if len(site) > 3 else "?"
        if name in choice_knobs and reader != "_get_choice":
            errors.append(
                f"{rel}:{lineno}: choice knob {name!r} is read via "
                f"{reader} instead of the registry parser _get_choice "
                f"(declared choices: "
                f"{tuple(specs[name].get('choices') or ())})")
    return errors


def validate_reads(specs: Dict[str, dict],
                   sites: List[Tuple[str, int, str, str]],
                   owed: Optional[Dict[str, str]] = None) -> List[str]:
    """Undeclared reads + dead (declared-but-unread) knobs. A read of an
    ``owed`` knob says which item owed it: once read, it moves into
    KNOB_SPECS."""
    errors = []
    owed = owed or {}
    for site in sites:
        rel, lineno, name = site[0], site[1], site[2]
        if name not in specs:
            hint = (f" (OWED to {owed[name]}: declare it and drop it from "
                    f"OWED)" if name in owed else "")
            errors.append(
                f"{rel}:{lineno}: env var {name!r} is read but not "
                f"declared in horovod_tpu_torch.common.knobs.KNOB_SPECS"
                f"{hint}")
    read = {site[2] for site in sites}
    # export-only knobs are part of the worker env contract: the framework
    # sets them for subprocesses but never reads them back
    declared = {n for n, s in specs.items()
                if not (isinstance(s, dict) and s.get("export"))}
    for name in sorted(declared - read):
        errors.append(
            f"KNOB_SPECS declares {name!r} but nothing under "
            f"horovod_tpu_torch/ "
            f"reads it (dead knob — remove it or wire it up)")
    return errors


ROADMAP_ITEM_RE = re.compile(r"^[A-C][0-9]+[a-z]?$")


def validate_partition(specs: Dict[str, dict], owed: Dict[str, str],
                       not_owed: Dict[str, str]) -> List[str]:
    """The declared knobs, OWED and NOT_OWED are pairwise disjoint; an
    OWED entry names a ROADMAP item, a NOT_OWED entry gives a reason, and
    both hold well-formed knob names."""
    errors = []
    tables = (("KNOB_SPECS", set(specs)), ("OWED", set(owed)),
              ("NOT_OWED", set(not_owed)))
    for i, (a, sa) in enumerate(tables):
        for b, sb in tables[i + 1:]:
            for name in sorted(sa & sb):
                errors.append(f"{name}: in both {a} and {b} — a knob is "
                              f"declared, owed or not owed, exactly one")
    for name, item in sorted(owed.items()):
        if not KNOB_NAME_RE.match(name):
            errors.append(f"OWED {name}: does not match "
                          f"{KNOB_NAME_RE.pattern}")
        if not isinstance(item, str) or not ROADMAP_ITEM_RE.match(item):
            errors.append(f"OWED {name}: {item!r} names no ROADMAP item "
                          f"(A10, A15, ...)")
    for name, reason in sorted(not_owed.items()):
        if not KNOB_NAME_RE.match(name):
            errors.append(f"NOT_OWED {name}: does not match "
                          f"{KNOB_NAME_RE.pattern}")
        if not isinstance(reason, str) or not reason.strip():
            errors.append(f"NOT_OWED {name}: missing reason")
    return errors


def run(pkg_root: Optional[str] = None) -> Tuple[List[str], dict]:
    """The full lint: (errors, stats). ``stats`` carries the scan size so
    report shows coverage, not just a green light."""
    if pkg_root is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from ..common.knobs import KNOB_SPECS, NOT_OWED, OWED
    errors: List[str] = []
    sites = scan_env_reads(pkg_root, errors=errors)
    errors += validate_specs(KNOB_SPECS)
    errors += validate_defaults(KNOB_SPECS)
    errors += validate_reads(KNOB_SPECS, sites, OWED)
    errors += validate_choice_reads(KNOB_SPECS, sites)
    errors += validate_partition(KNOB_SPECS, OWED, NOT_OWED)
    stats = {"declared": len(KNOB_SPECS), "owed": len(OWED),
             "not_owed": len(NOT_OWED), "read_sites": len(sites),
             "distinct_read": len({site[2] for site in sites}),
             "choice_knobs": sum(
                 1 for s in KNOB_SPECS.values()
                 if isinstance(s, dict) and s.get("type") == "choice")}
    return errors, stats
