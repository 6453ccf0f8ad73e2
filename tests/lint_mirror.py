"""Inputs for holding the port's analyzers (horovod_tpu_torch/analysis/)
against the reference's (horovod_tpu/analysis/): the reference suite's
fixture files, and every synthetic source its tests feed to
``check_source`` / ``check_sources``, harvested from the test files' ASTs
so the two suites cannot drift apart.

A source counts when it is a string literal, ``textwrap.dedent``/``_src``
of one, a name bound to one of those in the same test, or (for
``check_sources``) a dict literal of them.
"""

import ast
import os
from typing import Dict, List, Optional, Tuple

TESTS = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(TESTS, "fixtures")


def _literal(node: ast.AST, env: Dict[str, ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name) and node.id in env:
        return _literal(env[node.id], {})
    if isinstance(node, ast.Call) and len(node.args) == 1:
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            getattr(fn, "id", None)
        if name in ("dedent", "_src"):
            import textwrap
            inner = _literal(node.args[0], env)
            return None if inner is None else textwrap.dedent(inner)
    return None


def harvest(test_file: str, api: str = "check_source"
            ) -> List[Tuple[str, object]]:
    """``[(case id, source or {rel: source})]`` of every ``<x>.<api>(...)``
    call in ``tests/<test_file>`` whose source resolves to literals; for
    ``check_source`` the case also carries the ``rel`` argument when
    given."""
    path = os.path.join(TESTS, test_file)
    tree = ast.parse(open(path).read())
    out: List[Tuple[str, object]] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        env: Dict[str, ast.AST] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                env[node.targets[0].id] = node.value
        n = 0
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr == api and node.args):
                continue
            arg = node.args[0]
            if api == "check_sources":
                if isinstance(arg, ast.Name):
                    arg = env.get(arg.id, arg)
                if not isinstance(arg, ast.Dict):
                    continue
                srcs = {}
                for k, v in zip(arg.keys, arg.values):
                    key, val = _literal(k, env), _literal(v, env)
                    if key is None or val is None:
                        break
                    srcs[key] = val
                else:
                    out.append((f"{fn.name}-{n}", srcs))
                    n += 1
                continue
            src = _literal(arg, env)
            if src is None:
                continue
            rel = _literal(node.args[1], env) if len(node.args) > 1 else None
            out.append((f"{fn.name}-{n}", (src, rel)))
            n += 1
    return out


def fixture_paths(lint: str) -> List[str]:
    """The reference suite's fixture files and directories for ``lint``."""
    root = os.path.join(FIXTURES, lint)
    return sorted(os.path.join(root, name) for name in os.listdir(root)
                  if name != "__pycache__")
