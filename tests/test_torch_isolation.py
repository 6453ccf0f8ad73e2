"""horovod_tpu_torch stands alone: importing it loads neither jax nor any
module of the JAX package, and no file of the port imports one."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "horovod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_import_loads_no_jax_and_no_jax_package_module():
    code = (
        "import sys\n"
        "import horovod_tpu_torch, horovod_tpu_torch.models.resnet\n"
        "import horovod_tpu_torch.models.convert\n"
        "import horovod_tpu_torch.ops.fused_batch_norm\n"
        "import horovod_tpu_torch.ops.build\n"
        "import horovod_tpu_torch.parallel.flash_attention\n"
        "import horovod_tpu_torch.parallel.ring_attention\n"
        "import horovod_tpu_torch.parallel.ulysses\n"
        "import horovod_tpu_torch.parallel.mesh\n"
        "import horovod_tpu_torch.parallel.moe\n"
        "import horovod_tpu_torch.parallel.tensor_parallel\n"
        "import horovod_tpu_torch.parallel.pipeline\n"
        "import horovod_tpu_torch.parallel\n"
        "import horovod_tpu_torch.models.transformer\n"
        "import horovod_tpu_torch.models.vit\n"
        "import horovod_tpu_torch.models.mlp\n"
        "import horovod_tpu_torch.ops.adasum\n"
        "import horovod_tpu_torch.ops.sync_batch_norm\n"
        "import horovod_tpu_torch.ops.compression\n"
        "import horovod_tpu_torch.ops.collectives\n"
        "import horovod_tpu_torch.common.env\n"
        "import horovod_tpu_torch.common.retry\n"
        "import horovod_tpu_torch.faults, horovod_tpu_torch.metrics\n"
        "import horovod_tpu_torch.timeline, horovod_tpu_torch.trace\n"
        "import horovod_tpu_torch.stall_inspector\n"
        "import horovod_tpu_torch.native\n"
        "import horovod_tpu_torch.observability\n"
        "import horovod_tpu_torch.observability.monitor\n"
        "import horovod_tpu_torch.checkpoint\n"
        "import horovod_tpu_torch.checkpoint.flatten\n"
        "import horovod_tpu_torch.checkpoint.manager\n"
        "import horovod_tpu_torch.checkpoint.manifest\n"
        "import horovod_tpu_torch.checkpoint.shard_io\n"
        "import horovod_tpu_torch.runner\n"
        "import horovod_tpu_torch.runner.http_client\n"
        "import horovod_tpu_torch.runner.http_server\n"
        "import horovod_tpu_torch.elastic\n"
        "import horovod_tpu_torch.elastic.launcher\n"
        "import horovod_tpu_torch.runner.launch\n"
        "import horovod_tpu_torch.runner.run_task\n"
        "import horovod_tpu_torch.runner.task_agent\n"
        "import horovod_tpu_torch.runner.service\n"
        "import horovod_tpu_torch.runner.replication\n"
        "import horovod_tpu_torch.runner.aggregator\n"
        "import horovod_tpu_torch.elastic.failover\n"
        "import horovod_tpu_torch.common.knobs\n"
        "import horovod_tpu_torch.analysis.check\n"
        "import horovod_tpu_torch.analysis.lockcheck\n"
        "import horovod_tpu_torch.analysis.divcheck\n"
        "import horovod_tpu_torch.analysis.errflow\n"
        "import horovod_tpu_torch.analysis.knobcheck\n"
        "import horovod_tpu_torch.analysis.metriccheck\n"
        "import horovod_tpu_torch.analysis.faultcheck\n"
        "import horovod_tpu_torch.analysis.traceschema\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_jax_or_the_jax_package(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def test_chip_smoke_imports_no_jax():
    bad = [(line, root) for line, root in
           _imported_roots(REPO / "chip_smoke.py") if root in FORBIDDEN]
    assert not bad


# the test files whose subprocesses stand in for a port process (a KV
# primary, a driver, an aggregator, an elastic worker): their scripts, the
# module-level strings named *_SCRIPT, import only the port
SCRIPT_FILES = ("test_torch_control_plane.py", "test_torch_aggregator.py",
                "test_torch_chaos.py")


def _scripts(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant) \
                and isinstance(node.value.value, str) \
                and any(getattr(t, "id", "").endswith("_SCRIPT")
                        for t in node.targets):
            yield node.targets[0].id, node.value.value


@pytest.mark.parametrize("name", SCRIPT_FILES)
def test_subprocess_scripts_import_only_the_port(name, tmp_path):
    scripts = list(_scripts(REPO / "tests" / name))
    assert scripts, f"{name} holds no *_SCRIPT"
    for var, text in scripts:
        script = tmp_path / f"{var}.py"
        script.write_text(text)
        roots = {root for _, root in _imported_roots(script)}
        assert "horovod_tpu_torch" in roots, (name, var, roots)
        assert not roots & set(FORBIDDEN), (name, var, roots)


def test_torch_worker_imports_only_torch_and_the_port():
    """``tests/torch_worker.py`` runs every gloo and card world and the
    control-plane job's primary and workers."""
    bad = [(line, root) for line, root in
           _imported_roots(REPO / "tests" / "torch_worker.py")
           if root in FORBIDDEN]
    assert not bad


# top-level packages the port imports only inside the functions that need
# them: the card's machine may lack them (the launcher's --config-file
# reads YAML; the programmatic run() pickles with cloudpickle if it can)
LAZY = ("yaml", "cloudpickle")


def _module_level_roots(path: Path):
    """The roots a module imports when it is imported: its top-level
    statements, ``try`` and ``if`` blocks included, not its functions'."""
    tree = ast.parse(path.read_text(), filename=str(path))
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, (ast.Try, ast.If, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                todo.extend(getattr(node, field, []) or [])
        elif isinstance(node, ast.ExceptHandler):
            todo.extend(node.body)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_module_imports_yaml_or_cloudpickle_at_import(path):
    bad = [(line, root) for line, root in _module_level_roots(path)
           if root in LAZY]
    assert not bad, f"{path}: {bad}"


# names of the reference's __all__ the port does not export yet, and the one
# it exports that the reference lacks
OWED = set()
PORT_ONLY = {"device"}


def test_public_names_are_the_references_but_the_owed_ones():
    """The port's ``__all__`` is the reference's (read with ``ast``, so
    jax is not imported) minus exactly the names still owed, plus
    ``device``."""
    tree = ast.parse((REPO / "horovod_tpu" / "__init__.py").read_text())
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and any(getattr(t, "id", None) == "__all__"
                       for t in node.targets))
    res = subprocess.run(
        [sys.executable, "-c",
         "import horovod_tpu_torch as h; print('\\n'.join(h.__all__))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    port = res.stdout.split()
    assert len(port) == len(set(port))
    assert OWED <= set(ref)
    assert set(port) == (set(ref) - OWED) | PORT_ONLY
