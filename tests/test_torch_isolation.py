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
        "import horovod_tpu_torch.parallel\n"
        "import horovod_tpu_torch.models.transformer\n"
        "import horovod_tpu_torch.models.vit\n"
        "import horovod_tpu_torch.models.mlp\n"
        "import horovod_tpu_torch.ops.adasum\n"
        "import horovod_tpu_torch.ops.sync_batch_norm\n"
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
