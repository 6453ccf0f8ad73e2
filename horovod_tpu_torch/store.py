"""Checkpoint/artifact store.

The port's counterpart of ``horovod_tpu/store.py``. Parity: the
reference's Spark ``Store`` (spark/common/store.py:148-300
LocalStore/HDFSStore — filesystem layout for intermediate data, checkpoints
and logs, used by the estimators to persist per-epoch checkpoints and the
final model).

- The layout is the JAX package's: ``<prefix>/runs/<run_id>/checkpoints/
  step_N``, beside a ``latest`` JSON pointer written to a temporary file
  and renamed, so ``latest_checkpoint_step`` and ``checkpoint_steps`` read
  either package's run directories alike.
- A checkpoint is a torch tree (dicts, lists, tuples, tensors, numbers)
  saved with ``torch.save`` as ``step_N/state.pt``, every tensor copied to
  the CPU first (the JAX package takes ``np.asarray`` of each leaf).
  ``load_checkpoint`` returns CPU tensors; callers move them with
  ``load_state_dict``.
- A step the JAX package wrote (``leaves.npz`` + ``treedef.pkl``, or
  orbax) is not read here: loading it raises a ``RuntimeError`` that names
  its format.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import shutil
from typing import Any, List, Optional

import torch

CHECKPOINT_FILE = "state.pt"
_NPZ_FILE = "leaves.npz"   # the JAX package's step, beside treedef.pkl


def host_tree(tree: Any) -> Any:
    """``tree`` with every tensor detached and on the CPU (containers
    rebuilt, their types kept; a CPU tensor is taken as it is)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, host_tree(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    return tree


def _load_bytes(f) -> Any:
    """``torch.load`` onto the CPU, with ``weights_only`` where the tree
    allows it (tensors, containers, numbers, strings); a tree with other
    objects (numpy scalars, say) is read in full."""
    try:
        return torch.load(f, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        f.seek(0)
        return torch.load(f, map_location="cpu", weights_only=False)


def _reference_format_error(path: str, npz: bool) -> RuntimeError:
    fmt = ("the JAX package's npz + treedef format (leaves.npz, "
           "treedef.pkl)" if npz else "orbax (no state.pt in it)")
    return RuntimeError(
        f"checkpoint at {path} was written in {fmt}; it needs horovod_tpu "
        f"to read it — horovod_tpu_torch reads the {CHECKPOINT_FILE} that "
        f"its own stores write")


class Store:
    """Factory (parity: spark/common/store.py Store.create, which routes
    hdfs:// to HDFSStore at store.py:256): any ``scheme://`` prefix but
    ``file://`` is handed to fsspec (gs://, s3://, memory:// for tests),
    which is what preemptible elastic jobs should checkpoint to."""

    @staticmethod
    def create(prefix_path: str) -> "Store":
        if "://" in prefix_path and not prefix_path.startswith("file://"):
            return RemoteStore(prefix_path)
        return LocalStore(prefix_path.removeprefix("file://"))


class LocalStore(Store):
    """Filesystem store: ``<prefix>/runs/<run_id>/checkpoints/step_N``."""

    def __init__(self, prefix_path: str):
        self.prefix_path = os.path.abspath(prefix_path)
        os.makedirs(self.prefix_path, exist_ok=True)

    # -- paths --------------------------------------------------------------

    def run_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, "runs", run_id)

    def checkpoint_dir(self, run_id: str) -> str:
        return os.path.join(self.run_path(run_id), "checkpoints")

    def logs_path(self, run_id: str) -> str:
        return os.path.join(self.run_path(run_id), "logs")

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    # -- checkpoints ---------------------------------------------------------

    def _step_dir(self, run_id: str, step: int) -> str:
        return os.path.join(self.checkpoint_dir(run_id), f"step_{step}")

    def save_checkpoint(self, run_id: str, step: int, tree: Any) -> str:
        """Persist a torch tree and advance the ``latest`` pointer."""
        path = self._step_dir(run_id, step)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        tmp = os.path.join(path, f".{CHECKPOINT_FILE}.tmp")
        torch.save(host_tree(tree), tmp)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
        tmp = os.path.join(self.checkpoint_dir(run_id),
                           f".latest.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({"step": step}, f)
        os.replace(tmp, os.path.join(self.checkpoint_dir(run_id), "latest"))
        return path

    def latest_checkpoint_step(self, run_id: str) -> Optional[int]:
        p = os.path.join(self.checkpoint_dir(run_id), "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(json.load(f)["step"])

    def load_checkpoint(self, run_id: str, step: Optional[int] = None) -> Any:
        """Load a checkpoint tree of CPU tensors (``step=None`` → latest).
        Returns None if the run has no checkpoints."""
        if step is None:
            step = self.latest_checkpoint_step(run_id)
            if step is None:
                return None
        path = self._step_dir(run_id, step)
        target = os.path.join(path, CHECKPOINT_FILE)
        if not os.path.exists(target):
            if os.path.exists(os.path.join(path, _NPZ_FILE)):
                raise _reference_format_error(path, npz=True)
            if os.path.isdir(path):
                raise _reference_format_error(path, npz=False)
            raise FileNotFoundError(f"no checkpoint at {path}")
        with open(target, "rb") as f:
            return _load_bytes(f)

    def checkpoint_steps(self, run_id: str) -> List[int]:
        d = self.checkpoint_dir(run_id)
        if not os.path.isdir(d):
            return []
        return sorted(int(n.split("_", 1)[1]) for n in os.listdir(d)
                      if n.startswith("step_"))


class RemoteStore(Store):
    """fsspec-backed store for remote filesystems (gs://, s3://, hdfs://,
    memory:// for tests) — the HDFSStore role (reference
    spark/common/store.py:256), where elastic jobs on preemptible VMs must
    checkpoint off-host. The same layout and ``state.pt`` as
    :class:`LocalStore`; the ``latest`` pointer is a JSON object."""

    def __init__(self, prefix_url: str):
        try:
            import fsspec
        except ImportError as e:
            raise ValueError(
                f"remote store {prefix_url!r} requires fsspec (plus the "
                f"scheme's driver, e.g. gcsfs for gs://)") from e
        self.prefix_path = prefix_url.rstrip("/")
        self.fs, _ = fsspec.core.url_to_fs(self.prefix_path)

    # -- paths --------------------------------------------------------------

    def run_path(self, run_id: str) -> str:
        return f"{self.prefix_path}/runs/{run_id}"

    def checkpoint_dir(self, run_id: str) -> str:
        return f"{self.run_path(run_id)}/checkpoints"

    def logs_path(self, run_id: str) -> str:
        return f"{self.run_path(run_id)}/logs"

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)

    # -- checkpoints --------------------------------------------------------

    def _step_dir(self, run_id: str, step: int) -> str:
        return f"{self.checkpoint_dir(run_id)}/step_{step}"

    def save_checkpoint(self, run_id: str, step: int, tree: Any) -> str:
        path = self._step_dir(run_id, step)
        buf = io.BytesIO()
        torch.save(host_tree(tree), buf)
        with self.fs.open(f"{path}/{CHECKPOINT_FILE}", "wb") as f:
            f.write(buf.getvalue())
        # write-then-rename like LocalStore: a preemption mid-write must not
        # leave a truncated pointer (this class exists for preemptible VMs)
        latest = f"{self.checkpoint_dir(run_id)}/latest"
        tmp = f"{latest}.tmp.{os.getpid()}"
        with self.fs.open(tmp, "w") as f:
            json.dump({"step": step}, f)
        try:
            self.fs.mv(tmp, latest)
        except Exception:
            # object stores without rename: fall back to direct write
            with self.fs.open(latest, "w") as f:
                json.dump({"step": step}, f)
            try:
                self.fs.rm(tmp)
            except Exception:
                pass
        return path

    def latest_checkpoint_step(self, run_id: str) -> Optional[int]:
        p = f"{self.checkpoint_dir(run_id)}/latest"
        if not self.fs.exists(p):
            return None
        try:
            with self.fs.open(p, "r") as f:
                return int(json.load(f)["step"])
        except (ValueError, KeyError):
            # truncated pointer (crashed writer on a non-atomic backend):
            # recover from the step directories instead of crashing resume
            steps = self.checkpoint_steps(run_id)
            return steps[-1] if steps else None

    def load_checkpoint(self, run_id: str, step: Optional[int] = None) -> Any:
        if step is None:
            step = self.latest_checkpoint_step(run_id)
            if step is None:
                return None
        path = self._step_dir(run_id, step)
        target = f"{path}/{CHECKPOINT_FILE}"
        if not self.fs.exists(target):
            if self.fs.exists(f"{path}/{_NPZ_FILE}"):
                raise _reference_format_error(path, npz=True)
            if self.fs.exists(path):
                raise _reference_format_error(path, npz=False)
            raise FileNotFoundError(f"no checkpoint at {path}")
        with self.fs.open(target, "rb") as f:
            return _load_bytes(io.BytesIO(f.read()))

    def checkpoint_steps(self, run_id: str) -> List[int]:
        d = self.checkpoint_dir(run_id)
        if not self.fs.exists(d):
            return []
        names = [str(p).rstrip("/").rsplit("/", 1)[-1]
                 for p in self.fs.ls(d, detail=False)]
        return sorted(int(n.split("_", 1)[1]) for n in names
                      if n.startswith("step_"))
