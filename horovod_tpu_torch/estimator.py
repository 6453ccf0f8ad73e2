"""Estimator: train-loop-in-a-box with store checkpointing and resume.

The port's counterpart of ``horovod_tpu/estimator.py``. Parity: the
reference's Spark estimator layer — ``TorchEstimator.fit`` runs a
``RemoteTrainer`` closure on each worker (deserialize model, wrap optimizer
in ``hvd.DistributedOptimizer``, per-epoch train/validate with metric
averaging, rank-0 checkpoint to the Store, spark/torch/remote.py:35-382)
and returns a model usable for inference (spark/common/estimator.py).

No Spark and no serialization round-trip: a train loop over the eager
engine (under ``python -m horovod_tpu_torch.runner -np N`` and
single-process), in PyTorch's idiom:

- ``init_fn(generator) -> nn.Module`` builds the model from a CPU
  ``torch.Generator`` seeded with ``seed``; ``forward_fn(model, inputs)``,
  ``loss_fn(model, inputs, labels)`` and each of ``metric_fns`` take the
  module; ``optimizer`` is a factory, ``parameters -> torch.optim.Optimizer``
  (a torch optimizer binds to its parameters), wrapped in
  ``DistributedOptimizer(op, compression, backward_passes_per_step)``;
- the model runs on ``device``, by default ``hvd.device()``, the world's
  card; the estimator never falls back to the CPU on its own;
- per-epoch validation with cross-rank metric averaging
  (_keras/callbacks.py:48-87 MetricAverageCallback role);
- rank-0 checkpoints ``{"model", "optimizer", "epoch"}`` (the two
  ``state_dict()``s) to a :class:`~horovod_tpu_torch.store.Store` every
  ``checkpoint_every_n_epochs``, and resume from the latest through
  ``load_state_dict``.

Batches come from the data path as numpy arrays. On a card each one goes
to the device from pinned memory with ``non_blocking=True``: a blocking
copy waits for the stream, so the host would stall behind the previous
step's kernels at every step, while a pinned block is copied by DMA in
stream order and the caching host allocator reuses it once the copy has
passed. On the CPU the arrays are taken as they are. The per-step losses
stay on the device and are read once at the epoch's end: no step waits for
the host.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .common.reduce_ops import Average, ReduceOp
from .store import Store

_LOG = logging.getLogger("horovod_tpu_torch.estimator")


def _module_device(model: torch.nn.Module) -> torch.device:
    for t in list(model.parameters()) + list(model.buffers()):
        return t.device
    return torch.device("cpu")


def _to_device(a, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class TrainedModel:
    """Result of ``Estimator.fit`` (parity: the Spark estimator's returned
    inference model): the trained module, ``params`` as the JAX package
    names it, and the per-epoch ``history``."""

    def __init__(self, params: torch.nn.Module, forward_fn: Callable,
                 history: List[dict]):
        self.params = params
        self._forward = forward_fn
        self.history = history

    def predict(self, inputs) -> np.ndarray:
        """``forward_fn`` on ``inputs`` in eval mode under
        ``torch.no_grad()`` on the model's device, as numpy (a bf16 output
        cast to float32 first: numpy has no bf16)."""
        model = self.params
        was = model.training
        model.eval()
        try:
            with torch.no_grad():
                out = self._forward(model, _to_device(np.asarray(inputs),
                                                      _module_device(model)))
        finally:
            model.train(was)
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()


class Estimator:
    """Distributed train-loop-in-a-box.

    Args:
      init_fn: ``generator -> nn.Module``, the initial model.
      forward_fn: ``(model, inputs) -> outputs`` (used for predict).
      loss_fn: ``(model, inputs, labels) -> scalar loss tensor``.
      optimizer: ``parameters -> torch.optim.Optimizer``.
      store: a Store for checkpoints (or None to disable).
      run_id: checkpoint namespace within the store.
      epochs, batch_size: loop controls (batch_size is per worker).
      metric_fns: name -> ``(model, inputs, labels) -> scalar`` evaluated
        on validation data under ``torch.no_grad()``, averaged across
        ranks.
      checkpoint_every_n_epochs: rank-0 checkpoint cadence.
      backward_passes_per_step / compression / op: forwarded to the
        DistributedOptimizer wrapper.
      device: where the model trains (default ``hvd.device()``).
    """

    def __init__(self, init_fn: Callable, forward_fn: Callable,
                 loss_fn: Callable, optimizer: Callable,
                 store: Optional[Store] = None,
                 run_id: str = "default",
                 epochs: int = 1, batch_size: int = 32,
                 metric_fns: Optional[Dict[str, Callable]] = None,
                 checkpoint_every_n_epochs: int = 1,
                 op=Average, compression=None,
                 backward_passes_per_step: int = 1,
                 shuffle: bool = True, seed: int = 0, device=None):
        self.init_fn = init_fn
        self.forward_fn = forward_fn
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.store = store
        self.run_id = run_id
        self.epochs = epochs
        self.batch_size = batch_size
        self.metric_fns = metric_fns or {}
        self.checkpoint_every_n_epochs = checkpoint_every_n_epochs
        self.op = op
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self.shuffle = shuffle
        self.seed = seed
        self.device = device

    # -- internals ----------------------------------------------------------

    def _shard(self, n: int, rank: int, size: int) -> np.ndarray:
        """Contiguous shard of sample indices for this rank (parity: the
        estimator's per-worker data partition). Every rank gets exactly
        ``n // size`` samples — equal shard sizes mean equal batch counts,
        so ranks issue the same collective sequence (an uneven tail would
        deadlock the gradient allreduces)."""
        per = n // size
        lo = rank * per
        return np.arange(lo, lo + per)

    def _resume(self, model: torch.nn.Module, optimizer) -> int:
        """Load the latest checkpoint into ``model`` and ``optimizer``;
        returns the epoch to start from (0 without one)."""
        if self.store is None:
            return 0
        ckpt = self.store.load_checkpoint(self.run_id)
        if ckpt is None:
            return 0
        _LOG.info("resuming %s from checkpoint at epoch %s", self.run_id,
                  ckpt["epoch"])
        model.load_state_dict(ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])
        return int(ckpt["epoch"]) + 1

    def _array_batches(self, x, y, idx, epoch: int):
        order = idx
        if self.shuffle:
            order = np.random.RandomState(self.seed + epoch).permutation(idx)
        return ((x[order[lo:lo + self.batch_size]],
                 y[order[lo:lo + self.batch_size]])
                for lo in range(0, len(order) - self.batch_size + 1,
                                self.batch_size))

    # -- public -------------------------------------------------------------

    def fit(self, train_data, val_data: Optional[Tuple] = None
            ) -> TrainedModel:
        """Run the distributed train loop.

        ``train_data`` is either ``(inputs, labels)`` numpy arrays (the full
        dataset; each rank trains on an equal contiguous shard, like the
        estimator's partitioned dataframe) or a
        :class:`horovod_tpu_torch.data.ShardedNpzDataset` (on-disk shards
        taken round-robin per rank — the Petastorm reader-loop role,
        spark/torch/remote.py:35-382). Sharded datasets may be UNEVEN: a
        rank that runs out of batches joins (``hvd.join()``) and
        substitutes zeros for the peers' remaining gradient reductions, so
        no data is dropped and nothing deadlocks."""
        import horovod_tpu_torch as hvd
        from . import functions
        from .data import ShardedNpzDataset
        from .optimizer import DistributedOptimizer
        from .ops.compression import Compression

        if not hvd.is_initialized():
            hvd.init()
        rank, size = hvd.rank(), hvd.size()
        device = hvd.device() if self.device is None \
            else torch.device(self.device)

        model = self.init_fn(torch.Generator().manual_seed(self.seed))
        model.to(device)
        opt = DistributedOptimizer(
            self.optimizer(model.parameters()), op=self.op,
            compression=self.compression or Compression.none,
            backward_passes_per_step=self.backward_passes_per_step)
        start_epoch = self._resume(model, opt)
        # consistent start across ranks (broadcast_parameters /
        # BroadcastGlobalVariablesCallback). start_epoch too: only rank 0's
        # host may hold the checkpoint (non-shared store path), and a
        # per-rank epoch count would desynchronize the collective sequence.
        if size > 1:
            functions.broadcast_parameters(model.state_dict(), root_rank=0)
            functions.broadcast_optimizer_state(opt, root_rank=0)
            start_epoch = int(functions.broadcast_object(
                start_epoch, root_rank=0, name="est.start_epoch"))

        ragged = isinstance(train_data, ShardedNpzDataset)
        if not ragged:
            x, y = np.asarray(train_data[0]), np.asarray(train_data[1])
            idx = self._shard(len(x), rank, size)
        history: List[dict] = []

        for epoch in range(start_epoch, self.epochs):
            t0 = time.perf_counter()
            if ragged:
                # streaming reader: bounded host RAM, background prefetch,
                # per-epoch reshuffle. Every batch trains, including the
                # short tail; batch counts may differ across ranks — join()
                # below squares that up.
                batches = iter(train_data.iter_batches(
                    rank, size, self.batch_size, shuffle=self.shuffle,
                    seed=self.seed + epoch))
            else:
                batches = self._array_batches(x, y, idx, epoch)
            model.train()
            losses = []
            try:
                for bx, by in batches:
                    opt.zero_grad()
                    loss = self.loss_fn(model, _to_device(bx, device),
                                        _to_device(by, device))
                    loss.backward()
                    opt.step()
                    losses.append(loss.detach())
            finally:
                # an epoch left by an exception (an elastic reset, say)
                # joins the loader thread before anything else reads
                batches.close()
            if ragged and size > 1:
                # out of data for this epoch: match any still-training
                # peers' reductions with zero substitutes (reference join
                # semantics for the uneven last batches,
                # operations.cc:1004-1040). join() returns the LAST rank to
                # join, the one that saw the most batches and holds the
                # most-updated replica: a joined rank never applies the
                # peers' later updates, so replicas diverge after an uneven
                # epoch; re-sync everyone from it. Equal batch counts mean
                # nobody substituted and replicas are bit-identical — skip
                # the (full-model) re-broadcast then.
                last = hvd.join()
                n = len(losses)
                spread = hvd.allreduce(np.array([n, -n], np.float64),
                                       name=f"est.nb.{epoch}",
                                       op=ReduceOp.MAX).cpu()
                if spread[0] != -spread[1]:   # max(n) != min(n): diverged
                    functions.broadcast_parameters(model.state_dict(),
                                                   root_rank=last)
                    functions.broadcast_optimizer_state(opt, root_rank=last)
            loss_sum = (torch.stack(losses).double().sum().item()
                        if losses else 0.0)
            n_batches = len(losses)
            record = {"epoch": epoch, "time_s": time.perf_counter() - t0}
            if val_data is not None:
                record.update(self._validate(model, val_data, rank, size,
                                             device))
            # metric averaging across ranks (MetricAverageCallback) —
            # batch-count weighted, so a rank with an empty ragged shard
            # contributes (0, 0) instead of poisoning the mean with NaN
            if size > 1:
                totals = hvd.allreduce(
                    np.array([loss_sum, float(n_batches)], np.float64),
                    name=f"est.loss.{epoch}", op=ReduceOp.SUM).cpu()
                loss_sum, n_batches = float(totals[0]), float(totals[1])
            record["train_loss"] = (loss_sum / n_batches if n_batches
                                    else float("nan"))
            history.append(record)
            if rank == 0:
                _LOG.info("epoch %d: %s", epoch, record)
            if (self.store is not None and rank == 0 and
                    (epoch + 1) % self.checkpoint_every_n_epochs == 0):
                self.store.save_checkpoint(
                    self.run_id, epoch,
                    {"model": model.state_dict(),
                     "optimizer": opt.state_dict(), "epoch": epoch})
        return TrainedModel(model, self.forward_fn, history)

    def _validate(self, model, val_data, rank, size, device) -> dict:
        import horovod_tpu_torch as hvd
        x, y = np.asarray(val_data[0]), np.asarray(val_data[1])
        idx = self._shard(len(x), rank, size)
        bx, by = _to_device(x[idx], device), _to_device(y[idx], device)
        out = {}
        was = model.training
        model.eval()
        try:
            with torch.no_grad():
                for name, fn in self.metric_fns.items():
                    v = float(fn(model, bx, by))
                    if size > 1:
                        v = float(hvd.allreduce(
                            np.float32(v), name=f"est.val.{name}",
                            op=Average))
                    out[f"val_{name}"] = v
        finally:
            model.train(was)
        return out
