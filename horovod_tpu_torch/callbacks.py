"""Training-loop callbacks.

The port's counterpart of ``horovod_tpu/callbacks.py``. Parity: reference
``horovod/_keras/callbacks.py`` — ``BroadcastGlobalVariablesCallback``
(:22), ``MetricAverageCallback`` (:48), ``LearningRateScheduleCallback`` /
``LearningRateWarmupCallback`` (:90-186) — and ``keras/callbacks.py:157``
``BestModelCheckpoint``.

Callbacks act on a mutable :class:`TrainLoopState` the loop owns, with the
JAX package's field names: ``params`` holds the ``nn.Module`` and
``opt_state`` the optimizer (bare or wrapped by ``DistributedOptimizer``).
The LR callbacks keep an ``lr_scale`` multiplier and move the optimizer's
learning rate with it, as the reference's backend.set_value(
model.optimizer.lr, ...) does: :func:`scaled_lr` records each param
group's base lr, :func:`set_lr_scale` sets every group's ``lr`` to its base
× scale. A torch optimizer reads ``lr`` at each ``step()``, so the new rate
applies from the next step; through ``DistributedOptimizer`` the wrapped
optimizer's ``param_groups`` are the ones set, and under ZeRO-1 (``sharded=
True``) the shard optimizer copies them at every step. Step replay captures
only the gradient reduction, so a new rate leaves an armed step armed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

_LR_ATTR = "_hvd_scaled_lr"


@dataclass
class TrainLoopState:
    """Mutable view of the training loop the callbacks act on: ``params``
    the model (an ``nn.Module``, or a mapping of tensors), ``opt_state``
    the optimizer."""
    params: Any = None
    opt_state: Any = None
    epoch: int = 0
    lr_scale: float = 1.0          # multiplier set_lr_scale applies
    stop_training: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


def scaled_schedule(base_schedule, loop_state: TrainLoopState):
    """Wrap a schedule (``count -> lr``) or a float so the callbacks'
    ``lr_scale`` multiplier applies, read at each call."""
    def sched(count):
        base = base_schedule(count) if callable(base_schedule) \
            else base_schedule
        return base * loop_state.lr_scale
    return sched


class ScaledLRState(NamedTuple):
    """The record :func:`scaled_lr` keeps on the optimizer: each param
    group's base lr (a float, or a clone of a tensor lr) and the scale
    applied last."""
    base_lrs: Tuple[Any, ...]
    scale: float


def _torch_optimizer(optimizer) -> torch.optim.Optimizer:
    """The ``torch.optim.Optimizer`` under any wrappers (the port's
    optimizers keep it as ``.optimizer``)."""
    opt = optimizer
    while not isinstance(opt, torch.optim.Optimizer):
        inner = getattr(opt, "__dict__", {}).get("optimizer")
        if inner is None:
            raise TypeError(f"{type(optimizer).__name__} is not a torch "
                            "optimizer and wraps none")
        opt = inner
    return opt


def scaled_lr(optimizer):
    """Record each param group's current lr as its base and return
    ``optimizer``; :func:`set_lr_scale` then sets every group's lr to its
    base × a scale (the carrier of the LR schedule and warm-up callbacks,
    the reference's _keras/callbacks.py:90-186)::

        opt = hvd.DistributedOptimizer(scaled_lr(torch.optim.SGD(...)))
        ... the callbacks update state.lr_scale and call
        set_lr_scale(state.opt_state, state.lr_scale) ...
    """
    opt = _torch_optimizer(optimizer)
    bases = tuple(g["lr"].detach().clone() if torch.is_tensor(g["lr"])
                  else float(g["lr"]) for g in opt.param_groups)
    setattr(opt, _LR_ATTR, ScaledLRState(bases, 1.0))
    return optimizer


def set_lr_scale(optimizer, scale: float):
    """Set every param group's lr of ``optimizer`` (bare or wrapped) to its
    base × ``scale`` and return ``optimizer``. A tensor lr is set in
    place on its device, which adds no host synchronization."""
    opt = _torch_optimizer(optimizer)
    record = getattr(opt, _LR_ATTR, None)
    if record is None:
        raise ValueError("set_lr_scale: the optimizer has no base learning "
                         "rates; wrap it with scaled_lr() first")
    if len(record.base_lrs) != len(opt.param_groups):
        raise ValueError(f"set_lr_scale: scaled_lr() recorded "
                         f"{len(record.base_lrs)} param groups, the "
                         f"optimizer has {len(opt.param_groups)}")
    scale = float(scale)
    for group, base in zip(opt.param_groups, record.base_lrs):
        if torch.is_tensor(group["lr"]) and torch.is_tensor(base):
            torch.mul(base, scale, out=group["lr"])
        elif torch.is_tensor(group["lr"]):
            group["lr"].fill_(base * scale)
        else:
            group["lr"] = base * scale
    setattr(opt, _LR_ATTR, record._replace(scale=scale))
    return optimizer


class Callback:
    def on_train_begin(self, state: TrainLoopState):
        pass

    def on_epoch_begin(self, state: TrainLoopState):
        pass

    def on_epoch_end(self, state: TrainLoopState, logs: Dict[str, float]):
        pass

    def on_batch_begin(self, state: TrainLoopState, batch: int):
        pass

    def on_batch_end(self, state: TrainLoopState, batch: int,
                     logs: Optional[Dict[str, float]] = None):
        pass


class CallbackList(Callback):
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = list(callbacks)

    def on_train_begin(self, state):
        for c in self.callbacks:
            c.on_train_begin(state)

    def on_epoch_begin(self, state):
        for c in self.callbacks:
            c.on_epoch_begin(state)

    def on_epoch_end(self, state, logs):
        for c in self.callbacks:
            c.on_epoch_end(state, logs)

    def on_batch_begin(self, state, batch):
        for c in self.callbacks:
            c.on_batch_begin(state, batch)

    def on_batch_end(self, state, batch, logs=None):
        for c in self.callbacks:
            c.on_batch_end(state, batch, logs)


def _tensors(params):
    """The named tensors of a model (its ``state_dict()``, buffers
    included) or of a mapping of tensors."""
    return params.state_dict() if isinstance(params, torch.nn.Module) \
        else params


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the model's tensors and the optimizer's state from
    ``root_rank`` at train start, in place (reference
    _keras/callbacks.py:22-46; tensorflow/__init__.py:187
    BroadcastGlobalVariablesHook). A ZeRO-1 optimizer's state is rank-local
    shards and stays as it is (``broadcast_optimizer_state`` refuses it)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state):
        from . import functions
        if state.params is not None:
            functions.broadcast_parameters(_tensors(state.params),
                                           root_rank=self.root_rank)
        opt = state.opt_state
        if opt is not None and not (hasattr(opt, "_is_sharded")
                                    and opt._is_sharded()):
            functions.broadcast_optimizer_state(opt,
                                                root_rank=self.root_rank)


class MetricAverageCallback(Callback):
    """Average epoch metrics over all ranks before reporting (reference
    _keras/callbacks.py:48-87): one float64 vector through
    ``hvd.allreduce``."""

    def on_epoch_end(self, state, logs):
        import horovod_tpu_torch as hvd
        if not logs or hvd.size() == 1:
            return
        keys = sorted(logs.keys())
        vec = np.asarray([float(logs[k]) for k in keys], np.float64)
        out = hvd.allreduce(vec, name=f"metric_avg.e{state.epoch}",
                            op=hvd.Average).cpu().tolist()
        for k, v in zip(keys, out):
            logs[k] = float(v)


class LearningRateScheduleCallback(Callback):
    """Multiply LR by ``multiplier(epoch)`` within [start_epoch, end_epoch)
    (reference _keras/callbacks.py:90-155)."""

    def __init__(self, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 steps_per_epoch: Optional[int] = None):
        self.multiplier = multiplier if callable(multiplier) \
            else (lambda epoch: multiplier)
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self._batch = 0

    def _in_range(self, epoch) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def _apply(self, state):
        if state.opt_state is not None:
            state.opt_state = set_lr_scale(state.opt_state, state.lr_scale)

    def on_epoch_begin(self, state):
        self._batch = 0
        if self.staircase and self._in_range(state.epoch):
            new = float(self.multiplier(state.epoch))
            if new != state.lr_scale:
                state.lr_scale = new
                self._apply(state)

    def on_batch_begin(self, state, batch):
        if not self.staircase and self.steps_per_epoch and \
                self._in_range(state.epoch):
            frac = state.epoch + batch / self.steps_per_epoch
            new = float(self.multiplier(frac))
            # set only on change: LR plateaus cost nothing
            if new != state.lr_scale:
                state.lr_scale = new
                self._apply(state)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Ramp LR from lr/size up to lr over ``warmup_epochs`` (the gradual
    warmup of Goyal et al. the reference implements,
    _keras/callbacks.py:158-186): multiplier(epoch) =
    1/size · (epoch·(size-1)/warmup + 1)."""

    def __init__(self, warmup_epochs: float = 5.0, momentum_correction=None,
                 steps_per_epoch: Optional[int] = None, verbose: bool = False,
                 size: Optional[int] = None):
        def multiplier(epoch):
            if size is None:
                import horovod_tpu_torch as hvd
                world = hvd.size()
            else:
                world = size
            if warmup_epochs <= 0:
                return 1.0
            frac = min(float(epoch) / warmup_epochs, 1.0)
            return (1.0 / world) * (frac * (world - 1) + 1.0)
        super().__init__(multiplier, start_epoch=0,
                         end_epoch=math.ceil(warmup_epochs) + 1,
                         staircase=steps_per_epoch is None,
                         steps_per_epoch=steps_per_epoch)


class BestModelCheckpoint(Callback):
    """Save the model when the monitored metric improves, on rank 0 only
    (reference keras/callbacks.py:157 BestModelCheckpoint): ``torch.save``
    of ``{"params": <CPU state_dict>, "epoch": ..., <monitor>: ...}``."""

    def __init__(self, filepath: str, monitor: str = "val_loss",
                 mode: str = "min"):
        self.filepath = filepath
        self.monitor = monitor
        self.mode = mode
        self.best: Optional[float] = None

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        return value < self.best if self.mode == "min" else value > self.best

    def on_epoch_end(self, state, logs):
        import horovod_tpu_torch as hvd
        from .store import host_tree
        if hvd.rank() != 0 or not logs or self.monitor not in logs:
            return
        value = float(logs[self.monitor])
        if self._improved(value):
            self.best = value
            torch.save({"params": host_tree(dict(_tensors(state.params))),
                        "epoch": state.epoch, self.monitor: value},
                       self.filepath)


class CommitStateCallback(Callback):
    """Commit an elastic ``State`` every ``batches_per_commit`` batches
    (reference _keras/elastic.py:25-44 CommitStateCallbackImpl)."""

    def __init__(self, elastic_state, batches_per_commit: int = 1):
        self.elastic_state = elastic_state
        self.batches_per_commit = batches_per_commit

    def on_batch_end(self, state, batch, logs=None):
        if (batch + 1) % self.batches_per_commit == 0:
            self.elastic_state.commit()


__all__ = [
    "TrainLoopState", "Callback", "CallbackList", "scaled_schedule",
    "scaled_lr", "set_lr_scale", "ScaledLRState",
    "BroadcastGlobalVariablesCallback", "MetricAverageCallback",
    "LearningRateScheduleCallback", "LearningRateWarmupCallback",
    "BestModelCheckpoint", "CommitStateCallback",
]
