"""Distributed optimizers around a ``torch.optim.Optimizer``: gradient
allreduce, and the delta-model Adasum form.

The port's counterpart of ``horovod_tpu/optimizer.py``'s
``DistributedEagerOptimizer`` (:458-949) in the shape of Horovod's torch
frontend: ``step()`` grouped-allreduces every ``p.grad`` through the engine's
fused, bucketed path (with ``op=Adasum``, one Adasum reduction per gradient,
named as the reference names them), then runs the wrapped optimizer's step.
Like the reference it adds no backward hooks, sums (not averages) gradients
over ``backward_passes_per_step`` local passes, and skips the engine entirely
in a size-1 world.

    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.01, momentum=0.9))
    for batch in data:
        opt.zero_grad()
        loss_fn(model, batch).backward()
        opt.step()

:class:`DistributedDeltaAdasumOptimizer` is the reference's
``DistributedDeltaAdasumOptimizer`` (:1021-1131): the wrapped optimizer
steps on the local gradients and the parameter delta is Adasum-reduced.
"""

from __future__ import annotations

from typing import List

import torch

from .common.reduce_ops import Adasum, Average, ReduceOp
from .core.state import engine as _engine
from .ops.adasum import adasum_allreduce_handle
from .ops.compression import Compression


class _Wrapper:
    """What both optimizers share: attributes the wrapper does not define
    (``param_groups``, ``state``, ``defaults``, ...) are the wrapped
    optimizer's, and ``step()`` steps on every ``backward_passes_per_step``-th
    call, ``zero_grad()`` leaving the summed gradients alone in between."""

    def __init__(self, optimizer: torch.optim.Optimizer, compression,
                 backward_passes_per_step: int):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._count = 0
        self._step = 0

    def __getattr__(self, name):
        # only reached for names this wrapper does not define
        return getattr(self.__dict__["optimizer"], name)

    def _params_with_grads(self) -> List[torch.nn.Parameter]:
        return [p for group in self.optimizer.param_groups
                for p in group["params"] if p.grad is not None]

    def _due(self) -> bool:
        """Count a backward pass; True on the one that steps."""
        if self.backward_passes_per_step > 1:
            self._count += 1
            if self._count < self.backward_passes_per_step:
                return False
            self._count = 0
        return True

    def _next_step_name(self) -> int:
        # per-step names let one step's reduction be in flight while the
        # next is submitted; a 1024-step window bounds the name table
        step = self._step
        self._step = (self._step + 1) % 1024
        return step

    def zero_grad(self, set_to_none: bool = True):
        if self._count == 0:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)


class DistributedOptimizer(_Wrapper):
    """Wraps ``optimizer``; ``step()`` reduces every ``p.grad`` with ``op``
    (Average, Sum, ..., or Adasum) and then steps the wrapped optimizer.

    With ``backward_passes_per_step=k`` call ``step()`` after every backward
    pass: the first k-1 calls return without stepping and ``zero_grad()``
    leaves the gradients alone meanwhile, so autograd sums the k passes into
    ``p.grad``; the k-th call reduces that sum and steps."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = Average, compression=Compression.none,
                 backward_passes_per_step: int = 1):
        super().__init__(optimizer, compression, backward_passes_per_step)
        self.op = ReduceOp(op)

    def synchronize(self):
        """Reduce every ``p.grad`` in place (a no-op in a size-1 world)."""
        eng = _engine()
        if eng.backend.size() == 1:
            return
        params = self._params_with_grads()
        if not params:
            return
        packed = [self.compression.compress(p.grad) for p in params]
        step = self._next_step_name()
        if self.op == Adasum:
            # the coefficients are per tensor: one reduction per gradient
            handles = [adasum_allreduce_handle(eng, c,
                                               f"grad.adasum.s{step}.{i}")
                       for i, (c, _) in enumerate(packed)]
        else:
            handles = eng.grouped_allreduce([c for c, _ in packed],
                                            name=f"grad.s{step}", op=self.op)
        for p, (_, ctx), h in zip(params, packed, handles):
            g = self.compression.decompress(h.synchronize(), ctx)
            if g.dtype == p.grad.dtype and g.device == p.grad.device:
                # the reduced tensor becomes the gradient: no copy
                p.grad = g
            else:
                p.grad.copy_(g)

    def step(self, closure=None):
        if not self._due():
            return None
        self.synchronize()
        return self.optimizer.step(closure)


class DistributedDeltaAdasumOptimizer(_Wrapper):
    """Delta-model Adasum (Horovod's torch ``_DistributedAdasumOptimizer``):
    each ``step()`` stashes the parameters, runs the wrapped optimizer's
    step on the LOCAL gradients, Adasum-reduces each parameter's delta
    (new − stash) and sets the parameter to stash + reduced delta. The
    wrapped optimizer's state (AdamW's moments) advances from the local
    gradients. In a size-1 world it is exactly the wrapped step.

    The delta is a difference of fp32 parameters, so it differs from the
    update the optimizer computed by the rounding of (p + u) − p."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1):
        super().__init__(optimizer, compression, backward_passes_per_step)

    def step(self, closure=None):
        if not self._due():
            return None
        eng = _engine()
        if eng.backend.size() == 1:
            return self.optimizer.step(closure)
        params = self._params_with_grads()
        stash = [p.detach().clone() for p in params]
        loss = self.optimizer.step(closure)
        step = self._next_step_name()
        with torch.no_grad():
            pending = []
            for i, (p, s) in enumerate(zip(params, stash)):
                c, ctx = self.compression.compress(p - s)
                pending.append((adasum_allreduce_handle(
                    eng, c, f"delta.adasum.s{step}.{i}"), ctx))
            for p, s, (h, ctx) in zip(params, stash, pending):
                p.copy_(s.add_(self.compression.decompress(h.synchronize(),
                                                           ctx)))
        return loss
