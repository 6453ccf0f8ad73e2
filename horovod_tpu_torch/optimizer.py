"""Distributed optimizer: gradient allreduce around a ``torch.optim.Optimizer``.

The port's counterpart of ``horovod_tpu/optimizer.py``'s
``DistributedEagerOptimizer`` (:458-949) in the shape of Horovod's torch
frontend: ``step()`` grouped-allreduces every ``p.grad`` through the engine's
fused, bucketed path, then runs the wrapped optimizer's step. Like the
reference it adds no backward hooks, sums (not averages) gradients over
``backward_passes_per_step`` local passes, and skips the engine entirely in a
size-1 world.

    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.01, momentum=0.9))
    for batch in data:
        opt.zero_grad()
        loss_fn(model, batch).backward()
        opt.step()
"""

from __future__ import annotations

from typing import List

import torch

from .common.reduce_ops import Adasum, Average, ReduceOp
from .core.state import engine as _engine
from .ops.compression import Compression


class DistributedOptimizer:
    """Wraps ``optimizer``; attributes it does not define (``param_groups``,
    ``state``, ``defaults``, ...) are the wrapped optimizer's.

    With ``backward_passes_per_step=k`` call ``step()`` after every backward
    pass: the first k-1 calls return without stepping and ``zero_grad()``
    leaves the gradients alone meanwhile, so autograd sums the k passes into
    ``p.grad``; the k-th call reduces that sum and steps."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = Average, compression=Compression.none,
                 backward_passes_per_step: int = 1):
        if op == Adasum:
            raise NotImplementedError(
                "Adasum is not ported to horovod_tpu_torch yet")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.op = ReduceOp(op)
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

    def synchronize(self):
        """Allreduce every ``p.grad`` in place (a no-op in a size-1 world)."""
        eng = _engine()
        if eng.backend.size() == 1:
            return
        params = self._params_with_grads()
        if not params:
            return
        packed = [self.compression.compress(p.grad) for p in params]
        # per-step names let one step's reduction be in flight while the
        # next is submitted; a 1024-step window bounds the name table
        handles = eng.grouped_allreduce([c for c, _ in packed],
                                        name=f"grad.s{self._step}",
                                        op=self.op)
        self._step = (self._step + 1) % 1024
        for p, (_, ctx), h in zip(params, packed, handles):
            g = self.compression.decompress(h.synchronize(), ctx)
            if g.dtype == p.grad.dtype and g.device == p.grad.device:
                # the reduced view becomes the gradient: no copy
                p.grad = g
            else:
                p.grad.copy_(g)

    def step(self, closure=None):
        if self.backward_passes_per_step > 1:
            self._count += 1
            if self._count < self.backward_passes_per_step:
                return None
            self._count = 0
        self.synchronize()
        return self.optimizer.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        if self._count == 0:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)
