"""Synchronized batch normalization across data-parallel ranks.

The port's counterpart of ``horovod_tpu/ops/sync_batch_norm.py``: the
batch statistics are those of the global batch, every rank's rows
together, so every rank normalizes alike. The reference sums (sum, sumsq,
count) with ``lax.psum`` inside an SPMD program and takes the gradient from
autodiff of the psums; here each rank is a process and the module holds
its own backward:

- forward: one launch of K2 in its raw mode (:func:`~.kernels.bn_stats`)
  gives this rank's per-channel (sum, sumsq); with the rank's row count
  they are one fp32 buffer, summed over the group by one
  ``torch.distributed.all_reduce`` on the current stream. Then mean, var =
  max(E[x²] − mean², 0), invstd = rsqrt(var + eps), flax's EMA of the
  running statistics (``momentum`` is the decay; the running var is the
  biased one) and the affine, one ``addcmul`` written in the output dtype;
- backward: one launch of K3 in its raw mode (:func:`~.kernels.bn_bwd_stats`)
  with the global mean and invstd gives (Σdy, Σdy·x̂); one all_reduce of
  the two gives dx = scale·invstd·(dy − ΣDy/M − x̂·ΣDyX̂/M) over the global
  M, in the three passes of ``fused_batch_norm``'s backward. dscale and
  dbias are this rank's own sums: the optimizer reduces them like any
  other gradient.

The per-channel math between the collectives runs on C-length vectors in
plain PyTorch: a training layer launches K2 once forward and K3 once
backward, and otherwise only small per-channel ops, the affine and dx's
three passes (``chip_smoke.py``'s phase 14 counts them). Nothing reads a
device value on the host.

The collectives are ``torch.distributed`` calls on the module's group
(the world when None), as torch's own ``SyncBatchNorm`` makes them, not
named engine collectives: like the reference's ``psum`` they belong to the
model's forward and backward, so they sit outside the engine's names and
outside ``join``. At size 1, or without a process group, the same code
runs and only the collective is skipped.

The row count rides in the fp32 buffer as m // 4096 and m % 4096, so the
sums of both are exact up to 2^36 global rows and the count is the nearest
fp32 to the exact total (exact up to 2^24).

Layout as ``FusedBatchNorm``'s: (M, C), or an NCHW activation in
``channels_last``, read as its (M, C) view with no copy.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch import nn

from . import kernels
from .fused_batch_norm import _channel, _rows

_COUNT_SPLIT = 4096     # the count's low slot holds m % 4096


def _group_size(group) -> int:
    """Ranks of ``group`` (the world when None); 1 without a process
    group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _sum_over(buf: torch.Tensor, group) -> torch.Tensor:
    """``buf`` summed over the group in place (skipped at size 1)."""
    if _group_size(group) > 1:
        dist.all_reduce(buf, group=group)
    return buf


def _global_stats(x2d: torch.Tensor, group):
    """(mean, var, count) of an (M, C) activation over the group: K2's raw
    sums of this rank's rows and its row count in one fp32 buffer, one
    all_reduce, then the per-channel math. count is a fp32 0-dim tensor."""
    m, c = x2d.shape
    buf = torch.empty(2 * c + 2, dtype=torch.float32, device=x2d.device)
    if m:
        torch.stack(kernels.bn_stats(x2d), out=buf[:2 * c].view(2, c))
    else:
        buf[:2 * c].zero_()
    buf[2 * c].fill_(m // _COUNT_SPLIT)
    buf[2 * c + 1].fill_(m % _COUNT_SPLIT)
    _sum_over(buf, group)
    count = torch.add(buf[2 * c + 1], buf[2 * c], alpha=_COUNT_SPLIT)
    mean = buf[:c] / count
    var = torch.addcmul(buf[c:2 * c] / count, mean, mean,
                        value=-1).clamp_min_(0.0)
    return mean, var, count


def sync_batch_stats(x: torch.Tensor, group=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (mean, var) per channel of ``x`` over every rank of ``group``
    (the world when None), var the biased one: the reference's
    ``sync_batch_stats``. ``x`` is (M, C) or channels_last NCHW. No
    gradient flows through it (the module's backward is its own)."""
    with torch.no_grad():
        mean, var, _ = _global_stats(_rows(x), group)
    return mean, var


class _SyncBatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, running_mean, running_var,
                momentum: float, group, out_dtype):
        rows = _rows(x)
        c = rows.shape[1]
        mean, var, count = _global_stats(rows, group)
        invstd = torch.add(var, eps).rsqrt_()
        a = invstd if scale is None else scale.float() * invstd
        b = (-mean * a if bias is None
             else torch.addcmul(bias.float(), mean, a, value=-1))
        if running_mean is not None:
            running_mean.mul_(momentum).add_(mean, alpha=1 - momentum)
            running_var.mul_(momentum).add_(var, alpha=1 - momentum)
        y = torch.addcmul(_channel(b, x), x, _channel(a, x),
                          out=torch.empty_like(x, dtype=out_dtype))
        ctx.save_for_backward(x, mean, invstd, a, count)
        ctx.group = group
        ctx.channels = c
        ctx.has_scale, ctx.has_bias = scale is not None, bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, a, count = ctx.saved_tensors
        # autograd may hand over a gradient in another layout or dtype, or
        # expanded: K3 reads the (M, C) view of dy in x's dtype
        dy = dy.to(x.dtype)
        dy = (dy.contiguous(memory_format=torch.channels_last)
              if dy.dim() == 4 else dy.contiguous())
        c = ctx.channels
        if x.numel():
            local = torch.stack(kernels.bn_bwd_stats(_rows(dy), _rows(x),
                                                     mean, invstd))
        else:
            local = torch.zeros(2, c, dtype=torch.float32, device=x.device)
        dbias, dscale = local.unbind(0)
        k1, k2 = (_sum_over(local.clone(), ctx.group) / count).unbind(0)
        # dx = a * (dy - k1 - (x - mean) * invstd * k2)
        #    = (x - mean) * (-a * invstd * k2) + (-a * k1) + a * dy
        neg_a = -a
        c0 = neg_a * k1
        c1 = neg_a * invstd * k2
        u = torch.sub(x, _channel(mean, x))              # fp32
        torch.addcmul(_channel(c0, x), u, _channel(c1, x), out=u)
        dx = torch.addcmul(u, dy, _channel(a, x), out=torch.empty_like(x))
        return (dx, dscale if ctx.has_scale else None,
                dbias if ctx.has_bias else None, None, None, None, None,
                None, None)


class SyncBatchNorm(nn.Module):
    """Batch norm whose training statistics are those of the global batch
    over ``group`` (the world when None): the reference's
    ``SyncBatchNorm``, on the K2/K3 kernels' raw sums and one all_reduce
    each way. flax semantics as :class:`FusedBatchNorm`'s: ``momentum`` is
    the EMA's decay, the running var is the biased one, eval mode
    normalizes with the running statistics. ``dtype`` is the output dtype
    (the input's when None); the statistics are fp32 sums of the input as
    given. ``use_scale`` / ``use_bias`` keep the reference's names; the
    parameters (``weight``, ``bias``) and running statistics are fp32."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=None, use_bias: bool = True,
                 use_scale: bool = True, group=None, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.use_bias = use_bias
        self.use_scale = use_scale
        self.group = group
        self.weight = (nn.Parameter(torch.ones(num_features, device=device))
                       if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, device=device))
                     if use_bias else None)
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x):
        dtype = self.dtype or x.dtype
        if not self.training:
            a = torch.rsqrt(self.running_var + self.eps)
            if self.weight is not None:
                a = self.weight.float() * a
            b = -self.running_mean * a
            if self.bias is not None:
                b = self.bias.float() + b
            # differentiable: gradients may flow to weight and bias
            return torch.addcmul(_channel(b, x), x, _channel(a, x)).to(dtype)
        return _SyncBatchNormTrain.apply(
            x, self.weight, self.bias, self.eps, self.running_mean,
            self.running_var, self.momentum, self.group, dtype)
