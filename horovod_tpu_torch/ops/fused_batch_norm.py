"""Fused BatchNorm: one-launch statistics kernels + an explicit backward.

The port's counterpart of ``horovod_tpu/ops/fused_batch_norm.py``: the same
training math (:63-109) with use_fast_variance numerics
(var = E[x^2] - E[x]^2), the running-statistic EMA of flax (:152-157) and the
eval mode on running statistics (:142-148). The statistics passes are the
hand-written kernels of :mod:`horovod_tpu_torch.ops.kernels`, which also do
the per-channel math in their epilogue (:func:`~.kernels.bn_forward`: mean,
var, invstd, the affine's a and b and the EMA in place;
:func:`~.kernels.bn_backward`: dgamma, dbeta and dx's coefficients).

Backward (standard BatchNorm vjp):
    xh = (x - mu) * invstd
    dbeta = sum dy            dgamma = sum dy * xh
    dx = gamma * invstd * (dy - dbeta / M - xh * dgamma / M)
The cotangents of the returned mean and var are ignored: they feed the EMA
only.

The elementwise parts are plain PyTorch, computed in fp32 from the input
dtype (bf16, fp16 or fp32) as in the reference, with as few passes as eager
mode allows: the affine is one ``addcmul`` that reads x and writes y in its
dtype, and dx is three passes with one fp32 temporary. On the card a layer
issues 2 launches forward (K2, the affine) and 4 backward (K3, dx's three).

Layout: an NCHW activation must be ``channels_last`` so that its
``(M, C)`` view is contiguous; the kernels read that view with no copy.
"""

from __future__ import annotations

import torch
from torch import nn

from . import kernels


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The (M, C) view of an (M, C) or channels_last (N, C, H, W) tensor."""
    if x.dim() == 2:
        return x
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused batch norm takes (M, C) or channels_last "
                         f"(N, C, H, W) tensors; got shape {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    return x.permute(0, 2, 3, 1).view(-1, x.shape[1])


def _channel(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(C,) broadcast against ``like`` (channels on dim 1 of a 4-D tensor)."""
    return v.view(1, -1, 1, 1) if like.dim() == 4 else v


def _affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """x * a + b per channel, in fp32 (a, b are fp32), written in x's dtype
    in one pass (not differentiable: ``out=``)."""
    return torch.addcmul(_channel(b, x), x, _channel(a, x),
                         out=torch.empty_like(x))


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, running_mean=None,
                running_var=None, momentum: float = 0.9):
        stats = kernels.bn_forward(_rows(x), scale.float(), bias.float(), eps,
                                   running_mean, running_var, momentum)
        mean, var, invstd, a, b = stats.unbind(0)
        y = _affine(x, a, b)
        ctx.save_for_backward(x, scale, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        # no zero-filled cotangents for mean and var: two launches a layer
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, invstd = ctx.saved_tensors
        # autograd may hand over a gradient in another layout, or expanded:
        # the kernel reads the (M, C) view (no copy when it is one already)
        dy = (dy.contiguous(memory_format=torch.channels_last)
              if dy.dim() == 4 else dy.contiguous())
        coef = kernels.bn_backward(_rows(dy), _rows(x), mean, invstd,
                                   scale.float())
        dgamma, dbeta, a, c0, c1 = coef.unbind(0)
        # dx = a * (dy - k1 - (x - mean) * invstd * k2)
        #    = (x - mean) * (-a * invstd * k2) + (-a * k1) + a * dy
        u = torch.sub(x, _channel(mean, x))              # fp32
        torch.addcmul(_channel(c0, x), u, _channel(c1, x), out=u)
        dx = torch.addcmul(u, dy, _channel(a, x),
                           out=torch.empty_like(x))
        return (dx, dgamma.to(scale.dtype), dbeta.to(scale.dtype), None,
                None, None, None)


def batch_norm_train(x, scale, bias, eps: float, running_mean=None,
                     running_var=None, momentum: float = 0.9):
    """Training-mode batch norm over every axis but the channel axis.

    Returns ``(y, mean, var)``, mean and var in fp32 for the running-stat
    EMA; gradients flow through ``y`` only. When ``running_mean`` and
    ``running_var`` (fp32) are given they take flax's EMA in place
    (running = momentum * running + (1 - momentum) * batch)."""
    return _BatchNormTrain.apply(x, scale, bias, eps, running_mean,
                                 running_var, momentum)


class FusedBatchNorm(nn.Module):
    """Batch norm with the fused statistics kernels, flax semantics:
    ``momentum`` is the EMA's decay (running = momentum * running +
    (1 - momentum) * batch), the batch variance is the biased one, and
    training mode normalizes with batch statistics, eval mode with the
    running ones. ``dtype`` is the compute/output dtype (the input's when
    None); parameters and running statistics are fp32."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=None, zero_scale: bool = False,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        fill = 0.0 if zero_scale else 1.0
        self.weight = nn.Parameter(torch.full((num_features,), fill,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x):
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        if not self.training:
            invstd = torch.rsqrt(self.running_var + self.eps)
            a = self.weight.float() * invstd
            b = self.bias.float() - self.running_mean * a
            # differentiable: gradients may flow to weight and bias
            return torch.addcmul(_channel(b, x), x, _channel(a, x)).to(dtype)
        y, _, _ = batch_norm_train(x, self.weight, self.bias, self.eps,
                                   self.running_mean, self.running_var,
                                   self.momentum)
        return y
