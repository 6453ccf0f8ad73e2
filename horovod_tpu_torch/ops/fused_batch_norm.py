"""Fused BatchNorm: one-pass statistics kernels + an explicit backward.

The port's counterpart of ``horovod_tpu/ops/fused_batch_norm.py``: the same
training math (:63-109) with use_fast_variance numerics
(var = E[x^2] - E[x]^2), the running-statistic EMA of flax (:152-157) and the
eval mode on running statistics (:142-148). The two statistics passes are the
hand-written kernels of :mod:`horovod_tpu_torch.ops.kernels`.

Backward (standard BatchNorm vjp):
    xh = (x - mu) * invstd
    dbeta = sum dy            dgamma = sum dy * xh
    dx = gamma * invstd * (dy - dbeta / M - xh * dgamma / M)
The two reductions are one kernel pass over (dy, x). The cotangents of the
returned mean and var are ignored: they feed the EMA only.

The elementwise parts are plain PyTorch, computed in fp32 from the bf16
tensors as in the reference, with as few passes as eager mode allows: the
affine is one ``addcmul`` that reads x and writes y in its dtype, and dx is
three passes with one fp32 temporary.

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
    def forward(ctx, x, scale, bias, eps: float):
        x2d = _rows(x)
        m = x2d.shape[0]
        s, q = kernels.bn_stats(x2d)
        mean = s / m
        var = torch.clamp(q / m - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        a = scale.float() * invstd
        b = bias.float() - mean * a
        y = _affine(x, a, b)
        ctx.save_for_backward(x, scale, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, invstd = ctx.saved_tensors
        x2d = _rows(x)
        m = x2d.shape[0]
        s1, s2 = kernels.bn_bwd_stats(_rows(dy), x2d, mean, invstd)
        k1 = s1 / m
        k2 = s2 / m
        a = scale.float() * invstd
        # dx = a * (dy - k1 - (x - mean) * invstd * k2)
        #    = (x - mean) * (-a * invstd * k2) + (-a * k1) + a * dy
        u = torch.sub(x, _channel(mean, x))              # fp32
        torch.addcmul(_channel(-a * k1, x), u, _channel(-a * invstd * k2, x),
                      out=u)
        dx = torch.addcmul(u, dy, _channel(a, x),
                           out=torch.empty_like(x))
        return dx, s2.to(scale.dtype), s1.to(scale.dtype), None


def batch_norm_train(x, scale, bias, eps: float):
    """Training-mode batch norm over every axis but the channel axis.

    Returns ``(y, mean, var)``, mean and var in fp32 for the running-stat
    EMA; gradients flow through ``y`` only."""
    return _BatchNormTrain.apply(x, scale, bias, eps)


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
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            mom = self.momentum
            self.running_mean.copy_(mom * self.running_mean + (1 - mom) * mean)
            self.running_var.copy_(mom * self.running_var + (1 - mom) * var)
        return y
