"""ResNet-v1.5 family (ResNet-50 is the benchmark model).

The port's counterpart of ``horovod_tpu/models/resnet.py``, the same network:
bottleneck blocks, flax's "SAME" padding (asymmetric for stride 2), compute
in ``dtype`` (bf16 by default) with fp32 parameters and statistics, and the
``fused_bn`` switch between :class:`FusedBatchNorm` (the BN-statistics
kernels) and ``nn.BatchNorm2d``. The public call takes NHWC images, as the
reference does; inside, activations are NCHW tensors in ``channels_last``
memory, which is the same NHWC layout and what the BN kernels read with no
copy.

Module names follow the reference's parameter tree so that
:func:`horovod_tpu_torch.models.convert.resnet_from_flax` is a renaming.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_batch_norm import FusedBatchNorm


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]):
    # flax's default kernel init: truncated normal (2 sigma) of variance
    # 1/fan_in, the stddev corrected for the truncation
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


class Conv(nn.Module):
    """Bias-free convolution with flax's padding rule, computing in
    ``dtype`` on an fp32 (O, I, kH, kW) weight."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding=None, dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, \
            dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        _lecun_normal_(self.weight, cin * k * k, generator)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.padding is not None:
            pad = self.padding
        else:
            ph = _same_pads(x.shape[2], self.k, self.stride)
            pw = _same_pads(x.shape[3], self.k, self.stride)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
                pad = 0
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=pad)


def _norm(c: int, fused: bool, dtype, zero_scale: bool = False):
    if fused:
        return FusedBatchNorm(c, momentum=0.9, eps=1e-5, dtype=dtype,
                              zero_scale=zero_scale)
    bn = _BatchNorm(c, eps=1e-5, momentum=0.1, dtype=dtype)
    if zero_scale:
        nn.init.zeros_(bn.weight)
    return bn


class _BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` computing in ``dtype`` with fp32 parameters (the
    unfused ``fused_bn=False`` path; torch's momentum convention)."""

    def __init__(self, c, eps, momentum, dtype):
        super().__init__(c, eps=eps, momentum=momentum)
        self.compute_dtype = dtype

    def forward(self, x):
        return super().forward(x.float()).to(self.compute_dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, dtype,
                 fused_bn: bool, generator=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, generator=generator)
        self.conv0 = conv(cin, filters, 1)
        self.norm0 = _norm(filters, fused_bn, dtype)
        self.conv1 = conv(filters, filters, 3, stride)
        self.norm1 = _norm(filters, fused_bn, dtype)
        self.conv2 = conv(filters, filters * 4, 1)
        self.norm2 = _norm(filters * 4, fused_bn, dtype, zero_scale=True)
        self.has_proj = cin != filters * 4 or stride != 1
        if self.has_proj:
            self.conv_proj = conv(cin, filters * 4, 1, stride)
            self.norm_proj = _norm(filters * 4, fused_bn, dtype)

    def forward(self, x):
        residual = x
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.relu(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        if self.has_proj:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet-v1.5. ``forward`` takes (N, H, W, 3) images and returns fp32
    logits; ``model.train()``/``model.eval()`` select batch or running BN
    statistics. Parameters are made on the CPU from ``generator`` (a fresh
    seed-0 generator when None); move the model with ``.to(device)``."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16,
                 fused_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype,
                              generator=generator)
        self.bn_init = _norm(num_filters, fused_bn, dtype)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(cin, filters, stride, dtype,
                                              fused_bn, generator))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(cin, num_classes)
        _lecun_normal_(self.fc.weight, cin, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, images):
        # NHWC in memory is NCHW in channels_last: a free permute
        x = images.permute(0, 3, 1, 2).to(
            self.dtype, memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        ph = _same_pads(x.shape[2], 3, 2)
        pw = _same_pads(x.shape[3], 3, 2)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
        x = F.max_pool2d(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        x = F.linear(x, self.fc.weight.to(self.dtype),
                     self.fc.bias.to(self.dtype))
        return x.float()


ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
# Tiny variant for tests
ResNet18ish = partial(ResNet, stage_sizes=[1, 1, 1, 1], num_filters=16)
