"""Vision Transformer (ViT-B/16 style).

The port's counterpart of ``horovod_tpu/models/vit.py``: patchify, a class
token, learned position embeddings, pre-norm encoder blocks whose
non-causal attention is :func:`flash_attention_local` in the default
[B, T, H, D] layout (kernel K6 on the card; at 224 px T = 197, which is not
a multiple of K6's 64-row tiles), and a linear head on the class token.
bf16 compute on fp32 parameters, as the reference.

As in the flax model: LayerNorm has eps 1e-6; GELU is the tanh
approximation; the q/k/v/o projections have no bias (``DenseGeneral``
kernels [D, H, Dh] and [H, Dh, D]); the MLP and the head are biased.
Images are NHWC, as the port's ResNet takes them. The position embedding's
length is fixed by ``image_size`` at construction (flax infers it from the
first input). :func:`horovod_tpu_torch.models.convert.vit_from_flax`
carries the flax parameters over.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.flash_attention import flash_attention_local
from .resnet import _lecun_normal_


def _linear(d_in: int, d_out: int, generator) -> nn.Linear:
    """flax ``Dense``: lecun-normal kernel, zero bias."""
    lin = nn.Linear(d_in, d_out)
    _lecun_normal_(lin.weight, d_in, generator)
    nn.init.zeros_(lin.bias)
    return lin


def _dense_general(shape, fan_in: int, generator) -> nn.Parameter:
    w = nn.Parameter(torch.empty(*shape))
    _lecun_normal_(w, fan_in, generator)
    return w


def _norm(ln: nn.LayerNorm, x, dtype):
    """flax LayerNorm(dtype=...): statistics and affine in fp32, then the
    cast."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def _dense(lin: nn.Linear, x, dtype):
    return F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))


class EncoderBlock(nn.Module):
    def __init__(self, d: int, n_heads: int, d_ff: int, dtype, generator):
        super().__init__()
        dh = d // n_heads
        self.n_heads, self.dtype = n_heads, dtype
        self.ln1 = nn.LayerNorm(d, eps=1e-6)
        self.wq = _dense_general((d, n_heads, dh), d, generator)
        self.wk = _dense_general((d, n_heads, dh), d, generator)
        self.wv = _dense_general((d, n_heads, dh), d, generator)
        self.wo = _dense_general((n_heads, dh, d), d, generator)
        self.ln2 = nn.LayerNorm(d, eps=1e-6)
        self.fc1 = _linear(d, d_ff, generator)
        self.fc2 = _linear(d_ff, d, generator)

    def forward(self, x):
        b, t, d = x.shape
        dt, hd = self.dtype, self.wo.shape[0] * self.wo.shape[1]
        h = _norm(self.ln1, x, dt)
        q, k, v = ((h @ w.to(dt).reshape(d, hd)).view(b, t, self.n_heads, -1)
                   for w in (self.wq, self.wk, self.wv))
        att = flash_attention_local(q, k, v, causal=False)
        x = x + att.reshape(b, t, hd) @ self.wo.to(dt).reshape(hd, d)
        h = F.gelu(_dense(self.fc1, _norm(self.ln2, x, dt), dt),
                   approximate="tanh")
        return x + _dense(self.fc2, h, dt)


class ViT(nn.Module):
    """``forward`` takes (N, image_size, image_size, 3) images and returns
    fp32 logits. Parameters are made on the CPU from ``generator`` (a fresh
    seed-0 generator when None)."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 d_model: int = 768, n_layers: int = 12, n_heads: int = 12,
                 d_ff: int = 3072, dtype=torch.bfloat16,
                 image_size: int = 224,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.patch, self.dtype = patch, dtype
        self.patchify = nn.Conv2d(3, d_model, patch, stride=patch)
        _lecun_normal_(self.patchify.weight, 3 * patch * patch, generator)
        nn.init.zeros_(self.patchify.bias)
        tokens = (image_size // patch) ** 2 + 1
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos_embed = nn.Parameter(
            0.02 * torch.randn(1, tokens, d_model, generator=generator))
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, n_heads, d_ff, dtype, generator)
            for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=1e-6)
        self.head = _linear(d_model, num_classes, generator)

    def forward(self, images):
        dt = self.dtype
        b = images.shape[0]
        x = F.conv2d(images.permute(0, 3, 1, 2).to(dt),
                     self.patchify.weight.to(dt), self.patchify.bias.to(dt),
                     stride=self.patch)
        x = x.flatten(2).transpose(1, 2)            # [B, T, D], row-major
        x = torch.cat([self.cls.to(dt).expand(b, -1, -1), x], dim=1)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(
                f"{x.shape[1]} tokens, but the position embedding was made "
                f"for {self.pos_embed.shape[1]} (image_size at "
                "construction)")
        x = x + self.pos_embed.to(dt)
        for block in self.blocks:
            x = block(x)
        return _dense(self.head, _norm(self.ln_f, x, dt)[:, 0], dt).float()


ViT_B16 = partial(ViT, d_model=768, n_layers=12, n_heads=12, d_ff=3072)
ViT_S16 = partial(ViT, d_model=384, n_layers=12, n_heads=6, d_ff=1536)
ViT_Tiny = partial(ViT, d_model=64, n_layers=2, n_heads=4, d_ff=128, patch=8)
