"""Flash attention for the single-device (non-sequence-parallel) path.

The port's counterpart of ``horovod_tpu/parallel/flash_attention.py``
(:189-228): :func:`flash_attention_local` computes causal or full softmax
attention with scale 1/sqrt(D) through kernel K6 (the online-softmax
forward, ``csrc/flash_fwd_sm90.cu``, and a backward of three launches
under the saved lse, ``csrc/flash_bwd_sm90.cu``: TMA and wgmma at every
head dim and dtype, fp32 on tf32: ``ops.kernels.flash_route``). On a CUDA
tensor it always launches K6, in both layouts, for what the reference
computes: bf16, fp16 or fp32 inputs, any head dim (the Hopper kernels are
built for 64, 128, 192 and 256, the forward also for 320, 384 and 512,
and one forward, dk/dv and dq kernel for every multiple of 64 above
those, and read a head dim below their instance's in place, the columns
past it as zeros: ``ops.kernels.flash_needs_copy``), and
q and k/v of any lengths >= 1, different ones
included (causal: key <= query by absolute index, the library kernel's
rule). On a CPU tensor it runs K6's plain PyTorch versions, which
agree with :func:`horovod_tpu_torch.parallel.ring_attention.local_attention`,
the reference's CPU path.

Three rules of the reference do not carry over, because they are rules of
the TPU and its kernels, not of the function:

- the choice between the splash and the flash kernel, and the VMEM
  estimator behind it (:81-165; knobs ``HOROVOD_SPLASH``,
  ``HOROVOD_SPLASH_VMEM_LIMIT``, ``HOROVOD_SPLASH_BLOCK_KV``): there is one
  kernel here, and no VMEM scope to overflow;
- ``under_remat``, which only fed that choice: it is accepted and ignored;
- the route of sequence lengths that are not multiples of 128 to the
  materialized attention (:203-213), which exists because the TPU kernel's
  block verifier refuses them. K6 masks its tail tiles, so ViT's T = 197
  runs the same kernel.
"""

from __future__ import annotations

import math

import torch

from ..ops import kernels as K


class _FlashAttention(torch.autograd.Function):
    """K6 on [B, H, T, D] views: the forward saves (q, k, v, o, lse); the
    backward is di, then dk/dv, then dq."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = K.flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.is_cuda:
            do = K.flash_grad_in(do, "flash_bwd_dkdv")
        di = K.flash_bwd_pre(o, do)
        dk, dv = K.flash_bwd_dkdv(q, k, v, do, lse, di, ctx.causal,
                                  ctx.scale)
        dq = K.flash_bwd_dq(q, k, v, do, lse, di, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_local(q, k, v, causal: bool = True,
                          layout: str = "bthk",
                          under_remat: bool = False):
    """Attention of q, k, v laid out as ``layout``: "bthk" ([B, T, H, D],
    the framework's default) or "bhtk" ([B, H, T, D], the kernel's own
    order, which callers that project straight into it use). The result has
    the same layout. Neither layout is copied: the kernel takes strides.
    ``under_remat`` is accepted for the reference's signature and ignored
    (see the module docstring)."""
    del under_remat
    if layout not in ("bthk", "bhtk"):
        raise ValueError(f"unknown attention layout {layout!r}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    if layout == "bthk":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    out = _FlashAttention.apply(q, k, v, causal, scale)
    return out.transpose(1, 2) if layout == "bthk" else out
