"""Gradient compression: the optimizer's compressors and the engine's wire
codecs (the port of ``horovod_tpu/ops/compression.py``).

Two surfaces, as in the reference:

1. The Horovod-parity :class:`Compression` compressors the optimizers
   take. ``none``, ``fp16`` and ``bf16`` cast float tensors around the
   collective (parity: horovod/torch/compression.py). ``fp8`` and ``int8``
   carry ``wire_codec`` instead: they leave the tensor as it is and select
   the engine's wire codec, which encodes each fusion bucket inside the
   collective with an error-feedback residual (``core/engine.py``).
2. The codec arithmetic the collectives run (the reference's :51-171):
   :func:`encode`, :func:`decode`, :func:`decode_sum`, :func:`ef_encode`
   (quantize(g + r) with the quantization error carried forward), the
   in-place :func:`ef_encode_` the engine's buffers use, and the helpers
   the engine and replay share (:func:`resolve_codec`,
   :func:`wire_itemsize`).

Codecs:

- ``none``: identity.
- ``bf16``: cast to bfloat16 on the wire (2 bytes an element), summed in
  float32 after. No residual.
- ``fp8``: scale to float8_e4m3's range (448) and cast (1 byte); error
  feedback. Demoted to ``int8`` with a one-time warning where torch has no
  ``torch.float8_e4m3fn``.
- ``int8``: symmetric per-buffer linear quantization (scale amax/127,
  round half to even, clipped to ±127; 1 byte); error feedback.

The reference's codec is jnp that XLA compiles into its collective
programs; here it is PyTorch ops on either device, in the arithmetic of
those programs: XLA turns the scale's divide by the codec's range into a
multiply by its float32 reciprocal, encodes a bfloat16 bucket's ``g + r``
from its float32 sum, and fuses a float32 residual's multiply and
subtract into one rounding (the exact ``y - q * scale``, computed here in
float64, where it is exact: ``q * scale`` has at most 31 significant bits
and the difference is at most half a step). Every scale
is a (1,) device tensor: nothing here reads a value on the host, so the
codec legs run inside a CUDA graph and add no host wait.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("horovod_tpu_torch")

CODEC_NONE = "none"
CODEC_BF16 = "bf16"
CODEC_FP8 = "fp8"
CODEC_INT8 = "int8"
CODECS = (CODEC_NONE, CODEC_BF16, CODEC_FP8, CODEC_INT8)
# the error-feedback codecs: a rank-local residual buffer a fusion bucket is
# added back before quantization and carries the quantization error forward
EF_CODECS = (CODEC_FP8, CODEC_INT8)

_FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)
_FP8_MAX = 448.0
_INT8_MAX = 127.0
# the float32 reciprocals of the ranges: the scale is amax times them
_INV_RANGE = {CODEC_INT8: float(np.float32(1.0 / _INT8_MAX)),
              CODEC_FP8: float(np.float32(1.0 / _FP8_MAX))}

_warned_codec: set = set()


def _warn_once(key, msg):
    if key not in _warned_codec:
        _warned_codec.add(key)
        logger.warning(msg)


def wire_itemsize(codec: str, itemsize: int) -> int:
    """Bytes an element a codec puts on the wire (``itemsize`` is the
    uncompressed element size)."""
    if codec == CODEC_BF16:
        return min(2, itemsize)
    if codec in (CODEC_FP8, CODEC_INT8):
        return 1
    return itemsize


def resolve_codec(codec: str, dtype: torch.dtype) -> str:
    """The codec of a bucket of ``dtype`` under the call's ``codec``,
    deterministic in both so every rank resolves the same program:
    non-float buckets are never quantized, ``bf16`` on a 16-bit float
    bucket is ``none``, and ``fp8`` is ``int8`` (with one warning) where
    torch has no float8 dtype."""
    if codec not in CODECS or codec == CODEC_NONE:
        return CODEC_NONE
    if not dtype.is_floating_point:
        return CODEC_NONE
    if codec == CODEC_BF16:
        return CODEC_NONE if dtype.itemsize <= 2 else CODEC_BF16
    if codec == CODEC_FP8 and _FP8_DTYPE is None:
        _warn_once(("fp8",),
                   "fp8 wire codec requested but this torch has no "
                   "float8_e4m3fn dtype; using int8 (same wire bytes)")
        return CODEC_INT8
    return codec


def encode(x: torch.Tensor, codec: str
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode a flat float buffer for the wire: ``(payload, scale)``, the
    scale a (1,) float32 tensor for the quantizing codecs (symmetric, one a
    buffer: max(amax, 1e-30) over the codec's range) and None for
    ``bf16``."""
    if codec == CODEC_BF16:
        return x.to(torch.bfloat16), None
    if codec in EF_CODECS:
        xf = x.float()
        scale = (torch.clamp_min(xf.abs().max(), 1e-30)
                 * _INV_RANGE[codec]).reshape(1)
        y = xf / scale
        if codec == CODEC_INT8:
            # torch.round rounds half to even, as jnp.round does
            return y.round_().clamp_(-_INT8_MAX, _INT8_MAX).to(
                torch.int8), scale
        return y.to(_FP8_DTYPE), scale
    raise ValueError(f"unknown wire codec {codec!r}")


def decode(payload: torch.Tensor, scale: Optional[torch.Tensor], codec: str,
           out_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`encode` for one contribution."""
    if codec == CODEC_BF16:
        return payload.to(out_dtype)
    return (payload.float() * scale).to(out_dtype)


def decode_sum(payloads: torch.Tensor, scales: Optional[torch.Tensor],
               codec: str, out_dtype: torch.dtype,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode the ``(k, elems)`` encoded contributions, each with its
    sender's scale (``scales``: k of them), and sum them in float32: the
    receive side of the compressed exchange. With ``out``, the sum is cast
    into it."""
    if codec == CODEC_BF16:
        total = payloads.float().sum(0)
    else:
        total = (payloads.float() * scales.reshape(-1, 1)).sum(0)
    if out is None:
        return total.to(out_dtype)
    return out.copy_(total)


def _encoded_sum(x: torch.Tensor, residual: Optional[torch.Tensor],
                 y: torch.Tensor) -> torch.Tensor:
    """What the encode reads of ``y = x + residual``: ``y``, but for a
    bfloat16 bucket the float32 sum, as the reference's program holds it
    (XLA's CPU backend computes bfloat16 in float32 and, with its default
    excess precision, does not round that sum back before the encode)."""
    if x.dtype == torch.bfloat16 and residual is not None:
        return x.float() + residual.float()
    return y


def _residual(y: torch.Tensor, payload: torch.Tensor, scale: torch.Tensor,
              codec: str) -> torch.Tensor:
    """``y - decode(payload)``: for a float32 ``y`` rounded once from the
    exact difference (XLA's fused multiply-subtract), else in ``y``'s
    dtype."""
    if y.dtype == torch.float32:
        exact = y.double().sub_(payload.double().mul_(scale.double()))
        return exact.float()
    return y - decode(payload, scale, codec, y.dtype)


def ef_encode(x: torch.Tensor, residual: Optional[torch.Tensor], codec: str):
    """Error-feedback encode: quantize ``x + residual`` and return
    ``(payload, scale, new_residual)`` with ``new_residual = (x + r) -
    decode(payload)`` (EF-SGD: the compression error telescopes across
    steps instead of compounding). ``residual=None`` is a fresh buffer of
    zeros; a codec without error feedback returns no residual."""
    if codec not in EF_CODECS:
        payload, scale = encode(x, codec)
        return payload, scale, None
    y = x if residual is None else x + residual.to(x.dtype)
    payload, scale = encode(_encoded_sum(x, residual, y), codec)
    return payload, scale, _residual(y, payload, scale, codec)


def ef_encode_(x: torch.Tensor, residual: Optional[torch.Tensor],
               codec: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`ef_encode` on the engine's buffers, bitwise the same: the
    residual is added into ``x`` in place and the new residual written
    into ``residual`` in place (its address never moves, so a captured
    program carries it). Returns ``(payload, scale)``. With ``residual``
    None nothing is carried."""
    if codec not in EF_CODECS or residual is None:
        return encode(x, codec)
    enc = _encoded_sum(x, residual, None)
    y = x.add_(residual)
    payload, scale = encode(y if enc is None else enc, codec)
    residual.copy_(_residual(y, payload, scale, codec))
    return payload, scale


# ---------------------------------------------------------------------------
# Horovod-parity compressor surface
# ---------------------------------------------------------------------------


class Compressor:
    """compress returns (compressed_tensor, ctx); decompress inverts.
    ``wire_codec`` (None here) marks the engine's codecs: such a compressor
    leaves the tensor as it is and the engine encodes the collective's
    payload instead."""

    wire_codec = None

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Float tensors travel as ``wire_dtype`` and are restored to their
    dtype after; other tensors travel untouched, with ``ctx=None``."""

    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 keeps fp32's range and halves the bytes."""
    wire_dtype = torch.bfloat16


class _WireCodecCompressor(NoneCompressor):
    """The engine's codecs: compress and decompress are the identity (the
    codec sits inside the collective, its residual in engine state keyed
    by fusion bucket)."""


class FP8Compressor(_WireCodecCompressor):
    """Error-feedback fp8 (e4m3) wire codec: 4x fewer bytes on the encoded
    leg of fp32 gradients."""
    wire_codec = CODEC_FP8


class Int8Compressor(_WireCodecCompressor):
    """Error-feedback symmetric int8 wire codec."""
    wire_codec = CODEC_INT8


class Compression:
    """Optional gradient compression used during allreduce (reference
    naming)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    fp8 = FP8Compressor
    int8 = Int8Compressor
