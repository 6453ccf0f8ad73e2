"""Gradient compression for the optimizer's ``compression=`` argument
(parity: horovod/torch/compression.py; the ``none``/``fp16`` part of
``horovod_tpu/ops/compression.py``). The engine's wire codecs are not ported
yet."""

from __future__ import annotations

import torch


class Compressor:
    """compress returns (compressed_tensor, ctx); decompress inverts."""

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


class FP16Compressor(Compressor):
    """Float tensors travel as fp16 and are restored to their dtype after;
    other tensors travel untouched."""

    @staticmethod
    def compress(tensor):
        if tensor.is_floating_point():
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    """Optional gradient compression used during allreduce (reference
    naming)."""

    none = NoneCompressor
    fp16 = FP16Compressor
