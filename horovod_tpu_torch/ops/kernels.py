"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py``:

==========================  ==============================  ===============
TPU kernel (Pallas)         CUDA kernel (``csrc/``)         wrapper here
==========================  ==============================  ===============
``pack_pallas``             ``pack.cu``                     :func:`pack`
``bn_stats_pallas``         ``bn_stats.cu`` (forward)       :func:`bn_stats`
``bn_bwd_stats_pallas``     ``bn_stats.cu`` (backward)      :func:`bn_bwd_stats`
==========================  ==============================  ===============

Each wrapper takes its plain PyTorch version (``*_plain``, same module) for
a tensor that lies on the CPU, and only then. For a CUDA tensor it checks
device, dtype, shape and contiguity, launches the kernel on the current
stream, raises if the launch was refused, and adds one to its ``launches``
count. There is no fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

_THREADS = 256          # threads per block of the BN kernels (bn_stats.cu)
_BLOCKS_PER_SM = 8      # BN blocks resident per SM at 256 threads
_MIN_ROWS_PER_THREAD = 8


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _lib():
    from .build import library
    return library()


# ---------------------------------------------------------------------------
# K1: fusion-buffer pack
# ---------------------------------------------------------------------------


def pack_plain(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten and concatenate (the reference's ``build_pack``)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One-launch copy of ``tensors`` (one dtype, one device) into a new flat
    buffer at prefix-sum offsets; bitwise equal to :func:`pack_plain`."""
    if not tensors:
        raise ValueError("pack needs at least one tensor")
    dtype, device = tensors[0].dtype, tensors[0].device
    for t in tensors:
        if t.dtype != dtype or t.device != device:
            raise ValueError("pack takes tensors of one dtype on one device; "
                             f"got {t.dtype} on {t.device} beside {dtype} on "
                             f"{device}")
    if device.type == "cpu":
        return pack_plain(tensors)
    if device.type != "cuda":
        raise ValueError(f"pack: unsupported device {device}")
    for i, t in enumerate(tensors):
        if not t.is_contiguous():
            raise ValueError(f"pack: tensor {i} is not contiguous")
    lib = _lib()
    tile = lib.hvd_pack_tile_bytes()
    itemsize = tensors[0].element_size()
    rows, offset, tiles = [], 0, 0
    for t in tensors:
        nbytes = t.numel() * itemsize
        if nbytes:
            rows.append((t.data_ptr(), offset * itemsize, nbytes, tiles))
            tiles += -(-nbytes // tile)
        offset += t.numel()
    out = torch.empty(offset, dtype=dtype, device=device)
    if not rows:
        return out
    # one small asynchronous host-to-device copy of the table from pinned
    # memory; both caching allocators hold each buffer until the work on
    # this stream that reads it is done
    host = torch.empty((len(rows), 4), dtype=torch.int64, pin_memory=True)
    host.numpy()[:] = np.asarray(rows, dtype=np.uint64).view(np.int64)
    table = host.to(device, non_blocking=True)
    _check(lib.hvd_pack(device.index, table.data_ptr(), len(rows), tiles,
                        out.data_ptr(), _stream(device)), "pack")
    pack.launches += 1
    return out


pack.launches = 0


# ---------------------------------------------------------------------------
# K2/K3: BatchNorm statistics
# ---------------------------------------------------------------------------


def bn_stats_plain(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum, sum of squares) of (M, C) in fp32 (the reference's
    ``_stats`` fallback, fused_batch_norm.py:46-51)."""
    xf = x2d.float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_bwd_stats_plain(dy2d, x2d, mean, invstd):
    """Per-channel (sum(dy), sum(dy * xhat)) with xhat = (x - mean) * invstd
    (the reference's ``_bwd_stats`` fallback, fused_batch_norm.py:54-60)."""
    dyf = dy2d.float()
    xh = (x2d.float() - mean) * invstd
    return dyf.sum(0), (dyf * xh).sum(0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bn_chunks(m: int, c: int, itemsize: int, sms: int) -> int:
    """Row chunks of the split-M reduction: enough blocks for one full wave
    of ``_BLOCKS_PER_SM`` on every SM, but at least
    ``_MIN_ROWS_PER_THREAD`` rows for every thread."""
    vcols = c // (16 // itemsize)
    cols_per_block = min(vcols, _THREADS)
    rows_per_pass = _THREADS // cols_per_block
    col_tiles = -(-vcols // cols_per_block)
    want = -(-(_BLOCKS_PER_SM * sms) // col_tiles)
    most = -(-m // (rows_per_pass * _MIN_ROWS_PER_THREAD))
    return max(1, min(want, most))


def _check_bn_input(name: str, t: torch.Tensor, c: int, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {t.dtype} not supported "
                         "(bfloat16 or float32)")
    if t.dim() != 2 or t.shape[1] != c:
        raise ValueError(f"{name}: expected (M, {c}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the (M, C) view is not contiguous (an "
                         "NCHW activation must be channels_last)")
    vec = 16 // t.element_size()
    if c % vec or t.data_ptr() % 16:
        raise ValueError(f"{name}: C={c} must be a multiple of {vec} and the "
                         "data 16-byte aligned")


def bn_stats(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum, sum of squares) of an (M, C) activation, fp32 out,
    in one read of ``x2d``."""
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d)
    m, c = x2d.shape
    _check_bn_input("x", x2d, c, x2d.device)
    device = x2d.device
    chunks = bn_chunks(m, c, x2d.element_size(), _sm_count(device.index))
    partial = torch.empty(2 * chunks * c, dtype=torch.float32, device=device)
    s = torch.empty(c, dtype=torch.float32, device=device)
    q = torch.empty(c, dtype=torch.float32, device=device)
    _check(_lib().hvd_bn_stats(
        device.index, x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), m, c,
        chunks, partial.data_ptr(), s.data_ptr(), q.data_ptr(),
        _stream(device)), "bn_stats")
    bn_stats.launches += 1
    return s, q


bn_stats.launches = 0


def bn_bwd_stats(dy2d, x2d, mean, invstd):
    """Per-channel (sum(dy), sum(dy * (x - mean) * invstd)) in one read of
    ``dy2d`` and ``x2d``; ``mean``/``invstd`` are fp32 (C,)."""
    if x2d.device.type == "cpu":
        return bn_bwd_stats_plain(dy2d, x2d, mean, invstd)
    m, c = x2d.shape
    device = x2d.device
    _check_bn_input("x", x2d, c, device)
    _check_bn_input("dy", dy2d, c, device)
    if dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype:
        raise ValueError("dy and x must share shape and dtype")
    for name, v in (("mean", mean), ("invstd", invstd)):
        if v.shape != (c,) or v.dtype != torch.float32 or v.device != device \
                or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {device}")
    chunks = bn_chunks(m, c, x2d.element_size(), _sm_count(device.index))
    partial = torch.empty(2 * chunks * c, dtype=torch.float32, device=device)
    s1 = torch.empty(c, dtype=torch.float32, device=device)
    s2 = torch.empty(c, dtype=torch.float32, device=device)
    _check(_lib().hvd_bn_bwd_stats(
        device.index, dy2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(),
        invstd.data_ptr(), int(x2d.dtype == torch.bfloat16), m, c, chunks,
        partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), _stream(device)),
        "bn_bwd_stats")
    bn_bwd_stats.launches += 1
    return s1, s2


bn_bwd_stats.launches = 0


KERNELS = (pack, bn_stats, bn_bwd_stats)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
