"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py``:

=========================  =====================  ========================
TPU kernel (Pallas)        CUDA (``csrc/``)       wrapper here
=========================  =====================  ========================
``pack_pallas``            ``pack.cu``            :func:`pack`
``bn_stats_pallas``        ``bn_stats.cu``        :func:`bn_stats`
``bn_bwd_stats_pallas``    ``bn_stats.cu``        :func:`bn_bwd_stats`
``_triple_kernel``         ``adasum.cu``          :func:`adasum_triple`
``_scale_kernel``          ``adasum.cu``          :func:`adasum_scale`
jax's flash forward        ``flash_fwd_sm90.cu``  :func:`flash_fwd`
jax's flash backward       ``flash_bwd_sm90.cu``  :func:`flash_bwd_pre`,
                                                  :func:`flash_bwd_dkdv`,
                                                  :func:`flash_bwd_dq`
``_seg_fwd_pallas``        ``flash_fwd_sm90.cu``  :func:`flash_seg_fwd`
``_seg_bwd_pallas``        ``flash_bwd_sm90.cu``  :func:`flash_seg_bwd_dkdv`,
                                                  :func:`flash_seg_bwd_dq`
=========================  =====================  ========================

The attention kernels take bf16 and fp16 on the Hopper kernels above and
fp32 on ``flash_attn.cu``'s tf32 family (which also holds di and the C
entry points).

Each wrapper takes its plain PyTorch version (``*_plain``, same module) for
a tensor that lies on the CPU, and only then. For a CUDA tensor it checks
device, dtype, shape and contiguity, launches the kernel on the current
stream, raises if the launch was refused, and adds one to its ``launches``
count. There is no fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
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


# ---------------------------------------------------------------------------
# K4/K5: Adasum's pairwise combine
# ---------------------------------------------------------------------------
#
# K4 gives the fp32 triple [a·b, |a|², |b|²] of two same-shape tensors, K5
# the combine ca·a + cb·b from that triple (ca = 1 − a·b / (2|a|²), 0 when
# |a|² = 0, cb likewise) in the input dtype. The triple stays on the device
# between the two, so a collective can sum it over a group first (the
# sharded combine). Both are swap-symmetric bit for bit: triple(b, a) is
# triple(a, b) with its norms swapped, and scale(swapped triple, b, a) is
# scale(triple, a, b).

ADASUM_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ADASUM_THREADS = 256        # threads per block of adasum.cu's kernels
_ADASUM_TRIPLE_BLOCKS_PER_SM = 4
_ADASUM_SCALE_BLOCKS_PER_SM = 8


def adasum_triple_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 [a·b, |a|², |b|²] (the reference's ``_triple_kernel``)."""
    af, bf = a.float(), b.float()
    return torch.stack([(af * bf).sum(), (af * af).sum(), (bf * bf).sum()])


def _adasum_coefficients(triple: torch.Tensor):
    dot, na, nb = triple.unbind()
    ca = torch.where(na == 0, 0.0, 1 - dot / (2 * torch.where(na == 0, 1.0,
                                                               na)))
    cb = torch.where(nb == 0, 0.0, 1 - dot / (2 * torch.where(nb == 0, 1.0,
                                                               nb)))
    return ca, cb


def adasum_scale_plain(triple: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """ca·a + cb·b in fp32, in ``a``'s dtype (the reference's
    ``_scale_kernel`` with its coefficients)."""
    ca, cb = _adasum_coefficients(triple)
    return (ca * a.float() + cb * b.float()).to(a.dtype)


def _check_adasum(named, shape):
    """Raise on what K4/K5 do not take; return (device, dtype code)."""
    device, dtype = named[0][1].device, named[0][1].dtype
    for name, t in named:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"adasum: {name} is on {t.device}, expected "
                             f"{device} (a CUDA device)")
        if t.dtype not in ADASUM_DTYPES or t.dtype != dtype:
            raise ValueError(f"adasum: {name} is {t.dtype}; the kernels take "
                             "float32, bfloat16 or float16, one dtype for "
                             "both operands")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"adasum: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"adasum: {name} is not contiguous")
    if not math.prod(shape):
        raise ValueError("adasum: the operands are empty")
    return device, ADASUM_DTYPES[dtype]


def _adasum_blocks(device, groups: int, per_sm: int) -> int:
    return max(1, min(groups, per_sm * _sm_count(device.index)))


def _aligned(*ts) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def adasum_triple(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 [a·b, |a|², |b|²] of two same-shape contiguous tensors in one
    read of each (K4); deterministic and swap-symmetric bit for bit."""
    if a.device.type == "cpu":
        return adasum_triple_plain(a, b)
    device, code = _check_adasum((("a", a), ("b", b)), a.shape)
    n = a.numel()
    vec = 16 // a.element_size()
    blocks = _adasum_blocks(device, -(-n // (vec * _ADASUM_THREADS * 4)),
                            _ADASUM_TRIPLE_BLOCKS_PER_SM)
    partial = torch.empty(3 * blocks, dtype=torch.float32, device=device)
    triple = torch.empty(3, dtype=torch.float32, device=device)
    _check(_lib().hvd_adasum_triple(
        device.index, a.data_ptr(), b.data_ptr(), code, n, _aligned(a, b),
        blocks, partial.data_ptr(), triple.data_ptr(), _stream(device)),
        "adasum_triple")
    adasum_triple.launches += 1
    return triple


adasum_triple.launches = 0


def adasum_scale(triple: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """A new tensor ca·a + cb·b (K5), with the coefficients computed on the
    card from the fp32 ``triple`` in device memory: no host round trip."""
    if a.device.type == "cpu":
        return adasum_scale_plain(triple, a, b)
    device, code = _check_adasum((("a", a), ("b", b)), a.shape)
    if triple.dtype != torch.float32 or tuple(triple.shape) != (3,) \
            or triple.device != device or not triple.is_contiguous():
        raise ValueError(f"adasum: the triple must be a contiguous float32 "
                         f"(3,) tensor on {device}")
    out = torch.empty_like(a)
    n = a.numel()
    vec = 16 // a.element_size()
    blocks = _adasum_blocks(device, -(-(n // vec) // _ADASUM_THREADS),
                            _ADASUM_SCALE_BLOCKS_PER_SM)
    _check(_lib().hvd_adasum_scale(
        device.index, triple.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), code, n, _aligned(a, b, out), blocks,
        _stream(device)), "adasum_scale")
    adasum_scale.launches += 1
    return out


adasum_scale.launches = 0


# ---------------------------------------------------------------------------
# K6: flash attention, forward and backward
# ---------------------------------------------------------------------------
#
# Every tensor is a [B, H, T, D] view with any strides for B, H and T (a
# [B, T, H, D] tensor transposed is taken as it is): q and do of Tq rows, k
# and v of Tk rows, all of one dtype (bf16, fp16 or fp32). lse and di are
# fp32 [B, H, Tq], contiguous. Causal is the library kernel's rule, key <=
# query by absolute index (``_causal_mask``). The backward takes lse and di
# from outside: under a global lse, as ring attention's per-block backward
# needs, it is the same kernel. The kernels are built for the head dims of
# FLASH_HEAD_DIMS; any other D <= 128 is zero-padded to the next of them
# (zero columns change neither q kᵀ nor the softmax, and the padded columns
# of o, dq, dk and dv come out 0) and the outputs are views sliced back to
# D. A head dim above 128 raises (ROADMAP C3: no model the repo ships has
# one).

FLASH_HEAD_DIMS = (64, 128)      # the head dims the kernels are built for
_FLASH_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _causal_mask(tq: int, tk: int, device) -> torch.Tensor:
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril()


def flash_attention_fwd_plain(q, k, v, causal: bool, scale: float):
    """(o, lse): softmax(q kᵀ · scale) v with the reference's casts (scores
    and softmax in fp32, p cast to ``v.dtype`` before the PV product, o in
    ``q.dtype``) and lse = logsumexp of the scaled scores, fp32 [B, H, T]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device),
                          float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype), lse


def flash_bwd_pre_plain(o, do):
    """di = rowsum(do ∘ o) in fp32, [B, H, T]."""
    return (o.float() * do.float()).sum(-1)


def _flash_bwd_p_ds(q, k, v, do, lse, di, causal, scale):
    """The flash backward's p = exp(s·scale − lse) and ds = p ∘ (dp − di),
    with dp = do vᵀ, all fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(p.shape[-2], p.shape[-1], p.device),
                          0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - di[..., None])


def flash_bwd_dkdv_plain(q, k, v, do, lse, di, causal: bool, scale: float):
    """(dk, dv) = (dsᵀ q · scale, pᵀ do), with p and ds cast to the input
    dtype before their products (the kernel's rounding points)."""
    p, ds = _flash_bwd_p_ds(q, k, v, do, lse, di, causal, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, di, causal: bool, scale: float):
    """dq = ds k · scale, ds cast to the input dtype before the product."""
    _, ds = _flash_bwd_p_ds(q, k, v, do, lse, di, causal, scale)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool,
                              scale: float):
    """(dq, dk, dv) of :func:`flash_attention_fwd_plain` by the flash
    backward's own formulas: di = rowsum(do ∘ o), p = exp(s·scale − lse),
    ds = p ∘ (dp − di)."""
    di = flash_bwd_pre_plain(o, do)
    dk, dv = flash_bwd_dkdv_plain(q, k, v, do, lse, di, causal, scale)
    return flash_bwd_dq_plain(q, k, v, do, lse, di, causal, scale), dk, dv


def _flash_dim(d: int) -> int:
    """The built head dim that a head dim of ``d`` runs at."""
    for built in FLASH_HEAD_DIMS:
        if d <= built:
            return built
    raise ValueError(
        f"flash attention on CUDA takes head dims up to "
        f"{FLASH_HEAD_DIMS[-1]}; got {d} (ROADMAP C3: a larger instance "
        "needs more registers than the kernels' consumers hold)")


def flash_strides_ok(t: torch.Tensor) -> bool:
    """Whether the CUDA kernels take ``t``'s memory as it is: a contiguous
    head dim, B/H/T strides that are multiples of 8 elements and 16-byte
    aligned data. A tensor whose head dim is padded is copied anyway."""
    if t.shape[-1] not in FLASH_HEAD_DIMS:
        return True
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check_flash(named):
    """Raise on what the CUDA kernels do not take: tensors on one CUDA
    device, of one of the kernels' dtypes, 4-d with one B, H and D (D at
    most 128), in memory the kernels take unless D is padded. Returns
    (dtype code, device, the built head dim)."""
    device = dtype = dims = None
    for name, t in named:
        if t.device.type != "cuda" or (device is not None
                                       and t.device != device):
            raise ValueError(f"flash attention: {name} is on {t.device}, "
                             f"expected {device or 'a CUDA device'}")
        device = t.device
        if t.dtype not in _FLASH_DTYPES or (dtype is not None
                                            and t.dtype != dtype):
            raise ValueError(
                f"flash attention on CUDA takes bfloat16, float16 or "
                f"float32 inputs of one dtype; {name} is {t.dtype}"
                + (f" beside {dtype}" if dtype is not None else ""))
        dtype = t.dtype
        if t.dim() != 4 or (dims is not None and (t.shape[0], t.shape[1],
                                                  t.shape[3]) != dims):
            raise ValueError(f"flash attention: {name} has shape "
                             f"{tuple(t.shape)}; expected [B, H, T, D] "
                             "with the B, H and D of the others")
        dims = (t.shape[0], t.shape[1], t.shape[3])
        _flash_dim(t.shape[-1])
        if not flash_strides_ok(t):
            raise ValueError(
                f"flash attention: {name} needs a contiguous head dim, B/H/T "
                f"strides that are multiples of 8 and 16-byte aligned data; "
                f"got strides {t.stride()}")
    return _FLASH_DTYPES[dtype], device, _flash_dim(dims[2])


def _same_rows(a, b, names):
    if a.shape != b.shape:
        raise ValueError(f"flash attention: {names[0]} {tuple(a.shape)} and "
                         f"{names[1]} {tuple(b.shape)} differ")


def _padded(d: int, *ts):
    """``ts`` with their head dim zero-padded to ``d`` (as they are if it
    is theirs)."""
    return [t if t.shape[-1] == d else
            torch.nn.functional.pad(t, (0, d - t.shape[-1])) for t in ts]


def _check_stats(named, bht, device):
    for name, t in named:
        if t.dtype != torch.float32 or tuple(t.shape) != bht \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be a contiguous "
                             f"float32 {bht} tensor on {device}")


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(ts)))(
        *[s for t in ts for s in t.stride()[:3]])


def _launched(fn, code: int):
    """One launch of ``fn``'s kernel; fp32 inputs (``flash_attn.cu``'s tf32
    family, a kernel of its own) are also counted in ``tf32_launches``."""
    fn.launches += 1
    if code == _FLASH_DTYPES[torch.float32]:
        fn.tf32_launches += 1


def flash_fwd(q, k, v, causal: bool, scale: float):
    """(o, lse) of attention on [B, H, T, D] views; o is laid out as q."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    code, device, dp = _check_flash((("q", q), ("k", k), ("v", v)))
    _same_rows(k, v, ("k", "v"))
    (b, h, tq, d), tk = q.shape, k.shape[2]
    q, k, v = _padded(dp, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=device)
    _check(_lib().hvd_flash_fwd(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), _strides(q, k, v, o), b, h, tq, tk, dp,
        int(causal), scale, _stream(device)), "flash_fwd")
    _launched(flash_fwd, code)
    return o[..., :d], lse


flash_fwd.launches = flash_fwd.tf32_launches = 0


def flash_bwd_pre(o, do):
    """di = rowsum(do ∘ o), fp32 [B, H, T]."""
    if o.device.type == "cpu":
        return flash_bwd_pre_plain(o, do)
    code, device, dp = _check_flash((("o", o), ("do", do)))
    _same_rows(o, do, ("o", "do"))
    b, h, t, _ = o.shape
    o, do = _padded(dp, o, do)
    di = torch.empty(b, h, t, dtype=torch.float32, device=device)
    _check(_lib().hvd_flash_bwd_pre(
        device.index, code, o.data_ptr(), do.data_ptr(), di.data_ptr(),
        _strides(o, do), b, h, t, dp, _stream(device)), "flash_bwd_pre")
    flash_bwd_pre.launches += 1
    return di


flash_bwd_pre.launches = 0


def _bwd_inputs(q, k, v, do):
    """Checks the backward's inputs; returns (dtype code, device, built
    head dim, (B, H, Tq, Tk, D))."""
    code, device, dp = _check_flash(
        (("q", q), ("k", k), ("v", v), ("do", do)))
    _same_rows(k, v, ("k", "v"))
    _same_rows(q, do, ("q", "do"))
    (b, h, tq, d), tk = q.shape, k.shape[2]
    return code, device, dp, (b, h, tq, tk, d)


def flash_bwd_dkdv(q, k, v, do, lse, di, causal: bool, scale: float):
    """(dk, dv) under the given lse and di; laid out as k and v."""
    if q.device.type == "cpu":
        return flash_bwd_dkdv_plain(q, k, v, do, lse, di, causal, scale)
    code, device, dp, (b, h, tq, tk, d) = _bwd_inputs(q, k, v, do)
    _check_stats((("lse", lse), ("di", di)), (b, h, tq), device)
    q, k, v, do = _padded(dp, q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check(_lib().hvd_flash_bwd_dkdv(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, do, dk, dv), b, h, tq, tk, dp,
        int(causal), scale, _stream(device)), "flash_bwd_dkdv")
    _launched(flash_bwd_dkdv, code)
    return dk[..., :d], dv[..., :d]


flash_bwd_dkdv.launches = flash_bwd_dkdv.tf32_launches = 0


def flash_bwd_dq(q, k, v, do, lse, di, causal: bool, scale: float):
    """dq under the given lse and di; laid out as q."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, di, causal, scale)
    code, device, dp, (b, h, tq, tk, d) = _bwd_inputs(q, k, v, do)
    _check_stats((("lse", lse), ("di", di)), (b, h, tq), device)
    q, k, v, do = _padded(dp, q, k, v, do)
    dq = torch.empty_like(q)
    _check(_lib().hvd_flash_bwd_dq(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), b, h, tq, tk, dp, int(causal), scale,
        _stream(device)), "flash_bwd_dq")
    _launched(flash_bwd_dq, code)
    return dq[..., :d]


flash_bwd_dq.launches = flash_bwd_dq.tf32_launches = 0


# ---------------------------------------------------------------------------
# K7: ring attention's per-segment kernels
# ---------------------------------------------------------------------------
#
# One (q block, kv block) interaction of the ring, on [B, H, S, D] views of
# equal length S: the aligned causal diagonal (DIAG, causal=True) or a block
# that sees every key (FULL, causal=False). The forward gives the block's
# output normalised within the block and its lse, both fp32, for the ring's
# fp32 merge; the backward gives fp32 (dq, dk, dv) under the ring's GLOBAL
# lse and di, which the ring adds up over its hops. K6's kernels with fp32
# stores (for every input dtype and head dim K6 takes); lse and di may be
# strided [B, H, S] views (the zig-zag halves).

NEG_INF = -1e30   # the lse of a row that sees no key: finite, so merges stay


def flash_seg_fwd_plain(q, k, v, causal: bool, scale: float):
    """(o, lse), both fp32: the reference's ``_seg_fwd_jax`` semantics.
    Scores and softmax in fp32, p cast to ``v.dtype`` before the PV product
    (fp32 accumulation), o normalised within the block, never rounded. A
    row that sees no key gets o = 0 and lse = -1e30, not -inf or NaN."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device),
                          float("-inf"))
    m = s.amax(-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    seen = l > 0
    o = o / torch.where(seen, l, torch.ones_like(l))[..., None]
    lse = torch.where(seen, m + torch.log(torch.where(seen, l, 1.0)),
                      torch.full_like(l, NEG_INF))
    return o, lse


def _seg_bwd_p_ds(q, k, v, do, lse, di, causal, scale):
    """p = exp(s·scale − lse), masked entries 0, and ds = p ∘ (dp − di),
    fp32, both cast to the input dtype as the kernel does before its
    products (a no-op in fp32, where this is ``_seg_bwd_jax`` exactly)."""
    p, ds = _flash_bwd_p_ds(q, k, v, do, lse, di, causal, scale)
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_seg_bwd_dkdv_plain(q, k, v, do, lse, di, causal: bool,
                             scale: float):
    """fp32 (dk, dv) = (dsᵀ q · scale, pᵀ do) under the given lse and di."""
    p, ds = _seg_bwd_p_ds(q, k, v, do, lse, di, causal, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dk, dv


def flash_seg_bwd_dq_plain(q, k, v, do, lse, di, causal: bool, scale: float):
    """fp32 dq = ds k · scale under the given lse and di."""
    _, ds = _seg_bwd_p_ds(q, k, v, do, lse, di, causal, scale)
    return torch.matmul(ds, k.float()) * scale


def flash_seg_bwd_plain(q, k, v, lse, do, di, causal: bool, scale: float):
    """fp32 (dq, dk, dv) of one segment under the ring's global lse and di:
    the reference's ``_seg_bwd_jax`` (argument order included). No
    lse-cotangent term: p is the block's slice of the global softmax."""
    dk, dv = flash_seg_bwd_dkdv_plain(q, k, v, do, lse, di, causal, scale)
    return flash_seg_bwd_dq_plain(q, k, v, do, lse, di, causal, scale), dk, dv


def _check_seg_stats(named, bhs, device):
    """lse and di: fp32 [B, H, S] views with a unit T stride and 16-byte
    aligned rows, as a zig-zag half of a contiguous [B, H, T] tensor is."""
    for name, t in named:
        if t.dtype != torch.float32 or tuple(t.shape) != bhs \
                or t.device != device or t.stride(-1) != 1:
            raise ValueError(f"ring segment: {name} must be a float32 {bhs} "
                             f"view on {device} with a unit last stride")


def _seg_strides(ins, outs, stats) -> ctypes.Array:
    """The strides the C entry points take: B, H and T of each [B, H, S, D]
    tensor, then B and H of each [B, H, S] statistic."""
    vals = [s for t in ins + outs for s in t.stride()[:3]]
    vals += [s for t in stats for s in t.stride()[:2]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _seg_out(q):
    b, h, s, d = q.shape
    return torch.empty(b, h, s, d, dtype=torch.float32, device=q.device)


def _seg_inputs(q, k, v, do=None):
    """Checks a segment's inputs: K6's checks, and q and k/v of one
    length. Returns (dtype code, device, built head dim, (B, H, S, D))."""
    named = (("q", q), ("k", k), ("v", v)) + ((("do", do),) if do is not None
                                              else ())
    code, device, dp = _check_flash(named)
    for name, t in named[1:]:
        _same_rows(q, t, ("q", name))
    return code, device, dp, tuple(q.shape)


def flash_seg_fwd(q, k, v, causal: bool, scale: float):
    """(o fp32 [B, H, S, D], lse fp32 [B, H, S]) of one ring segment."""
    if q.device.type == "cpu":
        return flash_seg_fwd_plain(q, k, v, causal, scale)
    code, device, dp, (b, h, s, d) = _seg_inputs(q, k, v)
    q, k, v = _padded(dp, q, k, v)
    o = _seg_out(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=device)
    _check(_lib().hvd_flash_seg_fwd(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), _seg_strides([q, k, v], [o], [lse]), b,
        h, s, s, dp, int(causal), scale, _stream(device)), "flash_seg_fwd")
    _launched(flash_seg_fwd, code)
    return o[..., :d], lse


flash_seg_fwd.launches = flash_seg_fwd.tf32_launches = 0


def flash_seg_bwd_dkdv(q, k, v, do, lse, di, causal: bool, scale: float):
    """fp32 (dk, dv) of one ring segment under the global lse and di."""
    if q.device.type == "cpu":
        return flash_seg_bwd_dkdv_plain(q, k, v, do, lse, di, causal, scale)
    code, device, dp, (b, h, s, d) = _seg_inputs(q, k, v, do)
    _check_seg_stats((("lse", lse), ("di", di)), (b, h, s), device)
    q, k, v, do = _padded(dp, q, k, v, do)
    dk, dv = _seg_out(k), _seg_out(v)
    _check(_lib().hvd_flash_seg_bwd_dkdv(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _seg_strides([q, k, v, do], [dk, dv], [lse, di]), b,
        h, s, s, dp, int(causal), scale, _stream(device)),
        "flash_seg_bwd_dkdv")
    _launched(flash_seg_bwd_dkdv, code)
    return dk[..., :d], dv[..., :d]


flash_seg_bwd_dkdv.launches = flash_seg_bwd_dkdv.tf32_launches = 0


def flash_seg_bwd_dq(q, k, v, do, lse, di, causal: bool, scale: float):
    """fp32 dq of one ring segment under the global lse and di."""
    if q.device.type == "cpu":
        return flash_seg_bwd_dq_plain(q, k, v, do, lse, di, causal, scale)
    code, device, dp, (b, h, s, d) = _seg_inputs(q, k, v, do)
    _check_seg_stats((("lse", lse), ("di", di)), (b, h, s), device)
    q, k, v, do = _padded(dp, q, k, v, do)
    dq = _seg_out(q)
    _check(_lib().hvd_flash_seg_bwd_dq(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        _seg_strides([q, k, v, do], [dq], [lse, di]), b, h, s, s, dp,
        int(causal), scale, _stream(device)), "flash_seg_bwd_dq")
    _launched(flash_seg_bwd_dq, code)
    return dq[..., :d]


flash_seg_bwd_dq.launches = flash_seg_bwd_dq.tf32_launches = 0


KERNELS = (pack, bn_stats, bn_bwd_stats, adasum_triple, adasum_scale,
           flash_fwd, flash_bwd_pre, flash_bwd_dkdv, flash_bwd_dq,
           flash_seg_fwd, flash_seg_bwd_dkdv, flash_seg_bwd_dq)
# wrappers whose fp32 inputs launch a kernel of their own (the tf32 family)
TF32_KERNELS = (flash_fwd, flash_bwd_dkdv, flash_bwd_dq, flash_seg_fwd,
                flash_seg_bwd_dkdv, flash_seg_bwd_dq)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    for k in TF32_KERNELS:
        k.tf32_launches = 0


def launch_counts() -> dict:
    """Launches by wrapper (every dtype), and ``<wrapper>_tf32``: those of
    the tf32 family alone."""
    counts = {k.__name__: k.launches for k in KERNELS}
    counts.update({f"{k.__name__}_tf32": k.tf32_launches
                   for k in TF32_KERNELS})
    return counts
