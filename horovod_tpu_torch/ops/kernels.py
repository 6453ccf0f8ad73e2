"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py``:

=========================  =====================  ========================
TPU kernel (Pallas)        CUDA (``csrc/``)       wrapper here
=========================  =====================  ========================
``pack_pallas``            ``pack.cu``            :func:`pack`
``bn_stats_pallas``        ``bn_stats.cu``        :func:`bn_stats`,
                                                  :func:`bn_forward`
``bn_bwd_stats_pallas``    ``bn_stats.cu``        :func:`bn_bwd_stats`,
                                                  :func:`bn_backward`
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

The attention kernels are Hopper kernels (TMA, ``wgmma``) at every head
dim and dtype: bf16 and fp16 at head dims 64 and 128 (and those below,
built at them), 192 and 256 (160 is built at 192), the forward also at
320, 384 and 512 (288 is built at 320 and 448 runs on 512), and one
forward, one dk/dv and one dq kernel take every head dim above theirs
(512 for the forward, 256 for dk/dv and dq); fp32 at any head dim on tf32
``wgmma``. ``flash_attn.cu`` holds di and the C entry points.
:func:`flash_route` says which route a launch takes. The kernels read a
head dim below their instance's in place (16, 80, 96, 160, 288 of a
``[B, T, H, D]`` tensor, and any even one whose strides TMA takes);
elsewhere the wrapper copies the inputs zero-padded and counts the copy
(:func:`flash_needs_copy`, ``<wrapper>_pad_copies``).

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
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

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


def _pack_out(tensors: Sequence[torch.Tensor], out: torch.Tensor):
    """``out[:numel]`` for ``out=`` of the packs: a 1-d contiguous buffer of
    the tensors' dtype and device holding at least their elements."""
    total = sum(t.numel() for t in tensors)
    t0 = tensors[0]
    if (out.dim() != 1 or not out.is_contiguous() or out.dtype != t0.dtype
            or out.device != t0.device or out.numel() < total):
        raise ValueError(
            f"pack: out must be a 1-d contiguous {t0.dtype} buffer on "
            f"{t0.device} of at least {total} elements; got {out.dtype} "
            f"{tuple(out.shape)} on {out.device} (contiguous: "
            f"{out.is_contiguous()})")
    return out[:total]


def pack_plain(tensors: Sequence[torch.Tensor],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flatten and concatenate (the reference's ``build_pack``); with
    ``out``, into ``out[:numel]``, the rest of ``out`` left as it is."""
    flat = [t.reshape(-1) for t in tensors]
    if out is None:
        return torch.cat(flat)
    torch.cat(flat, out=_pack_out(tensors, out))
    return out


def pack(tensors: Sequence[torch.Tensor],
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-launch copy of ``tensors`` (one dtype, one device) into a new flat
    buffer at prefix-sum offsets; bitwise equal to :func:`pack_plain`. With
    ``out`` (a ZeRO-1 bucket's padded buffer), K1 writes ``out[:numel]``
    and leaves the rest alone, and ``out`` is returned; such launches are
    also counted in ``pack.out_launches``."""
    if not tensors:
        raise ValueError("pack needs at least one tensor")
    dtype, device = tensors[0].dtype, tensors[0].device
    for t in tensors:
        if t.dtype != dtype or t.device != device:
            raise ValueError("pack takes tensors of one dtype on one device; "
                             f"got {t.dtype} on {t.device} beside {dtype} on "
                             f"{device}")
    if out is not None:
        _pack_out(tensors, out)
    if device.type == "cpu":
        return pack_plain(tensors, out)
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
    given = out is not None
    if not given:
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
    pack.out_launches += given
    return out


pack.launches = 0
# of them, K1 into a caller's buffer (out=: the ZeRO-1 padded buckets)
pack.out_launches = 0
# K1 launched as a node of a replayed CUDA graph (PackTable)
pack.graph_launches = 0


class PackTable:
    """K1 at fixed sizes inside a captured program (step replay's CUDA
    graph, ``core/replay.py``): the capture records a launch that reads a
    device table whose address never moves, and each step writes its own
    tensors' addresses into that table before the graph runs. K1 is
    unchanged: it reads ``(src, offset, bytes, first tile)`` rows from a
    device table as it does for :func:`pack`.

    The rows' offsets, byte counts and tiles are fixed by ``sizes`` (numels,
    one dtype); only the source pointers change. :meth:`refresh` writes them
    into a pinned staging buffer and copies it into the device table with
    one asynchronous host-to-device copy on the current stream. A staging
    buffer is rewritten only once the event recorded after its last copy
    has completed (``query()``, never a wait); while every buffer is still
    in flight, a new one joins the ring. :meth:`capture` launches K1 from
    the table into ``out`` on the current stream, which a graph capture
    records; the graph's owner counts each replay of that node in
    ``pack.graph_launches``."""

    def __init__(self, sizes: Sequence[int], dtype: torch.dtype,
                 device: torch.device):
        lib = _lib()
        tile = lib.hvd_pack_tile_bytes()
        itemsize = dtype.itemsize
        self.sizes = [int(n) for n in sizes]
        self.dtype, self.device = dtype, device
        self.slots = [i for i, n in enumerate(self.sizes) if n]
        rows = np.zeros((len(self.slots), 4), dtype=np.int64)
        offset, tiles, r = 0, 0, 0
        for n in self.sizes:
            nbytes = n * itemsize
            if nbytes:
                rows[r] = (0, offset * itemsize, nbytes, tiles)
                tiles += -(-nbytes // tile)
                r += 1
            offset += n
        self.numel, self.tiles, self._rows = offset, tiles, rows
        self.table = torch.zeros(rows.shape, dtype=torch.int64,
                                 device=device)
        self._staging = []      # [pinned (rows, 4) int64, its last copy's event]

    def refresh(self, tensors: Sequence[torch.Tensor]):
        """Point the table's rows at ``tensors`` (the sizes, dtype and
        device it was built for, each contiguous)."""
        if len(tensors) != len(self.sizes):
            raise ValueError(f"PackTable of {len(self.sizes)} tensors given "
                             f"{len(tensors)}")
        for i, (t, n) in enumerate(zip(tensors, self.sizes)):
            if (t.dtype != self.dtype or t.device != self.device
                    or t.numel() != n or not t.is_contiguous()):
                raise ValueError(
                    f"PackTable: tensor {i} is {t.dtype} {tuple(t.shape)} on "
                    f"{t.device} (contiguous: {t.is_contiguous()}); the "
                    f"table holds {n} contiguous {self.dtype} elements on "
                    f"{self.device}")
        if not self.slots:
            return
        for buf, event in self._staging:
            if event.query():
                break
        else:
            buf = torch.empty(self._rows.shape, dtype=torch.int64,
                              pin_memory=True)
            event = torch.cuda.Event()
            self._staging.append((buf, event))
        host = buf.numpy()
        host[:] = self._rows
        host[:, 0] = [tensors[i].data_ptr() for i in self.slots]
        self.table.copy_(buf, non_blocking=True)
        event.record(torch.cuda.current_stream(self.device))

    def capture(self, out: torch.Tensor):
        """Launch K1 from the table into ``out`` (``numel`` elements) on the
        current stream."""
        if out.numel() != self.numel or out.dtype != self.dtype:
            raise ValueError(f"PackTable: out must hold {self.numel} "
                             f"{self.dtype} elements")
        if not self.slots:
            return
        _check(_lib().hvd_pack(self.device.index, self.table.data_ptr(),
                               len(self.slots), self.tiles, out.data_ptr(),
                               _stream(self.device)), "pack")


# ---------------------------------------------------------------------------
# K2/K3: BatchNorm statistics, with the module's per-channel math
# ---------------------------------------------------------------------------
#
# One kernel launch a call (csrc/bn_stats.cu) for bf16, fp16 or fp32 (M, C)
# views of any C >= 1, M >= 1 and alignment. Two modes of each kernel: the
# raw sums (bn_stats, bn_bwd_stats) and the module's per-channel math in the
# kernel's epilogue (bn_forward, bn_backward), all results in one fp32
# (rows, C) tensor. Launches of K2 in either mode are counted on bn_stats,
# of K3 on bn_bwd_stats.

BN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BN_ROW_BYTES = 128      # bytes of a channel tile's row (bn_stats.cu)
BN_STAGE_ROWS = 64      # rows of a stage of the kernels' TMA ring
BN_MAX_CLUSTER = 8      # CTAs of a cluster of the occupancy plan (portable)
# A tile whose rows over one cluster's CTAs are at most this many runs as one
# cluster (of up to 16 CTAs where the card allows it), when that gives the
# card at least BN_MIN_CTAS CTAs: no partial rows, no ticket.
BN_ONE_CLUSTER_ROWS = 4096
BN_MIN_CTAS = 64


class BnPlan(NamedTuple):
    """The grid of one K2/K3 launch: ``ctas`` CTAs for each of ``tiles``
    channel tiles of ``tile_channels``, in clusters of ``cluster``, each
    CTA summing ``rows_per_cta`` rows."""
    tile_channels: int
    tiles: int
    ctas: int
    cluster: int
    rows_per_cta: int

    @property
    def clusters(self) -> int:
        """Clusters of a tile: the partial rows in the workspace."""
        return self.ctas // self.cluster

    @property
    def workspace_floats(self) -> int:
        return self.tiles * self.clusters * 2 * self.tile_channels


@functools.lru_cache(maxsize=4096)
def bn_plan(m: int, c: int, itemsize: int, slots: int, sms: int,
            max_cluster: int = 16) -> BnPlan:
    """The grid of K2/K3 on an (m, c) input, on a card of ``sms`` SMs that
    holds ``slots`` CTAs at once in clusters of ``BN_MAX_CLUSTER`` and runs
    clusters of up to ``max_cluster``.

    A tile of few rows is one cluster of about sms / tiles CTAs (at least
    8, at most ``max_cluster``): no partial rows and no ticket, the
    measured best at ResNet-50's stage 3-4 shapes. Otherwise one wave of
    ``slots`` spread evenly over the tiles, no more CTAs of a tile than it
    has stages of rows, in clusters of 4 to 8."""
    ct = BN_ROW_BYTES // itemsize
    tiles = -(-c // ct)
    most = -(-m // BN_STAGE_ROWS)
    q = min(max_cluster, most, max(BN_MAX_CLUSTER, -(-sms // tiles)))
    if -(-m // q) <= BN_ONE_CLUSTER_ROWS and (tiles * q >= BN_MIN_CTAS
                                                or q == most):
        return BnPlan(ct, tiles, q, q, -(-m // q))
    n = max(1, min(slots // tiles, most))
    cluster = min(n, BN_MAX_CLUSTER)
    if n > BN_MAX_CLUSTER:
        # the largest cluster that divides n - k, for the smallest k
        # (one of 4 consecutive counts is a multiple of 4)
        for k in range(4):
            q = next((q for q in range(BN_MAX_CLUSTER, 3, -1)
                      if (n - k) % q == 0), None)
            if q:
                n, cluster = n - k, q
                break
    return BnPlan(ct, tiles, n, cluster, -(-m // n))


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


def bn_forward_plain(x2d, scale, bias, eps: float, running_mean=None,
                     running_var=None, momentum: float = 0.9):
    """fp32 [mean, var, invstd, a, b] (5, C) of the reference's
    ``_fwd_impl`` (fused_batch_norm.py:72-82): var = max(E[x^2] - mean^2,
    0), invstd = rsqrt(var + eps), a = scale * invstd, b = bias - mean * a;
    and, when given, flax's EMA of the running statistics in place
    (running = momentum * running + (1 - momentum) * batch, :152-157)."""
    s, q = bn_stats_plain(x2d)
    m = x2d.shape[0]
    mean = s / m
    var = torch.clamp(q / m - mean * mean, min=0.0)
    invstd = torch.rsqrt(var + eps)
    a = scale.float() * invstd
    b = bias.float() - mean * a
    if running_mean is not None:
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)
    return torch.stack([mean, var, invstd, a, b])


def bn_backward_plain(dy2d, x2d, mean, invstd, scale):
    """fp32 [dgamma, dbeta, a, -a * k1, -a * invstd * k2] (5, C) of the
    reference's ``_bn_bwd`` (fused_batch_norm.py:90-103): dgamma = sum
    dy*xhat, dbeta = sum dy, and dx's coefficients, dx = (x - mean) *
    (-a * invstd * k2) + (-a * k1) + a * dy with a = scale * invstd, k1 =
    sum dy / M, k2 = sum dy*xhat / M."""
    s1, s2 = bn_bwd_stats_plain(dy2d, x2d, mean, invstd)
    m = x2d.shape[0]
    a = scale.float() * invstd
    return torch.stack([s2, s1, a, -a * (s1 / m), -a * invstd * (s2 / m)])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _bn_card(index: int, code: int, bwd: bool) -> Tuple[int, int, int]:
    """(slots, SMs, largest cluster) of K2 (K3 with ``bwd``) on device
    ``index``: the CTAs it holds at once in clusters of BN_MAX_CLUSTER, by
    the CUDA occupancy calculator, and 16 if it runs clusters of 16."""
    lib = _lib()
    n = lib.hvd_bn_max_clusters(index, code, int(bwd), BN_MAX_CLUSTER)
    if n <= 0:
        raise RuntimeError(f"bn kernels: no cluster of {BN_MAX_CLUSTER} fits "
                           f"on device {index} (occupancy {n})")
    wide = lib.hvd_bn_max_clusters(index, code, int(bwd), 16) > 0
    return n * BN_MAX_CLUSTER, _sm_count(index), 16 if wide else 8


def _check_bn_input(name: str, t: torch.Tensor, c: int, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in BN_DTYPES:
        raise ValueError(f"{name}: dtype {t.dtype} not supported "
                         "(float32, bfloat16 or float16)")
    if t.dim() != 2 or t.shape[1] != c or t.shape[0] < 1:
        raise ValueError(f"{name}: expected (M >= 1, {c}), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the (M, C) view is not contiguous (an "
                         "NCHW activation must be channels_last)")


def _check_channels(named, c: int, device):
    for name, v in named:
        if v.shape != (c,) or v.dtype != torch.float32 \
                or v.device != device or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {device}")


_BN_WORK = {}   # (device index, stream) -> (fp32 workspace, int32 tickets)


def _bn_workspace(device, stream: int, plan: BnPlan):
    """The workspace and tickets of launches on ``stream``: allocated once
    and grown, never per call; the kernels leave every ticket at 0."""
    key = (device.index, stream)
    have = _BN_WORK.get(key)
    if have is None or have[0].numel() < plan.workspace_floats \
            or have[1].numel() < plan.tiles:
        floats = max(plan.workspace_floats,
                     have[0].numel() if have else 0)
        tiles = max(plan.tiles, have[1].numel() if have else 0)
        have = (torch.empty(floats, dtype=torch.float32, device=device),
                torch.zeros(tiles, dtype=torch.int32, device=device))
        _BN_WORK[key] = have
    return have


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bn_launch(x2d, dy2d=None, mean=None, invstd=None, epilogue=False,
               scale=None, bias=None, eps=0.0, running=(None, None),
               momentum=0.0) -> torch.Tensor:
    """One launch of K2 (``dy2d`` None) or K3; returns its fp32 (2 or 5, C)
    output."""
    m, c = x2d.shape
    device = x2d.device
    _check_bn_input("x", x2d, c, device)
    if dy2d is not None:
        _check_bn_input("dy", dy2d, c, device)
        if dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype:
            raise ValueError("dy and x must share shape and dtype")
        _check_channels((("mean", mean), ("invstd", invstd)), c, device)
    if epilogue:
        _check_channels(
            [("scale", scale)] + ([("bias", bias)] if dy2d is None else [])
            + [(n, t) for n, t in zip(("running_mean", "running_var"),
                                      running) if t is not None],
            c, device)
    code = BN_DTYPES[x2d.dtype]
    plan = bn_plan(m, c, x2d.element_size(),
                   *_bn_card(device.index, code, dy2d is not None))
    stream = _stream(device)
    work, tickets = _bn_workspace(device, stream, plan)
    out = torch.empty(5 if epilogue else 2, c, dtype=torch.float32,
                      device=device)
    grid = (plan.ctas, plan.cluster, plan.rows_per_cta, work.data_ptr(),
            tickets.data_ptr(), int(epilogue))
    if dy2d is None:
        _check(_lib().hvd_bn_stats(
            device.index, code, x2d.data_ptr(), m, c, *grid,
            _ptr(scale), _ptr(bias), eps, _ptr(running[0]), _ptr(running[1]),
            momentum, 1.0 - momentum, out.data_ptr(), stream), "bn_stats")
        bn_stats.launches += 1
    else:
        _check(_lib().hvd_bn_bwd_stats(
            device.index, code, dy2d.data_ptr(),
            x2d.data_ptr(), mean.data_ptr(), invstd.data_ptr(), m, c, *grid,
            _ptr(scale), out.data_ptr(), stream), "bn_bwd_stats")
        bn_bwd_stats.launches += 1
    return out


def bn_stats(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum, sum of squares) of an (M, C) activation, fp32 out,
    in one read of ``x2d`` (K2's raw mode)."""
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d)
    out = _bn_launch(x2d)
    return out[0], out[1]


bn_stats.launches = 0


def bn_bwd_stats(dy2d, x2d, mean, invstd):
    """Per-channel (sum(dy), sum(dy * (x - mean) * invstd)) in one read of
    ``dy2d`` and ``x2d``; ``mean``/``invstd`` are fp32 (C,) (K3's raw
    mode)."""
    if x2d.device.type == "cpu":
        return bn_bwd_stats_plain(dy2d, x2d, mean, invstd)
    out = _bn_launch(x2d, dy2d, mean, invstd)
    return out[0], out[1]


bn_bwd_stats.launches = 0


def bn_forward(x2d, scale, bias, eps: float, running_mean=None,
               running_var=None, momentum: float = 0.9) -> torch.Tensor:
    """:func:`bn_forward_plain` in one launch of K2 (the EMA, when the
    running statistics are given, in place in its epilogue); ``scale``,
    ``bias`` and the running statistics are fp32 (C,)."""
    if x2d.device.type == "cpu":
        return bn_forward_plain(x2d, scale, bias, eps, running_mean,
                                running_var, momentum)
    if (running_mean is None) != (running_var is None):
        raise ValueError("bn_forward: give both running statistics or "
                         "neither")
    return _bn_launch(x2d, epilogue=True, scale=scale, bias=bias, eps=eps,
                      running=(running_mean, running_var), momentum=momentum)


def bn_backward(dy2d, x2d, mean, invstd, scale) -> torch.Tensor:
    """:func:`bn_backward_plain` in one launch of K3; ``mean``, ``invstd``
    and ``scale`` are fp32 (C,)."""
    if x2d.device.type == "cpu":
        return bn_backward_plain(dy2d, x2d, mean, invstd, scale)
    return _bn_launch(x2d, dy2d, mean, invstd, epilogue=True, scale=scale)


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
# needs, it is the same kernel. Any head dim runs on the kernel instance
# built for the next of FLASH_HEAD_DIMS (D <= 128) or the next multiple of
# 64: zero columns change neither q kᵀ nor the softmax. The Hopper kernels
# (TMA, wgmma) run every launch: the forward, dk/dv and dq at every head
# dim and dtype (fp32 on tf32; above 256 the 16-bit dk/dv and dq split
# their output columns over blocks and sum S and dP over the depth's
# slabs, as the forward does above 512). They read a narrower view in
# place (TMA fills the columns past its D with zeros) and store its D
# columns, so the outputs are allocated at the real D, laid out as the
# inputs; only a view TMA cannot take below a built head dim is copied
# zero-padded and the outputs sliced back (:func:`flash_needs_copy`,
# counted in ``pad_copies``).

FLASH_HEAD_DIMS = (64, 128)      # the head dims of every Hopper kernel
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
    """The head dim that a head dim of ``d`` runs at: the next of
    FLASH_HEAD_DIMS, or above 128 the next multiple of 64."""
    for built in FLASH_HEAD_DIMS:
        if d <= built:
            return built
    return -(-d // 64) * 64


def flash_strides_ok(t: torch.Tensor) -> bool:
    """Whether TMA takes ``t``'s memory as it is: a contiguous head dim,
    B/H/T strides that are multiples of 16 bytes (8 elements of 16 bits, 4
    of fp32) and 16-byte aligned data. The kernels refuse other views at a
    built head dim and copy them below one (:func:`flash_needs_copy`)."""
    n = 16 // t.element_size()
    return (t.stride(-1) == 1 and all(s % n == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _pairs_ok(t: torch.Tensor) -> bool:
    """Whether di's kernel reads ``t`` in place: pairs of neighbouring
    elements, aligned to their size (a contiguous head dim, even strides
    and base)."""
    return (t.stride(-1) == 1 and all(s % 2 == 0 for s in t.stride()[:3])
            and t.data_ptr() % (2 * t.element_size()) == 0)


def flash_needs_copy(kernel: str, *ts) -> bool:
    """Whether the K6/K7 wrapper named ``kernel`` copies its inputs ``ts``
    ([B, H, T, D] views of one dtype and D) zero-padded to the built head
    dim (:func:`_flash_dim`) before its launch; a function of their shape,
    strides, dtype and address alone. Never at a built head dim. Below it:
    the Hopper kernels (every route) read an even D in place where TMA
    takes every view (:func:`flash_strides_ok`), as a [B, T, H, D] tensor
    whose D is a multiple of 8 (fp32: 4) is; di (``flash_bwd_pre``) reads
    pairs below D and copies an odd D or misaligned pairs."""
    d = ts[0].shape[-1]
    if d == _flash_dim(d):
        return False
    if kernel == "flash_bwd_pre":
        return d % 2 != 0 or not all(_pairs_ok(t) for t in ts)
    return d % 2 != 0 or not all(flash_strides_ok(t) for t in ts)


def flash_grad_in(do: torch.Tensor, kernel: str) -> torch.Tensor:
    """An incoming gradient ``do`` ([B, H, T, D]) as the backward wrappers
    (``kernel``: dk/dv's name) should get it: itself where TMA takes it
    (:func:`flash_strides_ok`) or where they copy it anyway, zero-padded
    (:func:`flash_needs_copy`: a head dim below a built one that is no
    multiple of 16 bytes, whose contiguous copy TMA takes no more); else
    one contiguous copy (of a gradient expanded from a sum, say), which
    they read in place."""
    d = do.shape[-1]
    if flash_strides_ok(do) or (d != _flash_dim(d)
                                and d % (16 // do.element_size()) != 0):
        return do
    return do.clone(memory_format=torch.contiguous_format)


def _check_flash(named):
    """Raise on what the CUDA kernels do not take: tensors on one CUDA
    device, of one of the kernels' dtypes, 4-d with one B, H and D, in
    memory TMA takes where D is a built head dim (below one, a view TMA
    cannot take is copied: :func:`flash_needs_copy`). Returns (dtype code,
    device, the head dim the kernels run at)."""
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
        built = t.shape[-1] == _flash_dim(t.shape[-1])
        if built and not flash_strides_ok(t):
            raise ValueError(
                f"flash attention: {name} needs a contiguous head dim, B/H/T "
                f"strides that are multiples of {16 // t.element_size()} "
                f"and 16-byte aligned data; got strides {t.stride()}")
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


def _flash_views(fn, dp: int, *ts):
    """(the tensors ``fn``'s kernel reads, their head dim): ``ts`` as they
    are, or, where :func:`flash_needs_copy` says so, copies zero-padded to
    the built head dim ``dp``, counted in ``fn.pad_copies``."""
    if flash_needs_copy(fn.__name__, *ts):
        fn.pad_copies += 1
        return _padded(dp, *ts), dp
    return list(ts), ts[0].shape[-1]


def _check_stats(named, bht, device):
    for name, t in named:
        if t.dtype != torch.float32 or tuple(t.shape) != bht \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be a contiguous "
                             f"float32 {bht} tensor on {device}")


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(ts)))(
        *[s for t in ts for s in t.stride()[:3]])


def flash_route(dtype: torch.dtype, d: int, kernel: str) -> str:
    """The kernel that a K6/K7 wrapper (``kernel``, its name) launches on
    the card for inputs of ``dtype`` and head dim ``d``, every one a Hopper
    kernel (TMA, ``wgmma``): "sm90" for bf16 and fp16 at head dims built at
    64 or 128; "sm90_wide" above 128: the forward at every head dim (deep
    above 512), dk/dv and dq at 192 and 256 and, above 256, on the deep
    kernels (the output columns split over blocks, S and dP summed over
    the depth's slabs: ``wgmma``'s N is at most 256); "sm90_tf32" on fp32
    (tf32 ``wgmma``): every wrapper at every head dim."""
    if kernel not in ROUTED_KERNELS_BY_NAME:
        raise ValueError(
            f"flash_route: {kernel!r} is not a K6/K7 wrapper with a route "
            f"({', '.join(ROUTED_KERNELS_BY_NAME)})")
    if dtype not in _FLASH_DTYPES:
        raise ValueError(f"flash_route: dtype {dtype} not supported")
    if dtype == torch.float32:
        return "sm90_tf32"
    if _flash_dim(d) <= FLASH_HEAD_DIMS[-1]:
        return "sm90"
    return "sm90_wide"


def _launched(fn, dtype: torch.dtype, dp: int):
    """One launch of ``fn``'s kernel, also counted by its route apart from
    the Hopper kernels at 64 and 128 (:func:`flash_route`): in
    ``sm90_wide_launches`` or ``sm90_tf32_launches``."""
    fn.launches += 1
    route = flash_route(dtype, dp, fn.__name__)
    if route != "sm90":
        setattr(fn, f"{route}_launches",
                getattr(fn, f"{route}_launches") + 1)


def flash_fwd(q, k, v, causal: bool, scale: float):
    """(o, lse) of attention on [B, H, T, D] views; o is laid out as q."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    code, device, dp = _check_flash((("q", q), ("k", k), ("v", v)))
    _same_rows(k, v, ("k", "v"))
    (b, h, tq, d), tk = q.shape, k.shape[2]
    (q, k, v), dr = _flash_views(flash_fwd, dp, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=device)
    _check(_lib().hvd_flash_fwd(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), _strides(q, k, v, o), b, h, tq, tk, dr,
        int(causal), scale, _stream(device)), "flash_fwd")
    _launched(flash_fwd, q.dtype, dp)
    return o[..., :d], lse


flash_fwd.launches = 0


def flash_bwd_pre(o, do):
    """di = rowsum(do ∘ o), fp32 [B, H, T]."""
    if o.device.type == "cpu":
        return flash_bwd_pre_plain(o, do)
    code, device, dp = _check_flash((("o", o), ("do", do)))
    _same_rows(o, do, ("o", "do"))
    b, h, t, _ = o.shape
    (o, do), dr = _flash_views(flash_bwd_pre, dp, o, do)
    di = torch.empty(b, h, t, dtype=torch.float32, device=device)
    _check(_lib().hvd_flash_bwd_pre(
        device.index, code, o.data_ptr(), do.data_ptr(), di.data_ptr(),
        _strides(o, do), b, h, t, dr, _stream(device)), "flash_bwd_pre")
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
    (q, k, v, do), dr = _flash_views(flash_bwd_dkdv, dp, q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check(_lib().hvd_flash_bwd_dkdv(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, do, dk, dv), b, h, tq, tk, dr,
        int(causal), scale, _stream(device)), "flash_bwd_dkdv")
    _launched(flash_bwd_dkdv, q.dtype, dp)
    return dk[..., :d], dv[..., :d]


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q, k, v, do, lse, di, causal: bool, scale: float):
    """dq under the given lse and di; laid out as q."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, di, causal, scale)
    code, device, dp, (b, h, tq, tk, d) = _bwd_inputs(q, k, v, do)
    _check_stats((("lse", lse), ("di", di)), (b, h, tq), device)
    (q, k, v, do), dr = _flash_views(flash_bwd_dq, dp, q, k, v, do)
    dq = torch.empty_like(q)
    _check(_lib().hvd_flash_bwd_dq(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), b, h, tq, tk, dr, int(causal), scale,
        _stream(device)), "flash_bwd_dq")
    _launched(flash_bwd_dq, q.dtype, dp)
    return dq[..., :d]


flash_bwd_dq.launches = 0


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
    (q, k, v), dr = _flash_views(flash_seg_fwd, dp, q, k, v)
    o = _seg_out(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=device)
    _check(_lib().hvd_flash_seg_fwd(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), _seg_strides([q, k, v], [o], [lse]), b,
        h, s, s, dr, int(causal), scale, _stream(device)),
        "flash_seg_fwd")
    _launched(flash_seg_fwd, q.dtype, dp)
    return o[..., :d], lse


flash_seg_fwd.launches = 0


def flash_seg_bwd_dkdv(q, k, v, do, lse, di, causal: bool, scale: float):
    """fp32 (dk, dv) of one ring segment under the global lse and di."""
    if q.device.type == "cpu":
        return flash_seg_bwd_dkdv_plain(q, k, v, do, lse, di, causal, scale)
    code, device, dp, (b, h, s, d) = _seg_inputs(q, k, v, do)
    _check_seg_stats((("lse", lse), ("di", di)), (b, h, s), device)
    (q, k, v, do), dr = _flash_views(flash_seg_bwd_dkdv, dp, q, k, v, do)
    dk, dv = _seg_out(k), _seg_out(v)
    _check(_lib().hvd_flash_seg_bwd_dkdv(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _seg_strides([q, k, v, do], [dk, dv], [lse, di]), b,
        h, s, s, dr, int(causal), scale, _stream(device)),
        "flash_seg_bwd_dkdv")
    _launched(flash_seg_bwd_dkdv, q.dtype, dp)
    return dk[..., :d], dv[..., :d]


flash_seg_bwd_dkdv.launches = 0


def flash_seg_bwd_dq(q, k, v, do, lse, di, causal: bool, scale: float):
    """fp32 dq of one ring segment under the global lse and di."""
    if q.device.type == "cpu":
        return flash_seg_bwd_dq_plain(q, k, v, do, lse, di, causal, scale)
    code, device, dp, (b, h, s, d) = _seg_inputs(q, k, v, do)
    _check_seg_stats((("lse", lse), ("di", di)), (b, h, s), device)
    (q, k, v, do), dr = _flash_views(flash_seg_bwd_dq, dp, q, k, v, do)
    dq = _seg_out(q)
    _check(_lib().hvd_flash_seg_bwd_dq(
        device.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        _seg_strides([q, k, v, do], [dq], [lse, di]), b, h, s, s, dr,
        int(causal), scale, _stream(device)), "flash_seg_bwd_dq")
    _launched(flash_seg_bwd_dq, q.dtype, dp)
    return dq[..., :d]


flash_seg_bwd_dq.launches = 0


KERNELS = (pack, bn_stats, bn_bwd_stats, adasum_triple, adasum_scale,
           flash_fwd, flash_bwd_pre, flash_bwd_dkdv, flash_bwd_dq,
           flash_seg_fwd, flash_seg_bwd_dkdv, flash_seg_bwd_dq)
# wrappers whose launches also count by route (flash_route): the Hopper
# kernels above head dim 128 (sm90_wide) and on fp32 (sm90_tf32)
ROUTED_KERNELS = (flash_fwd, flash_bwd_dkdv, flash_bwd_dq, flash_seg_fwd,
                  flash_seg_bwd_dkdv, flash_seg_bwd_dq)
ROUTED_KERNELS_BY_NAME = {k.__name__: k for k in ROUTED_KERNELS}
# wrappers that copy inputs their kernel cannot read in place
# (flash_needs_copy), counted in ``pad_copies``
PADDING_KERNELS = ROUTED_KERNELS + (flash_bwd_pre,)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    pack.out_launches = pack.graph_launches = 0
    for k in ROUTED_KERNELS:
        k.sm90_wide_launches = k.sm90_tf32_launches = 0
    for k in PADDING_KERNELS:
        k.pad_copies = 0


def launch_counts() -> dict:
    """Launches by wrapper (every dtype and head dim), and by route
    (:func:`flash_route`): ``<wrapper>_sm90_wide``, the Hopper kernels on
    bf16 and fp16 above 128 (every wrapper at every head dim);
    ``<wrapper>_sm90_tf32``, the Hopper kernels on fp32 (every wrapper at
    every head dim). ``<wrapper>_pad_copies`` counts the calls of a K6/K7
    wrapper (di included) that copied their inputs zero-padded
    (:func:`flash_needs_copy`) before the launch. ``pack_out`` counts
    K1's launches into a caller's buffer (``out=``, among ``pack``'s) and
    ``pack_graph`` its launches as nodes of replayed CUDA graphs
    (:class:`PackTable`)."""
    counts = {k.__name__: k.launches for k in KERNELS}
    counts["pack_out"] = pack.out_launches
    counts["pack_graph"] = pack.graph_launches
    for k in ROUTED_KERNELS:
        counts[f"{k.__name__}_sm90_wide"] = k.sm90_wide_launches
        counts[f"{k.__name__}_sm90_tf32"] = k.sm90_tf32_launches
    for k in PADDING_KERNELS:
        counts[f"{k.__name__}_pad_copies"] = k.pad_copies
    return counts


reset_launch_counts()
