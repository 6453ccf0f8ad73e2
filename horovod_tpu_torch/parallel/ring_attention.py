"""Ring attention: sequence parallelism over the sequence axis's process group.

The port's counterpart of ``horovod_tpu/parallel/ring_attention.py``. The
sequence is sharded over the ranks of a process group; K/V blocks rotate
around the ring, one neighbour hop a step, while each rank merges the
per-block results into a running (out, lse) pair in fp32:

    lse' = logaddexp(lse, lse_b)
    out' = out·exp(lse − lse') + out_b·exp(lse_b − lse')

The whole ring is one ``torch.autograd.Function`` (the reference's
whole-ring custom VJP, :460-478). The forward saves only the local
(q, k, v, out, lse); the backward computes di = rowsum(dout ∘ out) once and
runs each block's flash backward under the GLOBAL lse and di, so no
lse-cotangent term appears, while the dk/dv accumulators travel around the
ring with their K/V blocks and one last hop takes them home.

Each (q block, kv block) interaction is FULL (every key visible), DIAG
(the aligned causal diagonal) or EMPTY. Ranks and owners are known on the
host, so the kind is a Python branch: an EMPTY segment launches nothing.
FULL and DIAG run kernel K7 (``csrc/flash_fwd_sm90.cu`` and
``csrc/flash_bwd_sm90.cu``, or ``csrc/flash_attn.cu`` for fp32 inputs; fp32
outputs, any dtype and head dim that K6 takes) through
:mod:`horovod_tpu_torch.ops.kernels`, or its plain versions on the CPU.

Zig-zag layout (``layout="zigzag"``): the sequence is cut into 2n stripes
and rank r holds stripes (r, 2n−1−r), so every rank does the same work at
every step under a causal mask (:func:`zigzag_indices`,
:func:`zigzag_pair_kinds`). The (lo, hi) pair is EMPTY at every step and is
never computed.

The hop is one ``dist.batch_isend_irecv`` on the sequence group (send to
rank+1, receive from rank−1, into fresh buffers), issued before the step's
kernels so the transfer overlaps them. At ring size 1 the hop is the
identity and no P2P call is made: ``force_ring=True`` then drives the
multi-rank code path on one device, the reference's way of measuring it on
one chip. What does not carry over: the chunked pure-JAX segment kernels
and their ``HOROVOD_RING_CHUNK``/``HOROVOD_RING_SEG_BLOCK``/
``HOROVOD_RING_PALLAS`` knobs (VMEM tiling rules of the TPU), and the
varying-manual-axes casts of ``shard_map``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops import kernels as K
from .flash_attention import flash_attention_local

_NEG_INF = K.NEG_INF

# Per-block segment kinds (the reference's lax.switch branch order).
KIND_EMPTY, KIND_DIAG, KIND_FULL = 0, 1, 2

# Segments computed by the ring's forward and backward passes since the
# last reset, kernel launches or plain runs alike: an EMPTY pair adds none.
SEGMENTS = {"forward": 0, "backward": 0}


def _merge(o, lse, o_b, lse_b):
    """Merge two normalised partial results over disjoint key sets."""
    lse_n = torch.logaddexp(lse, lse_b)
    w = torch.exp(lse - lse_n)[..., None]
    w_b = torch.exp(lse_b - lse_n)[..., None]
    return o * w + o_b * w_b, lse_n


def _kind(a: int, b: int) -> int:
    """Segment kind of q-stripe ``a`` attending kv-stripe ``b`` under the
    global causal order: FULL below the diagonal, DIAG on it, EMPTY above."""
    return KIND_FULL if a > b else (KIND_DIAG if a == b else KIND_EMPTY)


def _stripes(rank: int, n: int, zigzag: bool) -> Sequence[int]:
    """The global stripes a rank's local block holds, in local order."""
    return (rank, 2 * n - 1 - rank) if zigzag else (rank,)


def _parts(x, count: int) -> List[torch.Tensor]:
    """``count`` equal views of [B, H, T, ...] along T."""
    return list(x.chunk(count, dim=2)) if count > 1 else [x]


class _Hop:
    """One ring hop of some tensors: each goes to rank+1 and its counterpart
    comes from rank−1 into a fresh buffer (``received``). Every rank of the
    group issues its hops in the same order. Call :meth:`wait` before
    reading ``received``; the sent tensors are held until then."""

    def __init__(self, tensors, group, n: int, rank: int):
        nxt = dist.get_global_rank(group, (rank + 1) % n)
        prv = dist.get_global_rank(group, (rank - 1) % n)
        self._sent = [t.contiguous() for t in tensors]
        self.received = [torch.empty_like(t) for t in self._sent]
        ops = []
        for t, buf in zip(self._sent, self.received):
            ops.append(dist.P2POp(dist.isend, t, nxt, group))
            ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        self._reqs = dist.batch_isend_irecv(ops)

    def wait(self):
        for r in self._reqs:
            r.wait()
        self._sent = None
        return self.received


def _segments(rank: int, owner: int, n: int, causal: bool, zigzag: bool):
    """(q part, kv part, diag) of every non-EMPTY segment of the ring step
    at which ``rank`` holds the kv block of ``owner``."""
    out = []
    for i, a in enumerate(_stripes(rank, n, zigzag)):
        for j, b in enumerate(_stripes(owner, n, zigzag)):
            kind = _kind(a, b) if causal else KIND_FULL
            if kind != KIND_EMPTY:
                out.append((i, j, kind == KIND_DIAG))
    return out


def _ring_fwd(q, k, v, causal, zigzag, group, n, rank, scale):
    """[B, H, T, D] local blocks -> (out fp32, lse fp32 [B, H, T])."""
    count = 2 if zigzag else 1
    qs = _parts(q, count)
    acc = [None] * count          # (o, lse) of each q part
    k_cur, v_cur = k, v
    for step in range(n):
        hop = _Hop((k_cur, v_cur), group, n, rank) if step < n - 1 else None
        ks, vs = _parts(k_cur, count), _parts(v_cur, count)
        segs = _segments(rank, (rank - step) % n, n, causal, zigzag)
        for i, j, diag in segs:
            o_b, lse_b = K.flash_seg_fwd(qs[i], ks[j], vs[j], diag, scale)
            # merging into the empty (0, -1e30) start is exact: skip it
            acc[i] = (o_b, lse_b) if acc[i] is None else _merge(
                *acc[i], o_b, lse_b)
        SEGMENTS["forward"] += len(segs)
        if hop is not None:
            k_cur, v_cur = hop.wait()
    # every row sees at least its own position, so no part stays empty
    if count == 1:
        return acc[0]
    return (torch.cat([o for o, _ in acc], dim=2),
            torch.cat([s for _, s in acc], dim=2))


def _ring_bwd(q, k, v, out, lse, do, causal, zigzag, group, n, rank,
              scale):
    """(dq, dk, dv) fp32 of the local blocks under the global lse."""
    count = 2 if zigzag else 1
    di = K.flash_bwd_pre(out, do)
    qs, dos = _parts(q, count), _parts(do, count)
    lses, dis = _parts(lse, count), _parts(di, count)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq_parts = _parts(dq, count)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    k_cur, v_cur = k, v
    for step in range(n):
        hop = _Hop((k_cur, v_cur), group, n, rank) if step < n - 1 else None
        ks, vs = _parts(k_cur, count), _parts(v_cur, count)
        dks, dvs = _parts(dk, count), _parts(dv, count)
        segs = _segments(rank, (rank - step) % n, n, causal, zigzag)
        for i, j, diag in segs:
            args = (qs[i], ks[j], vs[j], dos[i], lses[i], dis[i], diag,
                    scale)
            dk_b, dv_b = K.flash_seg_bwd_dkdv(*args)
            dks[j] += dk_b
            dvs[j] += dv_b
            dq_parts[i] += K.flash_seg_bwd_dq(*args)
        SEGMENTS["backward"] += len(segs)
        if hop is not None:
            k_cur, v_cur = hop.wait()
        # the dk/dv accumulators travel with their K/V block; after n hops
        # each block's gradient is home (at n = 1 the hop is the identity)
        if n > 1:
            dk, dv = _Hop((dk, dv), group, n, rank).wait()
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    """The whole ring on [B, H, T, D] views; returns out in ``q.dtype``,
    laid out as q."""

    @staticmethod
    def forward(ctx, q, k, v, causal, zigzag, group, n, rank):
        scale = 1.0 / math.sqrt(q.shape[-1])
        out32, lse = _ring_fwd(q, k, v, causal, zigzag, group, n, rank,
                               scale)
        out = torch.empty_like(q)
        out.copy_(out32)
        # the local blocks only, out as q.dtype (the reference's residuals)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, zigzag, group, n, rank, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        do = dout.to(q.dtype)
        if do.is_cuda:
            do = K.flash_grad_in(do, "flash_seg_bwd_dkdv")
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, do, *ctx.args)
        grads = []
        for g, like in ((dq, q), (dk, k), (dv, v)):
            t = torch.empty_like(like)
            t.copy_(g)
            grads.append(t)
        return (*grads, None, None, None, None, None)


def _group_rank(group, n: int) -> int:
    if n == 1:
        return 0
    if group is None:
        raise ValueError("ring attention over more than one rank needs the "
                         "sequence axis's process group")
    return dist.get_rank(group)


def ring_attention_p(q, k, v, axis_name: Optional[dist.ProcessGroup],
                     axis_size: int, causal: bool = True,
                     layout: str = "contiguous", force_ring: bool = False,
                     under_remat: bool = False):
    """Blockwise ring attention over the process group ``axis_name``.

    Args:
      q, k, v: local blocks [B, T_local, H, D]. Under ``"contiguous"`` the
        global sequence is the blocks in group-rank order; under
        ``"zigzag"`` rank r holds stripes (r, 2n−1−r) of the 2n-striped
        sequence (:func:`zigzag_indices`).
      axis_name: the sequence axis's process group (None at size 1).
      axis_size: its size n.
      causal: a causal mask over global positions. Non-causal attention
        does not depend on the key order, so it runs the contiguous
        schedule under either layout.
      force_ring: run the ring path at n = 1 (identity hop) instead of
        routing to :func:`~horovod_tpu_torch.parallel.flash_attention.
        flash_attention_local`.
      under_remat: accepted for the reference's signature and ignored.

    Returns the local output [B, T_local, H, D] in q's dtype.
    """
    del under_remat
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    n = axis_size
    if n == 1 and not force_ring:
        return flash_attention_local(q, k, v, causal=causal)
    if layout == "zigzag" and q.shape[1] % 2:
        raise ValueError("zigzag layout needs an even local block length")
    rank = _group_rank(axis_name, n)
    zigzag = causal and layout == "zigzag"
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    out = _Ring.apply(qh, kh, vh, causal, zigzag, axis_name, n, rank)
    return out.transpose(1, 2)


def zigzag_indices(t_global: int, n: int):
    """Permutation from the natural sequence order to the zig-zag layout.

    The sequence is cut into 2n stripes; rank r owns stripes (r, 2n−1−r).
    A contiguous split over the seq axis of ``x[..., idx, ...]`` hands each
    rank its stripe pair. Returns (idx, inverse), int64 tensors; apply
    ``inverse`` to outputs to restore the natural order."""
    if t_global % (2 * n):
        raise ValueError(f"sequence length {t_global} not divisible into "
                         f"{2 * n} zigzag stripes")
    s = t_global // (2 * n)
    idx = np.concatenate([
        np.concatenate([np.arange(r * s, (r + 1) * s),
                        np.arange((2 * n - 1 - r) * s, (2 * n - r) * s)])
        for r in range(n)])
    inv = np.empty_like(idx)
    inv[idx] = np.arange(t_global)
    return torch.from_numpy(idx), torch.from_numpy(inv)


def zigzag_pair_kinds(rank: int, owner: int, n: int):
    """The zig-zag schedule: kinds of the four stripe-pair interactions
    when ``rank`` attends the block owned by ``owner``, as
    {(qs, ks): kind} with qs/ks in {"lo", "hi"}. The ring's branches follow
    exactly this arithmetic."""
    a_lo, a_hi = _stripes(rank, n, True)
    b_lo, b_hi = _stripes(owner, n, True)
    return {("lo", "lo"): _kind(a_lo, b_lo), ("lo", "hi"): _kind(a_lo, b_hi),
            ("hi", "lo"): _kind(a_hi, b_lo), ("hi", "hi"): _kind(a_hi, b_hi)}


def local_attention(q, k, v, causal: bool = True):
    """Single-device reference attention, [B, T, H, D] -> [B, T, H, D].

    The reference's casts, exactly: scores in fp32 divided by sqrt(D), the
    causal mask filled with -1e30, softmax in fp32, the probabilities cast
    to ``v.dtype`` before the PV product, which accumulates in fp32, and the
    output cast to ``q.dtype``."""
    _, t, _, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
