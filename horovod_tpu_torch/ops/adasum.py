"""Adasum: scale-invariant gradient reduction.

The port's counterpart of ``horovod_tpu/ops/adasum.py``: log2(n) levels of
pairwise exchange, the vector-halving distance-doubling (VHDD) schedule;
at level d rank r combines its vector with that of rank r XOR d:

    adasum(a, b) = (1 - a·b / (2|a|²)) a + (1 - a·b / (2|b|²)) b

(a coefficient of 0 for a zero norm). The combine is kernels K4 (the fp32
triple a·b, |a|², |b|²) and K5 (the scaled add, its coefficients computed
on the card from the triple in device memory), two launches and no host
round trip. Both are swap-symmetric bit for bit, so partners, each
combining (mine, theirs), hold the same bits after every level and every
rank ends with the same result.

- :func:`adasum_allreduce_p` runs the schedule across processes: one
  ``dist.batch_isend_irecv`` a level exchanges the whole vector with the
  partner, into a fresh buffer. A power-of-two group size is required.
- :func:`hierarchical_adasum` is the two-level form (local mean by a
  reduce-scatter, the VHDD across nodes on the shards with the triple
  summed over the local group, then a local all-gather).
- :func:`adasum_stacked` runs either schedule in one process on an
  (n, *s) stack, the counterpart of ``build_adasum``'s function, computing
  one combine a pair and level; it is how one card drives the multi-rank
  arithmetic.
- :func:`adasum_allreduce_handle` is the engine entry of ``op=Adasum``.

On CPU tensors the combine takes K4/K5's plain versions; on CUDA tensors it
launches the kernels, or raises on what they do not take. The JAX package's
``HOROVOD_ADASUM_PALLAS`` choice between its Pallas and lax combines does
not carry over: the port has one combine per device type, and on CUDA it is
K4/K5.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.engine import _join_meta_row
from . import collectives as C, kernels as K


def adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Adasum of two same-shape tensors, accumulated in fp32 and
    returned in ``a``'s dtype as a new tensor: K4 then K5."""
    if a.shape != b.shape:
        raise ValueError(f"adasum_combine: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if a.numel() == 0:
        return a.clone()
    return K.adasum_scale(K.adasum_triple(a, b), a, b)


def adasum_combine_sharded(a: torch.Tensor, b: torch.Tensor,
                           group) -> torch.Tensor:
    """Pairwise Adasum of vectors sharded over ``group``: K4 on the local
    shard, the triple summed over the group on the device, then K5, so the
    coefficients are those of the whole vectors."""
    triple = K.adasum_triple(a, b)
    dist.all_reduce(triple, group=group)
    return K.adasum_scale(triple, a, b)


def _check_pow2(size: int):
    if size & (size - 1):
        raise ValueError(f"Adasum requires a power-of-2 size, got {size}")


def _cross_size(size: int, local_size: int) -> int:
    cross = size // local_size
    if size % local_size or cross & (cross - 1):
        raise ValueError(
            f"hierarchical Adasum requires a power-of-2 cross size, got "
            f"{cross} (= {size}/{local_size})")
    return cross


def _exchange(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``x`` to ``peer`` (its rank in ``group``; the world when None)
    and receive the peer's tensor into a fresh buffer: the isend and the
    irecv in one batch, so neither partner blocks the other."""
    dst = peer if group is None else dist.get_global_rank(group, peer)
    recv = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                       dist.P2POp(dist.irecv, recv, dst,
                                                  group)]):
        req.wait()
    return recv


def adasum_allreduce_p(x: torch.Tensor, group, size: int,
                       rank: int) -> torch.Tensor:
    """Adasum of ``x`` over the ``size`` ranks of ``group`` (the world when
    None), ``rank`` this process's rank in it: level d exchanges with rank
    XOR d and combines (mine, theirs). No P2P call at size 1."""
    _check_pow2(size)
    d = 1
    while d < size:
        x = adasum_combine(x, _exchange(x.contiguous(), rank ^ d, group))
        d *= 2
    return x


def hierarchical_adasum(x: torch.Tensor, local_group, cross_group,
                        local_size: int, size: int,
                        rank: int) -> torch.Tensor:
    """Hierarchical Adasum over ``size`` ranks laid out as (cross, local),
    rank = c·local_size + l (``hierarchical_adasum_p``): pad to a multiple
    of ``local_size``, divide by it, sum-reduce-scatter within the node,
    run the VHDD across nodes on the shards (partner (c XOR d)·local + l,
    the ``cross_group`` of l) with the triple summed over the node, then
    all-gather within the node and trim. The node's contribution is the
    mean of its ranks' tensors."""
    cross = _cross_size(size, local_size)
    if local_size == 1:
        return adasum_allreduce_p(x, None, size, rank)
    shape = x.shape
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % local_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    flat = flat / local_size
    shard = flat.new_empty(flat.numel() // local_size)
    C.reduce_scatter(shard, flat, local_group)
    c = rank // local_size
    d = 1
    while d < cross:
        shard = adasum_combine_sharded(shard, _exchange(shard, c ^ d,
                                                        cross_group),
                                       local_group)
        d *= 2
    out = torch.empty_like(flat)
    C.all_gather(out, shard, local_group)
    return out[:n].reshape(shape)


def _vhdd_stacked(vs: List[torch.Tensor]) -> torch.Tensor:
    n = len(vs)
    _check_pow2(n)
    d = 1
    while d < n:
        nxt = list(vs)
        for r in range(n):
            if r < r ^ d:     # partners' results are the same bits
                nxt[r] = nxt[r ^ d] = adasum_combine(vs[r], vs[r ^ d])
        vs = nxt
        d *= 2
    return vs[0]


def _hierarchical_stacked(vs: List[torch.Tensor],
                          local_size: int) -> torch.Tensor:
    cross = _cross_size(len(vs), local_size)
    shape = vs[0].shape
    m = vs[0].numel()
    pad = (-m) % local_size
    chunk = (m + pad) // local_size
    flats = []
    for v in vs:
        f = v.reshape(-1)
        if pad:
            f = torch.cat([f, f.new_zeros(pad)])
        flats.append(f / local_size)
    # node c's shard l: the sum over the node's ranks of their chunk l
    shards = []
    for c in range(cross):
        node = flats[c * local_size:(c + 1) * local_size]
        row = []
        for l in range(local_size):
            s = node[0][l * chunk:(l + 1) * chunk]
            for f in node[1:]:
                s = s + f[l * chunk:(l + 1) * chunk]
            row.append(s)
        shards.append(row)
    d = 1
    while d < cross:
        nxt = [list(row) for row in shards]
        for c in range(cross):
            p = c ^ d
            if c > p:
                continue
            triple = None
            for a, b in zip(shards[c], shards[p]):
                t = K.adasum_triple(a, b)
                triple = t if triple is None else triple + t
            for l, (a, b) in enumerate(zip(shards[c], shards[p])):
                nxt[c][l] = nxt[p][l] = K.adasum_scale(triple, a, b)
        shards = nxt
        d *= 2
    return torch.cat(shards[0])[:m].reshape(shape)


def adasum_stacked(x: torch.Tensor, local_size: int = 0,
                   prescale_factor: float = 1.0,
                   postscale_factor: float = 1.0) -> torch.Tensor:
    """Adasum of the n ranks' tensors stacked as ``x`` (n, *s), returned as
    (*s): the VHDD schedule (``local_size`` <= 1) or the hierarchical one
    (n = cross·local_size), in one process, with the pre- and postscale
    around it (``build_adasum``'s function). One combine a pair and level:
    34 tensors of 4 ranks take 34 · 2 · 2 launches of each kernel flat."""
    vs = [x[r] for r in range(x.shape[0])]
    if prescale_factor != 1.0:
        vs = [v * prescale_factor for v in vs]
    if local_size > 1:
        out = _hierarchical_stacked(vs, local_size)
    else:
        out = _vhdd_stacked(vs)
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return out


def hierarchical_local_size(engine) -> int:
    """The local size of the hierarchical form when
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` is on and the collectively agreed
    topology (``engine.topology``, the layout every two-level collective
    shares) has one with a power-of-two cross size; else 0 (flat)."""
    if not (engine.config.hierarchical_allreduce
            and engine._hierarchical_ok()):
        return 0
    local = engine.topology.local_size
    cross = engine.topology.size // local
    return local if local > 1 and not cross & (cross - 1) else 0


def adasum_allreduce_handle(engine, tensor, name: Optional[str] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0):
    """Engine entry of op=Adasum: a handle on this rank's Adasum of
    ``tensor`` over the world (flat, or hierarchical as
    :func:`hierarchical_local_size` decides), with the pre- and postscale
    around it. The work is issued here; on CUDA the handle completes when
    the stream reaches its end. At size > 1 it posts the engine's join
    round first (kind ``adasum``), so a joined rank runs this function with
    a zero tensor beside it."""
    x = engine._tensor(tensor)
    sub = engine._consume_substitute()
    # the per-tensor coefficient recursion is not a replayable bucket: a
    # step holding one never arms (core/replay.py)
    engine.replay.observe("adasum", sub, [x], name)
    name = engine._register(name, "adasum")
    engine._join_sync("adasum", [_join_meta_row(x, 0)], sub)
    v = x.clone(memory_format=torch.contiguous_format)
    if prescale_factor != 1.0:
        v.mul_(prescale_factor)
    size = engine.backend.size()
    if size > 1 and v.numel():
        rank = engine.backend.rank()
        local = hierarchical_local_size(engine)
        if local:
            v = hierarchical_adasum(v, *engine.hierarchical_groups(), local,
                                    size, rank)
        else:
            v = adasum_allreduce_p(v, None, size, rank)
    if postscale_factor != 1.0:
        v = v * postscale_factor
    return engine.track_result(name, v)


def adasum_reference(vectors) -> np.ndarray:
    """NumPy float64 VHDD of the ranks' vectors (the reference's
    ``adasum_reference``)."""

    def combine(a, b):
        a = a.astype(np.float64)
        b = b.astype(np.float64)
        dot = float(np.sum(a * b))
        na = float(np.sum(a * a))
        nb = float(np.sum(b * b))
        ca = 0.0 if na == 0 else 1.0 - dot / (2 * na)
        cb = 0.0 if nb == 0 else 1.0 - dot / (2 * nb)
        return ca * a + cb * b

    vecs = [np.asarray(v) for v in vectors]
    _check_pow2(len(vecs))
    d = 1
    while d < len(vecs):
        vecs = [combine(vecs[r], vecs[r ^ d]) for r in range(len(vecs))]
        d *= 2
    return vecs[0]
