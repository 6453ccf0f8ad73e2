"""Pack/unpack layer of the fused allreduce, the buckets of the ZeRO-1
sharded step, the wire codecs' compressed reduction, and the collective
algorithms and their selection.

Counterpart of the pack, scale and unpack steps of
``horovod_tpu/ops/collectives.py`` (``build_pack`` :1291, ``build_pack_group``
:1130, ``_unpack_flat`` :1395, the prescale/postscale of
``build_fused_allreduce`` :1044-1093), of its ZeRO-1 helpers
(``shard_spec`` :1304, ``_rs_flat`` :1315, ``_ag_flat`` :1367), of its
codec reducers (``codec_residual_elems`` :310, ``_rs_flat_codec`` :1332,
``_make_codec_reducer`` :360-393, ``ef_allreduce_p`` :398), and of its
algorithm selection (:60-303) and the reducers it selects between
(``_make_reduce_flat`` :948-998, ``hierarchical_alltoall_p`` :544-597,
``build_hierarchical_allgather`` :740-768). The flat collective itself is
a ``torch.distributed`` call made by the engine.

The compressed reduction (:func:`rs_flat_codec`, :func:`codec_allreduce`):
a quantized payload cannot be summed on the wire, so each rank encodes its
whole zero-padded bucket (with error feedback: quantize(flat + residual)),
an all-to-all hands rank r chunk r of every peer's payload, and rank r
decodes its chunks with their senders' scales and sums them in float32
into its own slice; a full-precision all-gather then returns every slice
(enc + nbytes on the wire against the ring's 2 x nbytes). Payloads travel
as byte views, so neither NCCL nor gloo needs to know int8, fp8 or bf16:
they move the bytes and never reduce them. The hierarchical arm
(:func:`codec_hier_allreduce`) encodes only the cross-island leg.

The algorithms (:func:`choose_algorithm` picks one per fusion bucket):
the flat ring (one ``all_reduce``), the recursive-doubling tree
(:func:`tree_allreduce`: log2(n) in-place ``all_reduce`` rounds over pair
groups) and the two-level ladder (:func:`hier_allreduce`: reduce-scatter
over the local group, then over the cross group, all-gather over the
cross group, then over the local group, in place). Where the JAX package
passes ``axis_index_groups`` to one collective, the port calls it on the
process group of this rank's line of ranks; the engine creates every such
group at init (``dist.new_group`` is collective).
"""

from __future__ import annotations

import itertools
import logging
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common.env import DEFAULT_TREE_THRESHOLD_BYTES
from . import compression as comp
from . import kernels

logger = logging.getLogger("horovod_tpu_torch")

# ---------------------------------------------------------------------------
# algorithm selection (the reference's :44-303)
# ---------------------------------------------------------------------------

ALGO_FLAT = "flat"
ALGO_TREE = "tree"
ALGO_HIERARCHICAL = "hierarchical"
ALGORITHMS = (ALGO_FLAT, ALGO_TREE, ALGO_HIERARCHICAL)

# kinds the selection covers; every other is flat
_SELECTABLE_KINDS = ("allreduce", "reducescatter", "allgather", "alltoall")

_warned_demotions: set = set()


def _demote(key: tuple, msg: str) -> str:
    """One WARNING per process and reason; returns the flat algorithm: a
    forcing or topology the world cannot express degrades, it never
    raises."""
    if key not in _warned_demotions:
        _warned_demotions.add(key)
        logger.warning("collective algorithm selection: %s; using flat", msg)
    return ALGO_FLAT


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def validate_algorithm(kind: str, algo: str, n: int, local_size: int) -> str:
    """Demote an algorithm the (kind, world, topology) cannot express:

    - tree needs a power-of-two world (the recursive-doubling pair rounds)
      and applies to reductions only;
    - hierarchical needs an exact non-trivial (cross, local)
      factorization, and never applies to reduce-scatter: ZeRO-1's shard
      ownership (rank r owns contiguous chunk r of the padded buffer,
      :func:`shard_spec`) pins the scatter to the flat ring, since a
      two-level scatter permutes chunk ownership."""
    if algo not in ALGORITHMS:
        return _demote((kind, algo), f"unknown algorithm {algo!r}")
    if n <= 1 or algo == ALGO_FLAT:
        return ALGO_FLAT
    if algo == ALGO_TREE:
        if kind not in ("allreduce",):
            return _demote((kind, algo),
                           f"tree does not apply to {kind}")
        if not _is_pow2(n):
            return _demote((kind, algo, n),
                           f"tree needs a power-of-2 world, have {n}")
        return ALGO_TREE
    if kind == "reducescatter":
        return _demote((kind, algo),
                       "reduce-scatter keeps the flat ring (shard-"
                       "ownership invariant, see validate_algorithm)")
    if not (1 < local_size < n and n % local_size == 0):
        return _demote((kind, algo, n, local_size),
                       f"no exact (cross, local) factorization for "
                       f"world {n} with local_size {local_size}")
    return ALGO_HIERARCHICAL


def choose_algorithm(kind: str, nbytes: int, topology,
                     force: str = "auto",
                     tree_threshold_bytes: int =
                     DEFAULT_TREE_THRESHOLD_BYTES,
                     hier_threshold_bytes: int = 0) -> str:
    """The algorithm of ONE bucket of ``kind`` carrying ``nbytes`` a rank
    over ``topology`` (a :class:`~..parallel.mesh.Topology`).

    ``force`` other than "auto" pins the choice (demoted when the world
    cannot express it). Auto rules:

    - a reduction of at most ``tree_threshold_bytes`` on a power-of-two
      world of 4 or more takes the tree: log2(n) latency steps against
      the ring's 2(n-1) (at n=2 tree and flat are one exchange);
    - above it, allreduce, allgather and alltoall take the two-level
      form when the topology factorizes and the payload reaches
      ``hier_threshold_bytes`` (0: always);
    - otherwise the flat ring.

    Deterministic in (kind, bytes, topology, knobs): every rank computes
    the same program, and so do replay and a joined rank's substitute."""
    n = int(topology.size)
    local = int(topology.local_size)
    if n <= 1 or kind not in _SELECTABLE_KINDS:
        return ALGO_FLAT
    if force != "auto":
        return validate_algorithm(kind, force, n, local)
    if (kind == "allreduce" and nbytes <= tree_threshold_bytes
            and n >= 4 and _is_pow2(n)):
        return ALGO_TREE
    if (kind in ("allreduce", "allgather", "alltoall")
            and topology.hierarchical_ok
            and nbytes >= hier_threshold_bytes):
        return ALGO_HIERARCHICAL
    return ALGO_FLAT


def link_split(algo: str, nbytes: int, local_size: int,
               kind: str = "allreduce", codec: str = comp.CODEC_NONE,
               itemsize: int = 4, size: int = 0) -> dict:
    """One bucket's payload bytes by the fabric link that paces them
    (``ici`` the fast fabric, ``dcn`` the slow one, ``flat`` the whole
    world), each byte counted once (the reference's :171-232):

    - hierarchical allreduce: 1/local_size of the payload crosses
      islands, the rest rides the local legs;
    - hierarchical allgather: every byte crosses (whole island blocks);
    - hierarchical alltoall: the (C-1)/C of the payload bound for other
      islands crosses (C = ``size // local_size``; ``size`` is needed for
      this kind only), the rest stays local;
    - every other form is ``flat``.

    ``codec`` shrinks the encoded leg: on the ladder only the cross
    exchange; on flat and tree allreduce half the payload (the compressed
    reduce-scatter, then the full-precision all-gather); a reduce-scatter
    all of it. ``itemsize`` is the uncompressed element size. These are
    submitted bytes, not link traffic."""
    nbytes = int(nbytes)

    def enc(b):
        if codec == comp.CODEC_NONE:
            return b
        return (b // itemsize) * comp.wire_itemsize(codec, itemsize)

    if algo == ALGO_HIERARCHICAL and local_size > 1:
        if kind == "allgather":
            return {"dcn": nbytes}
        if kind == "alltoall":
            cross = max(size // local_size, 1)
            dcn_raw = nbytes - nbytes // cross
            return {"dcn": enc(dcn_raw), "ici": nbytes - dcn_raw}
        dcn_raw = nbytes // local_size
        return {"dcn": enc(dcn_raw), "ici": nbytes - dcn_raw}
    if kind in ("allgather", "alltoall"):
        return {"flat": nbytes}
    if kind == "reducescatter":
        return {"flat": enc(nbytes)}
    half = nbytes // 2
    return {"flat": enc(half) + (nbytes - half)}


def slice_groups(n: int, local_size: int):
    """The one island-major rank layout every two-level collective shares:
    ``(local_groups, cross_groups)``, island c holding ranks ``[c·L,
    (c+1)·L)`` and cross group l the ranks at local index l, each list
    ascending. A process group's rank is the member's position in its
    list, so the reduce-scatter and the all-gather of every leg agree on
    which rank owns which chunk."""
    cross = n // local_size
    local_groups = [[c * local_size + l for l in range(local_size)]
                    for c in range(cross)]
    cross_groups = [[c * local_size + l for c in range(cross)]
                    for l in range(local_size)]
    return local_groups, cross_groups


def ring_edge_is_dcn(n: int, local_size: int) -> Tuple[bool, ...]:
    """Whether each of the n ring edges (rank i to rank (i+1) % n) crosses
    islands under :func:`slice_groups`' layout (the rule of the pipeline
    boundary codec's ``parallel/mesh.py`` ``pipeline_boundary_edges`` at
    one rank a stage). A world of one island has none."""
    if local_size <= 1 or local_size >= n or n % local_size:
        return tuple([False] * n)
    return tuple((i // local_size) != (((i + 1) % n) // local_size)
                 for i in range(n))


def tree_groups(n: int) -> List[List[List[int]]]:
    """The recursive-doubling rounds of a power-of-two world: round k pairs
    the ranks that differ in bit k; after log2(n) pairwise sums every rank
    holds the whole reduction (Thakur et al. 2005)."""
    assert _is_pow2(n), n
    rounds = []
    k = 1
    while k < n:
        rounds.append([[r, r | k] for r in range(n) if not (r & k)])
        k <<= 1
    return rounds


# ---------------------------------------------------------------------------
# the reducers of one flat buffer (the reference's _make_reduce_flat,
# :948-998): tree and the two-level ladder. Sum only; the engine keeps the
# prescale, Average's divide and the postscale around them (finish_reduce)
# ---------------------------------------------------------------------------


def tree_allreduce(flat: torch.Tensor, groups: Sequence) -> int:
    """Sum ``flat`` over the world in place in log2(n) rounds: round k an
    ``all_reduce`` over this rank's pair group of round k (``groups``, in
    round order; None is the whole world, a pair at n = 2). On the card
    each round is ordered on the current stream after the last, with no
    host wait. Returns the collectives launched."""
    for group in groups:
        dist.all_reduce(flat, group=group)
    return len(groups)


def hier_allreduce(flat: torch.Tensor, local_group, cross_group,
                   local_size: int, cross_size: int) -> int:
    """The two-level ladder on ``flat``, padded to a multiple of n = local
    × cross (K1 packs into :func:`padded_bucket`, whose tail is zero), in
    place: reduce-scatter over the local group (this rank keeps its
    local chunk l), reduce-scatter of that over the cross group (chunk c
    of it), all-gather over the cross group, all-gather over the local
    group. Every element is the local groups' sums summed across islands.
    Returns the collectives launched."""
    n = local_size * cross_size
    if flat.numel() % n:
        raise ValueError(f"the ladder's buffer of {flat.numel()} elements "
                         f"is not padded to {n} ranks")
    part = flat.numel() // local_size
    l = dist.get_rank(local_group)
    mine = flat[l * part:(l + 1) * part]
    shard_len = part // cross_size
    c = dist.get_rank(cross_group)
    shard = mine[c * shard_len:(c + 1) * shard_len]
    reduce_scatter(mine, flat, local_group)
    reduce_scatter(shard, mine, cross_group)
    all_gather(mine, shard, cross_group)
    all_gather(flat, mine, local_group)
    return 4


def hier_all_gather(out: torch.Tensor, inp: torch.Tensor, local_group,
                    cross_group, local_size: int, cross_size: int) -> int:
    """:func:`all_gather` in two legs (the reference's
    ``build_hierarchical_allgather``): every rank's ``inp`` gathered over
    the local group into this island's block of ``out``, then the
    islands' blocks over the cross group into ``out``. The islands are
    contiguous rank ranges, so ``out`` is in rank order, bitwise the flat
    gather's; ``inp`` may be this rank's own slice of ``out`` (ZeRO-1's
    parameter buffer), and then both legs run in place. Returns the
    collectives launched."""
    block_len = out.shape[0] // cross_size
    c = dist.get_rank(cross_group)
    block = out[c * block_len:(c + 1) * block_len]
    all_gather(block, inp, local_group)
    all_gather(out, block, cross_group)
    return 2


def hier_alltoall(x: torch.Tensor, local_group, cross_group,
                  local_size: int, cross_size: int,
                  codec: str = comp.CODEC_NONE) -> torch.Tensor:
    """The two-phase equal-split alltoall of an island-major world (the
    reference's ``hierarchical_alltoall_p``): rank r's dim 0 is n blocks
    of m rows, block j bound for rank j, viewed as (C, L, m, ...).

    - phase 1, over the local group along L: afterwards position [c', j]
      holds the block local peer j sends to rank c'·L + l, so every row
      bound for island c' is one contiguous block;
    - phase 2, over the cross group along C: whole island blocks cross.

    Pure routing: with ``codec`` "none" the result is bitwise the flat
    alltoall's. ``codec`` encodes the phase-2 payload only, with no
    residual (dispatched rows have no step-over-step identity for one),
    each received block decoded with its sender's scale (the scales
    gathered over the cross group)."""
    L, Cn = int(local_size), int(cross_size)
    n = L * Cn
    if x.shape[0] % n:
        raise ValueError(f"the two-phase alltoall needs dim 0 ({x.shape[0]})"
                         f" divisible by the world size ({n})")
    m = x.shape[0] // n
    rest = tuple(x.shape[1:])
    blk = x.reshape((Cn, L, m) + rest)
    # phase 1: the local group's all-to-all runs along dim 0, so L leads
    send = blk.transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    all_to_all(recv, send, [1] * L, [1] * L, local_group)
    y = recv.transpose(0, 1).contiguous()          # (C, L, m, ...)
    if codec == comp.CODEC_NONE:
        z = torch.empty_like(y)
        all_to_all(z, y, [1] * Cn, [1] * Cn, cross_group)
        return z.reshape(x.shape)
    payload, scale = comp.encode(y, codec)
    got = torch.empty_like(payload)
    all_to_all(got.view(torch.uint8).reshape(Cn, -1),
               payload.view(torch.uint8).reshape(Cn, -1),
               [1] * Cn, [1] * Cn, cross_group)
    scales = None
    if scale is not None:
        scales = scale.new_empty(Cn)
        all_gather(scales, scale, cross_group)
        scales = scales.reshape((Cn,) + (1,) * (got.dim() - 1))
    return comp.decode(got, scales, codec, x.dtype).reshape(x.shape)


# ---------------------------------------------------------------------------
# pack, scale, unpack
# ---------------------------------------------------------------------------


def pack_bucket(tensors: Sequence[torch.Tensor],
                use_kernel: bool) -> torch.Tensor:
    """One bucket's tensors as one new flat buffer: the hand-written pack
    kernel when ``use_kernel`` (``HOROVOD_PALLAS_PACK``), else the plain
    concatenation the reference packs with by default."""
    if use_kernel:
        return kernels.pack(tensors)
    return kernels.pack_plain(tensors)


# bytes: each bucket of a mixed-dtype group buffer starts on a multiple
_GROUP_ALIGN = 16


def pack_group(tensors: Sequence[torch.Tensor], buckets,
               prescale_factor: float = 1.0) -> List[torch.Tensor]:
    """Every bucket of ``buckets`` (index lists into ``tensors``, one dtype a
    bucket) packed by one plain pack into one buffer (the reference's
    ``build_pack_group``, the single-launch form's pack), then scaled in
    place by ``prescale_factor``: each bucket's flat buffer is a slice of
    it. Buckets of one dtype share a buffer of that dtype; a group of
    several dtypes packs bytes, each bucket starting on a 16-byte
    boundary."""
    if not buckets:
        return []
    members = [[tensors[i].reshape(-1) for i in idxs] for idxs in buckets]
    if len({m[0].dtype for m in members}) == 1:
        flat = prescale(torch.cat([t for m in members for t in m]),
                        prescale_factor)
        return unpack_flat(flat, [(sum(t.numel() for t in m),)
                                  for m in members])
    parts, spans, offset, pad = [], [], 0, None
    for m in members:
        nbytes = sum(t.numel() * t.element_size() for t in m)
        parts += [t.view(torch.uint8) for t in m]
        spans.append((offset, nbytes, m[0].dtype))
        offset += nbytes
        gap = -offset % _GROUP_ALIGN
        if gap:
            if pad is None:
                pad = torch.zeros(_GROUP_ALIGN, dtype=torch.uint8,
                                  device=m[0].device)
            parts.append(pad[:gap])
            offset += gap
    raw = torch.cat(parts)
    return [prescale(raw[o:o + n].view(dtype), prescale_factor)
            for o, n, dtype in spans]


def prescale(flat: torch.Tensor, factor: float) -> torch.Tensor:
    """In place on the private packed buffer, before the reduce."""
    if factor != 1.0:
        flat.mul_(factor)
    return flat


def finish_reduce(flat: torch.Tensor, average_over: int,
                  postscale_factor: float) -> torch.Tensor:
    """After a SUM reduce: divide by the world size for Average (as the
    reference does, ``psum`` then ``/ n``), then postscale. In place."""
    if average_over > 1:
        flat.div_(average_over)
    if postscale_factor != 1.0:
        flat.mul_(postscale_factor)
    return flat


def unpack_flat(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    """The bucket's members as views of the flat buffer at their prefix-sum
    offsets: no copy, so unpack needs no kernel."""
    out, offset = [], 0
    for shape in shapes:
        size = math.prod(shape)
        out.append(flat[offset:offset + size].view(shape))
        offset += size
    return out


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group,
                   async_op: bool = False):
    """Sum ``inp`` over ``group`` (the world when None), this rank keeping
    its dim-0 chunk in ``out``: ``reduce_scatter_single`` where torch has
    it, else its older name ``reduce_scatter_tensor``."""
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    return fn(out, inp, group=group, async_op=async_op)


def a2a_pack(tensors: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """One alltoall bucket's exchange buffer (the reference's
    ``_a2a_pack``): each (d0_i, ...) tensor, d0_i % n == 0, viewed as its
    (n, w_i) chunk matrix (row j the chunk bound for rank j), the rows
    concatenated into one contiguous (n, R) buffer, so the pack is the
    fusion: every destination's data is one row."""
    parts = [t.reshape(n, -1) for t in tensors]
    if len(parts) == 1:
        return parts[0].contiguous()
    return torch.cat(parts, dim=1)


def a2a_unpack(out: torch.Tensor, shapes) -> List[torch.Tensor]:
    """Each member's received tensor from a bucket's (n, R) result: its
    columns, in the pack's order, reshaped to its shape (a view for a
    bucket of one)."""
    if len(shapes) == 1:
        return [out.reshape(shapes[0])]
    n, res, off = out.shape[0], [], 0
    for shape in shapes:
        w = math.prod(shape) // n
        res.append(out[:, off:off + w].reshape(shape))
        off += w
    return res


def lazy_a2a_unpack(out: torch.Tensor, shapes):
    """:func:`a2a_unpack` deferred to the first call and kept: a bucket of
    several members copies its columns, which must wait until the
    exchange that fills ``out`` is done."""
    done: List[List[torch.Tensor]] = []

    def unpack() -> List[torch.Tensor]:
        if not done:
            done.append(a2a_unpack(out, shapes))
        return done[0]

    return unpack


def all_gather(out: torch.Tensor, inp: torch.Tensor, group,
               async_op: bool = False):
    """Concatenate every rank's ``inp`` of ``group`` along dim 0 into
    ``out`` (``all_gather_single``, else ``all_gather_into_tensor``)."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    return fn(out, inp, group=group, async_op=async_op)


def all_to_all(out: torch.Tensor, inp: torch.Tensor, out_splits: List[int],
               in_splits: List[int], group, async_op: bool = False):
    """Send ``in_splits[r]`` rows of ``inp`` (in rank order along dim 0) to
    rank r of ``group`` (the world when None) and receive ``out_splits[r]``
    rows from it into ``out``: ``all_to_all_single`` with uneven sizes
    where torch has it, else ``all_to_all`` on the row blocks."""
    fn = getattr(dist, "all_to_all_single", None)
    if fn is not None:
        return fn(out, inp, out_splits, in_splits, group=group,
                  async_op=async_op)
    return dist.all_to_all(list(out.split(out_splits)),
                           list(inp.split(in_splits)), group=group,
                           async_op=async_op)


# ---------------------------------------------------------------------------
# ZeRO-1: padded buckets, the flat reduce-scatter and the in-place all-gather
# ---------------------------------------------------------------------------


def shard_spec(total: int, n: int) -> tuple:
    """``(padded, shard)`` of a flat bucket of ``total`` elements over ``n``
    ranks: ``shard = ceil(total / n)`` and ``padded = shard * n``; rank r owns
    ``[r·shard, (r+1)·shard)`` of the zero-padded buffer, so the
    reduce-scatter and all-gather pair is exact for any total."""
    shard = -(-int(total) // int(n)) if n > 0 else int(total)
    return shard * n, shard


_BUCKET_TOKENS = itertools.count()


class ShardBucket:
    """One fusion bucket of a ZeRO-1 layout over ``n`` ranks: ``sizes``
    elements of one dtype (the layout's tensors ``idxs``), padded to
    ``padded = shard * n``. ``params`` is the flat home of the bucket's
    parameters, each a view of it; ``grads`` is the buffer its gradients are
    packed into. Both start as zeros and only ``[0, total)`` is ever written,
    so their tails stay zero with no memset. ``param_shard`` and
    ``grad_shard`` are this rank's ``[rank·shard, (rank+1)·shard)`` of each:
    the reduce-scatter writes its sum into ``grad_shard`` in place and the
    all-gather reads ``param_shard`` in place."""

    def __init__(self, idxs: Sequence[int], sizes: Sequence[int],
                 dtype: torch.dtype, device: torch.device, n: int,
                 rank: int):
        # the identity of the bucket's error-feedback residual lineage
        self.token = next(_BUCKET_TOKENS)
        self.n = n
        self.idxs = tuple(int(i) for i in idxs)
        self.sizes = tuple(int(s) for s in sizes)
        self.total = sum(self.sizes)
        self.padded, self.shard = shard_spec(self.total, n)
        self.params = torch.zeros(self.padded, dtype=dtype, device=device)
        self.grads = torch.zeros_like(self.params)
        lo = rank * self.shard
        self.param_shard = self.params[lo:lo + self.shard]
        self.grad_shard = self.grads[lo:lo + self.shard]


def pack_padded(tensors: Sequence[torch.Tensor], out: torch.Tensor,
                use_kernel: bool) -> torch.Tensor:
    """Pack ``tensors`` into ``out[:numel]`` of a padded buffer whose tail
    the caller keeps zero: K1's ``out=`` form when ``use_kernel``, else the
    plain one. No copy pads the bucket."""
    if use_kernel:
        return kernels.pack(tensors, out=out)
    return kernels.pack_plain(tensors, out=out)


def rs_flat(flat: torch.Tensor, shard: torch.Tensor, group,
            async_op: bool = False):
    """Sum the padded ``flat`` over ``group`` (the world when None), this
    rank's chunk landing in ``shard``, its own slice of ``flat`` (in place).
    Average is this Sum, then :func:`finish_reduce`'s divide on the shard,
    as the reference's ``_rs_flat`` does it."""
    return reduce_scatter(shard, flat, group, async_op)


def ag_flat(flat: torch.Tensor, shard: torch.Tensor, group,
            async_op: bool = False):
    """The inverse of :func:`rs_flat`: every rank's ``shard`` (its own slice
    of ``flat``) gathered into ``flat`` in place (the reference's
    ``_ag_flat``; the padded tail is never read back)."""
    return all_gather(flat, shard, group, async_op)


def scatter_shards(buckets: Sequence[ShardBucket],
                   tensors: Sequence[torch.Tensor], use_kernel: bool,
                   average_over: int, prescale_factor: float,
                   postscale_factor: float, group,
                   collective: bool = True, codecs=None,
                   residuals=None, interleave: bool = False) -> int:
    """A sharded step's first half: per bucket pack ``tensors`` (the
    gradients, indexed by the bucket's ``idxs``), prescale and post the
    reduce-scatter (with ``interleave``, every bucket's pack first, then
    the reduce-scatters back to back); then wait for each (a stream
    dependency on the card) and finish its shard (Average's divide, the
    postscale). A bucket whose ``codecs`` entry is a wire codec runs the
    compressed reduce-scatter (:func:`rs_flat_codec`) instead, its
    ``residuals`` entry updated in place. Without ``collective`` (a group
    of one rank outside the world) the packed buffer is the sum. Returns
    the collectives launched."""
    def pack(b):
        pack_padded([tensors[j] for j in b.idxs], b.grads, use_kernel)
        prescale(b.grads[:b.total], prescale_factor)

    if interleave:
        for b in buckets:
            pack(b)
    works, launched = [], 0
    for i, b in enumerate(buckets):
        if not interleave:
            pack(b)
        codec = codecs[i] if codecs else comp.CODEC_NONE
        if codec != comp.CODEC_NONE:
            rs_flat_codec(b.grads, b.grad_shard, residuals[i], codec, b.n,
                          group, collective)
            launched += collective
        elif collective:
            works.append(rs_flat(b.grads, b.grad_shard, group, async_op=True))
    for w in works:
        w.wait()
    for b in buckets:
        finish_reduce(b.grad_shard, average_over, postscale_factor)
    return launched + len(works)


def gather_shards(buckets: Sequence[ShardBucket], group,
                  collective: bool = True, algos=None, hier=None) -> int:
    """A sharded step's second half: every bucket's all-gather into its
    parameter buffer, in place, then a wait for each (a stream dependency
    on the card, never a host wait). A bucket whose ``algos`` entry is
    hierarchical gathers in two legs (:func:`hier_all_gather` with
    ``hier``, ``(local group, cross group, local size, cross size)``),
    bitwise the flat gather. Returns the collectives launched (one a bucket)."""
    if not collective:
        return 0
    algos = algos or (ALGO_FLAT,) * len(buckets)
    works = []
    for b, algo in zip(buckets, algos):
        if algo == ALGO_HIERARCHICAL:
            hier_all_gather(b.params, b.param_shard, *hier)
        else:
            works.append(ag_flat(b.params, b.param_shard, group,
                                 async_op=True))
    for w in works:
        w.wait()
    return len(buckets)


# ---------------------------------------------------------------------------
# wire codecs: the flat compressed reduction
# ---------------------------------------------------------------------------


def codec_residual_elems(cls: str, total: int, n: int, local_size: int,
                         algo: Optional[str], codec: str) -> Optional[int]:
    """Length of one error-feedback bucket's residual, the one shape rule
    the engine and replay share (the reference's :310-330): for the
    allreduce family (``cls`` "reduce") the local reduce-scatter's shard,
    the bucket padded to ``local_size`` over ``local_size``, on the
    hierarchical ladder (only the cross leg is encoded), and the whole
    zero-padded bucket, ``shard_spec(total, n)[0]``, on flat and tree
    (the compressed reduce-scatter encodes every element before the
    exchange); for the ZeRO-1 reduce-scatter leg ("sharded") the whole
    padded bucket. None: the codec carries no residual. The two lengths
    of a bucket of one element or more always differ, so a residual of
    one arm is never taken for the other's."""
    if codec not in comp.EF_CODECS:
        return None
    if cls not in ("reduce", "sharded"):
        raise ValueError(f"unknown residual class {cls!r}")
    total = int(total)
    if cls == "reduce" and algo == ALGO_HIERARCHICAL and local_size > 1:
        return shard_spec(total, local_size)[1]
    return shard_spec(total, n)[0]


def padded_bucket(total: int, n: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """An uninitialised buffer of ``shard_spec(total, n)[0]`` elements whose
    tail past ``total`` is zero: a bucket is packed into its prefix, so no
    copy pads it."""
    padded = shard_spec(int(total), n)[0]
    buf = torch.empty(padded, dtype=dtype, device=device)
    buf[total:].zero_()
    return buf


def rs_flat_codec(flat: torch.Tensor, shard: torch.Tensor,
                  residual: Optional[torch.Tensor], codec: str, n: int,
                  group, collective: bool = True):
    """The compressed reduce-scatter (the reference's ``_rs_flat_codec``):
    encode the whole padded ``flat`` (in place with ``residual``, which
    takes the new residual), send chunk r of the payload to rank r of
    ``group`` and gather every rank's scale, then decode and sum the
    received chunks in float32 into ``shard``, this rank's slice of
    ``flat`` (Sum; Average divides it after). Without ``collective`` (a
    group of one rank) the payload is the only contribution. Returns this
    rank's ``(payload, scale)``."""
    payload, scale = comp.ef_encode_(flat, residual, codec)
    recv, scales = payload, scale
    if collective:
        # byte views: the transports move the bytes, never reduce them
        recv = torch.empty_like(payload)
        chunks = [payload.numel() * payload.element_size() // n] * n
        all_to_all(recv.view(torch.uint8), payload.view(torch.uint8),
                   chunks, chunks, group)
        if scale is not None:
            scales = scale.new_empty(n)
            all_gather(scales, scale, group)
    comp.decode_sum(recv.view(n, -1), scales, codec, flat.dtype, out=shard)
    return payload, scale


def codec_allreduce(flat: torch.Tensor, total: int,
                    residual: Optional[torch.Tensor], codec: str, n: int,
                    rank: int, average_over: int, prescale_factor: float,
                    postscale_factor: float, group,
                    collective: bool = True):
    """The flat codec reduction of one padded bucket, in place: prescale
    ``flat[:total]``, :func:`rs_flat_codec` into this rank's slice,
    Average's divide on it, the full-precision all-gather of every slice
    into ``flat`` (in place), then the postscale (the reference's
    ``_make_codec_reducer`` flat arm, :388-393). ``flat`` holds
    ``shard_spec(total, n)[0]`` elements with a zero tail. Returns this
    rank's ``(payload, scale)``."""
    shard_len = shard_spec(int(total), n)[1]
    prescale(flat[:total], prescale_factor)
    shard = flat[rank * shard_len:(rank + 1) * shard_len]
    payload, scale = rs_flat_codec(flat, shard, residual, codec, n, group,
                                   collective)
    if average_over > 1:
        shard.div_(average_over)
    if collective:
        all_gather(flat, shard, group)
    finish_reduce(flat[:total], 1, postscale_factor)
    return payload, scale


def codec_hier_allreduce(flat: torch.Tensor, total: int,
                         residual: Optional[torch.Tensor], codec: str,
                         local_size: int, cross_size: int,
                         average_over: int, prescale_factor: float,
                         postscale_factor: float, local_group,
                         cross_group):
    """The codec reduction's hierarchical arm on one bucket, in place (the
    reference's :360-387): ``flat`` holds ``shard_spec(total,
    local_size)[0]`` elements with a zero tail. Prescale ``flat[:total]``;
    the local reduce-scatter in full precision into this rank's local
    chunk; ``ef_encode_`` of that chunk with ``residual`` (its length,
    updated in place); an all-gather of the payload bytes and the scales
    over the cross group and ``decode_sum`` of the cross contributions
    into the chunk; Average's divide; the local all-gather in full
    precision; the postscale. Only the cross leg is encoded. Returns this
    rank's ``(payload, scale)``."""
    part = flat.numel() // local_size
    prescale(flat[:total], prescale_factor)
    mine = flat[dist.get_rank(local_group) * part:][:part]
    reduce_scatter(mine, flat, local_group)
    payload, scale = comp.ef_encode_(mine, residual, codec)
    raw = payload.view(torch.uint8)
    got = raw.new_empty(cross_size * raw.numel())
    all_gather(got, raw, cross_group)
    scales = None
    if scale is not None:
        scales = scale.new_empty(cross_size)
        all_gather(scales, scale, cross_group)
    comp.decode_sum(got.view(payload.dtype).view(cross_size, -1), scales,
                    codec, flat.dtype, out=mine)
    if average_over > 1:
        mine.div_(average_over)
    all_gather(flat, mine, local_group)
    finish_reduce(flat[:total], 1, postscale_factor)
    return payload, scale


def ef_allreduce(x: torch.Tensor, residual: Optional[torch.Tensor],
                 codec: str, average: bool, group, n: int, rank: int,
                 collective: bool = True,
                 use_kernel: bool = True) -> torch.Tensor:
    """One tensor's compressed allreduce outside the engine (the
    reference's ``ef_allreduce_p``, what ``hvd.distributed`` and
    ``allreduce_gradients`` run): K1 packs ``x`` into a zero-tailed padded
    buffer, then :func:`codec_allreduce` with ``residual`` (the padded
    length, updated in place; None: one-shot). Returns the reduced tensor
    in ``x``'s shape, a view of that buffer."""
    total = x.numel()
    flat = padded_bucket(total, n, x.dtype, x.device)
    pack_padded([x.contiguous()], flat, use_kernel)
    codec_allreduce(flat, total, residual, codec, n, rank,
                    n if average else 1, 1.0, 1.0, group, collective)
    return flat[:total].view(x.shape)
