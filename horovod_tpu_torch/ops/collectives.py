"""Pack/unpack layer of the fused allreduce, the buckets of the ZeRO-1
sharded step, and the wire codecs' compressed reduction.

Counterpart of the pack, scale and unpack steps of
``horovod_tpu/ops/collectives.py`` (``build_pack`` :1291, ``build_pack_group``
:1130, ``_unpack_flat`` :1395, the prescale/postscale of
``build_fused_allreduce`` :1044-1093), of its ZeRO-1 helpers
(``shard_spec`` :1304, ``_rs_flat`` :1315, ``_ag_flat`` :1367), and of its
codec reducers' flat arm (``codec_residual_elems`` :310, ``_rs_flat_codec``
:1332, ``_make_codec_reducer`` :388-393, ``ef_allreduce_p`` :398). The
collective itself is a ``torch.distributed`` call made by the engine.

The compressed reduction (:func:`rs_flat_codec`, :func:`codec_allreduce`):
a quantized payload cannot be summed on the wire, so each rank encodes its
whole zero-padded bucket (with error feedback: quantize(flat + residual)),
an all-to-all hands rank r chunk r of every peer's payload, and rank r
decodes its chunks with their senders' scales and sums them in float32
into its own slice; a full-precision all-gather then returns every slice
(enc + nbytes on the wire against the ring's 2 x nbytes). Payloads travel
as byte views, so neither NCCL nor gloo needs to know int8, fp8 or bf16:
they move the bytes and never reduce them. The reference's hierarchical
arm (:360-387, only the cross-slice leg encoded) waits for ROADMAP A11:
under ``HOROVOD_HIERARCHICAL_ALLREDUCE`` a codec bucket runs this flat
form, and the engine says so once.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence
from typing import Optional

import torch
import torch.distributed as dist

from . import compression as comp
from . import kernels


def pack_bucket(tensors: Sequence[torch.Tensor],
                use_kernel: bool) -> torch.Tensor:
    """One bucket's tensors as one new flat buffer: the hand-written pack
    kernel when ``use_kernel`` (``HOROVOD_PALLAS_PACK``), else the plain
    concatenation the reference packs with by default."""
    if use_kernel:
        return kernels.pack(tensors)
    return kernels.pack_plain(tensors)


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
                   residuals=None) -> int:
    """A sharded step's first half: per bucket pack ``tensors`` (the
    gradients, indexed by the bucket's ``idxs``), prescale and post the
    reduce-scatter; then wait for each (a stream dependency on the card)
    and finish its shard (Average's divide, the postscale). A bucket whose
    ``codecs`` entry is a wire codec runs the compressed reduce-scatter
    (:func:`rs_flat_codec`) instead, its ``residuals`` entry updated in
    place. Without ``collective`` (a group of one rank outside the world)
    the packed buffer is the sum. Returns the collectives launched."""
    works, launched = [], 0
    for i, b in enumerate(buckets):
        pack_padded([tensors[j] for j in b.idxs], b.grads, use_kernel)
        prescale(b.grads[:b.total], prescale_factor)
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
                  collective: bool = True) -> int:
    """A sharded step's second half: every bucket's all-gather into its
    parameter buffer, in place, then a wait for each (a stream dependency
    on the card, never a host wait). Returns the collectives launched."""
    if not collective:
        return 0
    works = [ag_flat(b.params, b.param_shard, group, async_op=True)
             for b in buckets]
    for w in works:
        w.wait()
    return len(works)


# ---------------------------------------------------------------------------
# wire codecs: the flat compressed reduction
# ---------------------------------------------------------------------------


def codec_residual_elems(cls: str, total: int, n: int,
                         codec: str) -> Optional[int]:
    """Length of one error-feedback bucket's residual, the one shape rule
    the engine and replay share (the reference's :310-330 on its flat
    arm): the whole zero-padded bucket, ``shard_spec(total, n)[0]``, for
    the allreduce family (``cls`` "reduce": the compressed reduce-scatter
    encodes every element before the exchange) and for the ZeRO-1
    reduce-scatter leg ("sharded"). None: the codec carries no residual."""
    if codec not in comp.EF_CODECS:
        return None
    if cls not in ("reduce", "sharded"):
        raise ValueError(f"unknown residual class {cls!r}")
    return shard_spec(int(total), n)[0]


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
