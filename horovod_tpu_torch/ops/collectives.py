"""Pack/unpack layer of the fused allreduce.

Counterpart of the pack, scale and unpack steps of
``horovod_tpu/ops/collectives.py`` (``build_pack`` :1291, ``build_pack_group``
:1130, ``_unpack_flat`` :1395, the prescale/postscale of
``build_fused_allreduce`` :1044-1093). The collective itself is a
``torch.distributed`` call made by the engine.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.distributed as dist

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
