"""The tensor axis's autograd operators (Megatron's f and g, and their row
forms).

The reference runs tensor parallelism inside ``shard_map``, where the
backward of a replicated input is a ``psum`` that XLA inserts: an
activation that does not vary over the tensor axis but feeds a
tensor-sharded einsum gets its cotangent summed over the axis, and the
``psum`` after the row-parallel projection passes its cotangent through
unchanged. Eager torch has no such transpose, so each crossing is an
autograd function here, issued straight to the tensor group's
``torch.distributed`` collective:

- :func:`copy_to_group` (f): identity forward, all-reduce backward, before
  a column-parallel projection (``wq``/``wk``/``wv``, ``w1``) or a
  replicated weight used on this rank's share of the tokens (the MoE
  router);
- :func:`reduce_from_group` (g): all-reduce forward, identity backward,
  after a row-parallel one (``wo``, ``w2``);
- :func:`scatter_rows` / :func:`gather_rows`: this rank's block of rows of
  a replicated tensor, and the all-gather back; each one's backward is the
  other;
- :func:`mean_from_group`: the mean over the group of a per-rank value
  (the MoE aux loss of this rank's tokens), whose backward is the
  cotangent over the group size.

With these every replicated activation keeps one value and one gradient
on every rank of the tensor group, so each parameter's gradient needs only
the data x seq reduction the reference's transpose gives it. At size 1 (no
group) each is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import collectives as C


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    C.all_gather(out, x, group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.group, ctx.n = group, n
        per = x.shape[0] // n
        return x[rank * per:(rank + 1) * per].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_rows(g, ctx.group, ctx.n), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.rank, ctx.per = rank, x.shape[0]
        return _all_gather_rows(x, group, n)

    @staticmethod
    def backward(ctx, g):
        per = ctx.per
        return g[ctx.rank * per:(ctx.rank + 1) * per], None, None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        return _all_reduce(x, group) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def copy_to_group(x, group):
    """f: ``x`` as it is; its gradient summed over ``group``."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_group(x, group):
    """g: the sum of ``x`` over ``group``; the gradient as it is."""
    return x if group is None else _Reduce.apply(x, group)


def scatter_rows(x, group, n: int, rank: int):
    """Rows ``[rank·m, (rank+1)·m)`` of ``x`` (``m = len(x) / n``, ``x``
    replicated over ``group``); the backward all-gathers the rows'
    gradients, so every rank gets the whole one."""
    if group is None or n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    return _Scatter.apply(x, group, n, rank)


def gather_rows(x, group, n: int, rank: int):
    """Every rank's ``x`` of ``group`` concatenated along dim 0; the
    backward keeps this rank's rows of the (replicated) gradient."""
    if group is None or n == 1:
        return x
    return _Gather.apply(x, group, n, rank)


def mean_from_group(x, group, n: int):
    """The mean of ``x`` over ``group``; the gradient of this rank's term,
    ``g / n``."""
    if group is None or n == 1:
        return x
    return _Mean.apply(x, group, n)
