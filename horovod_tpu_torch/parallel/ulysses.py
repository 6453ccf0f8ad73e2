"""Ulysses-style (all-to-all) sequence parallelism.

The port's counterpart of ``horovod_tpu/parallel/ulysses.py``: instead of
rotating K/V blocks around a ring, one all-to-all on the sequence group
re-shards q, k and v from sequence-sharded to head-sharded, every rank runs
full-sequence attention on its slice of the heads through
:func:`~horovod_tpu_torch.parallel.flash_attention.flash_attention_local`
(kernel K6), and a second all-to-all restores sequence sharding. It needs
``n_heads % n == 0``; the global causal mask becomes an ordinary local one.

Each exchange is one ``dist.all_to_all_single`` on a contiguous [n, ...]
buffer (the reference's ``lax.all_to_all(..., tiled=True)``); its gradient
is the same exchange of the cotangents, since a uniform block exchange is
its own transpose.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .flash_attention import flash_attention_local


class _AllToAll(torch.autograd.Function):
    """Chunk j of dim 0 goes to rank j of ``group``; chunk j of the result
    came from rank j."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x, group, n: int):
    """[B, T/n, H, D] -> [B, T, H/n, D]: this rank's head group over the
    whole sequence, the blocks in group-rank order."""
    b, t, h, d = x.shape
    send = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
    recv = _AllToAll.apply(send, group)          # [n, B, T/n, H/n, D]
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)


def _heads_to_seq(x, group, n: int):
    """[B, T, H/n, D] -> [B, T/n, H, D], the inverse of _seq_to_heads."""
    b, t, hn, d = x.shape
    send = x.reshape(b, n, t // n, hn, d).permute(1, 0, 2, 3, 4)
    recv = _AllToAll.apply(send, group)          # [n, B, T/n, H/n, D]
    return recv.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hn, d)


def ulysses_attention_p(q, k, v, axis_name: Optional[dist.ProcessGroup],
                        axis_size: int, causal: bool = True,
                        under_remat: bool = False):
    """All-to-all sequence-parallel attention over the process group
    ``axis_name`` (None at size 1).

    Args:
      q, k, v: local blocks [B, T_local, H, D]; the global sequence is the
        blocks in group-rank order, as for
        :func:`~horovod_tpu_torch.parallel.ring_attention.ring_attention_p`
        with ``layout="contiguous"``.
      causal: a causal mask over global positions.

    Returns the local output block [B, T_local, H, D].
    """
    n = axis_size
    if n == 1:
        return flash_attention_local(q, k, v, causal=causal,
                                     under_remat=under_remat)
    heads = q.shape[2]
    if heads % n != 0:
        raise ValueError(
            f"ulysses attention needs n_heads ({heads}) divisible by the "
            f"sequence axis size ({n}); use ring attention otherwise")
    qh, kh, vh = (_seq_to_heads(x, axis_name, n) for x in (q, k, v))
    oh = flash_attention_local(qh, kh, vh, causal=causal,
                               under_remat=under_remat)
    return _heads_to_seq(oh, axis_name, n)
