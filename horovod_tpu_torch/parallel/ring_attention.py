"""Ring attention's single-device reference attention.

The port's counterpart of ``horovod_tpu/parallel/ring_attention.py``, so far
only :func:`local_attention` (:561-573): the materialized attention that the
single-shard transformer runs for ``attention="ring"``/``"ulysses"`` and that
the tests hold the flash kernel against. The ring itself (ppermute K/V
rotation, the zig-zag layout, the per-block kernels) comes with the
parallel families (ROADMAP A16).
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


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
