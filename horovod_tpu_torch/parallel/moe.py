"""Expert parallelism: Switch-style top-1 MoE with all-to-all dispatch.

The port's counterpart of ``horovod_tpu/parallel/moe.py`` (:1-130): tokens
are routed top-1 in fp32, packed into per-expert capacity slots, exchanged
(one ``all_to_all_single`` over the process group each way) so that each
rank holds the tokens of ITS experts from every peer, run through the local
expert FFNs as one batched product (``torch.bmm``: [E_local, n·C, d] x
[E_local, d, f]), and exchanged back.

Capacity follows Switch Transformer: from each rank's tokens every expert
accepts at most ``ceil(T·capacity_factor/E)``; the overflow contributes
zero (the caller's residual carries it). The aux load-balancing loss is the
fraction·probability dot over the valid rows.

The dispatch buffer is filled by ``index_copy`` of the kept rows (the
dropped ones go to a spare row that is cut off): no two kept tokens share
an (expert, slot), so the fill has no colliding writes and repeats bitwise
on the card. The reference's scatter-add sends dropped tokens to slot C-1
with zero weight, which adds zeros to the same buffer. No step reads a
mask or a count on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .ulysses import _AllToAll


class MoEParams(NamedTuple):
    router: torch.Tensor   # [d_model, n_experts_total]
    w_in: torch.Tensor     # [E_local, d_model, d_ff]
    w_out: torch.Tensor    # [E_local, d_ff, d_model]


def init_moe(d_model: int, d_ff: int, n_experts: int,
             n_expert_shards: int = 1, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> MoEParams:
    """One shard's expert weights and the replicated router, with the
    reference's scales (router N(0, 0.02²), He-normal experts), made on
    the CPU from ``generator``."""
    if n_experts % n_expert_shards:
        raise ValueError(f"n_experts {n_experts} must divide over "
                         f"{n_expert_shards} expert shards")
    e_local = n_experts // n_expert_shards
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    return MoEParams(
        router=torch.randn(d_model, n_experts, generator=g,
                           dtype=dtype) * 0.02,
        w_in=torch.randn(e_local, d_model, d_ff, generator=g, dtype=dtype)
        * math.sqrt(2.0 / d_model),
        w_out=torch.randn(e_local, d_ff, d_model, generator=g, dtype=dtype)
        * math.sqrt(2.0 / d_ff))


def capacity(tokens: int, capacity_factor: float, n_experts: int) -> int:
    """Slots an expert takes from one rank's ``tokens``."""
    return max(int(math.ceil(tokens * capacity_factor / n_experts)), 1)


def route(x, router, n_experts: int, cap: int, valid_mask=None):
    """Top-1 routing of ``x`` [T, d] in fp32: ``(expert, slot, keep, gate,
    aux, counts)``. ``keep`` marks the tokens that got a slot (a valid row
    within its expert's first ``cap``), ``gate`` the chosen expert's
    probability, ``aux`` the Switch loss over the valid rows, ``counts``
    each expert's valid tokens before capacity."""
    t = x.shape[0]
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                  # [T, E]
    expert = torch.argmax(probs, dim=-1)                   # [T]
    gate = probs.gather(-1, expert[:, None])[:, 0]
    if valid_mask is None:
        valid = torch.ones(t, dtype=torch.float32, device=x.device)
    else:
        valid = valid_mask.to(torch.float32)
    n_valid = torch.clamp(valid.sum(), min=1.0)
    onehot = torch.nn.functional.one_hot(expert, n_experts).float() \
        * valid[:, None]
    counts = onehot.sum(0)
    aux = n_experts * torch.sum(
        (counts / n_valid) * ((probs * valid[:, None]).sum(0) / n_valid))
    # each token's place in its expert's queue (invalid rows take none)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1).to(torch.int64) - 1
    keep = (pos < cap) & (pos >= 0)
    slot = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    return expert, slot, keep, gate, aux, counts


def dispatch(x, expert, slot, keep, n_experts: int, cap: int):
    """The [E·C, d] dispatch buffer: each kept token in its expert's slot,
    zeros elsewhere. ``index_copy`` sends the dropped tokens to one spare
    row past the buffer, which is cut off: no two written rows of the
    buffer collide, so the fill repeats bitwise on the card, and nothing
    reads the mask on the host."""
    spare = n_experts * cap
    rows = torch.where(keep, expert * cap + slot, torch.full_like(slot,
                                                                   spare))
    buf = x.new_zeros(spare + 1, x.shape[-1]).index_copy(0, rows, x)
    return buf[:spare]


def combine(buf, expert, slot, gatek, cap: int):
    """Each token's expert output from the [E·C, d] combine buffer, scaled
    by ``gatek`` (gate x keep: a dropped token's row times zero)."""
    return buf[expert * cap + slot] * gatek.to(buf.dtype)[:, None]


def expert_ffn(x, w_in, w_out):
    """relu FFN of each local expert on its rows: [E_l, R, d] -> [E_l, R,
    d], the reference's two batched einsums."""
    h = torch.relu(torch.bmm(x, w_in.to(x.dtype)))
    return torch.bmm(h, w_out.to(x.dtype))


def moe_layer_p(x, params: MoEParams, group, axis_size: int,
                capacity_factor: float = 1.25,
                valid_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE over the process group ``group`` of ``axis_size`` ranks
    (size 1, or no group: every expert local).

    Capacity and the aux loss are per dispatch group (this call's ``x`` on
    each rank of ``group``): the Switch/GShard semantics.

    Args:
      x: local tokens [T, d_model] (batch x sequence flattened).
      params: this rank's :class:`MoEParams` (experts sharded over the
        group, the router replicated).
      valid_mask: optional [T] bool; False rows (padding) do not route,
        take no capacity, are left out of the aux loss and give zeros.

    Returns ``(y, aux)``: y [T, d_model] (zeros for dropped tokens: add
    the residual outside) and the scalar load-balance loss.
    """
    n = axis_size
    t, d = x.shape
    e_local = params.w_in.shape[0]
    e_total = e_local * n
    cap = capacity(t, capacity_factor, e_total)
    expert, slot, keep, gate, aux, _ = route(x, params.router, e_total, cap,
                                             valid_mask)
    disp = dispatch(x, expert, slot, keep, e_total, cap)
    if n > 1:
        # [E·C, d] = [n, E_local·C, d]: block j goes to expert shard j
        recv = _AllToAll.apply(disp.view(n, e_local * cap, d), group)
        expert_in = recv.view(n, e_local, cap, d).transpose(0, 1) \
            .reshape(e_local, n * cap, d)
    else:
        expert_in = disp.view(e_total, cap, d)
    y = expert_ffn(expert_in, params.w_in, params.w_out)
    if n > 1:
        back = y.view(e_local, n, cap, d).transpose(0, 1) \
            .reshape(n, e_local * cap, d)
        combined = _AllToAll.apply(back, group).view(e_total * cap, d)
    else:
        combined = y.view(e_total * cap, d)
    return combine(combined, expert, slot, gate * keep, cap), aux
