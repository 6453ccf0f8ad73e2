"""Pipeline parallelism: a microbatched stage pipeline over the pipe group.

The port of ``horovod_tpu/parallel/pipeline.py``. One process is one
stage: the model's layers split into ``n_stages`` stages, one a rank of
the ``pipe`` axis of a :class:`~horovod_tpu_torch.parallel.mesh.TrainingMesh`.
Microbatches stream through the stages in ticks. At the end of a tick
each rank posts its hops in one ``dist.batch_isend_irecv``: the
activation it computed goes to the next stage, the cotangent to the
previous one, and only what the tick's table says a stage consumes is
posted (a rank with nothing to send or receive posts nothing). At pipe
size 1 a hop is a copy.

- :func:`pipeline_apply_p`: the forward fill-drain ladder, ``n_micro +
  n_stages - 1`` ticks, bubble ticks idle; the last stage's outputs go
  to every rank of the group. One ``torch.autograd.Function``: its
  backward runs the ticks in reverse with the reverse hops, on every rank.
- :func:`pipeline_train_1f1b`: the memory-bounded 1F1B training step,
  F(m) on stage s at tick ``m + s``, B(m) at ``m + 2(p-1) - s``; B
  recomputes the stage from a stash of its input (at most ``2p - 1``
  deep).
- :func:`pipeline_train_step`: the schedule selector
  (``HOROVOD_TPU_PIPELINE_SCHEDULE``): 1F1B, ``interleaved`` virtual
  stages (round-robin chunks) and ``zb`` (the backward split into B, the
  activation half, and W, the weight half, W deferred into the drain),
  run from :func:`build_schedule_tables`' static tables.

The schedule algebra (the tables, the bubble predictor, the resolver and
its one-time demotions) is a copy of the reference's: it is plain Python
and numpy. The executor differs in form, not in arithmetic: the
reference is one ``lax.scan`` inside ``shard_map`` with ``lax.cond`` for
the idle slots; here each rank loops over its column of the table, runs
only its active slots, and differentiates with ``torch.autograd.grad``
inside the B (or W) slot only: the F slot runs under ``torch.no_grad``
and keeps its input. Each gradient accumulates into its own buffer in
the table's order (microbatch order, per chunk), so every schedule gives
1F1B's bits at matched ``n_micro``.

Two differences from the reference:

- the port's 1F1B runs on the same executor (the generated 1f1b table,
  which fires every job at the hand mapping's tick), so
  ``boundary_codec`` applies to it too (the reference's hand-scanned 1F1B
  ignores it);
- with ``n_virtual > 1``, ``stage_params`` is a sequence of the stage's
  ``n_virtual`` chunk trees where the reference stacks them on a leading
  axis, and the stage gradients come back in the same form.

A parameter tree is a tensor, a dict, list or tuple of trees, or an
``nn.Module`` (whose gradients come back as a list in ``parameters()``
order). Plain tensors are differentiated through detached copies;
a module's parameters are differentiated in place (their ``.grad`` is
not touched).
"""

from __future__ import annotations

import logging
import warnings
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops import compression as comp

logger = logging.getLogger("horovod_tpu_torch.pipeline")

#: The schedule selector (HOROVOD_TPU_PIPELINE_SCHEDULE): "1f1b",
#: "interleaved" (virtual-stage round-robin chunks, Narayanan et al. 2021),
#: "zb" (the backward split into B and W, W deferred, Qi et al. 2023),
#: "auto" (the cheapest under the predictor below).
PIPELINE_SCHEDULES = ("1f1b", "interleaved", "zb", "auto")

# per-cell slot work in F units for the predictor: a full backward
# recomputes the cell, then pulls both gradients (3 F); the zb split pays
# the recompute in both halves (B = recompute + dx, W = recompute + dw)
SLOT_COST_F = 1.0
SLOT_COST_B_FULL = 3.0
SLOT_COST_B_SPLIT = 2.0
SLOT_COST_W = 2.0


def pipeline_bubble_fraction(n_stages: int, n_micro: int,
                             schedule: str = "1f1b",
                             n_virtual: int = 1) -> float:
    """The share of a schedule's time that is fill and drain: 1f1b
    ``(p-1)/(m+p-1)``; interleaved ``q/(m+q)`` with ``q = (p-1)/v``; zb
    from its table (:func:`predict_schedule_bubble`)."""
    p, m, v = n_stages, n_micro, max(1, n_virtual)
    if p <= 1:
        return 0.0
    if schedule in ("1f1b", "auto"):
        return (p - 1) / (m + p - 1)
    if schedule == "interleaved":
        q = (p - 1) / v
        return q / (m + q)
    if schedule == "zb":
        return predict_schedule_bubble("zb", p, m, 1)
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


# ---------------------------------------------------------------------------
# The schedule tables (a copy of the reference's :469-680)
#
# A greedy list scheduler assigns the F / B / W jobs of (microbatch, chunk)
# to (tick, stage) slots under the dataflow (one hop of latency at each
# chunk boundary), then interval colouring allocates the stash and inbox
# slots. Global chunk c lives on stage c % p at local index c // p
# (round-robin), so every chunk boundary is the same forward hop.
# ---------------------------------------------------------------------------


class _Tables(NamedTuple):
    """Static schedule tables: every array is int32 [ticks, p]."""
    ticks: int
    n_chunks: int
    split_bw: bool           # the zb B/W split
    act_depth: int           # activation stash slots a stage
    ct_depth: int            # cotangent stash slots a stage (zb)
    a_depth: int             # activation inbox slots a stage
    c_depth: int             # cotangent inbox slots a stage
    rows: dict               # name -> np.ndarray [ticks, p]


def _greedy_schedule(schedule: str, p: int, m: int, v: int):
    """Greedy list scheduling of the F/B/W jobs onto (tick, stage) slots:
    ``(fdone, bdone, wdone)``, job -> tick. F(m,c) needs F(m,c-1) a tick
    earlier; B(m,C-1) folds the last chunk's forward and the loss, so it
    needs F(m,C-2); B(m,c) needs B(m,c+1); W(m,c) (zb) needs B(m,c), the
    same tick allowed. B takes the smallest m (then the deepest chunk), F
    the smallest (m, c): at v=1 the hand 1F1B mapping. W fills idle F
    slots unless the backlog would pass p."""
    C = p * v
    split = schedule == "zb"
    f_jobs = {(mm, c) for mm in range(m) for c in range(C - 1)}
    b_jobs = {(mm, c) for mm in range(m) for c in range(C)}
    w_jobs = ({(mm, c) for mm in range(m) for c in range(C)}
              if split else set())
    fdone, bdone, wdone = {}, {}, {}
    t = 0
    guard = 8 * (m + 2) * (C + 2) + 64
    while f_jobs or b_jobs or w_jobs:
        if t >= guard:
            raise RuntimeError(
                f"pipeline schedule generator stalled ({schedule}, p={p}, "
                f"m={m}, v={v})")
        for s in range(p):
            ready_b = []
            for (mm, c) in b_jobs:
                if c % p != s:
                    continue
                dep = (fdone.get((mm, C - 2)) if c == C - 1
                       else bdone.get((mm, c + 1)))
                if dep is not None and dep + 1 <= t:
                    ready_b.append((mm, -c))
            if ready_b:
                mm, negc = min(ready_b)
                bdone[(mm, -negc)] = t
                b_jobs.discard((mm, -negc))
            ready_f = []
            for (mm, c) in f_jobs:
                if c % p != s:
                    continue
                if c == 0 or ((mm, c - 1) in fdone
                              and fdone[(mm, c - 1)] + 1 <= t):
                    ready_f.append((mm, c))
            f_fired = bool(ready_f)
            if ready_f:
                mm, c = min(ready_f)
                fdone[(mm, c)] = t
                f_jobs.discard((mm, c))
            if split:
                ready_w = sorted(
                    (mm, c) for (mm, c) in w_jobs
                    if c % p == s and (mm, c) in bdone
                    and bdone[(mm, c)] <= t)
                if ready_w and (not f_fired or len(ready_w) >= p):
                    mm, c = ready_w[0]
                    wdone[(mm, c)] = t
                    w_jobs.discard((mm, c))
        t += 1
    return fdone, bdone, wdone


def _alloc_slots(intervals):
    """Greedy interval colouring of ``{key: (start, end)}``, the conflict
    inclusive (a slot read at tick T is free from T+1: within a tick the
    executor writes before it reads). ``(slot_of_key, n_slots)``."""
    out, n_slots = {}, 0
    free, busy = [], []  # busy: list of (end, slot)
    for key, (start, end) in sorted(intervals.items(),
                                    key=lambda kv: (kv[1][0], kv[1][1])):
        busy = [(e, sl) for (e, sl) in busy if e >= start or free.append(sl)]
        if free:
            slot = min(free)
            free.remove(slot)
        else:
            slot = n_slots
            n_slots += 1
        busy.append((end, slot))
        out[key] = slot
    return out, max(n_slots, 1)


def build_schedule_tables(schedule: str, n_stages: int, n_micro: int,
                          n_virtual: int = 1) -> _Tables:
    """The static per-tick slot tables of one resolved schedule (cached)."""
    key = (schedule, n_stages, n_micro, n_virtual)
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    p, m, v = n_stages, n_micro, n_virtual
    C = p * v
    split = schedule == "zb"
    fdone, bdone, wdone = _greedy_schedule(schedule, p, m, v)
    ticks = max(list(fdone.values()) + list(bdone.values())
                + list(wdone.values())) + 1

    # buffer slots by interval colouring, a stage at a time
    act_iv = [dict() for _ in range(p)]   # (m, c) F-input stash
    ct_iv = [dict() for _ in range(p)]    # (m, c) cotangent stash (zb)
    a_in_iv = [dict() for _ in range(p)]  # (m, c) activation arrival
    c_in_iv = [dict() for _ in range(p)]  # (m, c) cotangent arrival
    for (mm, c), tf in fdone.items():
        s = c % p
        if c > 0:
            # chunk 0 never stashes: its backward re-embeds the microbatch
            last_read = wdone[(mm, c)] if split else bdone[(mm, c)]
            act_iv[s][(mm, c)] = (tf, last_read)
        # this F's output arrives on the next stage, read by F(m,c+1), or
        # by B(m,C-1) when c == C-2
        cons = (bdone[(mm, C - 1)] if c == C - 2 else fdone[(mm, c + 1)])
        a_in_iv[(c + 1) % p][(mm, c + 1)] = (tf + 1, cons)
    for (mm, c), tb in bdone.items():
        s = c % p
        if c >= 1:  # this B's dx arrives on the previous stage
            c_in_iv[(c - 1) % p][(mm, c - 1)] = (tb + 1, bdone[(mm, c - 1)])
        if split and c < C - 1:
            # the incoming cotangent, kept for the deferred W pull
            ct_iv[s][(mm, c)] = (tb, wdone[(mm, c)])
        if split and c == C - 1:
            # the last chunk's input came from the inbox: kept for W
            act_iv[s][(mm, c)] = (tb, wdone[(mm, c)])
    act_slot, ct_slot, a_slot, c_slot = [], [], [], []
    act_d = ct_d = a_d = c_d = 1
    for s in range(p):
        sl, n = _alloc_slots(act_iv[s]); act_slot.append(sl); act_d = max(act_d, n)
        sl, n = _alloc_slots(ct_iv[s]); ct_slot.append(sl); ct_d = max(ct_d, n)
        sl, n = _alloc_slots(a_in_iv[s]); a_slot.append(sl); a_d = max(a_d, n)
        sl, n = _alloc_slots(c_in_iv[s]); c_slot.append(sl); c_d = max(c_d, n)

    def tab(fill=0):
        return np.full((ticks, p), fill, dtype=np.int32)

    rows = {name: tab(-1) for name in
            ("f_m", "f_j", "f_src", "f_stash",
             "b_m", "b_j", "b_role", "b_x", "b_in", "b_save", "b_ct_save",
             "w_m", "w_j", "w_role", "w_x", "w_ct",
             "a_write", "c_write")}
    for name in ("f_active", "b_active", "w_active"):
        rows[name] = tab(0)
    for (mm, c), tf in fdone.items():
        s = c % p
        rows["f_active"][tf, s] = 1
        rows["f_m"][tf, s] = mm
        rows["f_j"][tf, s] = c // p
        rows["f_src"][tf, s] = (-1 if c == 0 else a_slot[s][(mm, c)])
        if c > 0:
            rows["f_stash"][tf, s] = act_slot[s][(mm, c)]
            rows["a_write"][fdone[(mm, c - 1)] + 1, s] = a_slot[s][(mm, c)]
    for (mm, c), tb in bdone.items():
        s = c % p
        rows["b_active"][tb, s] = 1
        rows["b_m"][tb, s] = mm
        rows["b_j"][tb, s] = c // p
        rows["b_role"][tb, s] = (0 if c == 0 else (2 if c == C - 1 else 1))
        if c == C - 1:
            rows["b_in"][tb, s] = a_slot[s][(mm, c)]
            rows["a_write"][fdone[(mm, c - 1)] + 1, s] = a_slot[s][(mm, c)]
            if split:
                rows["b_save"][tb, s] = act_slot[s][(mm, c)]
        else:
            if c > 0:
                rows["b_x"][tb, s] = act_slot[s][(mm, c)]
            rows["b_in"][tb, s] = c_slot[s][(mm, c)]
            rows["c_write"][bdone[(mm, c + 1)] + 1, s] = c_slot[s][(mm, c)]
            if split:
                rows["b_ct_save"][tb, s] = ct_slot[s][(mm, c)]
    for (mm, c), tw in wdone.items():
        s = c % p
        rows["w_active"][tw, s] = 1
        rows["w_m"][tw, s] = mm
        rows["w_j"][tw, s] = c // p
        rows["w_role"][tw, s] = (0 if c == 0 else (2 if c == C - 1 else 1))
        if c > 0:
            rows["w_x"][tw, s] = act_slot[s][(mm, c)]
        if c < C - 1:
            rows["w_ct"][tw, s] = ct_slot[s][(mm, c)]
    out = _Tables(ticks=ticks, n_chunks=C, split_bw=split,
                  act_depth=act_d, ct_depth=ct_d, a_depth=a_d, c_depth=c_d,
                  rows=rows)
    _TABLE_CACHE[key] = out
    return out


_TABLE_CACHE: dict = {}


# ---------------------------------------------------------------------------
# The bubble predictor (the reference's :683-740)
# ---------------------------------------------------------------------------

def _slot_cost(role: int, kind: str, split: bool) -> float:
    if kind == "F":
        return SLOT_COST_F
    if kind == "W":
        return SLOT_COST_W
    if not split:
        return SLOT_COST_B_FULL
    # split B: role 0's pull is all weight gradients, so its B slot is
    # bookkeeping (the work moved into W)
    return 0.0 if role == 0 else SLOT_COST_B_SPLIT


def predict_schedule_time(schedule: str, n_stages: int, n_micro: int,
                          n_virtual: int = 1) -> float:
    """A schedule's time in F-slot units under the synchronized-tick
    model: a tick costs its busiest stage's slot work (F 1, full B 3,
    split B 2 or 0, W 2)."""
    tb = build_schedule_tables(schedule, n_stages, n_micro, n_virtual)
    r = tb.rows
    total = 0.0
    for t in range(tb.ticks):
        worst = 0.0
        for s in range(n_stages):
            cost = 0.0
            if r["f_active"][t, s]:
                cost += _slot_cost(0, "F", tb.split_bw)
            if r["b_active"][t, s]:
                cost += _slot_cost(int(r["b_role"][t, s]), "B", tb.split_bw)
            if r["w_active"][t, s]:
                cost += _slot_cost(int(r["w_role"][t, s]), "W", tb.split_bw)
            worst = max(worst, cost)
        total += worst
    return total


def predict_schedule_bubble(schedule: str, n_stages: int, n_micro: int,
                            n_virtual: int = 1) -> float:
    """A schedule's predicted bubble by the marginal-microbatch method:
    the steady cost a microbatch c = (T(m) - T(m/2)) / (m/2), the ideal
    m·c, the bubble (T - ideal) / T."""
    m2 = max(1, n_micro // 2)
    t_m = predict_schedule_time(schedule, n_stages, n_micro, n_virtual)
    if m2 == n_micro:
        return pipeline_bubble_fraction(n_stages, n_micro)
    t_2 = predict_schedule_time(schedule, n_stages, m2, n_virtual)
    c = max((t_m - t_2) / (n_micro - m2), 1e-9)
    return max(0.0, (t_m - n_micro * c) / t_m)


# ---------------------------------------------------------------------------
# Schedule resolution (the reference's :743-846)
# ---------------------------------------------------------------------------

_DEMOTE_WARNED: set = set()


def _demote_once(key: tuple, msg: str):
    if key not in _DEMOTE_WARNED:
        _DEMOTE_WARNED.add(key)
        logger.warning(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def auto_microbatches(n_stages: int, batch: int, topology=None,
                      max_micro: int = 64) -> int:
    """The microbatch count of ``auto``: the divisor of ``batch`` (at most
    ``max_micro``) whose bubble, plus a per-tick launch cost where the
    topology has a fitted one, is cheapest."""
    divisors = [d for d in range(1, min(batch, max_micro) + 1)
                if batch % d == 0]
    if not divisors:
        return 1
    alpha_frac = 0.0
    if topology is not None:
        alpha = _fitted_alpha_s(topology)
        if alpha:
            # alpha a tick against ~1 ms of stage compute a tick
            alpha_frac = min(alpha / 1e-3, 1.0)
    best, best_cost = divisors[0], None
    for d in divisors:
        bubble = pipeline_bubble_fraction(n_stages, d)
        cost = 1.0 / max(1e-9, 1.0 - bubble) + alpha_frac * (d + n_stages)
        if best_cost is None or cost < best_cost - 1e-12:
            best, best_cost = d, cost
    return best


def _fitted_alpha_s(topology) -> float:
    """The per-launch latency (s) of a calibrated topology's fit; 0.0 for
    the port's nominal :class:`~horovod_tpu_torch.parallel.mesh.Topology`
    (the calibration waits for ROADMAP A15)."""
    try:
        fit = topology.fitted("flat")
        if fit is not None:
            return float(fit[0])
    except Exception:
        pass
    return float(getattr(topology, "launch_latency_us", 0.0) or 0.0) * 1e-6


def resolve_pipeline_schedule(schedule: str, n_stages: int, n_micro: int,
                              n_virtual: int = 1,
                              topology=None) -> Tuple[str, int]:
    """``(schedule, n_virtual)`` once a build, the degenerate cases
    demoted with one warning each: an unknown name and ``interleaved``
    with fewer than 2 chunks to 1f1b, and any schedule at ``n_micro <
    n_stages`` (no steady phase) to 1f1b. ``auto`` takes the cheapest
    candidate under :func:`predict_schedule_time` plus the per-tick
    launch cost."""
    v = max(1, int(n_virtual))
    if schedule not in PIPELINE_SCHEDULES:
        _demote_once(("schedule", schedule),
                     f"unknown pipeline schedule {schedule!r}; demoting to "
                     f"1f1b (valid: {PIPELINE_SCHEDULES})")
        schedule = "1f1b"
    if schedule == "auto":
        candidates = [("1f1b", 1)]
        if n_micro >= n_stages:
            if v >= 2:
                candidates.append(("interleaved", v))
            candidates.append(("zb", 1))
        alpha = _fitted_alpha_s(topology) if topology is not None else 0.0
        alpha_units = min(alpha / 1e-3, 1.0) if alpha else 0.0

        def priced(cand):
            sch, vv = cand
            tb = build_schedule_tables(sch, n_stages, n_micro, vv)
            # a chunk is 1/v of the stage: whole-stage units
            return (predict_schedule_time(sch, n_stages, n_micro, vv) / vv
                    + alpha_units * tb.ticks)

        schedule, v = min(candidates, key=priced)
    if schedule == "interleaved" and v < 2:
        _demote_once(("interleave_v", n_stages),
                     "interleaved pipeline schedule needs n_virtual >= 2 "
                     "chunks per stage; demoting to 1f1b")
        schedule = "1f1b"
    if n_micro < n_stages and schedule != "1f1b":
        _demote_once(("micro", schedule, n_stages, n_micro),
                     f"pipeline schedule {schedule!r} with n_micro="
                     f"{n_micro} < n_stages={n_stages} has no steady phase "
                     "to optimize; demoting to 1f1b")
        schedule = "1f1b"
    return schedule, v


def pipeline_chunk_placement(schedule: str, n_virtual: int) -> str:
    """How a resolved schedule places a stage's chunks: ``"contiguous"``
    (stage s owns consecutive chunks: 1f1b) or ``"roundrobin"`` (chunk
    c = j·p + s on stage s at local index j). At ``n_virtual == 1`` they
    coincide."""
    if n_virtual <= 1:
        return "contiguous"
    return "contiguous" if schedule == "1f1b" else "roundrobin"


# ---------------------------------------------------------------------------
# Trees of parameters
# ---------------------------------------------------------------------------

def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, in order (a module's trainable
    parameters)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return [p for p in tree.parameters() if p.requires_grad]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    raise TypeError(f"a parameter tree holds a {type(tree).__name__}")


def _rebuild(tree, it, keep_modules: bool = False):
    """``tree`` with its leaves taken from the iterator ``it`` in
    :func:`_leaves`' order: a module becomes the list of its own, or with
    ``keep_modules`` stays (its leaves consumed)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, nn.Module):
        mine = [next(it) for p in tree.parameters() if p.requires_grad]
        return tree if keep_modules else mine
    if isinstance(tree, dict):
        return {k: _rebuild(v, it, keep_modules) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it, keep_modules) for t in tree)
    raise TypeError(f"a parameter tree holds a {type(tree).__name__}")


class _Diff:
    """A tree prepared for ``torch.autograd.grad``: its plain tensors as
    detached leaves that require grad (``tree``), a module's parameters as
    they are; ``leaves`` the tensors to differentiate, in order."""

    def __init__(self, tree):
        self.source = tree
        self.tree = _rebuild(tree, iter([
            t if isinstance(t, nn.Parameter) else
            t.detach().requires_grad_(t.is_floating_point())
            for t in _leaves(tree)]), keep_modules=True)
        self.leaves = _leaves(self.tree)


def _grad(outputs, inputs, grad_outputs):
    """``torch.autograd.grad`` with zeros for an input the output does not
    reach; a tensor listed twice (one parameter in the first and the last
    tree at one stage) gets its gradient once, zeros after."""
    if not inputs:
        return []
    uniq = list({id(x): x for x in inputs}.values())
    gs = dict(zip(map(id, uniq), torch.autograd.grad(
        outputs, uniq, grad_outputs=grad_outputs, allow_unused=True)))
    out = []
    for x in inputs:
        g = gs.pop(id(x), None)
        out.append(torch.zeros_like(x) if g is None else g)
    return out


# ---------------------------------------------------------------------------
# The hops on the pipe group (the reference's _boundary_hops, :861-905)
# ---------------------------------------------------------------------------

_WIRE_BYTES = {"raw": 0, "coded": 0}
_WARMED: list = []     # the groups a collective has run on
_TAG_FWD, _TAG_BWD = 0, 2      # + 1 for a coded hop's scale


def wire_bytes() -> dict:
    """Bytes the pipeline's hops sent since the last
    :func:`reset_wire_bytes`, on raw and on coded edges."""
    return dict(_WIRE_BYTES)


def reset_wire_bytes():
    for k in _WIRE_BYTES:
        _WIRE_BYTES[k] = 0


def _stage_of(group, n_stages: int) -> int:
    if n_stages == 1:
        return 0
    if group is None:
        raise ValueError(f"a pipeline of {n_stages} stages needs its pipe "
                         "group")
    return dist.get_rank(group)


class _Hops:
    """The forward and backward hops of one rank on the pipe group.

    ``exchange`` posts one tick's hops in one ``batch_isend_irecv``, in the
    same order on every rank (the forward's send, its receive, then the
    backward's), and waits for them: on the card the wait orders the
    current stream after the transfer, with no host wait. At one stage a
    hop is a copy. A boundary listed in ``coded`` (boundary i joins stage i
    and i+1) sends the codec's payload and scale, decoded on arrival; the
    other boundaries send the activation as it is."""

    def __init__(self, group, n_stages: int, stage: int, act_shape,
                 act_dtype, device, boundary_codec=None):
        self.group, self.p, self.s = group, n_stages, stage
        self.shape, self.dtype, self.device = tuple(act_shape), act_dtype, \
            device
        self.codec, self.coded = comp.CODEC_NONE, (False,) * n_stages
        if boundary_codec and any(boundary_codec[1]):
            codec = comp.resolve_codec(boundary_codec[0], act_dtype)
            if codec != comp.CODEC_NONE:
                self.codec, self.coded = codec, tuple(
                    bool(c) for c in boundary_codec[1])
        if n_stages > 1:
            self.nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
            self.prv = dist.get_global_rank(group, (stage - 1) % n_stages)
            if not any(g is group for g in _WARMED):
                # a P2P batch is only defined once every rank of the group
                # has joined a collective on it (NCCL makes the group's
                # communicator there)
                dist.all_reduce(torch.zeros(1, device=device), group=group)
                _WARMED.append(group)

    def _payload_buffers(self):
        """Receive buffers of one coded hop: payload bytes and scale."""
        if self.codec == comp.CODEC_BF16:
            return [torch.empty(self.shape, dtype=torch.bfloat16,
                                device=self.device)]
        n = int(np.prod(self.shape))
        return [torch.empty(n, dtype=torch.uint8, device=self.device),
                torch.empty(1, dtype=torch.float32, device=self.device)]

    def _encode(self, x):
        payload, scale = comp.encode(x, self.codec)
        if scale is None:
            return [payload.contiguous()]
        return [payload.contiguous().view(torch.uint8).reshape(-1), scale]

    def _decode(self, bufs):
        if self.codec == comp.CODEC_BF16:
            return comp.decode(bufs[0], None, self.codec, self.dtype)
        q = bufs[0].view(torch.int8 if self.codec == comp.CODEC_INT8
                         else comp._FP8_DTYPE).reshape(self.shape)
        return comp.decode(q, bufs[1], self.codec, self.dtype)

    def exchange(self, send_f, recv_f: bool, send_b, recv_b: bool):
        """``(received activation, received cotangent)`` of one tick (None
        where nothing arrives)."""
        p, s = self.p, self.s
        if p == 1:
            # the self hop: a copy (through the codec on a coded boundary)
            out = []
            for x, want, edge in ((send_f, recv_f, s), (send_b, recv_b, s)):
                if not want:
                    out.append(None)
                elif self.coded[edge]:
                    out.append(self._decode(self._encode(x)))
                else:
                    out.append(x.clone())
            return out[0], out[1]
        ops, recvs = [], []
        # (tensor to send or None, receive?, send peer, receive peer, send
        # boundary, receive boundary, tag)
        for x, want, to, frm, b_send, b_recv, tag in (
                (send_f, recv_f, self.nxt, self.prv, s, (s - 1) % p,
                 _TAG_FWD),
                (send_b, recv_b, self.prv, self.nxt, (s - 1) % p, s,
                 _TAG_BWD)):
            if x is not None:
                coded = self.coded[b_send]
                parts = self._encode(x) if coded else [x.contiguous()]
                for i, t in enumerate(parts):
                    ops.append(dist.P2POp(dist.isend, t, to, self.group,
                                          tag + i))
                    _WIRE_BYTES["coded" if coded else "raw"] += \
                        t.numel() * t.element_size()
            if want:
                coded = self.coded[b_recv]
                if coded:
                    bufs = self._payload_buffers()
                else:
                    bufs = [torch.empty(self.shape, dtype=self.dtype,
                                        device=self.device)]
                for i, t in enumerate(bufs):
                    ops.append(dist.P2POp(dist.irecv, t, frm, self.group,
                                          tag + i))
                recvs.append((bufs, coded))
            else:
                recvs.append(None)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = []
        for r in recvs:
            if r is None:
                out.append(None)
            else:
                bufs, coded = r
                out.append(self._decode(bufs) if coded else bufs[0])
        return out[0], out[1]


def _act_struct(act_struct, micro_inputs, first_fn, first_params):
    """(shape, dtype) of the activation that hops: given, or the first
    microbatch through ``first_fn`` (the reference's ``eval_shape``)."""
    if act_struct is not None:
        return tuple(act_struct[0]), act_struct[1]
    if first_fn is None:
        return tuple(micro_inputs.shape[1:]), micro_inputs.dtype
    with torch.no_grad():
        a = first_fn(first_params, micro_inputs[0])
    return tuple(a.shape), a.dtype


# ---------------------------------------------------------------------------
# The forward ladder (the reference's pipeline_apply_p, :102-206)
# ---------------------------------------------------------------------------

class _ApplyP(torch.autograd.Function):
    """The fill-drain ladder as one autograd function over the leaves of
    the stage, first and last trees. ``spec`` carries the functions, the
    trees and the group; the forward saves each tick's stage input (with
    ``remat``) or its graph (without), the backward runs the ticks in
    reverse."""

    @staticmethod
    def forward(ctx, spec, micro_inputs, *leaves):
        p, s, last = spec["p"], spec["s"], spec["p"] - 1
        n_micro = micro_inputs.shape[0]
        hops = spec["hops"]
        sp, fp, lp = (_Diff(spec["stage_params"]), _Diff(spec["first"]),
                      _Diff(spec["last"]))
        ctx.spec, ctx.diffs = spec, (sp, fp, lp)
        saved = {}
        in_flight = None
        outputs = None
        for t in range(n_micro + p - 1):
            mb = t - s
            y = None
            if 0 <= mb < n_micro:
                if spec["remat"]:
                    with torch.no_grad():
                        x = (in_flight if s > 0 else
                             _embed(spec, fp.source, micro_inputs[mb]))
                        y = spec["stage_fn"](spec["stage_params"], x)
                        out = (_head(spec, lp.source, y) if s == last
                               else None)
                    saved[mb] = x if s > 0 else None
                else:
                    with torch.enable_grad():
                        xl = (in_flight.detach().requires_grad_()
                              if s > 0 else None)
                        x = xl if s > 0 else _embed(spec, fp.tree,
                                                    micro_inputs[mb])
                        yg = spec["stage_fn"](sp.tree, x)
                        og = _head(spec, lp.tree, yg) if s == last else yg
                    saved[mb] = (xl, og)
                    y = yg.detach()
                    out = og.detach() if s == last else None
                if s == last:
                    if outputs is None:
                        outputs = out.new_zeros((n_micro,) + tuple(out.shape))
                    outputs[mb] = out
            # stage s+1 works on microbatch mb at tick t+1
            send = y if (s < last and y is not None) else None
            recv = s > 0 and 0 <= t + 1 - s < n_micro
            in_flight, _ = hops.exchange(send, recv, None, False)
        ctx.saved, ctx.micro = saved, micro_inputs
        # the last stage's outputs on every rank of the group (the
        # reference's broadcast_p)
        if p > 1:
            if outputs is None:
                outputs = torch.empty((n_micro,) + spec["out_shape"],
                                      dtype=spec["out_dtype"],
                                      device=micro_inputs.device)
            dist.broadcast(outputs, dist.get_global_rank(spec["group"], last),
                           group=spec["group"])
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        spec = ctx.spec
        p, s, last = spec["p"], spec["s"], spec["p"] - 1
        n_micro = ctx.micro.shape[0]
        hops = spec["hops"]
        sp, fp, lp = ctx.diffs
        n_s, n_f = len(sp.leaves), len(fp.leaves)
        grads = [torch.zeros_like(x) for x in
                 sp.leaves + fp.leaves + lp.leaves]
        ct = None
        for t in reversed(range(n_micro + p - 1)):
            mb = t - s
            dx = None
            if 0 <= mb < n_micro:
                if spec["remat"]:
                    x_saved = ctx.saved[mb]
                    with torch.enable_grad():
                        xl = (x_saved.detach().requires_grad_()
                              if s > 0 else None)
                        x = xl if s > 0 else _embed(spec, fp.tree,
                                                    ctx.micro[mb])
                        yg = spec["stage_fn"](sp.tree, x)
                        og = _head(spec, lp.tree, yg) if s == last else yg
                else:
                    xl, og = ctx.saved[mb]
                ctx.saved[mb] = None
                cot = g_out[mb] if s == last else ct
                ins = (sp.leaves + (fp.leaves if s == 0 else [])
                       + (lp.leaves if s == last else [])
                       + ([xl] if s > 0 else []))
                got = _grad(og, ins, cot)
                for i, g in enumerate(got[:n_s]):
                    grads[i] += g
                k = n_s
                if s == 0:
                    for i, g in enumerate(got[k:k + n_f]):
                        grads[n_s + i] += g
                    k += n_f
                if s == last:
                    for i, g in enumerate(got[k:k + len(lp.leaves)]):
                        grads[n_s + n_f + i] += g
                    k += len(lp.leaves)
                if s > 0:
                    dx = got[k]
            # stage s-1 works on microbatch mb at tick t-1
            send = dx if s > 0 else None
            recv = s < last and 0 <= t - 1 - s < n_micro
            _, ct = hops.exchange(None, False, send, recv)
        if p > 1:
            # the replicated first and last trees: every rank's copy gets
            # the gradient (the transpose of their replication)
            for g in grads[n_s:]:
                dist.all_reduce(g, group=spec["group"])
        # module parameters are inputs through their own leaves
        return (None, None) + tuple(grads)


def _embed(spec, first_tree, micro):
    if spec["first_fn"] is not None:
        return spec["first_fn"](first_tree, micro)
    return micro.to(spec["act_dtype"])


def _head(spec, last_tree, y):
    if spec["last_fn"] is not None:
        return spec["last_fn"](last_tree, y)
    return y


def pipeline_apply_p(stage_fn: Callable, stage_params, micro_inputs,
                     axis_name, n_stages: int,
                     first_fn: Optional[Callable] = None,
                     first_params=None,
                     last_fn: Optional[Callable] = None,
                     last_params=None,
                     out_struct=None,
                     remat: bool = False, act_struct=None):
    """The forward pipeline over the pipe group ``axis_name`` (None at one
    stage) of ``n_stages`` ranks, this rank its stage.

    Args:
      stage_fn: ``(stage_params, x) -> y``, one stage; keeps the
        activation's shape ``[mb, ...]``.
      stage_params: this stage's parameter tree.
      micro_inputs: ``[n_micro, mb, ...]`` microbatches (the same on every
        rank; stage 0 reads them, through ``first_fn`` if given). Not
        differentiated.
      first_fn: ``(first_params, micro) -> activation``, on stage 0 only.
      last_fn: ``(last_params, y) -> out``, on the last stage only;
        ``out_struct`` ``(shape, dtype)`` of one microbatch's output, else
        found by running it on a zero activation.
      remat: keep only each tick's stage input and recompute the stage in
        the backward (without it each tick's graph is kept).
      act_struct: ``(shape, dtype)`` of the activation that hops, else
        found from the first microbatch.

    Returns ``[n_micro, *out_shape]``, the same on every rank. Its
    backward runs on every rank (each computes the loss from the
    replicated output): the last stage takes its own cotangent, the
    cotangents hop back stage by stage, and the gradients of
    ``first_params`` and ``last_params`` are summed over the group, so
    every rank's copy has the whole gradient."""
    p = n_stages
    s = _stage_of(axis_name, p)
    n_micro = micro_inputs.shape[0]
    if n_micro < 1:
        raise ValueError("need at least one microbatch")
    shape, dtype = _act_struct(act_struct, micro_inputs, first_fn,
                               first_params)
    hops = _Hops(axis_name, p, s, shape, dtype, micro_inputs.device)
    out_shape, out_dtype = shape, dtype
    if last_fn is not None:
        if out_struct is None:
            with torch.no_grad():
                o = last_fn(last_params, torch.zeros(
                    shape, dtype=dtype, device=micro_inputs.device))
            out_struct = (o.shape, o.dtype)
        out_shape, out_dtype = tuple(out_struct[0]), out_struct[1]
    spec = {"p": p, "s": s, "group": axis_name, "hops": hops,
            "stage_fn": stage_fn, "stage_params": stage_params,
            "first_fn": first_fn, "first": first_params,
            "last_fn": last_fn, "last": last_params, "remat": remat,
            "act_dtype": dtype, "out_shape": out_shape,
            "out_dtype": out_dtype}
    leaves = (_leaves(stage_params) + _leaves(first_params)
              + _leaves(last_params))
    return _ApplyP.apply(spec, micro_inputs, *leaves)


# ---------------------------------------------------------------------------
# The training executor: 1F1B and the tables (the reference's :234-447 and
# :908-1177)
# ---------------------------------------------------------------------------

def _run_tables(chunk_fn, chunks, micro_inputs, micro_targets, loss_fn,
                group, n_stages: int, tables: _Tables, first_fn, first_params,
                last_fn, last_params, boundary_codec, act_struct):
    """Run this rank's column of ``tables``: ``(loss, chunk grads, first
    grads, last grads)``, the reference's epilogue applied (the loss
    summed over the group times 1/m; the first and last gradients times
    1/m, summed over the group; the chunk gradients times 1/m)."""
    p, n_micro = n_stages, micro_inputs.shape[0]
    s = _stage_of(group, p)
    split = tables.split_bw
    dev = micro_inputs.device
    shape, dtype = _act_struct(act_struct, micro_inputs, first_fn,
                               first_params)
    hops = _Hops(group, p, s, shape, dtype, dev, boundary_codec)
    cds = [_Diff(c) for c in chunks]
    fd, ld = _Diff(first_params), _Diff(last_params)
    gs = [[torch.zeros_like(x) for x in c.leaves] for c in cds]
    gf = [torch.zeros_like(x) for x in fd.leaves]
    gl = [torch.zeros_like(x) for x in ld.leaves]
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    a_in = [None] * tables.a_depth
    c_in = [None] * tables.c_depth
    x_stash = [None] * tables.act_depth
    ct_stash = [None] * tables.ct_depth
    rows = tables.rows
    col = {k: v[:, s].tolist() for k, v in rows.items()}

    def embed(tree, m):
        if first_fn is not None:
            return first_fn(tree, micro_inputs[m])
        return micro_inputs[m].to(dtype)

    def add(acc, got):
        for a, g in zip(acc, got):
            a.add_(g)

    def pull(role, j, m, x, ct, want_w: bool, want_x: bool):
        """One recompute and pull of chunk ``j`` on microbatch ``m``:
        ``(chunk grads, first grads, last grads, dx, loss)``, None where a
        part is not wanted or not the role's."""
        cd = cds[j]
        with torch.enable_grad():
            if role == 0:
                out = chunk_fn(cd.tree, embed(fd.tree, m))
                got = _grad(out, cd.leaves + fd.leaves, ct)
                return got[:len(cd.leaves)], got[len(cd.leaves):], None, \
                    None, None
            xl = x.detach().requires_grad_(want_x)
            y = chunk_fn(cd.tree, xl)
            loss = None
            if role == 2:
                out = y if last_fn is None else last_fn(ld.tree, y)
                loss = loss_fn(out, micro_targets[m])
                y, ct = loss, torch.ones_like(loss)
            ins = ((cd.leaves + (ld.leaves if role == 2 else []))
                   if want_w else []) + ([xl] if want_x else [])
            got = _grad(y, ins, ct)
        nw = len(cd.leaves)
        dcp = got[:nw] if want_w else None
        dlp = got[nw:nw + len(ld.leaves)] if (want_w and role == 2) else None
        dx = got[-1] if want_x else None
        return dcp, None, dlp, dx, (None if loss is None else loss.detach())

    fwd_recv = bwd_recv = None
    for t in range(tables.ticks):
        # 1. the previous tick's arrivals land in their inbox slots
        if col["a_write"][t] >= 0:
            a_in[col["a_write"][t]] = fwd_recv
        if col["c_write"][t] >= 0:
            c_in[col["c_write"][t]] = bwd_recv
        # 2. F: the chunk forward, no graph; its input stashed
        y_f = None
        if col["f_active"][t]:
            src, j, m = col["f_src"][t], col["f_j"][t], col["f_m"][t]
            with torch.no_grad():
                x = embed(first_params, m) if src < 0 else a_in[src]
                y_f = chunk_fn(chunks[j], x)
            if col["f_stash"][t] >= 0:
                x_stash[col["f_stash"][t]] = x
        # 3. B: recompute from the stash (or the microbatch, or the
        # arrival), pull the cotangent through
        dx_b = None
        if col["b_active"][t]:
            role, j, m = col["b_role"][t], col["b_j"][t], col["b_m"][t]
            b_in = col["b_in"][t]
            if role == 2:
                x_b, ct_b = a_in[b_in], None
            else:
                x_b = x_stash[col["b_x"][t]] if role == 1 else None
                ct_b = c_in[b_in]
            if not (split and role == 0):
                # role 0's pull is all weight gradients: under the split
                # the whole job is W's
                dcp, dfp, dlp, dx_b, loss_m = pull(
                    role, j, m, x_b, ct_b, not split, role != 0)
                if dcp is not None:
                    add(gs[j], dcp)
                if dfp is not None:
                    add(gf, dfp)
                if dlp is not None:
                    add(gl, dlp)
                if loss_m is not None:
                    loss_acc += loss_m.float()
            if split:
                if col["b_ct_save"][t] >= 0:
                    ct_stash[col["b_ct_save"][t]] = ct_b
                if col["b_save"][t] >= 0:
                    x_stash[col["b_save"][t]] = x_b
        # 4. W (zb): the same pull again, for the weight half
        if split and col["w_active"][t]:
            role, j, m = col["w_role"][t], col["w_j"][t], col["w_m"][t]
            x_w = x_stash[col["w_x"][t]] if role != 0 else None
            ct_w = ct_stash[col["w_ct"][t]] if role != 2 else None
            dcp, dfp, dlp, _, _ = pull(role, j, m, x_w, ct_w, True, False)
            add(gs[j], dcp)
            if dfp is not None:
                add(gf, dfp)
            if dlp is not None:
                add(gl, dlp)
        # 5. the hops: what the next tick's tables say a stage consumes
        if t + 1 < tables.ticks:
            nxt, prv = (s + 1) % p, (s - 1) % p
            send_f = y_f if rows["a_write"][t + 1, nxt] >= 0 else None
            send_b = dx_b if rows["c_write"][t + 1, prv] >= 0 else None
            fwd_recv, bwd_recv = hops.exchange(
                send_f, bool(rows["a_write"][t + 1, s] >= 0),
                send_b, bool(rows["c_write"][t + 1, s] >= 0))
    inv = 1.0 / n_micro
    gf = [g * inv for g in gf]
    gl = [g * inv for g in gl]
    if p > 1:
        # the loss lives on the last stage, the first and last gradients
        # on theirs: the sum over the group gives every rank the value
        # (the others add zeros)
        works = [dist.all_reduce(x, group=group, async_op=True)
                 for x in [loss_acc] + gf + gl]
        for w in works:
            w.wait()
    loss = loss_acc * inv
    gs = [[g * inv for g in c] for c in gs]
    return (loss, [_rebuild(c.source, iter(g)) for c, g in zip(cds, gs)],
            _rebuild(first_params, iter(gf)), _rebuild(last_params, iter(gl)))


def pipeline_train_1f1b(stage_fn: Callable, stage_params, micro_inputs,
                        micro_targets, loss_fn: Callable, axis_name,
                        n_stages: int,
                        first_fn: Optional[Callable] = None,
                        first_params=None,
                        last_fn: Optional[Callable] = None,
                        last_params=None, boundary_codec=None,
                        act_struct=None):
    """The memory-bounded 1F1B training step over the pipe group
    ``axis_name`` of ``n_stages`` ranks, this rank its stage.

    Stage s runs the forward of microbatch m at tick ``m + s`` and its
    backward at tick ``m + 2(p-1) - s``, ``n_micro + 2(p-1)`` ticks (the
    1f1b table of :func:`build_schedule_tables`). The backward recomputes
    the stage from its stashed input (at most ``2p - 1`` kept: O(p) live
    activations whatever ``n_micro``); the last stage's forward runs
    inside its backward, which the loss seeds.

    Args as :func:`pipeline_apply_p`, and ``micro_targets`` ``[n_micro,
    mb, ...]`` (the last stage reads them), ``loss_fn(out, target)`` a
    microbatch's mean loss, ``boundary_codec`` ``(codec, coded_edges)``
    (:func:`~horovod_tpu_torch.parallel.mesh.pipeline_boundary_edges`).

    Returns ``(loss, stage_grads, first_grads, last_grads)``: the loss the
    mean over the microbatches, on every rank; the stage gradients this
    stage's; the first and last gradients the same on every rank."""
    if n_stages < 2:
        raise ValueError("pipeline_train_1f1b needs n_stages >= 2; a "
                         "single stage is just a plain train step")
    n_micro = micro_inputs.shape[0]
    if n_micro < 1:
        raise ValueError("need at least one microbatch")
    loss, gs, gf, gl = _run_tables(
        stage_fn, [stage_params], micro_inputs, micro_targets, loss_fn,
        axis_name, n_stages, build_schedule_tables("1f1b", n_stages,
                                                   n_micro, 1),
        first_fn, first_params, last_fn, last_params, boundary_codec,
        act_struct)
    return loss, gs[0], gf, gl


def pipeline_train_step(stage_fn: Callable, stage_params, micro_inputs,
                        micro_targets, loss_fn: Callable, axis_name,
                        n_stages: int, schedule: str = "1f1b",
                        n_virtual: int = 1,
                        first_fn: Optional[Callable] = None,
                        first_params=None,
                        last_fn: Optional[Callable] = None,
                        last_params=None,
                        boundary_codec=None, topology=None,
                        act_struct=None):
    """The schedule-selected training step (HOROVOD_TPU_PIPELINE_SCHEDULE).

    ``schedule`` one of :data:`PIPELINE_SCHEDULES`, resolved once here
    (:func:`resolve_pipeline_schedule`: degenerate cases demote to 1f1b
    with one warning). With ``n_virtual > 1`` ``stage_fn`` is one chunk's
    computation and ``stage_params`` the stage's ``n_virtual`` chunk trees,
    placed as :func:`pipeline_chunk_placement` says for the resolved
    schedule: contiguous for 1f1b (the chunks run back to back inside one
    stage), round-robin for interleaved and zb (the table executor).
    ``boundary_codec`` ``(codec, coded_edges)`` codes the hops of the
    listed boundaries; ``topology`` prices ``auto``.

    Returns :func:`pipeline_train_1f1b`'s ``(loss, stage_grads,
    first_grads, last_grads)``, the stage gradients a list of the chunks'
    when ``n_virtual > 1``. Every schedule gives 1F1B's bits at matched
    ``n_micro``."""
    n_micro = micro_inputs.shape[0]
    schedule, v = resolve_pipeline_schedule(schedule, n_stages, n_micro,
                                            n_virtual, topology)
    chunks = list(stage_params) if v > 1 else [stage_params]
    if len(chunks) != v:
        raise ValueError(f"{len(chunks)} chunk trees for n_virtual={v}")
    if schedule == "1f1b":
        if v == 1:
            return pipeline_train_1f1b(
                stage_fn, stage_params, micro_inputs, micro_targets,
                loss_fn, axis_name, n_stages, first_fn=first_fn,
                first_params=first_params, last_fn=last_fn,
                last_params=last_params, boundary_codec=boundary_codec,
                act_struct=act_struct)

        def composed_fn(sp, x):
            # contiguous placement: the stage's chunks in model order
            for j in range(v):
                x = stage_fn(sp[j], x)
            return x

        return pipeline_train_1f1b(
            composed_fn, chunks, micro_inputs, micro_targets, loss_fn,
            axis_name, n_stages, first_fn=first_fn,
            first_params=first_params, last_fn=last_fn,
            last_params=last_params, boundary_codec=boundary_codec,
            act_struct=act_struct)
    tables = build_schedule_tables("zb" if schedule == "zb" else
                                   "interleaved", n_stages, n_micro, v)
    loss, gs, gf, gl = _run_tables(
        stage_fn, chunks, micro_inputs, micro_targets, loss_fn, axis_name,
        n_stages, tables, first_fn, first_params, last_fn, last_params,
        boundary_codec, act_struct)
    return loss, (gs if v > 1 else gs[0]), gf, gl


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [n_micro, B/n_micro, ...] (B must divide)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} "
                         f"microbatches")
    return x.reshape(n_micro, b // n_micro, *x.shape[1:])


def merge_microbatches(y: torch.Tensor) -> torch.Tensor:
    """[n_micro, mb, ...] -> [n_micro*mb, ...]."""
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])
