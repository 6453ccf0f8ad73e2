"""Decoder-only transformer LM, the framework's flagship model.

The port's counterpart of ``horovod_tpu/models/transformer.py``: the
reference's ``_forward`` (:161-293) on a single shard or over a (data, seq,
tensor) mesh, its losses (:305-334), its initialization (:89-132), its
``param_specs`` and ``shard_params`` (:135-152, :962-968), its SPMD loss and
train step (:337-384), and the MoE-EP engine train step with its placement
(:717-959). RMSNorm, causal attention, a GELU MLP or a top-1 MoE FFN, the
head tied to the embedding; bf16 compute on fp32 parameters, cast per use.

Parameters keep the reference's leaf shapes (``wq/wk/wv`` [D, H, Dh],
``wo`` [H, Dh, D], ``w1`` [D, F], ``w2`` [F, D], ``ln1``/``ln2`` [D],
``embed`` [V, D], ``ln_f`` [D]; with ``use_moe`` ``router`` [D, E], ``w1``
[E, D, F] and ``w2`` [E, F, D]), one module per layer in an
``nn.ModuleList`` where the reference stacks them for ``lax.scan``, so
:func:`horovod_tpu_torch.models.convert.transformer_from_jax` is an unstack.

A Horovod training loop (``examples/transformer_lm.py --mode eager``)::

    hvd.init()
    model = Transformer(cfg).cuda()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4), op=hvd.Average)
    for inputs, targets in data:
        opt.zero_grad()
        lean_lm_loss(model, inputs, targets).backward()
        opt.step()

(``weight_decay=1e-4`` is ``optax.adamw``'s default; PyTorch's is 1e-2.)

Data, sequence and tensor parallelism
(``examples/transformer_lm.py --mesh data=2,seq=2``)::

    mesh = training_mesh({"data": 2, "seq": 2, "tensor": 2})
    shard_params(model, mesh, cfg)            # this rank's heads, F, experts
    step = make_train_step(mesh, cfg, torch.optim.AdamW(model.parameters()))
    loss = step(model, shard_tokens(mesh, inputs), shard_tokens(mesh, targets))

Each rank holds its [B/d, T/s] block of the batch. Attention runs on this
rank's heads (K6 on a single seq shard, ring attention or Ulysses over the
seq group); the MLP on its slice of F, or, with ``use_moe``, the MoE FFN
with the experts sharded over the tensor group (expert parallelism
replaces tensor parallelism for the FFN, as in the reference). The tensor
group's crossings are Megatron's operators
(``parallel/tensor_parallel.py``): the sum over the group follows ``wo``
and ``w2``, and each replicated input of a sharded product gets its
gradient summed over the group, so every parameter's gradient needs only
the data x seq reduction the reference's transpose gives it.

Pipeline parallelism (the reference's :387-715): the layer stack splits
over the ``pipe`` axis, one stage a rank (``parallel/pipeline.py``), the
embedding and ``ln_f`` replicated::

    mesh = training_mesh({"data": 2, "pipe": 2})
    order = pp_layer_order(cfg.n_layers, 2, v, schedule)  # round-robin
    pp_shard_layers(pp_permute_layers(model, order), mesh)  # this stage's
    step = make_pp_train_step(mesh, cfg, torch.optim.AdamW(
        model.parameters()), n_micro=4, schedule=schedule, n_virtual=v)
    loss = step(model, inputs, targets)    # this data shard's batch

:func:`make_pp_engine_train_step` keeps the whole model on every rank
and hands the full gradient to a ``DistributedOptimizer`` (the engine:
buckets, codecs, replay, ZeRO-1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.reduce_ops import Average, Sum
from ..core.state import engine as _engine
from ..metrics import registry as _metrics_registry
from ..ops import collectives as C
from ..optimizer import (DistributedOptimizer, allreduce_gradients,
                         distributed)
from ..parallel import moe as M
from ..parallel import pipeline as PL
from ..parallel.flash_attention import flash_attention_local
from ..parallel.mesh import (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS,
                             TrainingMesh)
from ..parallel.ring_attention import local_attention, ring_attention_p
from ..parallel.tensor_parallel import (copy_to_group, gather_rows,
                                        mean_from_group, reduce_from_group,
                                        scatter_rows)
from ..parallel.ulysses import ulysses_attention_p

REMAT_MODES = ("none", "block", "attention")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # "flash" runs kernel K6 (parallel/flash_attention.py) on a single
    # shard; "ring" and "ulysses" name the sequence-parallel attention, and
    # on a single shard the reference runs the materialized local_attention
    # for them (:206-207). Under sequence parallelism "flash" runs the ring.
    attention: str = "ring"
    # the ring's layout under sequence parallelism: "contiguous" (rank r
    # holds block r) or "zigzag" (stripes (r, 2n-1-r), causally balanced;
    # tokens and targets go through zigzag_indices first). Ring only.
    sp_layout: str = "contiguous"
    # the MoE FFN (parallel/moe.py): top-1 over n_experts, the experts
    # sharded over the tensor axis (expert parallelism replaces tensor
    # parallelism for the FFN); the loss adds moe_aux_weight x the layers'
    # mean Switch aux loss
    use_moe: bool = False
    n_experts: int = 8
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    # "none" saves every activation; "block" recomputes each layer from its
    # input in the backward; "attention" recomputes only the attention
    # sub-block (torch.utils.checkpoint, non-reentrant)
    remat: str = "none"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


class Parallel(NamedTuple):
    """The process groups a forward runs over: the seq group (ring or
    Ulysses attention) and the tensor group with this rank's index on it
    (None and 1 where the mesh has no such axis)."""
    seq_group: object = None
    seq_size: int = 1
    tensor_group: object = None
    tensor_size: int = 1
    tensor_rank: int = 0


SINGLE = Parallel()


def mesh_parallel(mesh: TrainingMesh) -> Parallel:
    """This rank's :class:`Parallel` on ``mesh``."""
    return Parallel(mesh.group(SEQ_AXIS), mesh.size(SEQ_AXIS),
                    mesh.group(TENSOR_AXIS), mesh.size(TENSOR_AXIS),
                    mesh.index.get(TENSOR_AXIS, 0))


def _normal(shape, fan_in: int, generator) -> nn.Parameter:
    """The reference's ``norm_init``: N(0, 1) * fan_in ** -0.5, fp32."""
    return nn.Parameter(torch.randn(*shape, generator=generator)
                        * (fan_in ** -0.5))


def _rmsnorm(x, scale):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator):
        super().__init__()
        d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        self.cfg = cfg
        self.ln1 = nn.Parameter(torch.ones(d))
        self.wq = _normal((d, h, dh), d, generator)
        self.wk = _normal((d, h, dh), d, generator)
        self.wv = _normal((d, h, dh), d, generator)
        self.wo = _normal((h, dh, d), d, generator)
        self.ln2 = nn.Parameter(torch.ones(d))
        if cfg.use_moe:
            e = cfg.n_experts
            self.w1 = _normal((e, d, f), d, generator)
            self.w2 = _normal((e, f, d), f, generator)
            self.router = nn.Parameter(
                torch.randn(d, e, generator=generator) * (d ** -0.5) * 0.1)
        else:
            self.w1 = _normal((d, f), d, generator)
            self.w2 = _normal((f, d), f, generator)

    def attn_block(self, x, par: Parallel = SINGLE):
        """Attention on this rank's heads (``wq``'s dim 1), its output
        summed over the tensor group."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, t, d = x.shape
        h, dh = self.wq.shape[1], self.wq.shape[2]
        x = copy_to_group(x, par.tensor_group)

        def proj(w):   # "btd,dhk->bthk": a view, no copy
            return (x @ w.to(dt).reshape(d, h * dh)).view(b, t, h, dh)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        remat = cfg.remat != "none"
        if par.seq_size > 1:
            if cfg.attention == "ulysses":
                if cfg.sp_layout == "zigzag":
                    raise ValueError(
                        "sp_layout='zigzag' needs ring attention: Ulysses "
                        "re-gathers the sequence in axis order, which under "
                        "a zigzag permutation breaks the causal mask")
                att = ulysses_attention_p(q, k, v, par.seq_group,
                                          par.seq_size, causal=True,
                                          under_remat=remat)
            else:
                att = ring_attention_p(q, k, v, par.seq_group, par.seq_size,
                                       causal=True, layout=cfg.sp_layout,
                                       under_remat=remat)
        elif cfg.attention == "flash":
            # "btd,dhk->bhtk" as the reference projects for the kernel: the
            # transposed views go to K6 as they are
            att = flash_attention_local(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, layout="bhtk", under_remat=remat).transpose(1, 2)
        else:
            att = local_attention(q, k, v, causal=True)
        # "bthk,hkd->btd"
        out = att.reshape(b, t, h * dh) @ self.wo.to(dt).reshape(h * dh, d)
        return reduce_from_group(out, par.tensor_group)

    def ffn(self, x, par: Parallel = SINGLE):
        """``(output, aux)``: the GELU MLP on this rank's slice of F summed
        over the tensor group (aux None), or the MoE FFN."""
        dt = self.cfg.dtype
        if self.cfg.use_moe:
            return self.moe_ffn(x, par)
        x = copy_to_group(x, par.tensor_group)
        u = F.gelu(x @ self.w1.to(dt), approximate="tanh")
        return reduce_from_group(u @ self.w2.to(dt), par.tensor_group), None

    def moe_ffn(self, x, par: Parallel = SINGLE):
        """The MoE FFN (the reference's :227-265): at tensor size 1 every
        expert is local; above it this shard's tokens split over the
        tensor group (padded, the pad rows masked), dispatch over it to
        the experts' owners, and gather back."""
        cfg = self.cfg
        b, t, d = x.shape
        tok = x.reshape(b * t, d)
        n, group = par.tensor_size, par.tensor_group
        if n == 1:
            y, aux = M.moe_layer_p(
                tok, M.MoEParams(self.router, self.w1, self.w2), None, 1,
                capacity_factor=cfg.moe_capacity_factor)
            return y.reshape(b, t, d), aux
        n_tok = tok.shape[0]
        pad = (-n_tok) % n
        if pad:
            tok = torch.cat([tok, tok.new_zeros(pad, d)])
        per = tok.shape[0] // n
        mine = scatter_rows(tok, group, n, par.tensor_rank)
        # pad rows must not route, take capacity or skew the aux loss
        rows = par.tensor_rank * per + torch.arange(per, device=x.device)
        params = M.MoEParams(copy_to_group(self.router, group), self.w1,
                             self.w2)
        y, aux = M.moe_layer_p(mine, params, group, n,
                               capacity_factor=cfg.moe_capacity_factor,
                               valid_mask=rows < n_tok)
        y = gather_rows(y, group, n, par.tensor_rank)[:n_tok]
        return y.reshape(b, t, d), mean_from_group(aux, group, n)

    def forward(self, h, par: Parallel = SINGLE):
        """``(h, aux)``: the layer's output and its MoE aux loss (None for
        the dense FFN)."""
        x = _rmsnorm(h, self.ln1)
        if self.cfg.remat == "attention":
            h = h + checkpoint(self.attn_block, x, par, use_reentrant=False)
        else:
            h = h + self.attn_block(x, par)
        out, aux = self.ffn(_rmsnorm(h, self.ln2), par)
        return h + out, aux


class Transformer(nn.Module):
    """The decoder LM of ``cfg``. Parameters are made on the CPU from
    ``generator`` (a fresh seed-0 generator when None) with the reference's
    distributions; move the model with ``.to(device)``."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {cfg.remat!r}; "
                             f"expected 'none', 'block', or 'attention'")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.Parameter(
            torch.randn(cfg.vocab_size, d, generator=generator)
            * (d ** -0.5) * (d ** 0.5) * 0.02)
        self.layers = nn.ModuleList(TransformerLayer(cfg, generator)
                                    for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.ones(d))

    def forward(self, tokens, logits_f32: bool = True, seq_group=None,
                seq_size: int = 1, par: Optional[Parallel] = None):
        """Logits [B, T, V] of int tokens [B, T]: fp32, or ``dtype`` with
        ``logits_f32=False``. Under sequence parallelism (``seq_size`` > 1)
        ``tokens`` is this rank's block of the sequence and attention runs
        over the process group ``seq_group``; ``par`` names the seq and
        tensor groups together."""
        if par is None:
            par = Parallel(seq_group, seq_size)
        return self.forward_aux(tokens, logits_f32, par)[0]

    def forward_aux(self, tokens, logits_f32: bool = True,
                    par: Parallel = SINGLE):
        """``(logits, aux)``: the logits and the layers' mean MoE aux loss
        (a zero for the dense FFN), the reference's ``_forward``."""
        dt = self.cfg.dtype
        h = self.embed[tokens].to(dt)   # the fp32 rows first, then the cast
        aux = None
        for layer in self.layers:
            if self.cfg.remat == "block":
                h, a = checkpoint(layer, h, par, use_reentrant=False)
            else:
                h, a = layer(h, par)
            if a is not None:
                aux = a if aux is None else aux + a
        h = _rmsnorm(h, self.ln_f)
        logits = h @ self.embed.to(dt).t()   # the head is tied to embed
        aux = (aux / self.cfg.n_layers if aux is not None
               else torch.zeros((), device=logits.device))
        return (logits.float() if logits_f32 else logits), aux


def forward_block(model: Transformer, tokens):
    """fp32 logits (the reference's logits-only entry point)."""
    return model(tokens)


def lean_xent(logits, targets):
    """Mean token cross-entropy over ``dtype`` logits: the max over the
    logits as they are, the exp-sum in fp32, the hit gathered from the
    logits as they are (the reference's ``_lean_xent``)."""
    mx = logits.max(-1).values.float()
    lse = mx + torch.log(torch.exp(logits.float() - mx[..., None]).sum(-1))
    hit = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - hit.float()).mean()


def lean_lm_loss(model: Transformer, inputs, targets):
    """The single-shard LM loss: logits kept in ``dtype``, then
    :func:`lean_xent`, plus ``moe_aux_weight`` x the aux loss with the
    MoE FFN (the reference's :330-333)."""
    logits, aux = model.forward_aux(inputs, logits_f32=False)
    loss = lean_xent(logits, targets)
    if model.cfg.use_moe:
        loss = loss + model.cfg.moe_aux_weight * aux
    return loss


def _local_loss_aux(model: Transformer, inputs, targets,
                    par: Parallel = SINGLE):
    """(sum of the token NLLs, token count, aux) of a local block: fp32
    logits and ``log_softmax``, as the reference's ``_local_loss``
    (:305-309)."""
    logits, aux = model.forward_aux(inputs, par=par)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return nll.sum(), nll.numel(), aux


def _local_loss(model: Transformer, inputs, targets, seq_group=None,
                seq_size: int = 1):
    """(sum of the token NLLs, token count) of a local block."""
    total, count, _ = _local_loss_aux(model, inputs, targets,
                                      Parallel(seq_group, seq_size))
    return total, count


def make_spmd_loss(mesh: TrainingMesh, cfg: TransformerConfig):
    """loss(model, inputs, targets) over the (data, seq, tensor) mesh, on
    this rank's [B/d, T/s] block of inputs and targets
    (:func:`shard_tokens`) and its :func:`shard_params` slice of the
    weights.

    Its value is the mean token NLL of the global batch on every rank (the
    local sums, allreduced, over count·d·s tokens), plus ``moe_aux_weight``
    x the aux loss averaged over data x seq (and tensor) with the MoE FFN.
    Its gradient is that of this rank's share only, local sum /
    (count·d·s): summed over data x seq (the world at tensor size 1) by
    the optimizer, the shares make the gradient of the global mean (the
    reference's psum-transpose reduction, :350-361). Ring attention's
    backward has already brought each K/V block's gradient home, and the
    tensor group's operators have summed every replicated activation's
    gradient over the group, so nothing else crosses ranks."""
    d, s = mesh.size(DATA_AXIS), mesh.size(SEQ_AXIS)
    t = mesh.size(TENSOR_AXIS)
    _check_tensor_split(cfg, t)
    par = mesh_parallel(mesh)

    def loss_fn(model: Transformer, inputs, targets):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the loss's")
        total, count, aux = _local_loss_aux(model, inputs, targets, par)
        share = total / (count * d * s)
        if cfg.use_moe:
            share = share + cfg.moe_aux_weight * aux / (d * s)
        # every tensor rank holds the same share: the world sum counts it
        # t times
        value = share.detach() if t == 1 else share.detach() / t
        mean = _engine().allreduce(value, name="sp.loss",
                                   op=Sum).synchronize()
        # the global mean's value, this rank's share's gradient
        return share + (mean - share.detach())

    return loss_fn


def make_train_step(mesh: TrainingMesh, cfg: TransformerConfig,
                    optimizer: torch.optim.Optimizer):
    """step(model, inputs, targets) -> loss: one step of ``optimizer`` (a
    plain ``torch.optim.Optimizer`` over the model's parameters, after
    :func:`shard_params` where the tensor axis is above 1) on the gradient
    of :func:`make_spmd_loss`, summed over the ranks first: over the world
    by ``DistributedOptimizer(op=Sum)`` at tensor size 1, else over data x
    seq by :func:`~horovod_tpu_torch.optimizer.distributed` (a sharded
    leaf's slice is this rank's own; a replicated one has one gradient on
    every rank of the tensor group). The reference's jitted (params,
    opt_state, inputs, targets) -> (params, opt_state, loss) with the
    model and optimizer holding their own state."""
    loss_fn = make_spmd_loss(mesh, cfg)
    if mesh.size(TENSOR_AXIS) > 1:
        rest = tuple(a for a in mesh.axis_names if a != TENSOR_AXIS)
        opt = distributed(optimizer, axis_name=rest, mesh=mesh, op=Sum)
    else:
        opt = DistributedOptimizer(optimizer, op=Sum)

    def step(model: Transformer, inputs, targets):
        opt.zero_grad()
        loss = loss_fn(model, inputs, targets)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def shard_tokens(mesh: TrainingMesh, tokens):
    """This rank's [B/d, T/s] block of a global [B, T] batch (the
    reference's ``P(data, seq)`` token sharding). Under ``sp_layout=
    "zigzag"`` permute the sequence with ``zigzag_indices`` first."""
    d, s = mesh.size(DATA_AXIS), mesh.size(SEQ_AXIS)
    b, t = tokens.shape
    if b % d or t % s:
        raise ValueError(f"a [{b}, {t}] batch does not split over data {d} "
                         f"x seq {s}")
    i, j = mesh.index.get(DATA_AXIS, 0), mesh.index.get(SEQ_AXIS, 0)
    return tokens[i * b // d:(i + 1) * b // d, j * t // s:(j + 1) * t // s]


# -- tensor parallelism: the placement (the reference's :135-152, :962) ----

def param_specs(cfg: TransformerConfig) -> dict:
    """Each leaf's dim sharded over the tensor axis, None where it is
    replicated: the reference's ``param_specs`` on the port's per-layer
    leaves (the reference's stacked dim less one). Heads (``wq/wk/wv``
    dim 1, ``wo`` dim 0) and the MLP's F (``w1`` dim 1, ``w2`` dim 0); with
    the MoE FFN the experts (``w1``/``w2`` dim 0) and a replicated
    router."""
    layers = {"ln1": None, "ln2": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0}
    if cfg.use_moe:
        layers.update({"router": None, "w1": 0, "w2": 0})
    else:
        layers.update({"w1": 1, "w2": 0})
    return {"embed": None, "layers": layers, "ln_f": None}


def _check_tensor_split(cfg: TransformerConfig, t: int):
    if cfg.n_heads % t:
        raise ValueError(f"n_heads {cfg.n_heads} does not split over "
                         f"tensor {t}")
    split = cfg.n_experts if cfg.use_moe else cfg.d_ff
    if split % t:
        raise ValueError(f"{'n_experts' if cfg.use_moe else 'd_ff'} "
                         f"{split} does not split over tensor {t}")


def _slice_leaf(p: nn.Parameter, dim: int, n: int, rank: int,
                full: int, what: str):
    """Keep block ``rank`` of ``n`` of ``p`` along ``dim`` in place."""
    if p.shape[dim] != full:
        raise ValueError(f"{what} has {p.shape[dim]} rows on dim {dim}, "
                         f"not the full {full}: already sharded?")
    k = full // n
    with torch.no_grad():
        p.data = p.data.narrow(dim, rank * k, k).clone()


def shard_params(model: Transformer, mesh: TrainingMesh,
                 cfg: TransformerConfig) -> Transformer:
    """Keep this rank's slice of each tensor-sharded leaf of ``model`` (a
    full model, the same on every rank), in place, per
    :func:`param_specs`: heads of ``wq/wk/wv`` and ``wo``, F of ``w1`` and
    ``w2``, or the experts of the MoE's. A no-op at tensor size 1. Build
    the optimizer after it. Returns ``model``."""
    t = mesh.size(TENSOR_AXIS)
    if t == 1:
        return model
    _check_tensor_split(cfg, t)
    rank = mesh.index[TENSOR_AXIS]
    specs = param_specs(cfg)["layers"]
    for i, layer in enumerate(model.layers):
        for name, dim in specs.items():
            if dim is not None:
                full = {"wq": cfg.n_heads, "wk": cfg.n_heads,
                        "wv": cfg.n_heads, "wo": cfg.n_heads}.get(
                    name, cfg.n_experts if cfg.use_moe else cfg.d_ff)
                _slice_leaf(getattr(layer, name), dim, t, rank, full,
                            f"layers.{i}.{name}")
    return model


# -- pipeline parallelism (the reference's :387-715) -----------------------

def _pp_layer(layer: TransformerLayer, h, block: bool = False):
    """One layer on a stage's activation block: the layer's own forward
    with no seq or tensor group (K6 attention; with ``use_moe`` the MoE
    FFN with every expert on the stage, its aux loss left out of the
    pipeline's objective, as the reference's :396-400). ``block``
    recomputes the layer from its input in the backward."""
    if block:
        return checkpoint(layer, h, use_reentrant=False)[0]
    return layer(h)[0]


def pp_param_specs(cfg: TransformerConfig) -> dict:
    """Each leaf's placement in the pipeline: the axis its layer stack
    splits over (``"pipe"``: a stage owns its rows' modules), None where
    it is replicated (the embedding and ``ln_f``); the reference's
    ``P(PIPE_AXIS)`` and ``P()``. The MoE FFN adds the router (every
    expert on its stage)."""
    keys = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")
    if cfg.use_moe:
        keys = keys + ("router",)
    return {"embed": None, "layers": {k: PIPE_AXIS for k in keys},
            "ln_f": None}


def pp_layer_order(n_layers: int, n_stages: int, n_virtual: int,
                   schedule: str = "interleaved"):
    """The physical order of the layer stack: ``order`` such that stage s
    owns rows ``order[s·rows:(s+1)·rows]`` (rows = n_layers / n_stages),
    its chunks in local order. Round-robin placements (interleaved or zb
    at ``n_virtual > 1``) give stage s the model chunks s, s+p, s+2p, ...;
    contiguous ones the identity. ``np.argsort(order)`` maps back to model
    order."""
    if PL.pipeline_chunk_placement(schedule, n_virtual) == "contiguous":
        return np.arange(n_layers)
    lpc = n_layers // (n_stages * n_virtual)
    return np.concatenate([
        np.arange((j * n_stages + s) * lpc, (j * n_stages + s + 1) * lpc)
        for s in range(n_stages) for j in range(n_virtual)])


def _is_identity(order) -> bool:
    return bool(np.all(np.asarray(order) == np.arange(len(order))))


def pp_permute_layers(params, order):
    """Apply :func:`pp_layer_order` to a :class:`Transformer`'s layers (in
    place, before :func:`pp_shard_layers` and the optimizer) or to a
    tree's stacked ``params["layers"]`` leaves (a new tree). The identity
    leaves either as it is."""
    if _is_identity(order):
        return params
    idx = np.asarray(order)
    if isinstance(params, Transformer):
        layers = list(params.layers)
        params.layers = nn.ModuleList(layers[i] for i in idx)
        return params
    out = dict(params)
    out["layers"] = {k: v[idx] for k, v in params["layers"].items()}
    return out


def pp_shard_layers(model: Transformer, mesh: TrainingMesh) -> Transformer:
    """Keep this rank's stage of ``model``'s layers, in place: rows
    [s·rows, (s+1)·rows) of the (permuted) stack, s its index on the
    ``pipe`` axis (the reference's ``P(PIPE_AXIS)`` placement). The
    embedding and ``ln_f`` stay. Build the optimizer after it."""
    p = mesh.size(PIPE_AXIS)
    n = model.cfg.n_layers
    if len(model.layers) != n:
        raise ValueError(f"the model holds {len(model.layers)} of "
                         f"{n} layers: already a stage?")
    if n % p:
        raise ValueError(f"n_layers {n} must divide into {p} stages")
    rows = n // p
    s = mesh.rank_in(PIPE_AXIS) if PIPE_AXIS in mesh.shape else 0
    model.layers = nn.ModuleList(list(model.layers)[s * rows:(s + 1) * rows])
    return model


def _pp_check(cfg: TransformerConfig, n_stages: int, n_virtual: int):
    if cfg.n_layers % (n_stages * n_virtual):
        raise ValueError(f"n_layers {cfg.n_layers} must divide into "
                         f"{n_stages} pipeline stages x {n_virtual} "
                         f"virtual chunks")
    if cfg.remat not in ("none", "block"):
        raise NotImplementedError(
            f"PP flagship supports remat='none'|'block', got {cfg.remat!r}")


def _pp_grads(cfg: TransformerConfig, n_virtual: int, n_micro: int,
              schedule: str, boundary_codec, topology, group,
              n_stages: int):
    """``grads(model, layers, inputs, targets) -> (loss, per-layer
    gradient lists, embed gradient, ln_f gradient)``: one pipelined
    forward and backward of this stage's ``layers`` (the stage's rows in
    local order) on this rank's batch."""
    dt, block = cfg.dtype, cfg.remat == "block"
    v = n_virtual

    def stage_fn(layers, x):
        for layer in layers:
            x = _pp_layer(layer, x, block)
        return x

    def first_fn(fp, tok):
        return fp["embed"][tok].to(dt)

    def last_fn(lp, y):
        return _rmsnorm(y, lp["ln_f"]) @ lp["embed"].to(dt).t()

    def grads(model: Transformer, layers: List[TransformerLayer], inputs,
              targets):
        micro_in = PL.split_microbatches(inputs, n_micro)
        micro_tgt = PL.split_microbatches(targets, n_micro)
        lpc = len(layers) // v
        sp = [layers[j * lpc:(j + 1) * lpc] for j in range(v)] if v > 1 \
            else layers
        act = ((micro_in.shape[1], micro_in.shape[2], cfg.d_model), dt)
        loss, gs, gf, gl = PL.pipeline_train_step(
            stage_fn, sp, micro_in, micro_tgt, lean_xent, group, n_stages,
            schedule=schedule, n_virtual=v, first_fn=first_fn,
            first_params={"embed": model.embed}, last_fn=last_fn,
            last_params={"embed": model.embed, "ln_f": model.ln_f},
            boundary_codec=boundary_codec, topology=topology,
            act_struct=act)
        per_layer = [lg for chunk in gs for lg in chunk] if v > 1 else gs
        return loss, per_layer, gf["embed"] + gl["embed"], gl["ln_f"]

    return grads


def _set_grads(model: Transformer, layers, per_layer, g_embed, g_ln_f):
    model.embed.grad = g_embed
    model.ln_f.grad = g_ln_f
    for layer, gl in zip(layers, per_layer):
        for p, g in zip([q for q in layer.parameters() if q.requires_grad],
                        gl):
            p.grad = g


def make_pp_train_step(mesh: TrainingMesh, cfg: TransformerConfig,
                       optimizer: torch.optim.Optimizer, n_micro: int,
                       schedule: str = "1f1b", n_virtual: int = 1,
                       boundary_codec=None, topology=None):
    """The pipelined flagship's train step over a ``("pipe",)`` or
    ``("data", "pipe")`` mesh (the reference's :476-602):
    ``step(model, inputs, targets) -> loss``, ``model`` this stage's
    (:func:`pp_shard_layers`), ``optimizer`` a plain
    ``torch.optim.Optimizer`` over its parameters, ``inputs`` and
    ``targets`` this data shard's [B/d, T] tokens, microbatched per
    replica.

    The embedding runs on stage 0, ``n_layers/p`` layers a stage, ``ln_f``,
    the tied head and :func:`lean_xent` on the last stage, scheduled by
    ``schedule`` (resolved once here: 1f1b, interleaved with ``n_virtual
    >= 2``, zb or auto; every one 1F1B's bits at matched ``n_micro``).
    Under a round-robin placement the model's layers must be permuted by
    :func:`pp_layer_order` before :func:`pp_shard_layers`; gradients stay
    in that layout. The embedding's gradient is its stage-0 (lookup) part
    plus its last-stage (head) part, each summed over the pipe group; at
    data > 1 every gradient and the loss are averaged over the data group
    (:func:`~horovod_tpu_torch.optimizer.allreduce_gradients`). Dense FFN
    only; ``remat`` "none" or "block" (each layer recomputed inside the
    stage's recompute). Every stage's backward recomputes its layers, so
    K6 runs under recompute."""
    if cfg.use_moe:
        raise NotImplementedError("PP flagship: dense FFN only (compose "
                                  "MoE with dp/sp/tp via make_train_step)")
    d_size, n_stages = mesh.size(DATA_AXIS), mesh.size(PIPE_AXIS)
    schedule, n_virtual = PL.resolve_pipeline_schedule(
        schedule, n_stages, n_micro, n_virtual, topology)
    _pp_check(cfg, n_stages, n_virtual)
    grads = _pp_grads(cfg, n_virtual, n_micro, schedule, boundary_codec,
                      topology, mesh.group(PIPE_AXIS), n_stages)
    rows = cfg.n_layers // n_stages

    def step(model: Transformer, inputs, targets):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        if len(model.layers) != rows:
            raise ValueError(f"the model holds {len(model.layers)} layers, "
                             f"a stage {rows}: pp_shard_layers first")
        layers = list(model.layers)
        loss, per_layer, g_embed, g_ln_f = grads(model, layers, inputs,
                                                 targets)
        if d_size > 1:
            flat = [g_embed] + [g for lg in per_layer for g in lg] + [
                g_ln_f, loss.reshape(1)]
            flat = allreduce_gradients(flat, axis_name=DATA_AXIS, mesh=mesh,
                                       op=Average)
            g_embed, g_ln_f, loss = flat[0], flat[-2], flat[-1][0]
            it = iter(flat[1:-2])
            per_layer = [[next(it) for _ in lg] for lg in per_layer]
        _set_grads(model, layers, per_layer, g_embed, g_ln_f)
        optimizer.step()
        return loss

    return step


def make_pp_engine_train_step(mesh: TrainingMesh, cfg: TransformerConfig,
                              opt, n_micro: int,
                              schedule: Optional[str] = None,
                              n_virtual: int = 0, boundary_codec=None,
                              topology=None):
    """The pipeline composed with the engine's data parallelism (the
    reference's :605-715): ``step(model, inputs, targets) -> loss``, the
    model whole on every rank (its layers in the :func:`pp_layer_order`
    layout), ``opt`` a :class:`~horovod_tpu_torch.optimizer.
    DistributedOptimizer` over its parameters (dense or ``sharded=True``:
    buckets, codecs, replay and ZeRO-1 all apply), the world the mesh's.

    A rank runs its stage's rows of the layers on its replica's batch
    (``inputs``/``targets``: the data shard's tokens), then the stage's
    layer gradients are all-gathered over the pipe group, so every rank of
    a replica hands the optimizer the same full gradient: the world's
    reduction is the mean over the replicas. Under ``op=Sum`` each rank
    hands over its share (the gradient over the world size), under
    ``op=Average`` the gradient itself. The loss is this replica's. With
    ``schedule=None`` the ``HOROVOD_TPU_PIPELINE_*`` knobs decide. The
    MoE FFN runs with every expert on its stage. The pipeline's own
    transfers are ``torch.distributed`` calls on the pipe group; the
    optimizer's one step of the collective stream replays after its
    warm-up, one dispatch a step whatever ``n_micro``."""
    from ..common.env import Config
    if schedule is None:
        ecfg = Config.from_env()
        schedule = ecfg.pipeline_schedule
        n_virtual = n_virtual or ecfg.pipeline_virtual_stages
    n_virtual = max(1, int(n_virtual))
    n_stages = mesh.size(PIPE_AXIS)
    schedule, n_virtual = PL.resolve_pipeline_schedule(
        schedule, n_stages, n_micro, n_virtual, topology)
    _pp_check(cfg, n_stages, n_virtual)
    group = mesh.group(PIPE_AXIS)
    grads = _pp_grads(cfg, n_virtual, n_micro, schedule, boundary_codec,
                      topology, group, n_stages)
    rows = cfg.n_layers // n_stages
    s = mesh.rank_in(PIPE_AXIS) if PIPE_AXIS in mesh.shape else 0
    if opt.op not in (Sum, Average):
        raise ValueError("make_pp_engine_train_step needs op=Sum or "
                         "op=Average")

    def step(model: Transformer, inputs, targets):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        if len(model.layers) != cfg.n_layers:
            raise ValueError("the engine step's model holds every layer")
        all_layers = list(model.layers)
        layers = all_layers[s * rows:(s + 1) * rows]
        loss, per_layer, g_embed, g_ln_f = grads(model, layers, inputs,
                                                 targets)
        if n_stages > 1:
            # every stage's rows to every rank of the replica: one gather
            flat = torch.cat([g.reshape(-1) for lg in per_layer
                              for g in lg])
            out = flat.new_empty(n_stages * flat.numel())
            C.all_gather(out, flat, group)
            per_layer = []
            for r in range(n_stages):
                block = out[r * flat.numel():(r + 1) * flat.numel()]
                off = 0
                for layer in all_layers[r * rows:(r + 1) * rows]:
                    lg = []
                    for p in layer.parameters():
                        if p.requires_grad:
                            lg.append(block[off:off + p.numel()].view_as(p))
                            off += p.numel()
                    per_layer.append(lg)
            layers = all_layers
        share = 1.0 / _engine().backend.size() if opt.op == Sum else 1.0
        if share != 1.0:
            g_embed, g_ln_f = g_embed * share, g_ln_f * share
            per_layer = [[g * share for g in lg] for lg in per_layer]
        _set_grads(model, layers, per_layer, g_embed, g_ln_f)
        opt.step()
        return loss

    return step


# -- expert parallelism over the engine world (the reference's :717-959) --

_EXPERT_LEAVES = ("w1", "w2")


def moe_ep_partition(model: Transformer, rank: int, size: int,
                     cfg: TransformerConfig):
    """Place a full ``use_moe`` model for :func:`make_moe_ep_train_step`:
    keep this rank's experts ``[rank·E/size, (rank+1)·E/size)`` of each
    layer's ``w1`` [E/size, D, F] and ``w2`` [E/size, F, D], in place, and
    return ``(shared, expert)``: name -> parameter of the replicated
    leaves (embedding, attention, norms, router) and of this rank's expert
    slices. Once, before training."""
    if not cfg.use_moe:
        raise ValueError("moe_ep_partition needs use_moe=True")
    size = max(int(size), 1)
    if cfg.n_experts % size:
        raise ValueError(f"n_experts {cfg.n_experts} must divide over "
                         f"{size} expert-parallel ranks")
    for i, layer in enumerate(model.layers):
        for name in _EXPERT_LEAVES:
            p = getattr(layer, name)
            if size > 1 or p.shape[0] != cfg.n_experts:
                _slice_leaf(p, 0, size, rank, cfg.n_experts,
                            f"layers.{i}.{name}")
    expert = {n: p for n, p in model.named_parameters()
              if n.rsplit(".", 1)[-1] in _EXPERT_LEAVES}
    shared = {n: p for n, p in model.named_parameters() if n not in expert}
    return shared, expert


def _ep_ffn(r, w1, w2, n: int, el: int, cap: int):
    """The local experts' FFN on the received [n·el·C, d] buffer (block j
    from rank j), returned in the same exchange layout."""
    d = r.shape[-1]
    e_in = r.view(n, el, cap, d).transpose(0, 1).reshape(el, n * cap, d)
    y = M.expert_ffn(e_in, w1, w2)
    return y.view(el, n, cap, d).transpose(0, 1).reshape(n * el * cap, d)


def _leaf(x):
    """A segment boundary: ``x``'s value as a new autograd leaf."""
    return x.detach().requires_grad_()


def make_moe_ep_train_step(engine, cfg: TransformerConfig,
                           optimizer: torch.optim.Optimizer):
    """Expert-parallel MoE train step on the engine's alltoall (the
    reference's :740-959): experts sharded over the engine world (one rank
    a card, the data axis), top-1 capacity routing as in
    :func:`~horovod_tpu_torch.parallel.moe.moe_layer_p`, the dispatch and
    combine exchanges through ``engine.grouped_alltoall``, so they take its
    per-bucket algorithm and codec, replay, join and metrics.

    The per-rank compute runs as autograd segments chained by hand: a
    layer's attention, routing and dispatch pack; its local experts' FFN;
    its combine; the loss head. Each exchange is an engine call issued
    from the caller's thread between segments, in its own
    ``step_begin``/``step_end`` pair, so a steady-state exchange replays
    as one dispatch: 4·L rounds a step (forward dispatch and combine, the
    backward's combine and dispatch: a uniform block exchange is its own
    transpose), each segment's backward run by ``torch.autograd.backward``
    on its saved outputs (no engine call inside an autograd backward).
    Then one AVERAGE ``grouped_allreduce`` round carries the shared
    gradients and the loss (at size > 1); the expert gradients stay local
    (each rank's experts saw every rank's tokens for them), and
    ``optimizer`` (a plain ``torch.optim.Optimizer`` over the model's
    parameters, after :func:`moe_ep_partition`) steps.

    Capacity: ``ceil(B·T·factor/E)`` slots an expert from each rank, the
    factor ``engine.config.moe_capacity_factor`` when above 0
    (``HOROVOD_TPU_MOE_CAPACITY_FACTOR``), else ``cfg.moe_capacity_factor``.
    The routing counts ([L, E] on the device) are read to the host once a
    step for ``hvd_tpu_moe_expert_tokens_total`` (by expert) and the
    per-layer ``hvd_tpu_moe_dispatch_skew`` (max / mean).

    Returns ``step(model, tokens, targets) -> loss`` (the world mean at
    size > 1)."""
    n = engine.backend.size()
    E = cfg.n_experts
    if not cfg.use_moe:
        raise ValueError("make_moe_ep_train_step needs use_moe=True")
    if E % max(n, 1):
        raise ValueError(f"n_experts {E} must divide over {n} "
                         f"expert-parallel ranks")
    el = E // max(n, 1)
    L = cfg.n_layers
    aux_w = cfg.moe_aux_weight
    reg = _metrics_registry()
    m_tokens = reg.counter("hvd_tpu_moe_expert_tokens_total")
    m_skew = reg.gauge("hvd_tpu_moe_dispatch_skew")

    def exchange(buf, name):
        engine.step_begin()
        try:
            return engine.grouped_alltoall([buf], name=name)[0].synchronize()
        finally:
            engine.step_end()

    def step(model: Transformer, tokens, targets):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        capf = engine.config.moe_capacity_factor or cfg.moe_capacity_factor
        b, t = tokens.shape
        cap = M.capacity(b * t, capf, E)
        dt = cfg.dtype
        for p in model.parameters():
            p.grad = None
        # -- forward: segments chained through the engine's exchanges --
        h0 = model.embed[tokens].to(dt)
        h = _leaf(h0)
        saved, counts, aux_total = [], [], 0.0
        for i, layer in enumerate(model.layers):
            h_in = h
            h_attn = h_in + layer.attn_block(_rmsnorm(h_in, layer.ln1))
            tok = _rmsnorm(h_attn, layer.ln2).reshape(b * t, -1)
            expert, slot, keep, gate, aux, cnt = M.route(tok, layer.router,
                                                         E, cap)
            disp = M.dispatch(tok, expert, slot, keep, E, cap)
            gatek = gate * keep
            counts.append(cnt)
            r = _leaf(exchange(disp.detach(), f"moe.dispatch.l{i}"))
            e_out = _ep_ffn(r, layer.w1, layer.w2, n, el, cap)
            c = _leaf(exchange(e_out.detach(), f"moe.combine.l{i}"))
            ha, gk = _leaf(h_attn), _leaf(gatek)
            h_out = ha + M.combine(c, expert, slot, gk, cap).view(b, t, -1)
            saved.append((h_in, (disp, aux, gatek, h_attn), r, e_out, c, ha,
                          gk, h_out))
            aux_total = aux_total + aux.detach()
            h = _leaf(h_out)
        ce = lean_xent(_rmsnorm(h, model.ln_f) @ model.embed.to(dt).t(),
                       targets)
        loss = ce.detach() + aux_w * aux_total / L
        # -- backward: the reverse chain, the exchanges transposed --------
        torch.autograd.backward(ce)
        g_h = h.grad
        g_aux = torch.full((), aux_w / L, device=ce.device)
        for i in reversed(range(L)):
            h_in, outs, r, e_out, c, ha, gk, h_out = saved[i]
            torch.autograd.backward(h_out, g_h)
            g_e = exchange(c.grad, f"moe.combine.bwd.l{i}")
            torch.autograd.backward(e_out, g_e)
            g_d = exchange(r.grad, f"moe.dispatch.bwd.l{i}")
            torch.autograd.backward(outs, (g_d, g_aux, gk.grad, ha.grad))
            g_h = h_in.grad
            saved[i] = None
        torch.autograd.backward(h0, g_h)
        # -- the shared gradients and the loss: one world mean ------------
        if n > 1:
            shared = [p for name, p in model.named_parameters()
                      if name.rsplit(".", 1)[-1] not in _EXPERT_LEAVES]
            engine.step_begin()
            try:
                hs = engine.grouped_allreduce(
                    [p.grad for p in shared] + [loss.reshape(1)],
                    name="moe.shared_grads", op=Average)
                outs = [hh.synchronize() for hh in hs]
            finally:
                engine.step_end()
            for p, g in zip(shared, outs[:-1]):
                p.grad = g
            loss = outs[-1][0]
        optimizer.step()
        if reg.enabled:
            _count_routing(torch.stack(counts).cpu(), m_tokens, m_skew)
        return loss

    return step


def _count_routing(counts, m_tokens, m_skew):
    """The step's routing counts ([L, E] on the host, one read a step)
    into the MoE counters: tokens by expert over the layers, and each
    layer's skew (max / mean)."""
    per_expert = counts.sum(0)
    for e, v in enumerate(per_expert.tolist()):
        if v:
            m_tokens.inc(float(v), expert=str(e))
    for i, row in enumerate(counts.tolist()):
        mean = sum(row) / len(row)
        m_skew.set(max(row) / max(mean, 1e-9), layer=str(i))
