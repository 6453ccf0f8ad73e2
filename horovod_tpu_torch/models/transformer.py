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

Not here yet: the pipeline's train-step factories (:387-715), which come
with the pipeline (ROADMAP A16b).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.reduce_ops import Average, Sum
from ..core.state import engine as _engine
from ..metrics import registry as _metrics_registry
from ..optimizer import DistributedOptimizer, distributed
from ..parallel import moe as M
from ..parallel.flash_attention import flash_attention_local
from ..parallel.mesh import DATA_AXIS, SEQ_AXIS, TENSOR_AXIS, TrainingMesh
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
