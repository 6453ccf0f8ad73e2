"""Decoder-only transformer LM, the framework's flagship model.

The port's counterpart of ``horovod_tpu/models/transformer.py``: the
reference's ``_forward`` (:161-293) on a single shard or sequence-parallel
over a (data, seq) mesh with tensor size 1, its losses (:305-334), its
initialization (:89-132) and its SPMD loss and train step (:337-384).
RMSNorm, causal attention, a GELU MLP, the head tied to the embedding; bf16
compute on fp32 parameters, cast per use.

Parameters keep the reference's leaf shapes (``wq/wk/wv`` [D, H, Dh],
``wo`` [H, Dh, D], ``w1`` [D, F], ``w2`` [F, D], ``ln1``/``ln2`` [D],
``embed`` [V, D], ``ln_f`` [D]), one module per layer in an
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

Sequence parallelism (``examples/transformer_lm.py --mesh data=2,seq=2``)::

    mesh = training_mesh({"data": 2, "seq": 2})
    step = make_train_step(mesh, cfg, torch.optim.AdamW(...))
    loss = step(model, shard_tokens(mesh, inputs), shard_tokens(mesh, targets))

Each rank holds its [B/d, T/s] block of the batch; attention runs ring
attention (``attention="ring"`` or ``"flash"``, ``sp_layout`` contiguous or
zigzag) or Ulysses over the seq group, and the gradients are summed over
the world by ``DistributedOptimizer(op=Sum)``.

Not here yet: tensor parallelism, the pipeline and MoE-EP train-step
factories (:387-969), which come with the parallel families (ROADMAP A16),
and the MoE FFN (``use_moe=True`` raises).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.reduce_ops import Sum
from ..core.state import engine as _engine
from ..optimizer import DistributedOptimizer
from ..parallel.flash_attention import flash_attention_local
from ..parallel.mesh import DATA_AXIS, SEQ_AXIS, TENSOR_AXIS, TrainingMesh
from ..parallel.ring_attention import local_attention, ring_attention_p
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
    use_moe: bool = False
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
        self.w1 = _normal((d, f), d, generator)
        self.w2 = _normal((f, d), f, generator)

    def attn_block(self, x, seq_group=None, seq_size: int = 1):
        cfg, dt = self.cfg, self.cfg.dtype
        b, t, d = x.shape
        h, dh = cfg.n_heads, cfg.head_dim

        def proj(w):   # "btd,dhk->bthk": a view, no copy
            return (x @ w.to(dt).reshape(d, h * dh)).view(b, t, h, dh)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        remat = cfg.remat != "none"
        if seq_size > 1:
            if cfg.attention == "ulysses":
                if cfg.sp_layout == "zigzag":
                    raise ValueError(
                        "sp_layout='zigzag' needs ring attention: Ulysses "
                        "re-gathers the sequence in axis order, which under "
                        "a zigzag permutation breaks the causal mask")
                att = ulysses_attention_p(q, k, v, seq_group, seq_size,
                                          causal=True, under_remat=remat)
            else:
                att = ring_attention_p(q, k, v, seq_group, seq_size,
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
        return att.reshape(b, t, h * dh) @ self.wo.to(dt).reshape(h * dh, d)

    def forward(self, h, seq_group=None, seq_size: int = 1):
        dt = self.cfg.dtype
        x = _rmsnorm(h, self.ln1)
        if self.cfg.remat == "attention":
            h = h + checkpoint(self.attn_block, x, seq_group, seq_size,
                               use_reentrant=False)
        else:
            h = h + self.attn_block(x, seq_group, seq_size)
        x = _rmsnorm(h, self.ln2)
        u = F.gelu(x @ self.w1.to(dt), approximate="tanh")
        return h + u @ self.w2.to(dt)


class Transformer(nn.Module):
    """The decoder LM of ``cfg``. Parameters are made on the CPU from
    ``generator`` (a fresh seed-0 generator when None) with the reference's
    distributions; move the model with ``.to(device)``."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.use_moe:
            raise NotImplementedError(
                "the MoE FFN is not ported to horovod_tpu_torch yet (ROADMAP "
                "A16, parallel/moe.py)")
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
                seq_size: int = 1):
        """Logits [B, T, V] of int tokens [B, T]: fp32, or ``dtype`` with
        ``logits_f32=False``. Under sequence parallelism (``seq_size`` > 1)
        ``tokens`` is this rank's block of the sequence and attention runs
        over the process group ``seq_group``."""
        dt = self.cfg.dtype
        h = self.embed[tokens].to(dt)   # the fp32 rows first, then the cast
        for layer in self.layers:
            if self.cfg.remat == "block":
                h = checkpoint(layer, h, seq_group, seq_size,
                               use_reentrant=False)
            else:
                h = layer(h, seq_group, seq_size)
        h = _rmsnorm(h, self.ln_f)
        logits = h @ self.embed.to(dt).t()   # the head is tied to embed
        return logits.float() if logits_f32 else logits


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
    :func:`lean_xent`."""
    return lean_xent(model(inputs, logits_f32=False), targets)


def _local_loss(model: Transformer, inputs, targets, seq_group=None,
                seq_size: int = 1):
    """(sum of the token NLLs, token count) of a local block: fp32 logits
    and ``log_softmax``, as the reference's ``_local_loss`` (:305-309)."""
    logits = model(inputs, seq_group=seq_group, seq_size=seq_size)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return nll.sum(), nll.numel()


def make_spmd_loss(mesh: TrainingMesh, cfg: TransformerConfig):
    """loss(model, inputs, targets) over the (data, seq) mesh, on this
    rank's [B/d, T/s] block of inputs and targets (:func:`shard_tokens`).

    Its value is the mean token NLL of the global batch on every rank (the
    local sums, allreduced, over count·d·s tokens). Its gradient is that of
    this rank's share only, local sum / (count·d·s): summed over the world
    by ``grouped_allreduce(op=Sum)``, the shares make the gradient of the
    global mean (the reference's psum-transpose reduction, :350-355). Ring
    attention's backward has already brought each K/V block's gradient
    home, so nothing else crosses ranks."""
    if mesh.size(TENSOR_AXIS) > 1:
        raise NotImplementedError("tensor parallelism is not ported yet "
                                  "(ROADMAP A16)")
    d, s = mesh.size(DATA_AXIS), mesh.size(SEQ_AXIS)
    group = mesh.group(SEQ_AXIS)

    def loss_fn(model: Transformer, inputs, targets):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the loss's")
        total, count = _local_loss(model, inputs, targets, group, s)
        share = total / (count * d * s)
        mean = _engine().allreduce(share.detach(), name="sp.loss",
                                   op=Sum).synchronize()
        # the global mean's value, this rank's share's gradient
        return share + (mean - share.detach())

    return loss_fn


def make_train_step(mesh: TrainingMesh, cfg: TransformerConfig,
                    optimizer: torch.optim.Optimizer):
    """step(model, inputs, targets) -> loss: one step of ``optimizer`` (a
    plain ``torch.optim.Optimizer`` over the model's parameters) on the
    gradient of :func:`make_spmd_loss`, which ``DistributedOptimizer(op=
    Sum)`` sums over the world first. The reference's jitted
    (params, opt_state, inputs, targets) -> (params, opt_state, loss) with
    the model and optimizer holding their own state."""
    loss_fn = make_spmd_loss(mesh, cfg)
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
