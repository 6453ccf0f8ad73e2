"""Decoder-only transformer LM, the framework's flagship model.

The port's counterpart of ``horovod_tpu/models/transformer.py`` on a single
shard: the reference's ``_forward`` with ``seq_size=None, tensor_size=None``
(:161-293), its loss (:312-334) and its initialization (:89-132). RMSNorm,
causal attention, a GELU MLP, the head tied to the embedding; bf16 compute
on fp32 parameters, cast per use.

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

Not here yet: the mesh, pipeline and MoE-EP train-step factories
(:337-969), which come with the parallel families (ROADMAP A16), and the
MoE FFN (``use_moe=True`` raises).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.flash_attention import flash_attention_local
from ..parallel.ring_attention import local_attention

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
    # "flash" runs kernel K6 (parallel/flash_attention.py); "ring" and
    # "ulysses" name sequence-parallel kernels, and on a single shard the
    # reference runs the materialized local_attention for them (:206-207)
    attention: str = "ring"
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

    def attn_block(self, x):
        cfg, dt = self.cfg, self.cfg.dtype
        b, t, d = x.shape
        h, dh = cfg.n_heads, cfg.head_dim

        def proj(w):   # "btd,dhk->bthk": a view, no copy
            return (x @ w.to(dt).reshape(d, h * dh)).view(b, t, h, dh)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        if cfg.attention == "flash":
            # "btd,dhk->bhtk" as the reference projects for the kernel: the
            # transposed views go to K6 as they are
            att = flash_attention_local(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, layout="bhtk",
                under_remat=cfg.remat != "none").transpose(1, 2)
        else:
            att = local_attention(q, k, v, causal=True)
        # "bthk,hkd->btd"
        return att.reshape(b, t, h * dh) @ self.wo.to(dt).reshape(h * dh, d)

    def forward(self, h):
        dt = self.cfg.dtype
        x = _rmsnorm(h, self.ln1)
        if self.cfg.remat == "attention":
            h = h + checkpoint(self.attn_block, x, use_reentrant=False)
        else:
            h = h + self.attn_block(x)
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

    def forward(self, tokens, logits_f32: bool = True):
        """Logits [B, T, V] of int tokens [B, T]: fp32, or ``dtype`` with
        ``logits_f32=False``."""
        dt = self.cfg.dtype
        h = self.embed[tokens].to(dt)   # the fp32 rows first, then the cast
        for layer in self.layers:
            if self.cfg.remat == "block":
                h = checkpoint(layer, h, use_reentrant=False)
            else:
                h = layer(h)
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
