"""horovod_tpu_torch's decoder LM and ViT against the JAX package.

The same numpy weights (carried by ``transformer_from_jax`` and
``vit_from_flax``) and tokens or images go through both packages in fp32 on
the CPU, where the port's attention runs K6's plain versions and the
reference's its materialized path. Tolerances, of each tensor's largest
entry: every parameter gradient agrees to 1e-5 (the same math summed in
another order; measured near 1e-6), the loss to a relative 1e-6, the
logits to 1e-4 (measured near 1e-6, but one run of XLA's CPU program read
2e-5, growing along the sequence).
Three AdamW steps agree with optax to 1e-6 absolute (the updates are
lr-sized, 3e-4, and agree to fp32 rounding of the parameters). The np=2
world holds its ranks bitwise equal and the one-process run on the whole
batch to the same 1e-6.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu.models.vit import ViT_Tiny as JaxViT_Tiny
from horovod_tpu_torch.models.convert import (transformer_from_jax,
                                              vit_from_flax)
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  forward_block, lean_lm_loss,
                                                  lean_xent)
from horovod_tpu_torch.models.vit import ViT_Tiny
from torch_worker import LM_STEPS, lm_config, lm_tokens, run_world

REL = 1e-5
LOGITS_REL = 1e-4
DIMS = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=32)


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), scale)


def _jax_params(cfg, seed=0):
    """The reference's init_params, perturbed so that no norm scale is 1."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray,
                                    JT.init_params(jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32), params)


def _tokens(seed=0, batch=2, t=32):
    toks = np.random.RandomState(seed).randint(0, DIMS["vocab_size"],
                                               size=(batch, t + 1))
    return toks[:, :-1], toks[:, 1:]


def _port(attention, **kw):
    cfg = TransformerConfig(dtype=torch.float32, attention=attention,
                            **DIMS, **kw)
    return cfg, Transformer(cfg)


@functools.partial(jax.jit, static_argnums=3)
def _jax_reference(params, x, y, cfg):
    """The reference's logits, LM loss and its gradients, one program."""
    loss, grads = jax.value_and_grad(JT.lean_lm_loss)(params, x, y, cfg)
    return JT.forward_block(params, x, cfg), loss, grads


@pytest.fixture(scope="module", params=["flash", "ring"])
def lm_pair(request):
    """Logits, loss and gradients of the reference and of the port."""
    attention = request.param
    jcfg = JT.TransformerConfig(dtype=jnp.float32, attention=attention,
                                **DIMS)
    params = _jax_params(jcfg)
    x, y = _tokens()
    logits, loss, grads = _jax_reference(params, x, y, jcfg)
    cfg, model = _port(attention)
    model.load_state_dict(transformer_from_jax(params, cfg), strict=True)
    got_logits = forward_block(model, torch.tensor(x)).detach()
    got_loss = lean_lm_loss(model, torch.tensor(x), torch.tensor(y))
    got_loss.backward()
    return dict(params=params, cfg=cfg,
                logits=(got_logits.numpy(), np.asarray(logits)),
                loss=(float(got_loss.detach()), float(loss)),
                grads=({n: p.grad.numpy() for n, p in
                        model.named_parameters()},
                       transformer_from_jax(jax.device_get(grads), cfg)))


def test_lm_logits_match_reference(lm_pair):
    got, want = lm_pair["logits"]
    assert got.dtype == np.float32 and got.shape == want.shape
    _close(got, want, LOGITS_REL)


def test_lm_loss_matches_reference(lm_pair):
    got, want = lm_pair["loss"]
    assert abs(got - want) <= 1e-6 * abs(want)


def test_lm_parameter_gradients_match_reference(lm_pair):
    got, want = lm_pair["grads"]
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name].numpy())


@pytest.mark.parametrize("remat", ["block", "attention"])
def test_lm_remat_equals_no_remat(lm_pair, remat):
    x, y = (torch.tensor(a) for a in _tokens())
    state = transformer_from_jax(lm_pair["params"], lm_pair["cfg"])
    grads = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(lm_pair["cfg"], remat=mode)
        model = Transformer(cfg)
        model.load_state_dict(state)
        lean_lm_loss(model, x, y).backward()
        grads[mode] = {n: p.grad for n, p in model.named_parameters()}
    for name, g in grads["none"].items():
        torch.testing.assert_close(grads[remat][name], g, rtol=1e-6,
                                   atol=1e-7)


def test_lm_rejects_unknown_remat_and_moe():
    """An unknown remat mode; the MoE-EP placement of a dense model, and of
    experts that do not divide over the ranks (the MoE FFN itself builds:
    tests/test_torch_moe.py)."""
    from horovod_tpu_torch.models.transformer import moe_ep_partition
    with pytest.raises(ValueError, match="unknown remat mode 'layer'"):
        _port("flash", remat="layer")
    cfg, model = _port("flash")
    with pytest.raises(ValueError, match="use_moe"):
        moe_ep_partition(model, 0, 2, cfg)
    cfg, model = _port("flash", use_moe=True, n_experts=6)
    assert tuple(model.layers[0].w1.shape) == (6, 32, 64)
    with pytest.raises(ValueError, match="must divide over 4"):
        moe_ep_partition(model, 0, 4, cfg)


def test_lean_xent_matches_reference_on_bf16_logits():
    rng = np.random.RandomState(5)
    logits = jnp.asarray(4 * rng.randn(2, 7, 50), jnp.bfloat16)
    targets = rng.randint(0, 50, size=(2, 7))
    want = JT._lean_xent(logits, jnp.asarray(targets))
    got = lean_xent(torch.tensor(np.asarray(logits, np.float32)).to(
        torch.bfloat16), torch.tensor(targets))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_lm_init_follows_reference_distributions():
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_heads=4,
                            n_layers=1, d_ff=1024)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(3))
    layer = model.layers[0]
    assert tuple(layer.wq.shape) == (256, 4, 64)
    assert tuple(layer.wo.shape) == (4, 64, 256)
    for w, fan_in in ((layer.wq, 256), (layer.wo, 256), (layer.w1, 256),
                      (layer.w2, 1024)):
        assert abs(float(w.detach().std()) * fan_in ** 0.5 - 1) < 0.05
    assert abs(float(model.embed.detach().std()) / 0.02 - 1) < 0.05
    assert torch.equal(layer.ln1, torch.ones(256))


def _optax_trajectory(params, cfg, x, y, steps):
    opt = optax.adamw(3e-4)
    state = opt.init(params)
    for _ in range(steps):
        grads = _jax_reference(params, x, y, cfg)[2]
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return params


def test_lm_adamw_steps_match_optax():
    jcfg = JT.TransformerConfig(dtype=jnp.float32, attention="flash", **DIMS)
    params = _jax_params(jcfg, seed=1)
    x, y = _tokens(seed=1)
    want = transformer_from_jax(jax.device_get(
        _optax_trajectory(params, jcfg, x, y, 3)), _port("flash")[0])
    cfg, model = _port("flash")
    model.load_state_dict(transformer_from_jax(params, cfg))
    # optax.adamw's defaults; PyTorch's weight decay default is 1e-2
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    for _ in range(3):
        opt.zero_grad()
        lean_lm_loss(model, torch.tensor(x), torch.tensor(y)).backward()
        opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def lm_world2(tmp_path_factory):
    return run_world("lm", 2, tmp_path_factory.mktemp("lm2"))


def test_np2_lm_ranks_stay_identical(lm_world2):
    a, b = lm_world2
    assert a["losses"] != b["losses"]       # each rank's own half batch
    for name in a["params"]:
        np.testing.assert_array_equal(a["params"][name], b["params"][name])


def test_np2_lm_matches_one_process_on_the_whole_batch(lm_world2):
    """Average of the half-batch gradients == gradient of the whole-batch
    mean (equal halves), so the trajectories agree."""
    model = Transformer(lm_config(),
                        generator=torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    tokens = torch.from_numpy(lm_tokens())
    for _ in range(LM_STEPS):
        opt.zero_grad()
        lean_lm_loss(model, tokens[:, :-1], tokens[:, 1:]).backward()
        opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(lm_world2[0]["params"][name],
                                   p.detach().numpy(), rtol=0, atol=1e-6)


def test_vit_tiny_logits_match_flax():
    """ViT_Tiny at 32 px (T = 17: 16 patches and the class token) with
    perturbed flax parameters carried by vit_from_flax, fp32."""
    rng = np.random.RandomState(6)
    images = rng.rand(3, 32, 32, 3).astype(np.float32)
    jm = JaxViT_Tiny(num_classes=10, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32),
        shapes["params"])
    want = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(images)))(
        params)
    model = ViT_Tiny(num_classes=10, dtype=torch.float32, image_size=32)
    model.load_state_dict(vit_from_flax(params), strict=True)
    got = model(torch.tensor(images)).detach()
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 10)
    _close(got.numpy(), np.asarray(want), LOGITS_REL)


def test_vit_tiny_sgd_step_matches_flax():
    """One SGD step of ViT_Tiny (4 heads of 16, the head dim the CUDA
    kernels pad to 64) at 32 px: every parameter gradient of the mean
    cross-entropy against jax.grad's through the flax model (1e-5), and the
    logits after the step (1e-4)."""
    rng = np.random.RandomState(7)
    images = rng.rand(3, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, size=3)
    jm = JaxViT_Tiny(num_classes=10, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32),
        shapes["params"])
    lr = 0.05

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(images))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    grads = jax.jit(jax.grad(loss_fn))(params)
    stepped = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    want = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(images)))(
        stepped)

    model = ViT_Tiny(num_classes=10, dtype=torch.float32, image_size=32)
    model.load_state_dict(vit_from_flax(params), strict=True)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    loss = torch.nn.functional.cross_entropy(model(torch.tensor(images)),
                                             torch.tensor(labels))
    loss.backward()
    want_grads = vit_from_flax(grads)
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy())
    opt.step()
    got = model(torch.tensor(images)).detach()
    _close(got.numpy(), np.asarray(want), LOGITS_REL)
