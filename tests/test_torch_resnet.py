"""horovod_tpu_torch's FusedBatchNorm and ResNet against the JAX package.

The same numpy inputs and weights (carried by ``resnet_from_flax``) go
through both packages in fp32 on the CPU; the port's BN statistics take
their plain versions there. Tolerances, relative to each tensor's largest
entry: the convolutions and reductions run in other orders in XLA and in
PyTorch, so fp32 results agree to rounding, amplified by BatchNorm's 1/std
at tiny batch. Outputs, logits and statistics agree to 1e-4. Parameter
gradients get 5e-4: against a float64 run of the JAX model, each fp32 side
is up to 1.7e-4 off (measured on this ResNet18ish), the port no further
than the JAX package.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from horovod_tpu.models.resnet import ResNet18ish as JaxResNet18ish
from horovod_tpu.ops.fused_batch_norm import FusedBatchNorm as JaxFusedBN
from horovod_tpu_torch.models.convert import resnet_from_flax
from horovod_tpu_torch.models.resnet import ResNet18ish
from horovod_tpu_torch.ops.fused_batch_norm import FusedBatchNorm

REL = 1e-4
GRAD_REL = 5e-4
BATCH, IMAGE = 4, 32


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), scale)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """An NHWC array as an NCHW channels_last tensor (same memory)."""
    return torch.tensor(x_nhwc).permute(0, 3, 1, 2)


# -- FusedBatchNorm ----------------------------------------------------------


def test_fused_batch_norm_matches_jax():
    """Outputs, all three gradients, the running-stat EMA and eval mode
    (mirrors test_pallas_kernels.py::test_fused_batch_norm_matches_flax)."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 5, 5, 12).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(12)).astype(np.float32)
    bias = (0.1 * rng.randn(12)).astype(np.float32)
    mod = JaxFusedBN(use_running_average=False, momentum=0.9, epsilon=1e-5,
                     dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def run(p, xx):
        return mod.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                         mutable=["batch_stats"])

    y_ref, mut = run(params, jnp.asarray(x))
    loss = lambda p, xx: jnp.sum(jnp.sin(run(p, xx)[0]))  # noqa: E731
    g_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    bn = FusedBatchNorm(12, momentum=0.9, eps=1e-5, dtype=torch.float32)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
    xt = _nchw(x).requires_grad_()
    y = bn(xt)
    torch.sin(y).sum().backward()
    _close(y.detach().permute(0, 2, 3, 1).numpy(), y_ref)
    _close(bn.weight.grad.numpy(), g_ref["scale"])
    _close(bn.bias.grad.numpy(), g_ref["bias"])
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), gx_ref)
    _close(bn.running_mean.numpy(), mut["batch_stats"]["mean"])
    _close(bn.running_var.numpy(), mut["batch_stats"]["var"])

    ev = JaxFusedBN(use_running_average=True, momentum=0.9, epsilon=1e-5,
                    dtype=jnp.float32)
    y_eval_ref = ev.apply({"params": params,
                           "batch_stats": mut["batch_stats"]},
                          jnp.asarray(x))
    bn.eval()
    _close(bn(_nchw(x)).detach().permute(0, 2, 3, 1).numpy(), y_eval_ref)


def test_fused_batch_norm_takes_rows_and_rejects_nchw_contiguous():
    bn = FusedBatchNorm(4, dtype=torch.float32)
    x = torch.randn(6, 4)
    mean = x.mean(0)
    y = bn(x)
    assert torch.allclose(y.mean(0), torch.zeros(4), atol=1e-6)
    assert torch.allclose(bn.running_mean, 0.1 * mean, atol=1e-6)
    with pytest.raises(ValueError, match="channels_last"):
        bn(torch.randn(2, 4, 3, 3))        # NCHW-contiguous, not channels_last


# -- ResNet18ish with carried weights ---------------------------------------


@pytest.fixture(scope="module")
def resnet_pair():
    return _run_pair(BATCH, IMAGE)


def _run_pair(batch, image):
    """One ResNet18ish(fused_bn=True) in fp32 in both packages, the same
    perturbed weights, the same batch; each side's logits, gradients,
    batch stats and one SGD-momentum step (optax on the JAX side)."""
    rng = np.random.RandomState(0)
    x = rng.rand(batch, image, image, 3).astype(np.float32)
    jm = JaxResNet18ish(num_classes=10, dtype=jnp.float32, fused_bn=True)
    # names and shapes from the model itself; values from the seed (every
    # BN scale perturbed away from flax's zero init so no branch is dead)
    shapes = jax.eval_shape(lambda k, a: jm.init(k, a, train=True),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32), shapes)
    variables["batch_stats"] = jax.tree_util.tree_map(
        np.abs, variables["batch_stats"])
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 1.0 if "scale" in jax.tree_util.keystr(p) else a,
        variables["params"])

    def loss(p):
        logits, mut = jm.apply({"params": p,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return jnp.mean(jnp.sin(logits)), (logits, mut["batch_stats"])

    (_, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])
    opt = optax.sgd(0.01, momentum=0.9)
    updates, _ = opt.update(grads, opt.init(variables["params"]),
                            variables["params"])
    stepped = optax.apply_updates(variables["params"], updates)

    model = ResNet18ish(num_classes=10, dtype=torch.float32, fused_bn=True)
    model.load_state_dict(resnet_from_flax(variables), strict=True)
    model.train()
    sgd = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    out = model(torch.tensor(x))
    torch.sin(out).mean().backward()
    grads_t = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats_t = {k: v.clone() for k, v in model.state_dict().items()
               if "running" in k}
    sgd.step()
    return dict(
        logits=(out.detach().numpy(), np.asarray(logits)),
        grads=(grads_t, resnet_from_flax({"params": jax.device_get(grads)})),
        stats=(stats_t, resnet_from_flax(
            {"batch_stats": jax.device_get(stats)})),
        step=(dict(model.named_parameters()),
              resnet_from_flax({"params": jax.device_get(stepped)})))


def test_resnet_logits_match_jax(resnet_pair):
    got, want = resnet_pair["logits"]
    _close(got, want)


def test_resnet_parameter_gradients_match_jax(resnet_pair):
    got, want = resnet_pair["grads"]
    assert set(got) == set(want)
    for name in want:
        _close(got[name].numpy(), want[name].numpy(), GRAD_REL)


def test_resnet_batch_stats_match_jax(resnet_pair):
    got, want = resnet_pair["stats"]
    assert set(got) == set(want)
    for name in want:
        _close(got[name].numpy(), want[name].numpy())


def test_resnet_sgd_momentum_step_matches_optax(resnet_pair):
    got, want = resnet_pair["step"]
    for name in want:
        _close(got[name].detach().numpy(), want[name].numpy())


def test_resnet_unfused_variant_logits_match_jax():
    """fused_bn=False (nn.BatchNorm2d against flax nn.BatchNorm): the
    train-mode logits agree; the weights carry the same way."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    jm = JaxResNet18ish(num_classes=10, dtype=jnp.float32, fused_bn=False)
    shapes = jax.eval_shape(lambda k, a: jm.init(k, a, train=True),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda s: (1 + 0.3 * rng.randn(*s.shape)).astype(np.float32), shapes)
    want, _ = jax.jit(lambda v: jm.apply(v, jnp.asarray(x), train=True,
                                         mutable=["batch_stats"]))(variables)
    model = ResNet18ish(num_classes=10, dtype=torch.float32, fused_bn=False)
    model.load_state_dict(resnet_from_flax(variables), strict=True)
    model.train()
    _close(model(torch.tensor(x)).detach().numpy(), np.asarray(want))


def test_resnet_same_padding_matches_flax_rule():
    from horovod_tpu_torch.models.resnet import _same_pads
    assert _same_pads(56, 3, 2) == (0, 1)      # even input, stride 2
    assert _same_pads(7, 3, 2) == (1, 1)
    assert _same_pads(56, 3, 1) == (1, 1)
    assert _same_pads(56, 1, 2) == (0, 0)
