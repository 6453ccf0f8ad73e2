"""horovod_tpu_torch's BatchNorm epilogue functions and FusedBatchNorm in
every dtype against the JAX package.

The port's ``bn_forward_plain`` / ``bn_backward_plain`` (what the K2/K3
kernels' epilogues compute; the module's CPU path) against the reference's
``batch_norm_train``, its ``jax.vjp`` and ``FusedBatchNorm``'s
``batch_stats``, on the same numpy inputs rounded to bf16, fp16 or fp32, at
channel counts the card's TMA route does not take (3, 12) and one it does
(64). The module in fp16 against the reference's.

Tolerances, relative to each tensor's largest entry: both sides compute in
fp32 from the same rounded inputs, summing in other orders, then round
outputs to the input dtype, where one flipped rounding is one unit in the
last place: so outputs in the input dtype agree to that dtype's epsilon
(at least 1e-5, for fp32's sums in another order); fp32 statistics and
per-channel sums agree to 1e-5 (of sum |terms| for the sums).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from horovod_tpu.ops.fused_batch_norm import (
    FusedBatchNorm as JaxFusedBN, batch_norm_train as jax_batch_norm_train)
from horovod_tpu_torch.ops import kernels as K
from horovod_tpu_torch.ops.fused_batch_norm import FusedBatchNorm

EPS = 1e-5
STAT_REL = 1e-5
DTYPES = ["float32", "bfloat16", "float16"]
CHANNELS = [3, 12, 64]


def _tol(dtype):
    return max(float(jnp.finfo(getattr(jnp, dtype)).eps), 1e-5)


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), rel * scale)


def _pair(shape, dtype, seed, mul=1.0, add=0.0):
    """The same values in ``dtype`` as a jax array and a torch tensor."""
    rng = np.random.RandomState(seed)
    xj = jnp.asarray(rng.randn(*shape) * mul + add, getattr(jnp, dtype))
    xt = torch.tensor(np.asarray(xj, np.float32)).to(getattr(torch, dtype))
    return xj, xt


def _params(c, seed):
    rng = np.random.RandomState(seed)
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    return scale, bias


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_forward_plain_matches_jax(dtype, c):
    """mean, var, invstd and the affine's a, b against the reference's
    training forward: y = x * a + b rounded to the dtype is its y."""
    xj, xt = _pair((4, 5, 3, c), dtype, 0, mul=2.0, add=0.5)
    scale, bias = _params(c, 1)
    y_ref, mean_ref, var_ref = jax_batch_norm_train(
        xj, jnp.asarray(scale), jnp.asarray(bias), EPS)
    out = K.bn_forward_plain(xt.reshape(-1, c), torch.tensor(scale),
                             torch.tensor(bias), EPS)
    mean, var, invstd, a, b = out
    assert out.shape == (5, c) and out.dtype == torch.float32
    _close(mean, mean_ref, STAT_REL)
    _close(var, var_ref, STAT_REL)
    _close(invstd, 1 / np.sqrt(np.asarray(var_ref, np.float64) + EPS),
           STAT_REL)
    y = (xt.float() * a + b).to(xt.dtype)
    _close(y.float().numpy(), np.asarray(y_ref, np.float32), _tol(dtype))


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_backward_plain_matches_jax_vjp(dtype, c):
    """dgamma, dbeta and dx from the backward epilogue's coefficients
    against ``jax.vjp`` of the reference's ``batch_norm_train``."""
    xj, xt = _pair((4, 5, 3, c), dtype, 2, mul=2.0, add=0.5)
    dyj, dyt = _pair((4, 5, 3, c), dtype, 3)
    scale, bias = _params(c, 4)
    _, vjp = jax.vjp(lambda x, s, b: jax_batch_norm_train(x, s, b, EPS)[0],
                     xj, jnp.asarray(scale), jnp.asarray(bias))
    dx_ref, ds_ref, db_ref = vjp(dyj)
    x2d, dy2d = xt.reshape(-1, c), dyt.reshape(-1, c)
    mean, _, invstd, _, _ = K.bn_forward_plain(
        x2d, torch.tensor(scale), torch.tensor(bias), EPS)
    out = K.bn_backward_plain(dy2d, x2d, mean, invstd, torch.tensor(scale))
    dgamma, dbeta, a, c0, c1 = out
    assert out.shape == (5, c) and out.dtype == torch.float32
    xh = (x2d.float() - mean) * invstd
    for got, want, terms in ((dgamma, ds_ref, dy2d.float() * xh),
                             (dbeta, db_ref, dy2d.float())):
        bound = STAT_REL * terms.abs().sum(0).numpy() + 1e-6
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)
    dx = ((x2d.float() - mean) * c1 + c0 + dy2d.float() * a).to(xt.dtype)
    _close(dx.float().numpy(), np.asarray(dx_ref, np.float32).reshape(-1, c),
           _tol(dtype))


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_forward_plain_ema_matches_flax_batch_stats(dtype, c):
    """The running statistics updated in place against the reference
    module's ``batch_stats`` after one training call."""
    xj, xt = _pair((4, 5, 3, c), dtype, 5, mul=2.0, add=0.5)
    scale, bias = _params(c, 6)
    rng = np.random.RandomState(7)
    rm0 = rng.randn(c).astype(np.float32)
    rv0 = (1 + rng.rand(c)).astype(np.float32)
    mod = JaxFusedBN(use_running_average=False, momentum=0.9, epsilon=EPS,
                     dtype=getattr(jnp, dtype))
    _, mut = mod.apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(rm0), "var": jnp.asarray(rv0)}},
        xj, mutable=["batch_stats"])
    rm, rv = torch.tensor(rm0), torch.tensor(rv0)
    K.bn_forward_plain(xt.reshape(-1, c), torch.tensor(scale),
                       torch.tensor(bias), EPS, rm, rv, 0.9)
    _close(rm.numpy(), mut["batch_stats"]["mean"], STAT_REL)
    _close(rv.numpy(), mut["batch_stats"]["var"], STAT_REL)


def test_fused_batch_norm_fp16_matches_jax():
    """FusedBatchNorm(dtype=float16) against the reference module with
    dtype float16: outputs, the three gradients and the running-stat EMA.
    The gradients' cotangent is cos(y) of the fp16 y, so a flipped rounding
    of y moves it: the per-channel sums get 1e-3."""
    c = 12
    rng = np.random.RandomState(8)
    x = (rng.randn(8, 5, 5, c) * 2 + 0.5).astype(np.float16)
    scale, bias = _params(c, 9)
    mod = JaxFusedBN(use_running_average=False, momentum=0.9, epsilon=EPS,
                     dtype=jnp.float16)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def run(p, xx):
        return mod.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                         mutable=["batch_stats"])

    y_ref, mut = run(params, jnp.asarray(x))
    loss = lambda p, xx: jnp.sum(  # noqa: E731
        jnp.sin(run(p, xx)[0].astype(jnp.float32)))
    g_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    bn = FusedBatchNorm(c, momentum=0.9, eps=EPS, dtype=torch.float16)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt)
    assert y.dtype == torch.float16
    torch.sin(y.float()).sum().backward()
    fp16 = _tol("float16")
    _close(y.detach().float().permute(0, 2, 3, 1).numpy(),
           np.asarray(y_ref, np.float32), fp16)
    _close(bn.weight.grad.numpy(), g_ref["scale"], 1e-3)
    _close(bn.bias.grad.numpy(), g_ref["bias"], 1e-3)
    _close(xt.grad.float().permute(0, 2, 3, 1).numpy(),
           np.asarray(gx_ref, np.float32), 2 * fp16)
    _close(bn.running_mean.numpy(), mut["batch_stats"]["mean"], STAT_REL)
    _close(bn.running_var.numpy(), mut["batch_stats"]["var"], STAT_REL)


@pytest.mark.parametrize("how", ["expanded", "nchw"])
def test_fused_batch_norm_takes_any_gradient_layout(how):
    """The backward reads dy's (M, C) view: an expanded gradient (of a
    sum) or an NCHW-contiguous one gives what a channels_last one gives."""
    rng = np.random.RandomState(10)
    x = torch.tensor(rng.randn(4, 6, 5, 5).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    dy = (torch.ones(4, 6, 5, 5).expand(4, 6, 5, 5) if how == "expanded"
          else torch.tensor(rng.randn(4, 6, 5, 5).astype(np.float32)))
    grads = []
    for g in (dy, dy.contiguous(memory_format=torch.channels_last)):
        bn = FusedBatchNorm(6)
        xt = x.clone().requires_grad_()
        bn(xt).backward(g)
        grads.append((xt.grad, bn.weight.grad, bn.bias.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
