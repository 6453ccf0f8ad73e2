"""horovod_tpu_torch's SyncBatchNorm against the JAX package's.

Each case (fp32, bf16 or fp16; 3, 12 or 64 channels; an (8, 3, 3, C) batch
split evenly over N, or a (24, C) batch whose ranks hold different row
counts, at np=4 one rank none) makes one global batch from a seed with
numpy
(``torch_worker.sync_bn_case``). The port runs on each rank's rows in a
size-1 world (this process, no process group), and in np=2 and np=4 gloo
worlds (``torch_worker.py``'s ``sync_bn`` scenario): a training step, a
second forward, then eval mode. The reference runs:

- ``sync_batch_stats`` under ``shard_map`` on the ``mesh8`` fixture with
  the global batch sharded over 8 devices (the statistics);
- ``SyncBatchNorm(axis_name=None)`` on the global batch, its ``jax.vjp``
  (y, dx and the parameters' gradients), the same module again (the
  EMA after two steps) and with ``use_running_average=True`` (eval).

Tolerances, as ``tests/test_torch_bn.py`` sets them, relative to each
tensor's largest entry: both sides compute in fp32 from the same rounded
inputs, summing in other orders, then round outputs to the input dtype,
where one flipped rounding is one unit in the last place: y, dx and the
eval output agree to that dtype's epsilon (at least 1e-5); statistics and
running statistics agree to 1e-5; dscale and dbias, this rank's sums
summed over the ranks, agree to 1e-5 of sum |terms| (plus 1e-6).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from horovod_tpu.ops.sync_batch_norm import (
    SyncBatchNorm as JaxSyncBN, sync_batch_stats as jax_sync_batch_stats)
from horovod_tpu_torch.models.convert import sync_batch_norm_from_flax
from horovod_tpu_torch.ops.fused_batch_norm import FusedBatchNorm
from horovod_tpu_torch.ops.sync_batch_norm import SyncBatchNorm
from torch_worker import (SYNC_BN_CHANNELS, SYNC_BN_DTYPES, SYNC_BN_EPS,
                          SYNC_BN_LAYOUTS, World, sync_bn_case, sync_bn_run)

STAT_REL = 1e-5
SIZES = [1, 2, 4]
CASES = [(n, dtype, c, layout) for n in SIZES for dtype in SYNC_BN_DTYPES
         for c in SYNC_BN_CHANNELS for layout in SYNC_BN_LAYOUTS]


def _tol(dtype):
    return max(float(jnp.finfo(getattr(jnp, dtype)).eps), 1e-5)


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), rel * scale)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each rank's results at sizes 1 (this process), 2 and 4 (gloo)."""
    out = tmp_path_factory.mktemp("sync_bn")
    started = {n: World("sync_bn", n, out) for n in (2, 4)}
    res = {1: [{(d, c, lay): sync_bn_run(0, 1, d, c, lay)
                for d in SYNC_BN_DTYPES for c in SYNC_BN_CHANNELS
                for lay in SYNC_BN_LAYOUTS}]}
    res.update({n: w.results() for n, w in started.items()})
    return res


def _variables(case):
    return {"params": {"scale": jnp.asarray(case["scale"]),
                       "bias": jnp.asarray(case["bias"])},
            "batch_stats": {"mean": jnp.asarray(case["mean"]),
                            "var": jnp.asarray(case["var"])}}


@functools.lru_cache(maxsize=None)
def _reference(dtype, c, layout):
    """The reference module on the global batch: y, dx, dscale, dbias, the
    running statistics after one and two steps, and eval mode's y."""
    case = sync_bn_case(dtype, c, layout)
    jd = getattr(jnp, dtype)
    x = jnp.asarray(case["x"], jd)
    dy = jnp.asarray(case["dy"], jd)
    mod = JaxSyncBN(use_running_average=False, axis_name=None, momentum=0.9,
                    epsilon=SYNC_BN_EPS)
    v = _variables(case)

    def run(xx, params):
        return mod.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, xx,
                         mutable=["batch_stats"])

    y, vjp, mut = jax.vjp(run, x, v["params"], has_aux=True)
    dx, dparams = vjp(dy)
    _, mut2 = mod.apply({"params": v["params"], **mut}, x,
                        mutable=["batch_stats"])
    y_eval = JaxSyncBN(use_running_average=True, momentum=0.9,
                       epsilon=SYNC_BN_EPS).apply(
        {"params": v["params"], **mut2}, x)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"y": f32(y), "dx": f32(dx), "dscale": f32(dparams["scale"]),
            "dbias": f32(dparams["bias"]),
            "mean1": f32(mut["batch_stats"]["mean"]),
            "var1": f32(mut["batch_stats"]["var"]),
            "mean2": f32(mut2["batch_stats"]["mean"]),
            "var2": f32(mut2["batch_stats"]["var"]), "y_eval": f32(y_eval)}


@functools.lru_cache(maxsize=None)
def _mesh8_stats(mesh8, dtype, c, layout):
    """The reference's sync_batch_stats in shard_map over 8 devices."""
    from jax import shard_map
    case = sync_bn_case(dtype, c, layout)
    x = jnp.asarray(case["x"], getattr(jnp, dtype))
    axes = tuple(range(x.ndim - 1))

    def body(blk):
        m, v = jax_sync_batch_stats(blk, "world", axes)
        return m[None], v[None]

    fn = jax.jit(shard_map(body, mesh=mesh8, in_specs=P("world"),
                           out_specs=(P("world"), P("world"))))
    mean, var = fn(jax.device_put(x, NamedSharding(mesh8, P("world"))))
    return np.asarray(mean)[0], np.asarray(var)[0]


def _gathered(worlds, n, key, field):
    """A per-rank field concatenated in rank order (each rank's rows)."""
    return np.concatenate([r[key][field] for r in worlds[n]])


@pytest.mark.parametrize("n,dtype,c,layout", CASES)
def test_statistics_match_the_reference_on_mesh8(worlds, mesh8, n, dtype,
                                                 c, layout):
    """sync_batch_stats on each rank's rows: every rank holds the global
    batch's (mean, var) that the reference's psums give on 8 shards."""
    mean_ref, var_ref = _mesh8_stats(mesh8, dtype, c, layout)
    for r in worlds[n]:
        mean, var = r[(dtype, c, layout)]["stats"]
        _close(mean, mean_ref, STAT_REL)
        _close(var, var_ref, STAT_REL)


@pytest.mark.parametrize("n,dtype,c,layout", CASES)
def test_forward_and_backward_match_the_global_batch(worlds, n, dtype, c,
                                                     layout):
    """y and dx on each rank's rows against the reference's on the global
    batch; dscale and dbias summed over the ranks against its gradients."""
    key = (dtype, c, layout)
    ref = _reference(*key)
    case = sync_bn_case(*key)
    for field in ("y", "dx"):
        got = _gathered(worlds, n, key, field)
        assert got.shape == ref[field].shape
        _close(got, ref[field], _tol(dtype))
    x = case["x"].reshape(-1, c).astype(np.float64)
    dy = case["dy"].reshape(-1, c).astype(np.float64)
    xh = (x - x.mean(0)) / np.sqrt(x.var(0) + SYNC_BN_EPS)
    for field, terms in (("dscale", dy * xh), ("dbias", dy)):
        got = sum(r[key][field] for r in worlds[n])
        bound = STAT_REL * np.abs(terms).sum(0) + 1e-6
        assert np.all(np.abs(got - ref[field]) <= bound), field


@pytest.mark.parametrize("n,dtype,c,layout", CASES)
def test_running_statistics_and_eval_match_the_reference(worlds, n, dtype,
                                                         c, layout):
    """The EMA after one and two training steps on every rank, and eval
    mode on the running statistics."""
    key = (dtype, c, layout)
    ref = _reference(*key)
    for r in worlds[n]:
        for field in ("mean1", "var1", "mean2", "var2"):
            _close(r[key][field], ref[field], STAT_REL)
    _close(_gathered(worlds, n, key, "y_eval"), ref["y_eval"], _tol(dtype))


@pytest.mark.parametrize("c", SYNC_BN_CHANNELS)
@pytest.mark.parametrize("dtype", SYNC_BN_DTYPES)
def test_size1_is_fused_batch_norm(dtype, c):
    """At size 1 the module computes what FusedBatchNorm does: y, dx, the
    gradients and the running statistics."""
    case = sync_bn_case(dtype, c, "nhwc")
    x0 = torch.tensor(case["x"]).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    dy = torch.tensor(case["dy"]).to(x0.dtype).permute(0, 3, 1, 2)
    got = []
    for mod in (SyncBatchNorm(c), FusedBatchNorm(c)):
        with torch.no_grad():
            mod.weight.copy_(torch.tensor(case["scale"]))
            mod.bias.copy_(torch.tensor(case["bias"]))
        x = x0.clone().requires_grad_()
        y = mod(x)
        y.backward(dy)
        got.append([y.detach().float(), x.grad.float(), mod.weight.grad,
                    mod.bias.grad, mod.running_mean, mod.running_var])
    for i, (a, b) in enumerate(zip(*got)):
        _close(a.numpy(), b.numpy(), _tol(dtype) if i < 2 else STAT_REL)


@pytest.mark.parametrize("use_scale,use_bias",
                         [(False, False), (True, False), (False, True)])
def test_without_scale_or_bias_matches_the_reference(use_scale, use_bias):
    case = sync_bn_case("float32", 12, "ragged")
    x = jnp.asarray(case["x"])
    ref = JaxSyncBN(use_running_average=False, epsilon=SYNC_BN_EPS,
                    use_scale=use_scale, use_bias=use_bias)
    params = {k: jnp.asarray(case[k]) for k, on in
              (("scale", use_scale), ("bias", use_bias)) if on}
    bs = {"mean": jnp.zeros(12), "var": jnp.ones(12)}

    def run(xx, p):
        return ref.apply({"params": p, "batch_stats": bs}, xx,
                         mutable=["batch_stats"])[0]

    y_ref, vjp = jax.vjp(run, x, params)
    dx_ref, dp_ref = vjp(jnp.asarray(case["dy"]))
    mod = SyncBatchNorm(12, eps=SYNC_BN_EPS, use_scale=use_scale,
                        use_bias=use_bias)
    assert (mod.weight is None) != use_scale
    assert (mod.bias is None) != use_bias
    mod.load_state_dict(sync_batch_norm_from_flax(
        {"params": params, "batch_stats": bs}))
    xt = torch.tensor(case["x"]).requires_grad_()
    y = mod(xt)
    y.backward(torch.tensor(case["dy"]))
    _close(y.detach().numpy(), y_ref, 1e-5)
    _close(xt.grad.numpy(), dx_ref, 1e-5)
    for name, p in (("scale", mod.weight), ("bias", mod.bias)):
        if p is not None:
            _close(p.grad.numpy(), dp_ref[name], 1e-5)


def test_converter_carries_the_reference_variables():
    """sync_batch_norm_from_flax: the reference module's params and
    batch_stats loaded into the port's, eval outputs alike."""
    case = sync_bn_case("float32", 12, "nhwc")
    v = _variables(case)
    sd = sync_batch_norm_from_flax(v)
    assert sorted(sd) == ["bias", "running_mean", "running_var", "weight"]
    mod = SyncBatchNorm(12)
    mod.load_state_dict(sd)
    mod.eval()
    y_ref = JaxSyncBN(use_running_average=True, epsilon=SYNC_BN_EPS).apply(
        v, jnp.asarray(case["x"]))
    y = mod(torch.tensor(case["x"]).permute(0, 3, 1, 2))
    _close(y.detach().permute(0, 2, 3, 1).numpy(), y_ref, 1e-5)

