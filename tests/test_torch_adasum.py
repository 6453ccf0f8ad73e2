"""horovod_tpu_torch's Adasum against the JAX package's.

- The combine (K4/K5's plain versions through ``ops.adasum.adasum_combine``)
  against ``adasum_combine_pallas`` in interpret mode and the lax
  ``adasum_combine``, from the same numpy inputs: fp32 within 1e-6 of the
  largest entry (fp32 sums in another order move the coefficients by a few
  ulps), bf16 within one bf16 ulp of each entry (the same fp32 value, or
  one a few fp32 ulps away, rounds to the same or the next bf16). Swap
  symmetry is bitwise.
- ``adasum_stacked`` against ``build_adasum`` on 2-, 4- and 8-device
  meshes, flat and hierarchical, within 1e-5 relative and 1e-6 absolute
  (fp32 sums in another order, at each of up to three levels), and against
  ``adasum_reference`` (float64) at the JAX tests' rtol 1e-4 / atol 1e-5.
- gloo worlds of 2 and 4 ranks, flat and hierarchical (local size 2), from
  ``tests/torch_worker.py``: allreduce and grouped_allreduce with
  op=Adasum against ``build_adasum`` on a mesh of the same size,
  reducescatter against numpy, and two steps of grad-Adasum
  (``DistributedOptimizer(SGD, op=Adasum)``) and delta-Adasum
  (``DistributedDeltaAdasumOptimizer(AdamW)``) on the MLP against
  ``allreduce_gradients(op=Adasum)`` and ``distributed_delta_adasum(
  optax.adamw)`` (the hierarchical world against the reference's
  hierarchical ``build_adasum``). Ranks must be bitwise identical.
  Grad-Adasum is held within 1e-5 relative and 1e-6 of each tensor's
  largest entry; delta-Adasum within 2e-6 of each tensor's largest entry
  besides: torch's AdamW alone ends 1.3e-6 of a bias's largest entry away
  from optax's after two steps on this MLP (it rounds in other places),
  and the port's delta is (p + u) − p of fp32 parameters where optax hands
  over u itself.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.models.mlp import mlp_loss as jax_mlp_loss
from horovod_tpu.ops import adasum as JA
from horovod_tpu.ops.pallas_kernels import adasum_combine_pallas
from horovod_tpu.optimizer import (allreduce_gradients,
                                   distributed_delta_adasum)
from horovod_tpu.parallel.mesh import WORLD_AXIS
from horovod_tpu_torch.models.convert import mlp_from_jax
from horovod_tpu_torch.models.mlp import MLP, mlp_loss
from horovod_tpu_torch.ops import adasum as A, kernels as K
from torch_worker import (ADASUM_ADAMW, ADASUM_GROUP_SHAPES,
                          ADASUM_MLP_SIZES, ADASUM_SGD_LR, ADASUM_STEPS,
                          World, adasum_inputs, adasum_mlp_data,
                          adasum_mlp_params, shard_rows)

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (None, torch.bfloat16, jnp.bfloat16)}


def _operands(shape, seed=0):
    """fp32 a and b, b leaning on a so the coefficients are not near 1."""
    rng = np.random.RandomState(seed)
    a = rng.randn(*shape).astype(np.float32)
    b = (0.6 * a + rng.randn(*shape)).astype(np.float32)
    return a, b


def _port_combine(a, b, dtype):
    ta, tb = (torch.from_numpy(x).to(DTYPES[dtype][1]) for x in (a, b))
    return A.adasum_combine(ta, tb).float().numpy()


def _bf16_ulp(x):
    """One bf16 ulp of each entry of x (8 bits of mantissa)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_combine_close(got, want, dtype):
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("ref", ["pallas", "lax"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (1000,), (65537,), (3, 257)])
def test_combine_matches_the_reference(monkeypatch, shape, dtype, ref):
    monkeypatch.delenv("HOROVOD_ADASUM_PALLAS", raising=False)
    a, b = _operands(shape, seed=len(shape) + shape[-1])
    ja, jb = (jnp.asarray(x, DTYPES[dtype][2]) for x in (a, b))
    fn = adasum_combine_pallas if ref == "pallas" else JA.adasum_combine
    want = np.asarray(fn(ja, jb).astype(jnp.float32))
    got = _port_combine(a, b, dtype)
    assert got.shape == shape
    _assert_combine_close(got, want, dtype)


@pytest.mark.parametrize("zero", ["a", "b", "both"])
def test_combine_with_a_zero_operand(zero):
    """A zero norm gives a zero coefficient: 0 combined with b is b."""
    a, b = _operands((257,), seed=3)
    if zero in ("a", "both"):
        a = np.zeros_like(a)
    if zero in ("b", "both"):
        b = np.zeros_like(b)
    got = _port_combine(a, b, "float32")
    want = np.asarray(JA.adasum_combine(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a + b)


def test_combine_orthogonal_is_the_sum():
    got = _port_combine(np.array([1.0, 0.0, 0.0], np.float32),
                        np.array([0.0, 1.0, 0.0], np.float32), "float32")
    np.testing.assert_allclose(got, [1.0, 1.0, 0.0], rtol=1e-6)


def test_combine_parallel_is_the_vector():
    a = np.array([2.0, -1.0, 3.0], np.float32)
    np.testing.assert_allclose(_port_combine(a, a, "float32"), a, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_combine_is_swap_symmetric_bitwise(dtype):
    a, b = (torch.from_numpy(x).to(dtype) for x in _operands((4099,), 5))
    t_ab, t_ba = K.adasum_triple(a, b), K.adasum_triple(b, a)
    assert torch.equal(t_ba, t_ab[[0, 2, 1]])
    assert torch.equal(A.adasum_combine(a, b), A.adasum_combine(b, a))


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (WORLD_AXIS,))


def _build_adasum(x, local=0, pre=1.0, post=1.0):
    """The reference's stacked Adasum of x (n, *s) on an n-device mesh."""
    mesh = _mesh(x.shape[0])
    fn = JA.build_adasum(mesh, WORLD_AXIS, pre, post, local_size=local)
    return np.asarray(fn(jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, P(WORLD_AXIS)))).astype(
            jnp.float32))


def _node_means(x, local):
    if local <= 1:
        return list(x)
    return [x[c * local:(c + 1) * local].mean(axis=0)
            for c in range(len(x) // local)]


STACKED_CASES = [(2, 0), (2, 2), (4, 0), (4, 2), (4, 4), (8, 0), (8, 2),
                 (8, 4)]


@pytest.mark.parametrize("shape", [(32,), (7, 5)])
@pytest.mark.parametrize("n,local", STACKED_CASES)
def test_stacked_matches_build_adasum(n, local, shape):
    x = np.random.RandomState(40 + n + local).randn(n, *shape).astype(
        np.float32)
    got = A.adasum_stacked(torch.from_numpy(x), local_size=local).numpy()
    np.testing.assert_allclose(got, _build_adasum(x, local), rtol=1e-5,
                               atol=1e-6)
    want = JA.adasum_reference(_node_means(x, local)).reshape(shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_stacked_scales_like_build_adasum():
    x = np.random.RandomState(50).randn(4, 9).astype(np.float32)
    got = A.adasum_stacked(torch.from_numpy(x), local_size=2,
                           prescale_factor=0.5, postscale_factor=3.0)
    np.testing.assert_allclose(got.numpy(), _build_adasum(x, 2, 0.5, 3.0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("call,match", [
    (lambda: A.adasum_stacked(torch.zeros(3, 4)), "power-of-2 size"),
    (lambda: A.adasum_stacked(torch.zeros(6, 4), local_size=2),
     "power-of-2 cross size"),
    (lambda: A.adasum_allreduce_p(torch.zeros(4), None, 6, 0),
     "power-of-2 size"),
])
def test_non_power_of_two_sizes_raise(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# --- gloo worlds -----------------------------------------------------------

WORLDS = {"np2": (2, None), "np4": (4, None), "np4_hier": (4, 2)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three ``adasum`` worlds, started together."""
    out = tmp_path_factory.mktemp("adasum")
    started = {}
    for key, (n, local) in WORLDS.items():
        env = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"} if local else None
        started[key] = World("adasum", n, out, local_size=local, env=env)
    return {key: w.results() for key, w in started.items()}


def _stack(key, field):
    n = WORLDS[key][0]
    return np.stack([adasum_inputs(r)[field] for r in range(n)])


@pytest.mark.parametrize("key", list(WORLDS))
def test_world_takes_the_form_it_was_launched_for(worlds, key):
    assert [r["local_size"] for r in worlds[key]] == \
        [WORLDS[key][1] or 0] * WORLDS[key][0]


@pytest.mark.parametrize("key", list(WORLDS))
def test_world_allreduce_matches_build_adasum(worlds, key):
    local = WORLDS[key][1] or 0
    res = worlds[key][0]
    x = _stack(key, "single")
    np.testing.assert_allclose(res["single"], _build_adasum(x, local),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["async"], res["single"], rtol=0, atol=0)
    assert res["async_poll_after"]
    np.testing.assert_allclose(res["scaled"],
                               _build_adasum(x, local, 0.5, 3.0),
                               rtol=1e-5, atol=1e-6)
    for i, shape in enumerate(ADASUM_GROUP_SHAPES):
        g = np.stack([adasum_inputs(r)["group"][i]
                      for r in range(WORLDS[key][0])])
        np.testing.assert_allclose(res["group"][i], _build_adasum(g, local),
                                   rtol=1e-5, atol=1e-6)
    # bf16, rounded at each level: within a bf16 ulp of the largest entry
    # a level
    want = _build_adasum(_stack(key, "bf16").astype(jnp.bfloat16), local)
    levels = int(np.log2(WORLDS[key][0] // max(local, 1)))
    assert np.abs(res["bf16"] - want).max() <= \
        max(levels, 1) * _bf16_ulp(np.abs(want).max())


@pytest.mark.parametrize("key", list(WORLDS))
def test_world_reducescatter_matches_numpy(worlds, key):
    n = WORLDS[key][0]
    total = _stack(key, "rs").sum(axis=0)
    chunk = -(-total.shape[0] // n)
    for r, res in enumerate(worlds[key]):
        rows = total[r * chunk:(r + 1) * chunk]
        np.testing.assert_array_equal(res["rs_sizes"],
                                      [len(total[q * chunk:(q + 1) * chunk])
                                       for q in range(n)])
        np.testing.assert_allclose(res["rs_sum"], rows, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(res["rs_avg"], rows / n, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("key", list(WORLDS))
def test_world_ranks_are_bitwise_identical(worlds, key):
    first = worlds[key][0]
    for res in worlds[key][1:]:
        for field in ("single", "scaled", "bf16", "async"):
            np.testing.assert_array_equal(res[field], first[field])
        for a, b in zip(res["group"], first["group"]):
            np.testing.assert_array_equal(a, b)
        for kind in ("grad", "delta"):
            for mine, theirs in zip(res[kind], first[kind]):
                for name in mine:
                    np.testing.assert_array_equal(mine[name], theirs[name])


def _jax_params():
    return [{k: jnp.asarray(v) for k, v in layer.items()}
            for layer in adasum_mlp_params()]


def _stacked_reduce(n, local):
    """Leaf-wise Adasum of a stacked (n, ...) tree: the reference's
    ``allreduce_gradients(op=Adasum)`` inside shard_map (flat), or its
    hierarchical ``build_adasum`` (what its eager engine runs)."""
    mesh = _mesh(n)
    if local:
        fn = JA.build_adasum(mesh, WORLD_AXIS, local_size=local)
        sharding = NamedSharding(mesh, P(WORLD_AXIS))
        return lambda tree: jax.tree_util.tree_map(
            lambda a: fn(jax.device_put(a, sharding)), tree)

    def body(g):
        return allreduce_gradients(
            jax.tree_util.tree_map(lambda a: a[0], g), WORLD_AXIS,
            op=hvd.Adasum, axis_size=n)

    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(WORLD_AXIS),
                                 out_specs=P(), check_vma=False))


def _local_grads(params, n):
    x, y = adasum_mlp_data(n)
    grad = jax.jit(jax.grad(jax_mlp_loss))
    gs = [grad(params, (x[s], y[s]))
          for s in (shard_rows(r, n, len(x)) for r in range(n))]
    return gs


def _stack_trees(trees):
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *trees)


def _as_state_dict(params):
    return {k: v.numpy() for k, v in mlp_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}


def _reference_grad_adasum(n, local):
    params = _jax_params()
    reduce = _stacked_reduce(n, local)
    opt = optax.sgd(ADASUM_SGD_LR)
    state = opt.init(params)
    traj = []
    for _ in range(ADASUM_STEPS):
        g = reduce(_stack_trees(_local_grads(params, n)))
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        traj.append(_as_state_dict(params))
    return traj


def _adamw():
    kw = ADASUM_ADAMW
    return optax.adamw(kw["lr"], b1=kw["betas"][0], b2=kw["betas"][1],
                       eps=kw["eps"], weight_decay=kw["weight_decay"])


def _reference_delta_adasum(n, local):
    """Each rank's AdamW state advances on its local gradients; the
    updates are Adasum-reduced: ``distributed_delta_adasum`` in shard_map
    with the per-rank states stacked (flat), or the per-rank updates
    through the hierarchical ``build_adasum``."""
    params = _jax_params()
    inner = _adamw()
    states = _stack_trees([inner.init(params)] * n)
    mesh = _mesh(n)
    if local:
        reduce = _stacked_reduce(n, local)
        update = jax.jit(jax.vmap(inner.update, in_axes=(0, 0, None)))

        def step(grads, states, params):
            updates, states = update(grads, states, params)
            return optax.apply_updates(params, reduce(updates)), states
    else:
        opt = distributed_delta_adasum(_adamw(), WORLD_AXIS, n)

        def body(g, st, params):
            first = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)
            updates, st = opt.update(first(g), first(st), params)
            return (optax.apply_updates(params, updates),
                    jax.tree_util.tree_map(lambda a: a[None], st))

        step = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P(WORLD_AXIS), P(WORLD_AXIS), P()),
            out_specs=(P(), P(WORLD_AXIS)), check_vma=False))
    traj = []
    for _ in range(ADASUM_STEPS):
        params, states = step(_stack_trees(_local_grads(params, n)), states,
                              params)
        traj.append(_as_state_dict(params))
    return traj


@pytest.mark.parametrize("key", list(WORLDS))
def test_world_grad_adasum_trajectory_matches_reference(worlds, key):
    want = _reference_grad_adasum(WORLDS[key][0], WORLDS[key][1] or 0)
    for got_step, want_step in zip(worlds[key][0]["grad"], want):
        for name, w in want_step.items():
            np.testing.assert_allclose(got_step[name], w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("key", list(WORLDS))
def test_world_delta_adasum_trajectory_matches_reference(worlds, key):
    want = _reference_delta_adasum(WORLDS[key][0], WORLDS[key][1] or 0)
    start = mlp_from_jax(adasum_mlp_params())
    for got_step, want_step in zip(worlds[key][0]["delta"], want):
        for name, w in want_step.items():
            assert not np.array_equal(w, start[name].numpy())
            np.testing.assert_allclose(got_step[name], w, rtol=1e-5,
                                       atol=2e-6 * np.abs(w).max())


@pytest.mark.parametrize("n,local", [(4, 0), (4, 2)])
def test_cards_scenario_rehearsal_on_gloo(tmp_path, n, local):
    """The card test's ``adasum_cards`` scenario on gloo with a tiny bf16 LM
    and the kernels' plain versions: ranks agree bitwise, every reduced
    gradient equals ``adasum_stacked`` of the gathered local gradients, and
    nothing launches a kernel on the CPU."""
    env = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"} if local else None
    res = World("adasum_cards", n, tmp_path, local_size=local or None,
                env=env).results()
    for kind in ("grad", "delta"):
        assert len({r[kind]["digest"] for r in res}) == 1
        for r in res:
            assert np.isfinite(r[kind]["losses"]).all()
            assert r[kind]["launches"] == {"adasum_triple": 0,
                                           "adasum_scale": 0}
    for r in res:
        assert r["local_size"] == local
        assert len(r["grad"]["rel_err"]) == 2 + 8 * 2     # the LM's tensors
        assert max(r["grad"]["rel_err"]) <= 1e-6


# --- size 1 ----------------------------------------------------------------


@pytest.fixture
def world1(monkeypatch):
    monkeypatch.delenv("HOROVOD_TPU_COORDINATOR", raising=False)
    monkeypatch.delenv("HOROVOD_TPU_NUM_PROCESSES", raising=False)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def test_size1_adasum_and_reducescatter_are_local(world1):
    x = torch.from_numpy(np.random.RandomState(60).randn(5, 3).astype(
        np.float32))
    assert torch.equal(hvd.allreduce(x, op=hvd.Adasum), x)
    torch.testing.assert_close(
        hvd.allreduce(x, op=hvd.Adasum, prescale_factor=2.0,
                      postscale_factor=0.25), x * 0.5, rtol=0, atol=0)
    outs = hvd.grouped_allreduce([x, x[0]], name="g", op=hvd.Adasum)
    assert torch.equal(outs[0], x) and torch.equal(outs[1], x[0])
    assert torch.equal(hvd.reducescatter(x), x)
    torch.testing.assert_close(hvd.reducescatter(x, op=hvd.Average), x)
    with pytest.raises(ValueError, match="Sum and Average"):
        hvd.reducescatter(x, op=hvd.Max)


def test_mlp_matches_the_reference_model():
    params = adasum_mlp_params()
    x, y = adasum_mlp_data(2)
    model = MLP(ADASUM_MLP_SIZES)
    model.load_state_dict(mlp_from_jax(params))
    want = jax_mlp_loss(_jax_params(), (jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = mlp_loss(model, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
