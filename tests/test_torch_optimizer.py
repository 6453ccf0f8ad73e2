"""horovod_tpu_torch's DistributedOptimizer and broadcast helpers.

np=2 on gloo: each rank trains the same MLP on its half of the data; the
trajectory must equal the reference math (the two shard gradients averaged,
then optax.sgd(0.01, momentum=0.9)) to fp32 rounding (rtol 1e-5 over three
steps) and be bitwise identical on both ranks. At np=1 the wrapper must take
the size-1 shortcut and step exactly like the wrapped optimizer, with
op=Adasum and in the delta-Adasum form too.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import horovod_tpu_torch as hvd
from torch_worker import mlp_data, mlp_params, run_world, shard_rows


def _reference_trajectory(steps: int, size: int):
    x, y = mlp_data()
    params = {"w1": jnp.asarray(mlp_params()[0]),
              "w2": jnp.asarray(mlp_params()[1])}

    def loss(p, xs, ys):
        return jnp.mean((jnp.tanh(xs @ p["w1"]) @ p["w2"] - ys) ** 2)

    grad = jax.jit(jax.grad(loss))
    opt = optax.sgd(0.01, momentum=0.9)
    state = opt.init(params)
    shards = [shard_rows(r, size, len(x)) for r in range(size)]
    traj = []
    for _ in range(steps):
        gs = [grad(params, x[s], y[s]) for s in shards]
        g = jax.tree_util.tree_map(lambda *a: sum(a) / size, *gs)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        traj.append([np.asarray(params["w1"]), np.asarray(params["w2"])])
    return traj


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world("optimizer", 2, tmp_path_factory.mktemp("opt2"))


def test_np2_sgd_momentum_trajectory_matches_reference(world2):
    want = _reference_trajectory(3, 2)
    for res in world2:
        for got_step, want_step in zip(res["traj"], want):
            for g, w in zip(got_step, want_step):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_np2_ranks_stay_identical(world2):
    for a, b in zip(world2[0]["traj"], world2[1]["traj"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.fixture
def world1(monkeypatch):
    monkeypatch.delenv("HOROVOD_TPU_COORDINATOR", raising=False)
    monkeypatch.delenv("HOROVOD_TPU_NUM_PROCESSES", raising=False)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Tanh(),
                               torch.nn.Linear(3, 2))


def test_size1_steps_like_the_wrapped_optimizer(world1):
    x = torch.tensor(mlp_data()[0])
    a, b = _model(), _model()
    plain = torch.optim.SGD(a.parameters(), lr=0.1, momentum=0.9)
    dist = hvd.DistributedOptimizer(
        torch.optim.SGD(b.parameters(), lr=0.1, momentum=0.9),
        compression=hvd.Compression.fp16)
    for _ in range(3):
        for m, o in ((a, plain), (b, dist)):
            o.zero_grad()
            m(x).pow(2).mean().backward()
            o.step()
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert dist.param_groups[0]["lr"] == 0.1       # the wrapped optimizer's
    hvd.broadcast_parameters(b.state_dict())        # size 1: a no-op
    hvd.broadcast_optimizer_state(dist)


def test_backward_passes_per_step_sums_the_passes(world1):
    x = torch.tensor(mlp_data()[0])
    a, b = _model(), _model()
    dist = hvd.DistributedOptimizer(torch.optim.SGD(a.parameters(), lr=0.1),
                                    backward_passes_per_step=2)
    plain = torch.optim.SGD(b.parameters(), lr=0.1)
    for half in (x[:4], x[4:]):
        dist.zero_grad()
        a(half).pow(2).mean().backward()
        dist.step()
    plain.zero_grad()
    for half in (x[:4], x[4:]):
        b(half).pow(2).mean().backward()        # summed, not averaged
    plain.step()
    for p, q in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wrap", ["grad", "delta"])
def test_size1_adasum_optimizers_step_like_the_inner_one(world1, wrap):
    """In a size-1 world Adasum of one rank is the identity: both Adasum
    optimizers step exactly like the wrapped AdamW."""
    x = torch.tensor(mlp_data()[0])
    a, b = _model(), _model()
    plain = torch.optim.AdamW(a.parameters(), lr=0.01)
    inner = torch.optim.AdamW(b.parameters(), lr=0.01)
    dist = (hvd.DistributedOptimizer(inner, op=hvd.Adasum) if wrap == "grad"
            else hvd.DistributedDeltaAdasumOptimizer(inner))
    for _ in range(3):
        for m, o in ((a, plain), (b, dist)):
            o.zero_grad()
            m(x).pow(2).mean().backward()
            o.step()
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_fp16_compression_round_trip():
    x = torch.randn(5, dtype=torch.float32)
    c, ctx = hvd.Compression.fp16.compress(x)
    assert c.dtype == torch.float16
    assert hvd.Compression.fp16.decompress(c, ctx).dtype == torch.float32
    ints = torch.arange(3)
    c, ctx = hvd.Compression.fp16.compress(ints)
    assert c is ints and ctx is None
