"""horovod_tpu_torch's ZeRO-1 sharded optimizer (``DistributedOptimizer(
sharded=True)``, ``Engine.sharded_step``, replay's sharded arm and
``hvd.distributed``) on gloo/CPU, against the reference's math and the
JAX package's own sharded optimizer (``tests/test_sharded_optimizer.py``'s
eager cases, and the additions below).

Worlds of 1, 2 and 4 ranks (``torch_worker.py``'s ``sharded`` scenario)
train an MLP whose buckets (63 and 3 floats at a 256-byte fusion
threshold) divide neither 2 nor 4, so every case pads. Tolerances: against
the reference's math (optax on the averaged shard gradients, float32 in
another order) rtol 1e-5, atol 1e-6 over five steps, as
``tests/test_torch_optimizer.py`` states it; against the port's dense
``DistributedOptimizer`` bitwise where the buckets are the same (gloo sums
each element of a bucket in the same order in its allreduce and in its
reduce-scatter of the padded bucket, as these worlds show), and within one
float32 unit where two param groups cut the buckets elsewhere (rtol 1e-6,
atol 1e-7: another order of four summands); across ranks bitwise (every
rank's parameters are the same all-gathered buffer).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import horovod_tpu as ref_hvd
from horovod_tpu.ops.collectives import shard_spec as ref_shard_spec
from horovod_tpu.optimizer import (DistributedEagerOptimizer,
                                   _zero1_layout)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.engine import (_KIND_CODES, SHARDED_JOIN_ERROR,
                                           bucket_by_size)
from horovod_tpu_torch.core.state import engine as port_engine
from horovod_tpu_torch.ops import collectives as C, kernels as K
from horovod_tpu_torch.optimizer import _zero1_plan
from torch_worker import (SHARDED_GROUP_LRS, SHARDED_OPTS, SHARDED_ROWS,
                          SHARDED_STEPS, SHARDED_THRESHOLD, World,
                          sharded_data,
                          sharded_model, sharded_params, sharded_weights,
                          shard_rows)

SIZES = (1, 2, 4)
KINDS = tuple(SHARDED_OPTS)
REF_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    started = {n: World("sharded", n, out) for n in SIZES}
    return {n: w.results() for n, w in started.items()}


def _optax(kind: str, lr=None):
    cls, args = SHARDED_OPTS[kind]
    lr = args["lr"] if lr is None else lr
    if cls == "SGD":
        return optax.sgd(lr, momentum=args["momentum"])
    return optax.adam(lr)


def _loss(p, xs, ys):
    w1, b1, w2, b2 = p
    return jnp.mean((jnp.tanh(xs @ w1 + b1) @ w2 + b2 - ys) ** 2)


def _reference(kinds, replicas: int, steps: int, lrs=None):
    """The reference's math: the MLP's gradients on each of ``replicas``
    data shards averaged, then optax (one transform a param group: w1, b1
    and w2, b2 when ``lrs`` gives the groups' lrs). The weights after each
    step."""
    x, y = sharded_data()
    params = [jnp.asarray(p) for p in sharded_params()]
    grad = jax.jit(jax.grad(_loss))
    parts = ([(slice(0, 4), _optax(kinds, None))] if lrs is None else
             [(slice(0, 2), _optax(kinds, lrs[0])),
              (slice(2, 4), _optax(kinds, lrs[1]))])
    states = [opt.init(params[sl]) for sl, opt in parts]
    rows = [shard_rows(r, replicas, SHARDED_ROWS) for r in range(replicas)]
    traj = []
    for _ in range(steps):
        gs = [grad(params, x[s], y[s]) for s in rows]
        g = [sum(t) / replicas for t in zip(*gs)]
        for i, (sl, opt) in enumerate(parts):
            upd, states[i] = opt.update(g[sl], states[i], params[sl])
            params[sl] = optax.apply_updates(params[sl], upd)
        traj.append([np.asarray(p) for p in params])
    return traj


def _close(got, want, **tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **tol)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_sharded_trajectory_matches_the_reference_math(worlds, n, kind):
    """Every step, replay on (the warm-up, then replayed steps) and off."""
    want = _reference(kind, n, SHARDED_STEPS)
    for res in worlds[n]:
        _close(res[kind]["sharded"], want, **REF_TOL)
        _close(res[kind]["sharded_off"], want, **REF_TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_sharded_is_bitwise_the_dense_port(worlds, n, kind):
    for res in worlds[n]:
        _equal(res[kind]["sharded"], res[kind]["dense"])
        _equal(res[kind]["sharded_off"], res[kind]["dense"])


@pytest.mark.parametrize("n", SIZES)
def test_sharded_ranks_agree_bitwise(worlds, n):
    for res in worlds[n][1:]:
        for kind in KINDS:
            _equal(res[kind]["sharded"], worlds[n][0][kind]["sharded"])


@pytest.mark.parametrize("n", SIZES)
def test_sharded_layout_and_state_are_the_shards(worlds, n):
    """ceil(total/n) a bucket, padded to a multiple of n; the optimizer's
    state lives over the shards (SGD: one momentum buffer a bucket; Adam:
    two), so it shrinks with n; the dense state is every parameter's."""
    shards = [-(-t // n) for t in (63, 3)]
    for res in worlds[n]:
        for kind, per in (("sgd_momentum", 1), ("adam", 2)):
            r = res[kind]
            assert r["layout"] == [(t, s, s * n)
                                   for t, s in zip((63, 3), shards)]
            assert r["state_shapes"] == sorted([(s,) for s in shards] * per)
            # Adam's two step counts: 4-byte scalars
            steps = 4 * 2 * (per - 1)
            assert r["dense_state_bytes"] == 4 * 66 * per + 2 * steps
            assert r["state_bytes"] == 4 * sum(shards) * per + steps
            if n > 1:
                assert r["state_bytes"] < r["dense_state_bytes"]


@pytest.mark.parametrize("n", SIZES)
def test_sharded_replays_one_dispatch_a_steady_step(worlds, n):
    """After the warm-up (3 steps) a step is one dispatch of the armed
    program; an eager step is a reduce-scatter and an all-gather a bucket.
    With replay off every step is eager."""
    for res in worlds[n]:
        for kind in KINDS:
            r = res[kind]
            assert r["replay"] == (1, SHARDED_STEPS - 3, 0)
            assert r["dispatches"] == [4] * 3 + [1] * (SHARDED_STEPS - 3)
            assert r["dispatches_off"] == [4] * SHARDED_STEPS


@pytest.mark.parametrize("n", SIZES)
def test_sharded_backward_passes_per_step(worlds, n):
    """Two local passes summed before the reduce-scatter, as the dense
    optimizer sums them before its allreduce: the same weights."""
    for res in worlds[n]:
        _equal(res["accum"]["sharded"], res["accum"]["dense"])
        assert len(res["accum"]["sharded"]) == 4


@pytest.mark.parametrize("n", SIZES)
def test_sharded_param_groups_keep_their_lrs(worlds, n):
    want = _reference("sgd_momentum", n, SHARDED_STEPS, SHARDED_GROUP_LRS)
    for res in worlds[n]:
        _close(res["groups"]["sharded"], want, **REF_TOL)
        _close(res["groups"]["sharded"], res["groups"]["dense"], rtol=1e-6,
               atol=1e-7)
        _equal(res["groups"]["sharded"], worlds[n][0]["groups"]["sharded"])


@pytest.mark.parametrize("n", [2, 4])
def test_join_against_a_sharded_step_raises_on_every_rank(worlds, n):
    """Rank 0 joins after its steps; the others' next sharded step (a
    replayed one) reads the join round and raises the reference's error,
    as rank 0's join() does; nothing was exchanged, and an allreduce of
    every rank afterwards completes."""
    for res in worlds[n]:
        assert res["join"]["errors"] == [SHARDED_JOIN_ERROR]
        assert res["join"]["after"] == float(n)


@pytest.mark.parametrize("n", SIZES)
def test_distributed_over_the_world(worlds, n):
    """hvd.distributed, dense and shard_optimizer=True, Adam over the
    world: the reference's math, and the two bitwise alike."""
    want = _reference("adam", n, SHARDED_STEPS)
    for res in worlds[n]:
        _close(res["world"], want, **REF_TOL)
        _equal(res["world_sharded"], res["world"])


def test_distributed_over_a_mesh_axis(worlds):
    """{"data": 2, "seq": 2} on 4 ranks: the data axis averages the two
    data replicas, so every rank follows the reference's math at 2."""
    want = _reference("adam", 2, SHARDED_STEPS)
    for rank, res in enumerate(worlds[4]):
        assert res["data_index"] == rank // 2
        _close(res["mesh"], want, **REF_TOL)
        _equal(res["mesh_sharded"], res["mesh"])


# ---------------------------------------------------------------------------
# parity of the pieces with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total", [0, 1, 3, 63, 64, 1000, 1 << 20])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_shard_spec_matches_the_reference(total, n):
    assert C.shard_spec(total, n) == ref_shard_spec(total, n)


@pytest.mark.parametrize("threshold", [64, SHARDED_THRESHOLD, 1 << 26])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_layout_matches_the_references(threshold, n):
    """One param group: the port's buckets and shards are the reference's
    ``_zero1_layout`` of the same leaves."""
    model = sharded_model("cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    plan, params, _ = _zero1_plan(opt, n, threshold)
    ref = _zero1_layout([jnp.asarray(p) for p in sharded_params()], n,
                        threshold)
    assert [(idxs, sizes, shard) for _, idxs, sizes, shard in plan] == [
        (tuple(i), tuple(s), shard) for i, s, _, shard in ref]
    assert len(params) == 4


@pytest.fixture
def world1(monkeypatch):
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_PALLAS_PACK",
                "HOROVOD_TPU_SHARD_OPTIMIZER", "HOROVOD_TPU_STEP_REPLAY"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        yield port_engine()
    finally:
        hvd.shutdown()


def _steps(opt, model, steps, rows=slice(None)):
    x, y = (torch.from_numpy(a[rows]) for a in sharded_data())
    traj = []
    for _ in range(steps):
        opt.zero_grad()
        ((model(x) - y) ** 2).mean().backward()
        opt.step()
        traj.append(sharded_weights(model))
    return traj


@pytest.mark.parametrize("kind", KINDS)
def test_size1_sharded_matches_the_references_sharded_optimizer(world1,
                                                                kind):
    """The JAX package's DistributedEagerOptimizer(sharded=True) and the
    port's on the same weights and batch (the reference's world is its 8
    virtual devices, each with the same gradient)."""
    ref_hvd.init()
    x, y = (jnp.asarray(a) for a in sharded_data())
    ref_opt = DistributedEagerOptimizer(_optax(kind), sharded=True)
    p = [jnp.asarray(v) for v in sharded_params()]
    s = ref_opt.init(p)
    grad = jax.jit(jax.grad(_loss))
    want = []
    for _ in range(SHARDED_STEPS):
        p, s = ref_opt.update_and_apply(grad(p, x, y), s, p)
        want.append([np.asarray(v) for v in p])
    cls, args = SHARDED_OPTS[kind]
    model = sharded_model("cpu")
    opt = hvd.DistributedOptimizer(
        getattr(torch.optim, cls)(model.parameters(), **args), sharded=True)
    _close(_steps(opt, model, SHARDED_STEPS), want, **REF_TOL)


def test_pack_out_writes_its_prefix_and_leaves_the_tail():
    """K1's out= form on the CPU (its plain version): ``out[:numel]`` is
    the concatenation, the rest of the buffer keeps its values, and a
    buffer too small, of another dtype or not 1-d contiguous is refused."""
    rng = np.random.RandomState(3)
    ts = [torch.from_numpy(rng.randn(*s).astype(np.float32))
          for s in ((3, 5), (7,), (1,), (2, 2, 3))]
    total = sum(t.numel() for t in ts)
    for fn in (K.pack, K.pack_plain):
        out = torch.full((total + 5,), 7.0)
        assert fn(ts, out=out) is out
        assert torch.equal(out[:total], K.pack_plain(ts))
        assert torch.equal(out[total:], torch.full((5,), 7.0))
        for bad in (torch.zeros(total - 1), torch.zeros(total + 1).double(),
                    torch.zeros(2, total)[:, 0], torch.zeros(1, total + 1)):
            with pytest.raises(ValueError, match="out must be"):
                fn(ts, out=bad)
    before = K.launch_counts()["pack_out"]
    K.pack(ts, out=torch.zeros(total))
    assert K.launch_counts()["pack_out"] == before     # CPU: no launch


def test_pack_padded_and_the_bucket_buffers():
    """A ShardBucket's buffers are padded zeros, its shards rank r's
    slices; pack_padded fills [0, total) alone."""
    b = C.ShardBucket((0, 1), (3, 4), torch.float32, torch.device("cpu"),
                      3, 2)
    assert (b.total, b.shard, b.padded) == (7, 3, 9)
    assert b.grad_shard.data_ptr() == b.grads[6:].data_ptr()
    assert b.param_shard.data_ptr() == b.params[6:].data_ptr()
    C.pack_padded([torch.ones(3), torch.full((4,), 2.0)], b.grads, True)
    assert b.grads.tolist() == [1.0] * 3 + [2.0] * 4 + [0.0, 0.0]


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


def test_sharded_validation_errors():
    """The reference's restrictions, with its messages."""
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(ValueError, match="Average|Sum"):
        hvd.DistributedOptimizer(torch.optim.SGD(p, lr=0.1), sharded=True,
                                 op=hvd.Adasum)
    with pytest.raises(ValueError, match="compression"):
        hvd.DistributedOptimizer(torch.optim.SGD(p, lr=0.1), sharded=True,
                                 compression=hvd.Compression.fp16)
    with pytest.raises(ValueError, match="Average|Sum"):
        hvd.distributed(torch.optim.SGD(p, lr=0.1), shard_optimizer=True,
                        op=hvd.Adasum)
    with pytest.raises(ValueError, match="compression"):
        hvd.distributed(torch.optim.SGD(p, lr=0.1), shard_optimizer=True,
                        compression=hvd.Compression.fp16)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        hvd.distributed(torch.optim.SGD(p, lr=0.1), shard_optimizer=True,
                        backward_passes_per_step=2)
    with pytest.raises(ValueError, match="Adasum"):
        hvd.distributed(torch.optim.SGD(p, lr=0.1), op=hvd.Adasum)


def test_distributed_names_its_axis(world1):
    p = [torch.nn.Parameter(torch.zeros(3))]
    p[0].grad = torch.ones(3)
    with pytest.raises(ValueError, match="needs mesh="):
        hvd.distributed(torch.optim.SGD(p, lr=0.1), axis_name="data").step()


def test_sharded_knob_default(world1, monkeypatch):
    """sharded=None defers to HOROVOD_TPU_SHARD_OPTIMIZER (off by
    default), read at the first step; an Adasum optimizer stays
    replicated under it."""
    from horovod_tpu_torch.common.env import Config
    assert Config.from_env().shard_optimizer is False
    monkeypatch.setenv("HOROVOD_TPU_SHARD_OPTIMIZER", "1")
    assert Config.from_env().shard_optimizer is True
    model = sharded_model("cpu")
    monkeypatch.setattr(world1.config, "shard_optimizer", True)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    _steps(opt, model, 1)
    assert opt._zero is not None
    adasum = hvd.DistributedOptimizer(
        torch.optim.SGD(sharded_model("cpu").parameters(), lr=0.1),
        op=hvd.Adasum)
    assert not adasum._is_sharded()
    monkeypatch.setattr(world1.config, "shard_optimizer", False)
    model = sharded_model("cpu")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    _steps(opt, model, 1)
    assert opt._zero is None


def test_sharded_survives_a_threshold_move(world1):
    """The layout is frozen at the first step: a later move of the fusion
    threshold does not re-bucket the live run, which keeps stepping like
    the dense optimizer."""
    model, dense_model = sharded_model("cpu"), sharded_model("cpu")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1), sharded=True)
    dense = hvd.DistributedOptimizer(torch.optim.SGD(
        dense_model.parameters(), lr=0.1))
    got = _steps(opt, model, 1)
    layout = [(b.total, b.shard) for b in opt._zero.buckets]
    assert layout == [(66, 66)]
    world1.config.fusion_threshold_bytes = 64    # would cut 4 buckets
    got += _steps(opt, model, 2)
    assert [(b.total, b.shard) for b in opt._zero.buckets] == layout
    _equal(got, _steps(dense, dense_model, 3))


def test_sharded_lost_layout_raises(world1):
    """A layout recomputed after the cache lost it (at a moved threshold)
    disagrees with the live shards: the step raises instead of running on
    them."""
    model = sharded_model("cpu")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1), sharded=True)
    _steps(opt, model, 1)
    opt._layout_cache.clear()
    world1.config.fusion_threshold_bytes = 64
    with pytest.raises(ValueError, match="layout mismatch"):
        _steps(opt, model, 1)


def test_broadcast_optimizer_state_refuses_a_sharded_state(world1):
    model = sharded_model("cpu")
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters()),
                                   sharded=True)
    with pytest.raises(ValueError, match="rank-local shards"):
        hvd.broadcast_optimizer_state(opt, root_rank=0)
    with pytest.raises(ValueError, match="rank-local shards"):
        hvd.broadcast_optimizer_state(hvd.distributed(
            torch.optim.Adam(model.parameters()), shard_optimizer=True))


def test_sharded_missing_grad_raises_naming_it(world1):
    """A parameter the loss leaves out has no gradient: the sharded step
    raises a ValueError naming it (a zero would move it under momentum or
    weight decay)."""
    model = sharded_model("cpu")
    extra = torch.nn.Parameter(torch.zeros(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        [{"params": list(model.parameters())}, {"params": [extra]}],
        lr=0.1, momentum=0.9), sharded=True)
    with pytest.raises(ValueError, match=r"param_groups\[1\]\['params'\]"
                                         r"\[0\] \(2,\) has no gradient"):
        _steps(opt, model, 1)


def test_sharded_state_dict_is_the_shards_and_params_view_the_buffers(
        world1):
    """The state is the shard optimizer's (over the flat shards), the
    model's parameters are views of the buckets' parameter buffers, and a
    scheduler moving the wrapped optimizer's lr reaches the shards."""
    model, dense_model = sharded_model("cpu"), sharded_model("cpu")
    inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(inner, sharded=True)
    dense_inner = torch.optim.SGD(dense_model.parameters(), lr=0.1,
                                  momentum=0.9)
    dense = hvd.DistributedOptimizer(dense_inner)
    scheds = [torch.optim.lr_scheduler.StepLR(o, 1, gamma=0.5)
              for o in (inner, dense_inner)]
    got, want = [], []
    for _ in range(3):
        got += _steps(opt, model, 1)
        want += _steps(dense, dense_model, 1)
        for s in scheds:
            s.step()
    _equal(got, want)
    (b,) = opt._zero.buckets
    ptr = b.params.data_ptr()
    offsets = [p.data_ptr() - ptr for p in model.parameters()]
    assert offsets == [0, 4 * 35, 4 * 42, 4 * 63]
    state = opt.state_dict()["state"]
    assert [tuple(v["momentum_buffer"].shape) for v in state.values()] \
        == [(66,)]
    # the lr of the last step: the scheduler has moved the wrapped one on
    assert opt._zero.optimizer.param_groups[0]["lr"] == 0.1 * 0.5 ** 2
    assert inner.param_groups[0]["lr"] == 0.1 * 0.5 ** 3


def test_sharded_step_has_join_kind_10_and_no_substitute(world1):
    """Kind 10 is the reference's sharded_step; a joined rank's
    substitute for it raises the reference's text and leaves the engine
    as it was."""
    assert _KIND_CODES["sharded_step"] == 10
    with pytest.raises(hvd.HorovodInternalError) as e:
        world1._dispatch_substitute(10, np.zeros((0, 10), dtype=np.int64))
    assert str(e.value) == SHARDED_JOIN_ERROR
    assert world1._join_substitute is False
    assert world1.shard_layout(10) == (10, 10)


def test_bucket_by_size_feeds_the_layout_per_group():
    """Two param groups never share a bucket, even under a threshold that
    would merge their parameters."""
    model = sharded_model("cpu")
    ps = list(model.parameters())
    opt = torch.optim.SGD([{"params": ps[:2]}, {"params": ps[2:]}], lr=0.1)
    plan, _, _ = _zero1_plan(opt, 4, 1 << 20)
    assert [(g, idxs) for g, idxs, _, _ in plan] == [(0, (0, 1)),
                                                     (1, (2, 3))]
    assert len(bucket_by_size(ps, 1 << 20)) == 1


def test_sharded_cards_rehearsal_on_gloo(tmp_path):
    """The card scenario (``-k "cards and sharded"``) with a tiny bf16 LM
    on 2 gloo ranks: every rank's parameters alike, the sharded run
    bitwise the dense one, both replayed after the warm-up, and the
    shard optimizer's state half the dense one's (plus the step counts)."""
    res = World("sharded_cards", 2, tmp_path).results()
    for kind in ("dense", "sharded"):
        assert res[0][kind]["digest"] == res[1][kind]["digest"]
        assert all(r[kind]["replay"] == (1, 2, 0) for r in res)
    for r in res:
        sh, de = r["sharded"], r["dense"]
        assert sh["bitwise"] and sh["max_diff"] == 0.0
        assert sh["losses"] == de["losses"]
        (total, shard, padded), = sh["buckets"]
        assert (shard, padded) == (-(-total // 2), 2 * -(-total // 2))
        assert abs(sh["state_bytes"] / de["state_bytes"] - 0.5) < 0.01


def test_replayed_step_releases_its_gradients(world1):
    """A replayed step's inputs are released once its program launched:
    after zero_grad() nothing keeps the step's gradients alive through the
    next backward (the armed program's buffers are its own)."""
    import gc
    import weakref
    model = sharded_model("cpu")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1), sharded=True)
    _steps(opt, model, 4)                        # the warm-up, then a replay
    assert world1.replay.replayed_steps == 1
    grads = [weakref.ref(p.grad) for p in model.parameters()]
    opt.zero_grad()
    gc.collect()
    assert all(g() is None for g in grads)
