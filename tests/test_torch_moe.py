"""horovod_tpu_torch's MoE layer, its MoE-EP train step and the engine's
grouped alltoall against the JAX package (``tests/test_moe.py`` and the
grouped-alltoall cases of ``tests/test_replay.py``).

In this process both packages run at size 1 on the same numpy inputs: the
MoE layer (:35, :61, :77), the MoE-EP step (:120, :139, :166), and the
grouped alltoall's replay (test_replay.py :342, :409). Gloo worlds of 2 and
4 processes (``moe_ep`` in ``tests/torch_worker.py``, join disabled so
that the exchanges arm, as the reference's MoE replay runs) run the layer
over a world of 4 expert shards and the MoE-EP step on 2 and 4 ranks.

The reference's in-process world has one rank, so its MoE-EP step at 2 and
4 ranks is composed from its own size-1 step over the same per-rank token
blocks: each rank's loss and gradients are its block's under the size-1
step (routing and capacity are per source rank, and the exchange only
moves a rank's dispatch buffer to the experts' owners and back), the shared
gradients and the loss are their mean (the step's AVERAGE round), an
expert's gradient is their sum (each owner's experts see every rank's
tokens), and ``optax.sgd`` applies them.

Tolerances: the layer to rtol 2e-5 / atol 2e-6 and the aux loss to 1e-5
(test_moe.py:54-56); the MoE-EP losses to 1e-5 relative and the parameters
after five steps to 1e-5 of each tensor's largest entry (fp32 on both
sides); repeats bitwise.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax

import horovod_tpu as ref_hvd
from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import moe as RM
import horovod_tpu_torch as hvd
import torch
from horovod_tpu_torch.core.state import engine as port_engine
from horovod_tpu_torch.models.convert import (transformer_from_jax,
                                              transformer_shard)
from horovod_tpu_torch.parallel import moe as PM
from torch_worker import (MOE_EP_DIMS, MOE_EP_EXPERTS, MOE_EP_FACTOR,
                          MOE_EP_LR, MOE_EP_STEPS, MOE_LAYER, World,
                          moe_ep_config, moe_ep_params, moe_ep_tokens,
                          moe_ep_trajectory, moe_layer_inputs)

SIZES = (2, 4)


def _ref_cfg():
    return JT.TransformerConfig(dtype=jnp.float32, attention="flash",
                                use_moe=True, n_experts=MOE_EP_EXPERTS,
                                moe_capacity_factor=MOE_EP_FACTOR,
                                **MOE_EP_DIMS)


@functools.partial(jax.jit, static_argnums=4)
def _ref_layer_jit(x, router, w_in, w_out, factor):
    return RM.moe_layer_p(x, RM.MoEParams(router, w_in, w_out), "none", 1,
                          capacity_factor=factor)


def _ref_layer(x, router, w_in, w_out, factor):
    return _ref_layer_jit(*(jnp.asarray(a) for a in (x, router, w_in,
                                                      w_out)), factor)


def _port_layer(x, router, w_in, w_out, factor, grad=False):
    ts = [torch.from_numpy(np.asarray(a)).clone().requires_grad_(grad)
          for a in (x, router, w_in, w_out)]
    y, aux = PM.moe_layer_p(ts[0], PM.MoEParams(*ts[1:]), None, 1,
                            capacity_factor=factor)
    return y, aux, ts


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The ``moe_ep`` worlds of 2 and 4 ranks, started before the
    reference computes; their results."""
    out = tmp_path_factory.mktemp("moe_ep")
    started = {n: World("moe_ep", n, out,
                        env={"HOROVOD_JOIN_DISABLE": "1"})
               for n in SIZES}
    return {n: w.results() for n, w in started.items()}


@pytest.fixture(scope="module")
def ref_engine():
    ref_hvd.init()
    eng = ref_hvd._engine()
    eng.replay.invalidate_all("test isolation")
    return eng


@pytest.fixture
def port_eng(monkeypatch):
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_TPU_STEP_REPLAY",
                "HOROVOD_TPU_WORLD_VERSION"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    eng = port_engine()
    eng.replay.invalidate_all("test isolation")
    yield eng
    # a world left up would hand the next test file's hvd.init() this one
    hvd.shutdown()


# -- the layer (test_moe.py) ------------------------------------------------

def test_moe_layer_matches_reference_single_shard():
    x, router, w_in, w_out = moe_layer_inputs()
    for factor in (MOE_LAYER["factor"], 1.0, 0.5):
        want, aux_want = _ref_layer(x, router, w_in, w_out, factor)
        y, aux, _ = _port_layer(x, router, w_in, w_out, factor)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-5)


def test_moe_layer_over_four_expert_shards(worlds):
    """:35: the layer with its 8 experts over a world of 4 (one
    ``all_to_all_single`` each way) against the reference's single shard
    and its own 4-shard ``shard_map``; the gradients through the exchange
    (x's and the router's are a rank's own, an expert's sums every rank's
    identical loss)."""
    x, router, w_in, w_out = moe_layer_inputs()
    factor = MOE_LAYER["factor"]
    want, aux_want = _ref_layer(x, router, w_in, w_out, factor)
    n = 4
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("expert",))
    el = MOE_LAYER["experts"] // n
    P = jax.sharding.PartitionSpec

    def body(x, router, w_in, w_out):
        return RM.moe_layer_p(x, RM.MoEParams(router, w_in[0], w_out[0]),
                              "expert", n, capacity_factor=factor)

    shard_y, shard_aux = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P("expert"), P("expert")),
        out_specs=(P(), P()), check_vma=False))(
        jnp.asarray(x), jnp.asarray(router),
        jnp.asarray(w_in).reshape(n, el, *w_in.shape[1:]),
        jnp.asarray(w_out).reshape(n, el, *w_out.shape[1:]))

    def loss(x, router, w_in, w_out):
        y, aux = _ref_layer_jit(x, router, w_in, w_out, factor)
        return jnp.sum(y ** 2) + 0.01 * aux

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (x, router, w_in, w_out)))
    for r, res in enumerate(worlds[n]):
        got = res["layer"]
        for ref_y, ref_aux in ((want, aux_want), (shard_y, shard_aux)):
            np.testing.assert_allclose(got["y"], np.asarray(ref_y),
                                       rtol=2e-5, atol=2e-6)
            np.testing.assert_allclose(got["aux"], float(ref_aux),
                                       rtol=1e-5)
        gx, grouter, gw_in, gw_out = (np.asarray(g) for g in grads)
        mine = slice(r * el, (r + 1) * el)
        for g, w in zip(got["grads"], (gx, grouter, n * gw_in[mine],
                                       n * gw_out[mine])):
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max())


def test_gradients_flow_through_dispatch():
    """:61, against the reference's gradients."""
    x, router, w_in, w_out = moe_layer_inputs()
    x = x[:32]

    def loss(x, router, w_in, w_out):
        y, aux = _ref_layer_jit(x, router, w_in, w_out, 8.0)
        return jnp.sum(y ** 2) + 0.01 * aux

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (x, router, w_in, w_out)))
    y, aux, ts = _port_layer(x, router, w_in, w_out, 8.0, grad=True)
    (y.pow(2).sum() + 0.01 * aux).backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
    assert float(ts[1].grad.abs().sum()) > 0   # the router, through the gate


def test_capacity_overflow_drops_tokens():
    """:77: capacity 1 and 16 identical tokens: only the first survives."""
    x, router, w_in, w_out = moe_layer_inputs()
    x = np.tile(x[:1], (16, 1))
    factor = 1.0 / 16 * MOE_LAYER["experts"]
    y, _, _ = _port_layer(x, router, w_in, w_out, factor)
    nz = np.flatnonzero(np.abs(y.detach().numpy()).sum(axis=1) > 1e-9)
    assert len(nz) == 1 and nz[0] == 0, nz
    want, _ = _ref_layer(x, router, w_in, w_out, factor)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-6)


def test_dispatch_keeps_only_the_kept_rows():
    """The dispatch buffer holds each kept token in its expert's slot and
    zeros elsewhere: the reference's scatter-add buffer, bitwise."""
    x, router, _, _ = moe_layer_inputs()
    xt, rt = torch.from_numpy(x), torch.from_numpy(router)
    e = MOE_LAYER["experts"]
    cap = PM.capacity(len(x), 1.0, e)
    expert, slot, keep, _, _, counts = PM.route(xt, rt, e, cap)
    buf = PM.dispatch(xt, expert, slot, keep, e, cap).view(e, cap, -1)
    want = np.zeros((e, cap, x.shape[1]), np.float32)
    np.add.at(want, (expert.numpy(), slot.numpy()),
              x * keep.numpy()[:, None])
    np.testing.assert_array_equal(buf.numpy(), want)
    assert int(counts.sum()) == len(x) and int(keep.sum()) < len(x)


# -- the MoE-EP train step (test_moe.py:97-178) ------------------------------

def _capturing_sgd():
    """(optimizer, grads): an optax transformation that records the
    gradients it is given and updates nothing."""
    grads = []

    def update(g, state, params=None):
        grads.append(g)
        return jax.tree_util.tree_map(jnp.zeros_like, g), state

    return optax.GradientTransformation(lambda p: optax.EmptyState(),
                                        update), grads


def _reference_ep(eng, size: int, steps: int):
    """The reference's MoE-EP trajectory on ``size`` ranks: losses, and
    each rank's parameters after it in the port's naming (module doc)."""
    cfg = _ref_cfg()
    opt, grads = _capturing_sgd()
    step = JT.make_moe_ep_train_step(eng, cfg, opt)
    params = jax.tree_util.tree_map(jnp.asarray, moe_ep_params())
    shared, expert = JT.moe_ep_partition(params, 0, 1, cfg)
    sgd = optax.sgd(MOE_EP_LR)
    state = sgd.init({"shared": shared, "expert": expert})
    losses = []
    for _ in range(steps):
        got = []
        for r in range(size):
            x, y = (jnp.asarray(a, jnp.int32) for a in moe_ep_tokens(r))
            *_, loss = step(shared, expert, (), x, y)
            got.append(float(loss))
        per = grads[-size:]
        g = {"shared": jax.tree_util.tree_map(
                lambda *a: sum(a) / size, *[p["shared"] for p in per]),
             "expert": jax.tree_util.tree_map(
                lambda *a: sum(a), *[p["expert"] for p in per])}
        p = {"shared": shared, "expert": expert}
        updates, state = sgd.update(g, state, p)
        p = optax.apply_updates(p, updates)
        shared, expert = p["shared"], p["expert"]
        losses.append(float(np.mean(np.float32(got))) if size > 1
                      else got[0])
    full = dict(shared, layers=dict(shared["layers"], **expert))
    state = transformer_from_jax(jax.device_get(full), moe_ep_config(torch))
    return losses, [{k: v.numpy() for k, v in transformer_shard(
        state, moe_ep_config(torch), size, r, ep=True).items()}
        for r in range(size)]


def _close(got, want, tol=1e-5):
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-6)
        err = np.abs(got[name] - w).max()
        assert err <= tol * scale, (name, err, scale)


def test_moe_ep_step_matches_reference_at_size_1(ref_engine, port_eng):
    """:120 and :166 at size 1, in this process: the port's trajectory
    against the reference's, bitwise against its own repeat; it learns,
    and the shared and the expert leaves both move."""
    ref_engine.replay.invalidate_all("test isolation")
    want_losses, want_params = _reference_ep(ref_engine, 1, MOE_EP_STEPS)
    got = moe_ep_trajectory(hvd, port_eng, 0, 1, MOE_EP_STEPS)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    _close(got["params"], want_params[0])
    assert got["losses"][-1] < got["losses"][0]
    start = transformer_from_jax(moe_ep_params(), moe_ep_config(torch))
    for name in ("layers.0.w1", "embed"):
        assert not np.array_equal(got["params"][name],
                                  start[name].numpy()), name
    port_eng.replay.invalidate_all("test isolation")
    again = moe_ep_trajectory(hvd, port_eng, 0, 1, MOE_EP_STEPS)
    assert again["losses"] == got["losses"]
    for name, v in got["params"].items():
        np.testing.assert_array_equal(again["params"][name], v)


@pytest.mark.parametrize("size", SIZES)
def test_moe_ep_step_matches_reference(worlds, ref_engine, size):
    """:120 at 2 and 4 ranks: the losses (the world mean) and each rank's
    parameters (the shared ones and its experts) after five SGD steps,
    against the reference's step composed over the same token blocks."""
    ref_engine.replay.invalidate_all("test isolation")
    want_losses, want_params = _reference_ep(ref_engine, size, MOE_EP_STEPS)
    for r, res in enumerate(worlds[size]):
        np.testing.assert_allclose(res["ep"]["losses"], want_losses,
                                   rtol=1e-5)
        _close(res["ep"]["params"], want_params[r])
        assert res["ep"]["losses"][-1] < res["ep"]["losses"][0]
        assert res["ep"]["expert"] == [f"layers.{i}.{w}" for i in range(2)
                                       for w in ("w1", "w2")]


@pytest.mark.parametrize("size", SIZES)
def test_moe_ep_step_is_bitwise_deterministic(worlds, size):
    """:166 at 2 and 4 ranks: a fresh start repeats the losses bitwise, and
    every rank holds the same shared parameters."""
    ranks = worlds[size]
    for res in ranks:
        assert res["ep_again"] == res["ep"]["losses"][:4]
    for res in ranks[1:]:
        for name in ranks[0]["ep"]["shared"]:
            np.testing.assert_array_equal(res["ep"]["params"][name],
                                          ranks[0]["ep"]["params"][name])


@pytest.mark.parametrize("size", SIZES)
def test_moe_ep_steady_state_is_one_dispatch_a_round(worlds, size):
    """test_replay.py:409 at 2 and 4 ranks: once armed, each exchange round
    and the shared-gradient round replay as one dispatch (4·L + 1 a step),
    with no fallback after the warm-up."""
    rounds = 4 * MOE_EP_DIMS["n_layers"] + 1
    for res in worlds[size]:
        marks = res["ep"]["marks"]
        assert marks[-1][:2] == (rounds, rounds), marks
        assert marks[-2][:2] == (rounds, rounds), marks
        assert marks[-1][2] == marks[-3][2], marks


@pytest.mark.parametrize("size", SIZES)
def test_moe_ep_routing_metrics_populate(worlds, size):
    """:139 at 2 and 4 ranks: each rank counts its B·T tokens a layer and
    step by expert, and every layer's skew gauge is at least 1."""
    tokens = 2 * 16 * MOE_EP_DIMS["n_layers"] * MOE_EP_STEPS
    for res in worlds[size]:
        before, after = res["metrics"]

        def rows(snap, name):
            ent = (snap.get("counters", {}).get(name)
                   or snap.get("gauges", {}).get(name) or {})
            return {tuple(sorted(lab.items())): v
                    for lab, v in ent.get("values", [])}

        got = rows(after, "hvd_tpu_moe_expert_tokens_total")
        base = rows(before, "hvd_tpu_moe_expert_tokens_total")
        assert sum(got.values()) - sum(base.values()) == tokens
        skew = rows(after, "hvd_tpu_moe_dispatch_skew")
        assert {dict(k)["layer"] for k in skew} == {"0", "1"}
        assert all(v >= 1.0 for v in skew.values())


def test_moe_ep_routing_metrics_match_reference(ref_engine, port_eng):
    """:139 at size 1: one step's counter series (by expert) and skew
    gauges (by layer) are the reference's."""
    from horovod_tpu.metrics import registry as ref_registry
    from horovod_tpu_torch.metrics import registry as port_registry

    def rows(snap, name):
        ent = (snap.get("counters", {}).get(name)
               or snap.get("gauges", {}).get(name) or {})
        return {tuple(sorted(lab.items())): v
                for lab, v in ent.get("values", [])}

    def delta(a, b, name):
        ra, rb = rows(a, name), rows(b, name)
        return {k: v - ra.get(k, 0.0) for k, v in rb.items()
                if v != ra.get(k, 0.0)}

    ref_engine.replay.invalidate_all("test isolation")
    b0 = ref_registry().snapshot()
    _reference_ep(ref_engine, 1, 1)
    b1 = ref_registry().snapshot()
    p0 = port_registry().snapshot()
    moe_ep_trajectory(hvd, port_eng, 0, 1, 1)
    p1 = port_registry().snapshot()
    name = "hvd_tpu_moe_expert_tokens_total"
    assert delta(p0, p1, name) == delta(b0, b1, name)
    skew = "hvd_tpu_moe_dispatch_skew"
    got, want = rows(p1, skew), rows(b1, skew)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)


# -- the grouped alltoall (test_replay.py:339-447) ---------------------------

def _a2a_step(eng, tensors, tag):
    eng.step_begin()
    hs = eng.grouped_alltoall(list(tensors), name=tag)
    out = [h.synchronize() for h in hs]
    eng.step_end()
    return out


def test_grouped_alltoall_stream_replays(ref_engine, port_eng):
    """:342: capture, arm, replay, with the reference's counters after
    every step; size-1 values exactly the inputs."""
    rng = np.random.RandomState(1)
    a = rng.randn(6, 3).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    trails = []
    for eng, conv in ((ref_engine, jnp.asarray), (port_eng, torch.from_numpy)):
        eng.config.step_replay_warmup = 2
        eng.replay.invalidate_all("test isolation")
        eng.replay.captured_streams = eng.replay.replayed_steps = 0
        eng.replay.fallbacks = 0
        trail = []
        for i in range(4):
            out = _a2a_step(eng, (conv(a), conv(b)), f"a2a.{i}")
            np.testing.assert_array_equal(np.asarray(out[0]), a)
            np.testing.assert_array_equal(np.asarray(out[1]), b)
            r = eng.replay
            trail.append((r.captured_streams, r.replayed_steps, r.fallbacks))
        trails.append(trail)
        eng.config.step_replay_warmup = 3
    assert trails[0] == trails[1] and trails[1][-1] == (1, 2, 0)


def test_replayed_alltoall_step_is_single_dispatch(port_eng):
    a = torch.from_numpy(np.random.RandomState(2).randn(8, 2)
                         .astype(np.float32))
    port_eng.config.step_replay_warmup = 2
    try:
        for i in range(3):
            _a2a_step(port_eng, (a,), f"a2a1.{i}")
        d0 = port_eng.dispatch_count
        out = _a2a_step(port_eng, (a,), "a2a1.9")
        assert port_eng.dispatch_count - d0 == 1
        assert torch.equal(out[0], a)
    finally:
        port_eng.config.step_replay_warmup = 3


def test_moe_ep_steady_state_one_dispatch_per_round(port_eng):
    """:409 at size 1: after two warm-up steps the MoE-EP step's 4·L
    exchange rounds are each one replayed dispatch, with no fallback."""
    import horovod_tpu_torch.models.transformer as tm
    cfg = moe_ep_config(torch)
    model = tm.Transformer(cfg)
    model.load_state_dict(transformer_from_jax(moe_ep_params(), cfg))
    tm.moe_ep_partition(model, 0, 1, cfg)
    step = tm.make_moe_ep_train_step(
        port_eng, cfg, torch.optim.SGD(model.parameters(), lr=0.1))
    x, y = (torch.from_numpy(a) for a in moe_ep_tokens(0))
    for _ in range(2):
        step(model, x, y)
    port_eng.replay.replayed_steps = port_eng.replay.fallbacks = 0
    rounds = 4 * cfg.n_layers
    d0 = port_eng.dispatch_count
    loss = step(model, x, y)
    assert port_eng.replay.replayed_steps == rounds
    assert port_eng.replay.fallbacks == 0
    assert port_eng.dispatch_count - d0 == rounds
    assert np.isfinite(float(loss))


def test_grouped_alltoall_join_substitute_and_debug_check(worlds):
    """Kind 11: rank 1 joins while rank 0 runs a grouped alltoall of two
    tensors in one bucket; rank 0 keeps its own chunk and gets zeros for
    the joined rank's, and join() names rank 0 the last. A shape mismatch
    under HOROVOD_TPU_DEBUG_CONSISTENCY raises the same error on both."""
    ranks = worlds[2]
    res = ranks[0]["join"]
    a = np.arange(1.0, 13.0, dtype=np.float32).reshape(4, 3)
    want_a = np.concatenate([a[:2], np.zeros((2, 3), np.float32)])
    np.testing.assert_array_equal(res["outs"][0], want_a)
    np.testing.assert_array_equal(res["outs"][1],
                                  np.array([1.0, 0.0], np.float32))
    for r in ranks:
        assert r["join"]["last"] == 0
        assert r["join"]["mismatch"] == "TensorShapeMismatchError"


def test_grouped_alltoall_refuses_a_ragged_tensor(port_eng, monkeypatch):
    monkeypatch.setattr(port_eng.backend, "size", lambda: 4)
    with pytest.raises(ValueError, match="divisible by size"):
        port_eng.grouped_alltoall([torch.zeros(6, 2)])


def test_moe_capacity_factor_knob(monkeypatch):
    from horovod_tpu_torch.common import env as port_env
    from horovod_tpu.common import env as ref_env
    monkeypatch.setenv("HOROVOD_TPU_MOE_CAPACITY_FACTOR", "1.5")
    assert port_env.Config.from_env().moe_capacity_factor == \
        ref_env.Config.from_env().moe_capacity_factor == 1.5
    monkeypatch.delenv("HOROVOD_TPU_MOE_CAPACITY_FACTOR")
    assert port_env.Config.from_env().moe_capacity_factor == 0.0


@pytest.mark.parametrize("remat", ["none", "block"])
def test_moe_lm_single_shard_matches_reference(remat):
    """The MoE FFN on a single shard (tensor size 1: every expert local)
    through ``lean_lm_loss``, which adds ``moe_aux_weight`` x the aux loss
    (the reference's :330-333): the loss and every gradient leaf."""
    import dataclasses
    from horovod_tpu_torch.models.transformer import Transformer, lean_lm_loss
    cfg = dataclasses.replace(_ref_cfg(), attention="ring", remat=remat)
    params = jax.tree_util.tree_map(jnp.asarray, moe_ep_params())
    x, y = (jnp.asarray(a, jnp.int32) for a in moe_ep_tokens(0))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JT.lean_lm_loss(p, x, y, cfg)))(params)
    pcfg = dataclasses.replace(moe_ep_config(torch), attention="ring",
                               remat=remat)
    model = Transformer(pcfg)
    model.load_state_dict(transformer_from_jax(moe_ep_params(), pcfg))
    got = lean_lm_loss(model, *(torch.from_numpy(a)
                                for a in moe_ep_tokens(0)))
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-5 * abs(float(loss))
    want = transformer_from_jax(jax.device_get(grads), pcfg)
    _close({n: p.grad.numpy() for n, p in model.named_parameters()},
           {n: v.numpy() for n, v in want.items()}, tol=1e-5)


def test_init_moe_shards_the_experts():
    """``init_moe``: one shard's experts at the reference's scales (router
    N(0, 0.02²), He-normal experts) and the reference's refusal of
    experts that do not divide over the shards."""
    p = PM.init_moe(64, 256, 8, n_expert_shards=4,
                    generator=torch.Generator().manual_seed(3))
    assert tuple(p.router.shape) == (64, 8)
    assert tuple(p.w_in.shape) == (2, 64, 256)
    assert tuple(p.w_out.shape) == (2, 256, 64)
    assert abs(float(p.router.std()) / 0.02 - 1) < 0.1
    assert abs(float(p.w_in.std()) / (2 / 64) ** 0.5 - 1) < 0.05
    assert abs(float(p.w_out.std()) / (2 / 256) ** 0.5 - 1) < 0.05
    with pytest.raises(ValueError, match="must divide over 3"):
        PM.init_moe(64, 256, 8, n_expert_shards=3)
    with pytest.raises(ValueError, match="must divide over 3"):
        RM.init_moe(jax.random.PRNGKey(0), 64, 256, 8, n_expert_shards=3)
