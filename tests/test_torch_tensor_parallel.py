"""horovod_tpu_torch's tensor parallelism against the JAX package.

One gloo world of 4 processes (``tp_lm`` in ``tests/torch_worker.py``, laid
out as two nodes of 2) runs the port's ``shard_params``, ``make_spmd_loss``
and ``make_train_step`` on (data, seq, tensor) meshes (2, 1, 2), (1, 2, 2)
and (1, 1, 4): the dense LM (its heads and F over the tensor axis) with SGD
0.1 and AdamW 1e-3, the MoE FFN (its experts over the tensor axis) with
AdamW, the pad-row case (3 x 6 tokens over tensor 4) and a
``multislice_mesh`` step. The reference runs ``make_spmd_loss`` on the same
mesh shapes of the conftest's virtual CPU devices, from the same numpy
weights and tokens, while the world runs (``test_transformer_spmd.py``'s
:35, :137, :173 and :229); its steps are ``make_train_step``'s body
(:377-382).

The port's results are each rank's slices; ``transformer_unshard``
reassembles them along the tensor axis before the comparison.

Tolerances: the loss to 1e-4 relative (test_transformer_spmd.py:49), the
MoE loss also to 5e-4 of the single-device loss (:137, :173), every
gradient leaf and the parameters after two steps to 1e-4 of each tensor's
largest entry, the steps' losses to 1e-3 (fp32 on both sides).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel.mesh import multislice_mesh as ref_multislice
from horovod_tpu_torch.models import transformer as PT
from horovod_tpu_torch.models.convert import (transformer_from_jax,
                                              transformer_shard,
                                              transformer_to_jax,
                                              transformer_unshard)
from torch_worker import (SP_DIMS, SP_LRS, SP_STEPS, TP_EXPERTS, TP_MESHES,
                          TP_MOE_FACTOR, TP_MULTISLICE, TP_PAD_FACTOR, World,
                          sp_tokens, tp_pad_tokens, tp_params)

AXES = (JT.DATA_AXIS, JT.SEQ_AXIS, JT.TENSOR_AXIS)


def _ref_cfg(moe, factor=TP_MOE_FACTOR):
    return JT.TransformerConfig(dtype=jnp.float32, use_moe=moe,
                                n_experts=TP_EXPERTS,
                                moe_capacity_factor=factor, **SP_DIMS)


def _port_cfg(moe, factor=TP_MOE_FACTOR):
    return PT.TransformerConfig(dtype=torch.float32, use_moe=moe,
                                n_experts=TP_EXPERTS,
                                moe_capacity_factor=factor, **SP_DIMS)


def _optax(name):
    lr = SP_LRS[name]
    if name == "sgd":
        return optax.sgd(lr)
    return optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def _port_state(tree, cfg):
    return {k: v.numpy() for k, v in transformer_from_jax(
        jax.device_get(tree), cfg).items()}


def _reference(mesh, moe, factor, tokens, opts):
    """The reference's loss, gradients and, per optimizer, its step losses
    and parameters (in the port's naming, full tensors), and its
    single-device loss (the MoE's target in :137 and :173)."""
    cfg = _ref_cfg(moe, factor)
    port_cfg = _port_cfg(moe, factor)
    params = jax.tree_util.tree_map(jnp.asarray, tp_params(moe))
    sharded = JT.shard_params(params, mesh, cfg)
    tok = NamedSharding(mesh, P(JT.DATA_AXIS, JT.SEQ_AXIS))
    x, y = (jax.device_put(jnp.asarray(a, jnp.int32), tok) for a in tokens)
    value_and_grad = jax.jit(jax.value_and_grad(JT.make_spmd_loss(mesh,
                                                                  cfg)))
    loss, grads = value_and_grad(sharded, x, y)
    out = {"loss": float(loss), "single": _single(moe, factor, tokens),
           "grads": _port_state(grads, port_cfg)}
    for name in opts:
        # the update on the gathered (unsharded) trees: elementwise, so the
        # placement does not change it, and it compiles once per optimizer
        # and tree instead of once per mesh
        opt, update = _UPDATES[name, moe]
        p, losses = params, []
        state = opt.init(p)
        for _ in range(SP_STEPS):
            loss, g = value_and_grad(JT.shard_params(p, mesh, cfg), x, y)
            p, state = update(jax.device_get(g), state, p)
            losses.append(float(loss))
        out[name] = {"losses": losses, "params": _port_state(p, port_cfg)}
    return out


class _Updates(dict):
    def __missing__(self, key):
        opt = _optax(key[0])
        self[key] = (opt, jax.jit(functools.partial(_apply, opt)))
        return self[key]


_UPDATES = _Updates()
_SINGLE = {}


def _single(moe, factor, tokens):
    """The reference's single-device loss (one per model and batch)."""
    key = (moe, factor, tokens[0].shape)
    if key not in _SINGLE:
        cfg = _ref_cfg(moe, factor)

        def loss(params, x, y):
            total, count, aux = JT._local_loss(params, x, y, cfg)
            return total / count + (cfg.moe_aux_weight * aux if moe else 0)

        _SINGLE[key] = float(jax.jit(loss)(
            jax.tree_util.tree_map(jnp.asarray, tp_params(moe)),
            *(jnp.asarray(a) for a in tokens)))
    return _SINGLE[key]


def _apply(opt, grads, state, params):
    updates, state = opt.update(grads, state, params)
    return optax.apply_updates(params, updates), state


def _mesh(shape):
    d, s, t = shape
    return Mesh(np.array(jax.devices()[:d * s * t]).reshape(d, s, t), AXES)


CASES = ([("dense", m) for m in TP_MESHES]
         + [("moe", m) for m in TP_MESHES])
IDS = [f"{k}-d{m[0]}s{m[1]}t{m[2]}" for k, m in CASES]
OPTS = {"dense": tuple(SP_LRS), "moe": ("adamw",)}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """(the port's per-rank results, {case: the reference's}); the world
    runs while the reference compiles."""
    world = World("tp_lm", 4, tmp_path_factory.mktemp("tp_lm"),
                  local_size=2)
    tokens = sp_tokens()
    refs = {(kind, shape): _reference(_mesh(shape), kind == "moe",
                                      TP_MOE_FACTOR, tokens, OPTS[kind])
            for kind, shape in CASES}
    refs["pad"] = _reference(_mesh((1, 1, 4)), True, TP_PAD_FACTOR,
                             tp_pad_tokens(), ())
    ms = ref_multislice(TP_MULTISLICE[0], TP_MULTISLICE[1],
                        devices=jax.devices()[:4])
    refs["multislice"] = _reference(ms, False, TP_MOE_FACTOR, tokens,
                                    ("sgd",))
    return world.results(), refs


def _tensor_size(key):
    if key in ("pad",):
        return 4
    if key == "multislice":
        return TP_MULTISLICE[1]["tensor"]
    return key[1][2]


def _full(ranks, key, moe, getter):
    """The full tensors from the ranks' slices: rank r's tensor index is
    r % t (tensor is the innermost axis), and the ranks that share one
    hold the same slice."""
    t = _tensor_size(key)
    cfg = _port_cfg(moe)
    states = [{k: torch.from_numpy(v) for k, v in getter(ranks[i]).items()}
              for i in range(t)]
    for r, res in enumerate(ranks):
        for k, v in getter(res).items():
            np.testing.assert_array_equal(v, states[r % t][k].numpy(),
                                          err_msg=f"rank {r} {k}")
    return {k: v.numpy() for k, v in transformer_unshard(states, cfg).items()}


def _close(got, want, tol=1e-4):
    assert set(got) == set(want), (set(got) ^ set(want))
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-6)
        err = np.abs(got[name] - w).max()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tp_loss_matches_reference(tp, case):
    ranks, refs = tp
    want = refs[case]["loss"]
    for res in ranks:
        assert abs(res[case]["loss"] - want) <= 1e-4 * abs(want), \
            (res[case]["loss"], want)
    if case[0] == "moe":     # the reference's own bound (:137)
        np.testing.assert_allclose(ranks[0][case]["loss"],
                                   refs[case]["single"], rtol=5e-4)
    else:
        np.testing.assert_allclose(ranks[0][case]["loss"],
                                   refs[case]["single"], rtol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tp_gradients_match_reference(tp, case):
    ranks, refs = tp
    got = _full(ranks, case, case[0] == "moe", lambda r: r[case]["grads"])
    _close(got, refs[case]["grads"])


@pytest.mark.parametrize("case,opt", [(c, o) for c in CASES
                                      for o in OPTS[c[0]]],
                         ids=[f"{i}-{o}" for c, i in zip(CASES, IDS)
                              for o in OPTS[c[0]]])
def test_tp_train_steps_match_reference(tp, case, opt):
    ranks, refs = tp
    want = refs[case][opt]
    for res in ranks:
        np.testing.assert_allclose(res[case][opt]["losses"], want["losses"],
                                   rtol=1e-3)
    got = _full(ranks, case, case[0] == "moe",
                lambda r: r[case][opt]["params"])
    _close(got, want["params"])


def test_tp_steps_lower_the_loss(tp):
    ranks, _ = tp
    for case in CASES:
        for opt in OPTS[case[0]]:
            losses = ranks[0][case][opt]["losses"]
            assert losses[-1] < losses[0], (case, opt, losses)


def test_moe_pad_rows_do_not_skew_results(tp):
    """:173: 18 tokens a shard over tensor 4 (a pad of 2): the loss matches
    the reference's SPMD loss and the single-device one, and so do the
    gradients."""
    ranks, refs = tp
    want = refs["pad"]
    for res in ranks:
        assert abs(res["pad"]["loss"] - want["loss"]) <= \
            1e-4 * abs(want["loss"])
    np.testing.assert_allclose(ranks[0]["pad"]["loss"], want["single"],
                               rtol=5e-4)
    _close(_full(ranks, "pad", True, lambda r: r["pad"]["grads"]),
           want["grads"])


def test_multislice_mesh_step_matches_reference(tp):
    """:229 on 4 ranks as two islands of 2: data across the islands, seq x
    tensor inside one; two SGD steps as the reference's on its
    ``multislice_mesh``."""
    ranks, refs = tp
    names, shape, _ = ranks[0]["multislice_axes"]
    assert names == ("data", "seq", "tensor")
    assert shape == {"data": 2, "seq": 1, "tensor": 2}
    # the tensor axis's lines are neighbouring ranks: one island
    assert [r["multislice_axes"][2]["data"] for r in ranks] == [0, 0, 1, 1]
    want = refs["multislice"]
    assert np.isfinite(ranks[0]["multislice"]["loss"])
    np.testing.assert_allclose(ranks[0]["multislice"]["sgd"]["losses"],
                               want["sgd"]["losses"], rtol=1e-3)
    _close(_full(ranks, "multislice", False,
                 lambda r: r["multislice"]["sgd"]["params"]),
           want["sgd"]["params"])


def test_mesh_helpers_in_the_world(tp):
    ranks, _ = tp
    for r, res in enumerate(ranks):
        assert res["world_mesh"] == {"world": 4}
        names, shape, index = res["hierarchical"]
        assert names == ("cross", "local")
        assert shape == {"cross": 2, "local": 2}
        assert index == {"cross": r // 2, "local": r % 2}
        assert res["pp_dp_sp"] == {"pipe": 2, "data": 2, "seq": 1}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_param_specs_match_reference(moe):
    """Each leaf's tensor-sharded dim: the reference's ``PartitionSpec``
    (on its stacked leaves) less the layer dim."""
    ref = JT.param_specs(_ref_cfg(moe))
    port = PT.param_specs(_port_cfg(moe))

    def dim(spec, stacked):
        spec = tuple(spec)
        if JT.TENSOR_AXIS not in spec:
            return None
        return spec.index(JT.TENSOR_AXIS) - (1 if stacked else 0)

    assert set(ref["layers"]) == set(port["layers"])
    for name, spec in ref["layers"].items():
        assert port["layers"][name] == dim(spec, True), name
    for name in ("embed", "ln_f"):
        assert port[name] == dim(ref[name], False), name


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_placement_converts_both_ways(moe):
    """A full reference tree -> the port's state -> each rank's
    tensor-parallel (and MoE-EP) slices -> the full state -> the
    reference's tree again, bitwise; each slice is the one the reference's
    ``shard_params`` puts on that tensor index."""
    cfg = _port_cfg(moe)
    params = tp_params(moe)
    full = transformer_from_jax(params, cfg)
    for t in (2, 4):
        shards = [transformer_shard(full, cfg, t, r) for r in range(t)]
        back = transformer_unshard(shards, cfg)
        for k, v in full.items():
            assert torch.equal(back[k], v), k
        mesh = _mesh((1, 1, t))
        placed = JT.shard_params(jax.tree_util.tree_map(jnp.asarray, params),
                                 mesh, _ref_cfg(moe))
        for leaf, spec in JT.param_specs(_ref_cfg(moe))["layers"].items():
            arr = placed["layers"][leaf]
            for shard in arr.addressable_shards:
                r = list(mesh.devices.reshape(-1)).index(shard.device)
                want = np.asarray(shard.data)
                for i in range(cfg.n_layers):
                    np.testing.assert_array_equal(
                        shards[r][f"layers.{i}.{leaf}"].numpy(), want[i])
    if moe:
        ep = [transformer_shard(full, cfg, 2, r, ep=True) for r in range(2)]
        assert ep[0]["layers.0.wq"].shape == full["layers.0.wq"].shape
        assert ep[1]["layers.0.w1"].shape[0] == TP_EXPERTS // 2
        back = transformer_unshard(ep, cfg, ep=True)
        for k, v in full.items():
            assert torch.equal(back[k], v), k
    tree = transformer_to_jax(full, cfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree,
                           jax.tree_util.tree_map(np.asarray, params))


def test_shard_params_refuses_a_second_slice():
    cfg = _port_cfg(False)
    model = PT.Transformer(cfg)

    class _Mesh:
        axis_names = ("tensor",)

        def size(self, axis):
            return 2 if axis == "tensor" else 1

        index = {"tensor": 1}

    PT.shard_params(model, _Mesh(), cfg)
    assert tuple(model.layers[0].wq.shape) == (32, 2, 8)
    assert tuple(model.layers[0].w1.shape) == (32, 32)
    assert tuple(model.layers[0].w2.shape) == (32, 32)
    with pytest.raises(ValueError, match="already sharded"):
        PT.shard_params(model, _Mesh(), cfg)
