"""horovod_tpu_torch's sequence-parallel LM against the JAX package.

One gloo world of 4 processes (``sp_lm`` in ``tests/torch_worker.py``) runs
the port's ``make_spmd_loss`` and ``make_train_step`` on (data, seq) meshes
(1, 4) and (2, 2), for ring attention in both layouts and Ulysses, with SGD
0.1 and AdamW 1e-3, two steps each. The reference runs ``make_spmd_loss``
on (d, s, 1) meshes of the conftest's virtual CPU devices, from the same
numpy weights and tokens, while the world runs; its steps are
``make_train_step``'s body (:377-382): ``value_and_grad`` of the SPMD loss,
compiled once per configuration, then the optax update.

Tolerances: the loss to 1e-4 relative (test_transformer_spmd.py:49), the
steps' losses to 1e-3, the parameters after two steps to 1e-4 of each
tensor's largest entry (fp32 on both sides, measured near 1e-6).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh

from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel.ring_attention import zigzag_indices
from horovod_tpu_torch.models.convert import transformer_from_jax
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
from torch_worker import (SP_DIMS, SP_LRS, SP_MESHES, SP_STEPS, SP_VARIANTS,
                          World, sp_params, sp_tokens)

CASES = [(mesh, att, layout) for mesh in SP_MESHES
         for att, layout in SP_VARIANTS]
IDS = [f"d{m[0]}s{m[1]}-{a}-{l}" for m, a, l in CASES]


def _optax(name):
    lr = SP_LRS[name]
    if name == "sgd":
        return optax.sgd(lr)
    return optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def _reference(mesh_shape, attention, layout):
    """The reference's loss and, per optimizer, its step losses and final
    parameters in the port's naming."""
    d, s = mesh_shape
    mesh = Mesh(np.array(jax.devices()[:d * s]).reshape(d, s, 1),
                (JT.DATA_AXIS, JT.SEQ_AXIS, JT.TENSOR_AXIS))
    cfg = JT.TransformerConfig(dtype=jnp.float32, attention=attention,
                               sp_layout=layout, **SP_DIMS)
    x, y = sp_tokens()
    if layout == "zigzag":
        idx = np.asarray(zigzag_indices(x.shape[1], s)[0])
        x, y = x[:, idx], y[:, idx]
    value_and_grad = jax.jit(jax.value_and_grad(JT.make_spmd_loss(mesh, cfg)))
    params0 = jax.tree_util.tree_map(jnp.asarray, sp_params())
    out = {"loss": float(value_and_grad(params0, x, y)[0])}
    port_cfg = TransformerConfig(**SP_DIMS)
    for name in SP_LRS:
        opt = _optax(name)
        update = jax.jit(lambda g, st, p, opt=opt: _apply(opt, g, st, p))
        params, state, losses = params0, opt.init(params0), []
        for _ in range(SP_STEPS):
            loss, grads = value_and_grad(params, x, y)
            grads = jax.tree_util.tree_map(np.asarray, grads)
            params, state = update(grads, state, params)
            losses.append(float(loss))
        out[name] = {"losses": losses, "params": {
            k: v.numpy() for k, v in transformer_from_jax(
                jax.device_get(params), port_cfg).items()}}
    return out


def _apply(opt, grads, state, params):
    updates, state = opt.update(grads, state, params)
    return optax.apply_updates(params, updates), state


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """(the port's per-rank results, {case: the reference's}); the world
    runs while the reference compiles."""
    world = World("sp_lm", 4, tmp_path_factory.mktemp("sp_lm"))
    refs = {case: _reference(*case) for case in CASES}
    return world.results(), refs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sp_loss_matches_reference(sp, case):
    ranks, refs = sp
    want = refs[case]["loss"]
    for res in ranks:       # the global mean, the same on every rank
        assert abs(res[case]["loss"] - want) <= 1e-4 * abs(want), \
            (res[case]["loss"], want)


@pytest.mark.parametrize("opt", list(SP_LRS))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sp_train_steps_match_reference(sp, case, opt):
    ranks, refs = sp
    want = refs[case][opt]
    for res in ranks:
        got = res[case][opt]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
        for name, w in want["params"].items():
            scale = max(np.abs(w).max(), 1e-6)
            err = np.abs(got["params"][name] - w).max()
            assert err <= 1e-4 * scale, (name, err, scale)


def test_sp_ranks_stay_identical(sp):
    ranks, _ = sp
    for case in CASES:
        for opt in SP_LRS:
            for res in ranks[1:]:
                for name, p in ranks[0][case][opt]["params"].items():
                    np.testing.assert_array_equal(
                        res[case][opt]["params"][name], p)


def test_sp_steps_lower_the_loss(sp):
    ranks, _ = sp
    for case in CASES:
        for opt in SP_LRS:
            losses = ranks[0][case][opt]["losses"]
            assert losses[-1] < losses[0], (case, opt, losses)


def test_tensor_parallel_mesh_raises(sp):
    """A tensor axis the heads do not split over (2 heads over tensor 4)
    raises on every rank; tensor parallelism itself is
    tests/test_torch_tensor_parallel.py's."""
    ranks, _ = sp
    for res in ranks:
        assert "n_heads 2 does not split over tensor 4" in \
            res["tensor_error"]


def test_zigzag_with_ulysses_raises():
    cfg = TransformerConfig(dtype=torch.float32, attention="ulysses",
                            sp_layout="zigzag", **SP_DIMS)
    model = Transformer(cfg)
    tokens = torch.zeros(1, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="zigzag.*needs ring attention"):
        model(tokens, seq_group=None, seq_size=2)
    # on a single shard the layout is moot, as in the reference
    assert model(tokens).shape == (1, 8, SP_DIMS["vocab_size"])


def test_sp_config_defaults_to_the_contiguous_layout():
    cfg = TransformerConfig()
    assert cfg.sp_layout == JT.TransformerConfig().sp_layout == "contiguous"
    assert dataclasses.replace(cfg, sp_layout="zigzag").sp_layout == "zigzag"
