"""horovod_tpu_torch's pipeline parallelism against the JAX package.

One gloo world of 4 processes (``pipeline`` in ``tests/torch_worker.py``,
laid out as two islands of 2) runs the port's schedules, its
``pipeline_apply_p``, the pipelined flagship's train steps, the engine
step and the boundary codec, while the reference computes the same cases
on 4 virtual CPU devices from the same numpy weights and data:

- (a) the schedule algebra (tables, predictors, the resolver and its
  one-time demotions, the p=1 errors) equal to the reference's exactly,
  in process;
- (b) the 8-cell tanh pipeline of ``test_pipeline_schedules.py`` (S=4,
  NC=8, D=16, BM=6, two SGD steps) under 1f1b, interleaved v=2 and zb at
  m = 8, 6 and 2: the port's schedules bitwise each other, their losses
  and final cells within 1e-6 of the reference's ``pipeline_train_step``;
- (c) ``pipeline_apply_p`` on ``test_pipeline.py``'s cases at its
  tolerances (outputs rtol 2e-5 / atol 2e-6, gradients rtol 1e-4 / atol
  1e-5; the lm form's loss rtol 1e-5);
- (d) the flagship at the reference's widths: ``make_pp_train_step`` on
  pipe 4 (remat none and block, zb) and on data 2 x pipe 2 (1f1b, and
  interleaved v=2 through ``pp_layer_order``), the loss within 1e-5
  relative and the parameters after one SGD step within rtol 1e-4 / atol
  1e-5 of the reference's single-device step and (pipe 4) of its
  ``make_pp_train_step``; zb bitwise 1f1b;
- (e) ``make_pp_engine_train_step`` (``DistributedOptimizer(sharded=True,
  op=Sum)``) on data 2 x pipe 2: losses and parameters within 1e-6 of
  ``make_pp_train_step``'s on the same mesh, the steady-state dispatches
  a step equal at m = 4 and 8, replay armed and replaying, the 2-expert
  MoE trajectory bitwise reproducible with its loss falling (the port's
  own invariants: the reference's versions fail on this tree);
- (f) the boundary codec: ``pipeline_boundary_edges`` equal to the
  reference's, a bf16-coded 1F1B run within 1e-3 relative of the
  reference's coded table executor, fewer wire bytes on the coded edges.
"""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import mesh as RM
from horovod_tpu.parallel import pipeline as RP
from horovod_tpu_torch.common import env as penv
from horovod_tpu_torch.models import transformer as PT
from horovod_tpu_torch.models.convert import (transformer_from_jax,
                                              transformer_pp_shard,
                                              transformer_pp_unshard)
from horovod_tpu_torch.parallel import mesh as PM
from horovod_tpu_torch.parallel import pipeline as PL
from torch_worker import (PP_DIMS, PP_ENGINE_STEPS, PP_FLAGSHIP, PP_MB,
                          PP_MICRO, PP_MOE_STEPS, PP_SCHEDULES, PP_STAGES,
                          PP_SUITE_STEPS, World,
                          pp_apply_data, pp_apply_params, pp_cell_data,
                          pp_cell_order, pp_cells, pp_params, pp_tokens)


# -- the reference's computations -------------------------------------------

def _pipe_mesh(n=PP_STAGES):
    return Mesh(np.array(jax.devices()[:n]), ("pipe",))


def _ref_cell_stage(sp, x):
    h, _ = lax.scan(lambda h, lp: (jnp.tanh(h @ lp["w"] + lp["b"]), None),
                    x, sp)
    return h


def _ref_cell_loss(y, tgt):
    return jnp.mean((y - tgt) ** 2)


def _ref_suite(n_micro, codec=None):
    """The reference's two SGD steps of the tanh cells under 1f1b:
    (losses, (w, b) in model order). With ``codec`` the coded 1F1B table
    executor (its pipeline_train_step's 1F1B ignores the codec)."""
    mesh = _pipe_mesh()
    w, b = pp_cells()
    params = jax.device_put({"w": w, "b": b}, NamedSharding(mesh, P("pipe")))

    def body(params, mi, mt):
        if codec is None:
            loss, gs, _, _ = RP.pipeline_train_step(
                _ref_cell_stage, params, mi, mt, _ref_cell_loss, "pipe",
                PP_STAGES, schedule="1f1b")
        else:
            loss, gs, _, _ = RP._pipeline_train_tables(
                _ref_cell_stage, params, mi, mt, _ref_cell_loss, "pipe",
                PP_STAGES, RP.build_schedule_tables("1f1b", PP_STAGES,
                                                    n_micro, 1), 1,
                boundary_codec=codec)
        return loss, gs

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(P("pipe"), P(), P()),
                               out_specs=(P(), P("pipe")), check_vma=False))
    x, t = pp_cell_data(n_micro)
    mi, mt = (RP.split_microbatches(jnp.asarray(a), n_micro) for a in (x, t))
    losses = []
    for _ in range(PP_SUITE_STEPS):
        loss, gs = fn(params, mi, mt)
        losses.append(float(loss))
        params = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, gs)
    return losses, (np.asarray(params["w"]), np.asarray(params["b"]))


def _ref_apply():
    """test_pipeline.py's targets: the sequential tanh stack's outputs and
    gradients, the lm form's loss and gradients, and the reference's
    pipeline_apply_p at m=4."""
    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def seq(params, x):
        for s in range(PP_STAGES):
            x = stage({"w": params["w"][s], "b": params["b"][s]}, x)
        return x

    out = {}
    prm = jax.tree_util.tree_map(jnp.asarray, pp_apply_params("tanh", 0))
    x = jnp.asarray(pp_apply_data("tanh", 1))
    out["tanh"] = np.asarray(seq(prm, x))
    mesh = _pipe_mesh()

    def body(params, micro):
        local = {"w": params["w"][0], "b": params["b"][0]}
        return RP.pipeline_apply_p(stage, local, micro, "pipe", PP_STAGES)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=({"w": P("pipe"), "b": P("pipe")}, P()),
        out_specs=P(), check_vma=False))
    out["tanh_pipe_m4"] = np.asarray(RP.merge_microbatches(fn(
        jax.device_put(prm, NamedSharding(mesh, P("pipe"))),
        RP.split_microbatches(x, 4))))
    prm = jax.tree_util.tree_map(jnp.asarray, pp_apply_params("tanh", 2))
    x = jnp.asarray(pp_apply_data("tanh", 3))
    out["tanh_grads"] = jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: jnp.sum(seq(p, x) ** 2))(prm))
    prm = jax.tree_util.tree_map(jnp.asarray, pp_apply_params("lm", 5))
    tok, tgt = (jnp.asarray(a) for a in pp_apply_data("lm", 6))

    def lm_loss(p):
        h = p["emb"][tok]
        for s in range(PP_STAGES):
            h = h + jnp.tanh(h @ p["w"][s] + p["b"][s])
        logp = jax.nn.log_softmax(h @ p["out"])
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], axis=-1))

    loss, g = jax.value_and_grad(lm_loss)(prm)
    out["lm"] = {"loss": float(loss),
                 **jax.tree_util.tree_map(np.asarray, g)}
    return out


def _ref_cfg(**kw):
    return JT.TransformerConfig(dtype=jnp.float32, attention="flash",
                                **PP_DIMS, **kw)


def _ref_flagship():
    """The reference's single-device SGD(0.1) step and its 4-stage
    make_pp_train_step: (loss, params in the port's naming)."""
    cfg = _ref_cfg()
    port_cfg = PT.TransformerConfig(dtype=torch.float32, attention="flash",
                                    **PP_DIMS)
    params = jax.tree_util.tree_map(jnp.asarray, pp_params())
    x, y = (jnp.asarray(a, jnp.int32) for a in pp_tokens())
    loss, g = jax.value_and_grad(
        lambda p: JT.lean_lm_loss(p, x, y, cfg))(params)
    opt = optax.sgd(0.1)
    up, _ = opt.update(g, opt.init(params), params)

    def port(tree):
        return {k: v.numpy() for k, v in transformer_from_jax(
            jax.device_get(tree), port_cfg).items()}

    out = {"single": (float(loss), port(optax.apply_updates(params, up)))}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:PP_STAGES]),
                             (JT.PIPE_AXIS,))
    sharded = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params,
        JT.pp_param_specs(cfg))
    step = JT.make_pp_train_step(mesh, cfg, optax.sgd(0.1), n_micro=PP_MB)
    p_pp, _, l_pp = step(sharded, optax.sgd(0.1).init(sharded), x, y)
    out["pipe4"] = (float(l_pp), port(p_pp))
    return out


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    """(the port's per-rank results, the reference's); the world runs
    while the reference compiles."""
    world = World("pipeline", 4, tmp_path_factory.mktemp("pipeline"),
                  local_size=2, timeout=240)
    ref = {"suite": {m: _ref_suite(m) for m in PP_MICRO},
           "apply": _ref_apply(), "flagship": _ref_flagship()}
    edges = RM.pipeline_boundary_edges(RM.Topology(size=4, local_size=2),
                                       PP_STAGES)
    ref["edges"] = edges
    ref["coded"] = _ref_suite(8, codec=("bf16", edges))
    return world.results(), ref


def _cells_model_order(ranks, key):
    """The suite's (w, b) in model order from the stages' rows."""
    sched, v, m = key
    order = pp_cell_order(*RP.resolve_pipeline_schedule(sched, PP_STAGES, m,
                                                        v))
    w = np.concatenate([r["suite"][key][1][0] for r in ranks])
    b = np.concatenate([r["suite"][key][1][1] for r in ranks])
    inv = np.argsort(order)
    return w[inv], b[inv]


# -- (a) the schedule algebra, in process ------------------------------------

def _outcome(fn, *args):
    """``fn(*args)``'s value, or its exception's type and text; and the
    warnings it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value = ("ok", fn(*args))
        except (ValueError, RuntimeError) as e:
            value = (type(e).__name__, str(e))
    return value, [str(w.message) for w in caught]


def _tables(mod, *args):
    tb = mod.build_schedule_tables(*args)
    return (tb.ticks, tb.n_chunks, tb.split_bw, tb.act_depth, tb.ct_depth,
            tb.a_depth, tb.c_depth,
            {k: v.tolist() for k, v in sorted(tb.rows.items())})


@pytest.mark.parametrize("schedule", list(RP.PIPELINE_SCHEDULES) +
                         ["wavefront"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_schedule_algebra_matches_reference(schedule, p):
    """Over m in {1, 2, 4, 6, 8} and v in {1, 2}: the resolver (with its
    one-time warnings, the caches emptied on both sides), the tables and
    depths of the resolved schedule, the bubble fractions and the
    predictors, errors included (the p=1 zb stall), equal the
    reference's."""
    assert PL.PIPELINE_SCHEDULES == RP.PIPELINE_SCHEDULES
    for mod in (PL, RP):
        mod._DEMOTE_WARNED.clear()
        mod._TABLE_CACHE.clear()
    for m in (1, 2, 4, 6, 8):
        for v in (1, 2):
            res = [_outcome(mod.resolve_pipeline_schedule, schedule, p, m, v)
                   for mod in (PL, RP)]
            assert res[0] == res[1], (schedule, p, m, v, res)
            (kind, resolved), _ = res[0]
            if kind != "ok":
                continue
            sched, vv = resolved
            for fn in ("build_schedule_tables", "predict_schedule_time",
                       "predict_schedule_bubble"):
                got = [_outcome(_tables if fn == "build_schedule_tables"
                                else getattr(mod, fn),
                                *((mod,) if fn == "build_schedule_tables"
                                  else ()), sched, p, m, vv)
                       for mod in (PL, RP)]
                assert got[0] == got[1], (fn, sched, p, m, vv)
            for s2 in ("1f1b", "interleaved", "zb"):
                got = [_outcome(mod.pipeline_bubble_fraction, p, m, s2, v)
                       for mod in (PL, RP)]
                assert got[0] == got[1], (s2, p, m, v)
            assert PL.pipeline_chunk_placement(sched, vv) == \
                RP.pipeline_chunk_placement(sched, vv)
            assert PL.auto_microbatches(p, m * 4) == \
                RP.auto_microbatches(p, m * 4)


def test_single_stage_raises_as_the_reference():
    """At p=1 zb's generator stalls and 1F1B refuses one stage, with the
    reference's errors; interleaved v=2 runs 9 ticks at m=4."""
    x = torch.zeros(4, 2, 3)
    with pytest.raises(RuntimeError, match=r"stalled \(zb, p=1, m=4, v=1\)"):
        PL.pipeline_train_step(lambda sp, h: h, {}, x, x,
                               lambda y, t: y.sum(), None, 1, schedule="zb")
    with pytest.raises(ValueError, match="needs n_stages >= 2"):
        PL.pipeline_train_step(lambda sp, h: h, {}, x, x,
                               lambda y, t: y.sum(), None, 1,
                               schedule="1f1b")
    assert PL.build_schedule_tables("interleaved", 1, 4, 2).ticks == \
        RP.build_schedule_tables("interleaved", 1, 4, 2).ticks == 9


def test_1f1b_table_is_the_hand_mapping():
    """pipeline_train_1f1b's table (the generated 1f1b one) fires F(m) on
    stage s at tick m + s (none on the last stage: its forward folds into
    B) and B(m) at m + 2(p-1) - s, the reference's hand scan; its input
    stash is at most 2p - 1 deep."""
    for p in (2, 3, 4):
        for m in (1, 2, 5, 8):
            tb = PL.build_schedule_tables("1f1b", p, m, 1)
            assert tb.ticks == m + 2 * (p - 1)
            assert tb.act_depth <= 2 * p - 1
            for t in range(tb.ticks):
                for s in range(p):
                    f = 0 <= t - s < m and s != p - 1
                    b = 0 <= t - 2 * (p - 1) + s < m
                    assert bool(tb.rows["f_active"][t, s]) == f
                    assert bool(tb.rows["b_active"][t, s]) == b
                    if f:
                        assert tb.rows["f_m"][t, s] == t - s
                    if b:
                        assert tb.rows["b_m"][t, s] == t - 2 * (p - 1) + s


# -- (b) the schedule suite ---------------------------------------------------

@pytest.mark.parametrize("m", PP_MICRO)
@pytest.mark.parametrize("sched,v", PP_SCHEDULES)
def test_schedule_suite_matches_reference(pp, sched, v, m):
    ranks, ref = pp
    key = (sched, v, m)
    want_l, (want_w, want_b) = ref["suite"][m]
    for r in ranks:
        np.testing.assert_allclose(r["suite"][key][0], want_l, rtol=1e-6,
                                   atol=1e-6)
    w, b = _cells_model_order(ranks, key)
    np.testing.assert_allclose(w, want_w, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b, want_b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", PP_MICRO)
def test_schedules_are_bitwise_1f1b(pp, m):
    """interleaved v=2 and zb give 1F1B's losses and cells bit for bit,
    at a divisible m, a ragged one and m < stages (demoted)."""
    ranks, _ = pp
    base = _cells_model_order(ranks, ("1f1b", 1, m))
    for sched, v in PP_SCHEDULES[1:]:
        assert ranks[0]["suite"][sched, v, m][0] == \
            ranks[0]["suite"]["1f1b", 1, m][0]
        got = _cells_model_order(ranks, (sched, v, m))
        for a, b in zip(got, base):
            np.testing.assert_array_equal(a, b)


# -- (c) pipeline_apply_p -------------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 8])
def test_apply_matches_sequential(pp, m):
    ranks, ref = pp
    for r in ranks:
        np.testing.assert_allclose(r["apply"][f"tanh_m{m}"],
                                   ref["apply"]["tanh"], rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(ranks[0]["apply"]["tanh_m4"],
                               ref["apply"]["tanh_pipe_m4"], rtol=2e-5,
                               atol=2e-6)


def test_apply_gradients_match_sequential(pp):
    ranks, ref = pp
    for k in ("w", "b"):
        got = np.stack([r["apply"]["tanh_grads"][k] for r in ranks])
        np.testing.assert_allclose(got, ref["apply"]["tanh_grads"][k],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("remat", [0, 1])
def test_apply_lm_form_matches_reference(pp, remat):
    """embed (stage 0) -> blocks -> head (last stage): the loss and every
    gradient, with and without remat; the replicated embedding's and
    head's gradients the same on every rank."""
    ranks, ref = pp
    want = ref["apply"]["lm"]
    for r in ranks:
        got = r["apply"][f"lm_remat{remat}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in ("emb", "out"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
    for k in ("w", "b"):
        got = np.stack([r["apply"][f"lm_remat{remat}"][k] for r in ranks])
        np.testing.assert_allclose(got, want[k], rtol=1e-4, atol=1e-5)


# -- (d) the pipelined flagship ----------------------------------------------

def _port_cfg():
    return PT.TransformerConfig(dtype=torch.float32, attention="flash",
                                **PP_DIMS)


def _flagship_state(ranks, name):
    """The full state in model order from the stages of data replica 0."""
    stages = sorted((r["flagship"][name]["index"].get("pipe", 0), r)
                    for r in ranks
                    if r["flagship"][name]["index"].get("data", 0) == 0)
    states = [{k: torch.from_numpy(v) for k, v in
               r["flagship"][name]["state"].items()} for _, r in stages]
    order = stages[0][1]["flagship"][name]["order"]
    return {k: v.numpy() for k, v in transformer_pp_unshard(
        states, _port_cfg(), order).items()}


def _params_close(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", [c[0] for c in PP_FLAGSHIP])
def test_flagship_matches_single_device(pp, name):
    ranks, ref = pp
    loss, params = ref["flagship"]["single"]
    for r in ranks:
        np.testing.assert_allclose(r["flagship"][name]["loss"], loss,
                                   rtol=1e-5)
    _params_close(_flagship_state(ranks, name), params)


def test_flagship_matches_reference_pipeline(pp):
    ranks, ref = pp
    loss, params = ref["flagship"]["pipe4"]
    np.testing.assert_allclose(ranks[0]["flagship"]["pipe4"]["loss"], loss,
                               rtol=1e-5)
    _params_close(_flagship_state(ranks, "pipe4"), params)


@pytest.mark.parametrize("other,base", [("pipe4_zb", "pipe4"),
                                        ("dp2pp2_interleaved", "dp2pp2")])
def test_flagship_schedules_bitwise(pp, other, base):
    """zb and interleaved v=2 (round-robin layers) give 1F1B's loss and
    updated parameters bit for bit (test_flagship_zb_matches_1f1b)."""
    ranks, _ = pp
    assert ranks[0]["flagship"][other]["loss"] == \
        ranks[0]["flagship"][base]["loss"]
    got, want = _flagship_state(ranks, other), _flagship_state(ranks, base)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_interleaved_flagship_holds_permuted_rows(pp):
    """Under interleaved v=2 on pipe 2 stage s holds layers s and s+2."""
    ranks, _ = pp
    for r in ranks:
        case = r["flagship"]["dp2pp2_interleaved"]
        assert list(case["order"]) == [0, 2, 1, 3]
        assert sorted({k.split(".")[1] for k in case["state"]
                       if k.startswith("layers.")}) == ["0", "1"]


# -- (e) the engine step ------------------------------------------------------

def test_engine_step_matches_pp_train_step(pp):
    """DistributedOptimizer(sharded=True, op=Sum) over the world: the
    replicas' mean loss and the whole model equal make_pp_train_step's
    data-averaged loss and stages to 1e-6."""
    ranks, _ = pp
    for step in range(PP_ENGINE_STEPS):
        eng = np.mean([r["engine_losses"][step] for r in ranks])
        np.testing.assert_allclose(eng, ranks[0]["pp_losses"][step],
                                   rtol=1e-6)
    cfg = _port_cfg()
    # data replica 0's stages (ranks 0 and 1 of data x pipe (2, 2))
    pp_state = transformer_pp_unshard(
        [{k: torch.from_numpy(v) for k, v in ranks[i]["pp_state"].items()}
         for i in (0, 1)], cfg)
    for r in ranks:
        for k, v in pp_state.items():
            np.testing.assert_allclose(r["engine_state"][k], v.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_engine_dispatches_do_not_grow_with_microbatches(pp):
    ranks, _ = pp
    for r in ranks:
        assert r["dispatches_m4"] == r["dispatches_m8"] == 1, r
        for m in (4, 8):
            assert r[f"captured_m{m}"] >= 1 and r[f"replayed_m{m}"] >= 1
            assert np.isfinite(r[f"loss_m{m}"])


def test_engine_moe_trajectory_reproducible(pp):
    ranks, _ = pp
    for r in ranks:
        first, second = r["moe_trajectories"]
        assert first == second
        assert len(first) == PP_MOE_STEPS
        assert all(np.isfinite(first)) and first[-1] < first[0], first


# -- (f) the boundary codec and the mesh -------------------------------------

@pytest.mark.parametrize("size,local", [(4, 1), (4, 2), (4, 4), (8, 2),
                                        (8, 4), (16, 4)])
def test_boundary_edges_match_reference(size, local):
    for n in (1, 2, 4):
        for stage_size in (None, 1, 2):
            assert PM.pipeline_boundary_edges(
                PM.Topology(size=size, local_size=local), n, stage_size) == \
                RM.pipeline_boundary_edges(
                    RM.Topology(size=size, local_size=local), n, stage_size)


def test_coded_run_matches_reference(pp):
    """bf16 on the hops that cross islands (the world's topology: two
    islands of 2): the losses within 1e-3 of the reference's coded table
    executor; the coded edges' bytes below the raw ones'."""
    ranks, ref = pp
    assert ranks[0]["edges"] == ref["edges"] == (False, True, False, True)
    for r in ranks:
        np.testing.assert_allclose(r["coded_run"][0], ref["coded"][0],
                                   rtol=1e-3)
        assert r["coded_run"][0] != r["raw_run"][0]
    raw = sum(r["raw_bytes"]["raw"] for r in ranks)
    coded = {k: sum(r["coded_bytes"][k] for r in ranks)
             for k in ("raw", "coded")}
    assert sum(r["raw_bytes"]["coded"] for r in ranks) == 0
    # half the boundaries are coded, each hop at 2 bytes an element
    assert coded["coded"] > 0 and coded["coded"] < coded["raw"]
    assert coded["raw"] + 2 * coded["coded"] == raw


def test_pipe_neighbours(pp):
    ranks, _ = pp
    for rank, r in enumerate(ranks):
        # data x pipe (2, 2): rank = 2 * data + pipe
        d, s = divmod(rank, 2)
        assert r["stage"] == s
        other = 2 * d + (1 - s)
        assert tuple(r["neighbours"]) == (other, other)


# -- the surface ----------------------------------------------------------------

def test_parallel_exports_the_references_names():
    import horovod_tpu.parallel as RPar
    import horovod_tpu_torch.parallel as PPar
    assert set(RPar.__all__) <= set(PPar.__all__)
    for name in ("PIPE_AXIS", "pp_param_specs", "pp_layer_order",
                 "pp_permute_layers", "make_pp_train_step",
                 "make_pp_engine_train_step"):
        assert hasattr(PT, name), name


def test_config_reads_the_pipeline_knobs(monkeypatch):
    for name in ("HOROVOD_TPU_PIPELINE_SCHEDULE",
                 "HOROVOD_TPU_PIPELINE_VIRTUAL_STAGES",
                 "HOROVOD_TPU_PIPELINE_MICROBATCHES",
                 "HOROVOD_TPU_PIPELINE_BOUNDARY_CODEC"):
        assert getattr(penv, name) == name
        monkeypatch.delenv(name, raising=False)
    cfg = penv.Config.from_env()
    assert (cfg.pipeline_schedule, cfg.pipeline_virtual_stages,
            cfg.pipeline_microbatches, cfg.pipeline_boundary_codec) == \
        ("1f1b", 1, 0, "none")
    monkeypatch.setenv("HOROVOD_TPU_PIPELINE_SCHEDULE", "ZB")
    monkeypatch.setenv("HOROVOD_TPU_PIPELINE_VIRTUAL_STAGES", "2")
    monkeypatch.setenv("HOROVOD_TPU_PIPELINE_MICROBATCHES", "8")
    monkeypatch.setenv("HOROVOD_TPU_PIPELINE_BOUNDARY_CODEC", "int8")
    cfg = penv.Config.from_env()
    assert (cfg.pipeline_schedule, cfg.pipeline_virtual_stages,
            cfg.pipeline_microbatches, cfg.pipeline_boundary_codec) == \
        ("zb", 2, 8, "int8")
    monkeypatch.setenv("HOROVOD_TPU_PIPELINE_SCHEDULE", "wavefront")
    assert penv.Config.from_env().pipeline_schedule == "1f1b"
    assert penv.PIPELINE_SCHEDULE_MODES == PL.PIPELINE_SCHEDULES


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_pp_param_specs_match_reference(moe):
    ref = JT.pp_param_specs(_ref_cfg(use_moe=moe, n_experts=2))
    port = PT.pp_param_specs(PT.TransformerConfig(
        use_moe=moe, n_experts=2, **PP_DIMS))
    assert set(ref["layers"]) == set(port["layers"])
    for k, spec in ref["layers"].items():
        assert spec == P("pipe") and port["layers"][k] == PT.PIPE_AXIS
    assert ref["embed"] == P() and port["embed"] is None
    assert ref["ln_f"] == P() and port["ln_f"] is None


@pytest.mark.parametrize("p,v,sched", [(2, 2, "interleaved"), (4, 2, "zb"),
                                       (2, 2, "1f1b"), (4, 1, "zb"),
                                       (1, 4, "interleaved")])
def test_layer_order_and_stage_shards(p, v, sched):
    """pp_layer_order equals the reference's; the stages' shards of a
    full state hold the reference's P("pipe") blocks of stack[order], and
    unshard back to the full state bit for bit; pp_permute_layers and
    pp_shard_layers leave a model holding the same rows."""
    n = 8
    order = PT.pp_layer_order(n, p, v, sched)
    np.testing.assert_array_equal(order, JT.pp_layer_order(n, p, v, sched))
    cfg = PT.TransformerConfig(dtype=torch.float32, **dict(PP_DIMS,
                                                           n_layers=n))
    tree = pp_params(dict(PP_DIMS, n_layers=n))
    full = transformer_from_jax(tree, cfg)
    rows = n // p
    shards = [transformer_pp_shard(full, cfg, p, s, order) for s in range(p)]
    permuted = JT.pp_permute_layers(tree, order)
    for s, sh in enumerate(shards):
        for i in range(rows):
            np.testing.assert_array_equal(
                sh[f"layers.{i}.wq"].numpy(),
                permuted["layers"]["wq"][s * rows + i])
    back = transformer_pp_unshard(shards, cfg, order)
    for k, t in full.items():
        assert torch.equal(back[k], t), k

    class _Mesh:
        shape = {"pipe": p}

        def __init__(self, s):
            self.s = s

        def size(self, axis):
            return self.shape.get(axis, 1)

        def rank_in(self, axis):
            return self.s

    for s in range(p):
        model = PT.Transformer(cfg)
        model.load_state_dict(full)
        PT.pp_shard_layers(PT.pp_permute_layers(model, order), _Mesh(s))
        got = {k: v for k, v in model.state_dict().items()}
        assert set(got) == set(shards[s])
        for k, t in shards[s].items():
            assert torch.equal(got[k], t), k
    if p > 1:
        with pytest.raises(ValueError, match="already a stage"):
            PT.pp_shard_layers(model, _Mesh(0))


def test_pp_steps_refuse_what_the_reference_refuses():
    class _Mesh:
        shape = {"pipe": 1}

        def size(self, axis):
            return 1

        def group(self, axis):
            return None

        def rank_in(self, axis):
            return 0

    cfg = PT.TransformerConfig(dtype=torch.float32, use_moe=True,
                               n_experts=2, **PP_DIMS)
    with pytest.raises(NotImplementedError, match="dense FFN only"):
        PT.make_pp_train_step(_Mesh(), cfg, None, 4, schedule="interleaved",
                              n_virtual=2)
    cfg = PT.TransformerConfig(dtype=torch.float32, remat="attention",
                               **PP_DIMS)
    with pytest.raises(NotImplementedError, match="remat"):
        PT.make_pp_train_step(_Mesh(), cfg, None, 4, schedule="interleaved",
                              n_virtual=2)
    cfg = PT.TransformerConfig(dtype=torch.float32, **PP_DIMS)
    with pytest.raises(ValueError, match="must divide"):
        PT.make_pp_train_step(_Mesh(), cfg, None, 4, schedule="interleaved",
                              n_virtual=3)


def test_split_merge_roundtrip():
    x = torch.arange(24.0).reshape(12, 2)
    assert torch.equal(PL.merge_microbatches(PL.split_microbatches(x, 3)), x)
    with pytest.raises(ValueError, match="divisible"):
        PL.split_microbatches(x, 5)
