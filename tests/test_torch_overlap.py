"""horovod_tpu_torch's bucket-pipelined overlap, the single-launch grouped
allreduce and the ZeRO-1 all-gather prefetch leg (core/engine.py,
core/replay.py), against the JAX package's (``tests/test_overlap.py``).

At size 1 the cases of ``tests/test_overlap.py`` run on the port's engine
in this process (the two ``apply_xla_lhs`` cases stay out: their knob has
no meaning on CUDA, ``common/knobs.py`` NOT_OWED). Size-1 collectives
return their inputs, so every assertion checks the plumbing: mode
resolution, the split step's launches and held legs, the staged replay,
the counters, the world-version invalidation, and trajectories across
"off", "interleave" and "staged", which must be bitwise equal (the modes
move launches, never arithmetic). The JAX package's sharded optimizer
under "staged" with the prefetch on runs the same seeded numpy parameters
and gradients for 6 steps of SGD with momentum 0.9; the port's parameters
agree within 1e-6 of the largest entry (fp32; optax and torch order the
momentum update's products alike, but may round the last step apart).

At np=2 (``torch_worker.py``'s ``overlap`` scenario, join off so "staged"
is not demoted): a grouped Sum with ``single_launch`` on, off and flipped
mid-run, uncompressed and int8, bitwise alike in every output and in the
error-feedback residuals (the lineage runs on across the flip); ZeRO-1
under "staged" with the prefetch bitwise the "off" trajectory across a
world-version bump that drops the held leg. The ``overlap_cards`` scenario
(the card's is ``tests/test_torch_cuda.py -k "cards and overlap"``) is
rehearsed on gloo at 2 and 4 ranks with a tiny LM.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as ref_hvd
from horovod_tpu.common.reduce_ops import ReduceOp as RefOp
from horovod_tpu.optimizer import DistributedEagerOptimizer
import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch import metrics as hvd_metrics
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.reduce_ops import ReduceOp
from horovod_tpu_torch.core.state import engine as port_engine
from torch_worker import (OVERLAP_BUMP, OVERLAP_CARD_RUNS, OVERLAP_SIZES,
                          OVERLAP_STEPS, OVERLAP_ZERO1_STEPS, run_world)

PARITY_TOL = 1e-6


def _ctr(name):
    return hvd_metrics.counter_total(hvd_metrics.snapshot(), name)


def _stages(kind):
    series = hvd_metrics.snapshot()["counters"].get(
        "hvd_tpu_overlap_stage_launches_total", {"values": []})
    return sum(v for labels, v in series["values"]
               if labels.get("kind") == kind)


@pytest.fixture()
def engine(monkeypatch):
    """The port's size-1 engine, replay on with a warm-up of 2."""
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_PALLAS_PACK",
                "HOROVOD_TPU_STEP_REPLAY", "HOROVOD_TPU_WORLD_VERSION",
                "HOROVOD_TPU_OVERLAP_PIPELINE", "HOROVOD_TPU_ZERO1_PREFETCH",
                "HOROVOD_TPU_SINGLE_LAUNCH"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    eng = port_engine()
    eng.config.step_replay_warmup = 2
    eng.config.step_replay = True
    eng.replay.invalidate_all("test isolation")
    try:
        yield eng
    finally:
        eng.replay.invalidate_all("test isolation")
        hvd.shutdown()
        os.environ.pop("HOROVOD_TPU_WORLD_VERSION", None)


def _params():
    return (torch.nn.Parameter(torch.ones(4, 4)),
            torch.nn.Parameter(torch.zeros(4)))


def _step(opt, w, b, x):
    opt.zero_grad()
    ((x @ w + b) ** 2).sum().backward()
    opt.step()


def _sharded_run(eng, mode, steps=6, lr=0.1, prefetch=True):
    """``steps`` ZeRO-1 steps of SGD with momentum under ``mode`` from a
    fixed start; the final parameters."""
    eng.config.overlap_pipeline = mode
    eng.config.zero1_prefetch = prefetch
    eng.replay.invalidate_all(f"mode -> {mode}")
    w, b = _params()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([w, b], lr=lr, momentum=0.9), sharded=True)
    x = torch.ones(2, 4)
    for _ in range(steps):
        _step(opt, w, b, x)
    return [w.detach().clone(), b.detach().clone()]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the reference's cases at size 1 (tests/test_overlap.py:77-336)
# ---------------------------------------------------------------------------


def test_overlap_mode_resolution(engine, monkeypatch):
    """Explicit modes pass through; on the CPU "auto" is interleave at
    size 1 and respects the stage-bytes threshold; a join-live world with
    peers demotes staged to interleave on every path."""
    cfg = engine.config
    cfg.overlap_pipeline = "off"
    assert engine._overlap_mode(1 << 30, 8, True) == "off"
    cfg.overlap_pipeline = "staged"
    assert engine._overlap_mode(0, 1) == "staged"
    cfg.overlap_pipeline = "interleave"
    assert engine._overlap_mode(1 << 30, 8) == "interleave"
    cfg.overlap_pipeline = "auto"
    assert engine._overlap_mode(1 << 30, 8, True) == "interleave"
    monkeypatch.setattr(engine.backend, "size", lambda: 2)
    cfg.join_enabled = True
    cfg.overlap_pipeline = "staged"
    assert engine._overlap_mode(1 << 30, 8, True) == "interleave"
    cfg.overlap_pipeline = "auto"
    assert engine._overlap_mode(1 << 30, 8, True) == "interleave"
    cfg.join_enabled = False
    assert engine._overlap_mode(1 << 30, 8, True) == "staged"
    # below the stage bytes, or one bucket of a dense step: interleave
    assert engine._overlap_mode(cfg.overlap_stage_bytes - 1, 8) == \
        "interleave"
    assert engine._overlap_mode(1 << 30, 1) == "interleave"
    cfg.overlap_pipeline = "staged"
    assert engine._overlap_mode(0, 1) == "staged"


def test_overlap_auto_is_off_on_a_cuda_device(engine, monkeypatch):
    """On a CUDA device "auto" is off wherever the reference's rule would
    stage or interleave (one stream: nothing to overlap); the explicit
    modes pass through, and the join demotion still applies."""
    cfg = engine.config
    # undone before the fixture's shutdown, which must see the CPU world
    with monkeypatch.context() as m:
        m.setattr(engine.backend, "device", torch.device("cuda", 0))
        cfg.join_enabled = False
        for size in (1, 2):
            m.setattr(engine.backend, "size", lambda s=size: s)
            cfg.overlap_pipeline = "auto"
            for args in ((1 << 30, 8, True), (1 << 30, 8), (0, 1)):
                assert engine._overlap_mode(*args) == "off"
            for mode in ("interleave", "staged"):
                cfg.overlap_pipeline = mode
                assert engine._overlap_mode(1 << 30, 8, True) == mode
        cfg.join_enabled = True
        assert engine._overlap_mode(1 << 30, 8, True) == "interleave"


def test_overlap_mode_matches_the_reference(engine, monkeypatch):
    """On the CPU the port's resolution is the reference's over a grid of
    knobs, bytes, buckets, arms, world sizes and join switches."""
    ref_hvd.init()
    ref = ref_hvd._engine()
    saved = (ref.config.overlap_pipeline, ref.config.join_enabled,
             ref.config.overlap_stage_bytes)
    try:
        for size in (1, 2):
            monkeypatch.setattr(engine.backend, "size", lambda s=size: s)
            monkeypatch.setattr(ref.backend, "size", lambda s=size: s)
            for base in ("off", "interleave", "staged", "auto"):
                for join in (True, False):
                    for eng in (engine, ref):
                        eng.config.overlap_pipeline = base
                        eng.config.join_enabled = join
                        eng.config.overlap_stage_bytes = 1000
                    for nbytes in (0, 999, 1000, 1 << 20):
                        for buckets in (1, 3):
                            for sharded in (False, True):
                                assert engine._overlap_mode(
                                    nbytes, buckets, sharded) == \
                                    ref._overlap_mode(nbytes, buckets,
                                                      sharded)
    finally:
        (ref.config.overlap_pipeline, ref.config.join_enabled,
         ref.config.overlap_stage_bytes) = saved


def test_grouped_allreduce_pipelined_parity(engine):
    """off and interleave, the single-launch form and the per-bucket one,
    bitwise alike and bitwise the JAX package's (size 1: the inputs)."""
    rng = np.random.RandomState(0)
    arrays = [rng.randn(5, 3).astype(np.float32),
              rng.randn(17).astype(np.float32),
              rng.randn(2, 2).astype(np.float32)]
    ref_hvd.init()
    ref_out = [np.asarray(h.synchronize()) for h in
               ref_hvd._engine().grouped_allreduce(
                   [jnp.asarray(a) for a in arrays], name="par.ref",
                   op=RefOp.SUM)]
    engine.config.fusion_threshold_bytes = 48   # several buckets
    outs = {}
    for mode in ("off", "interleave"):
        for single in (True, False):
            engine.config.overlap_pipeline = mode
            engine.config.single_launch = single
            hs = engine.grouped_allreduce(
                [torch.from_numpy(a) for a in arrays],
                name=f"par.{mode}.{single}", op=ReduceOp.SUM)
            outs[(mode, single)] = [h.synchronize().numpy() for h in hs]
    for got in outs.values():
        for a, b in zip(got, ref_out):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("op", ["SUM", "AVERAGE"])
def test_single_launch_mixed_dtypes_and_scales(engine, op):
    """One pack of a group of several dtypes (a byte buffer, each bucket on
    a 16-byte boundary), prescaled once: bitwise the per-bucket form."""
    rng = np.random.RandomState(3)
    ts = [torch.from_numpy(rng.randn(3).astype(np.float16)),
          torch.from_numpy(rng.randn(5).astype(np.float32)),
          torch.from_numpy(rng.randn(7).astype(np.float64)),
          torch.from_numpy(rng.randn(2, 3).astype(np.float32))]
    outs = []
    for single in (True, False):
        engine.config.single_launch = single
        hs = engine.grouped_allreduce(ts, name=f"mix.{single}",
                                      op=ReduceOp[op], prescale_factor=0.5,
                                      postscale_factor=3.0)
        outs.append([h.synchronize() for h in hs])
    for a, b, t in zip(*outs, ts):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a, b)
        assert torch.equal(a, t * 0.5 * 3.0)


def test_sharded_prefetch_trajectory_bitwise_equal(engine):
    """The split step (update, then the prefetch leg) is bitwise the
    unsplit one; the leg rides the staged schedule only: under "auto" at
    size 1 the mode is interleave and no leg is launched or held."""
    p_off = _sharded_run(engine, "off", prefetch=False)
    legs0 = _ctr("hvd_tpu_overlap_prefetch_total")
    _equal(p_off, _sharded_run(engine, "auto"))
    assert _ctr("hvd_tpu_overlap_prefetch_total") == legs0
    assert not engine._zero1_prefetch
    _equal(p_off, _sharded_run(engine, "staged"))
    assert _ctr("hvd_tpu_overlap_prefetch_total") > legs0
    _equal(p_off, _sharded_run(engine, "interleave"))


def test_staged_replay_sharded_two_launch_steady_state(engine):
    """Under "staged" a replayed sharded step is two dispatches (zupd and
    the held zag leg); each steady step holds one row, retired without an
    invalidation; the trajectory is bitwise the serial one."""
    p_off = _sharded_run(engine, "off", prefetch=False)
    legs0 = _ctr("hvd_tpu_overlap_prefetch_total")
    zupd0, zag0 = _stages("replay_zupd"), _stages("replay_zag")
    engine.config.overlap_pipeline = "staged"
    engine.config.zero1_prefetch = True
    engine.replay.invalidate_all("staged test")
    start = engine.replay.replayed_steps
    w, b = _params()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([w, b], lr=0.1, momentum=0.9), sharded=True)
    x = torch.ones(2, 4)
    for _ in range(4):       # the warm-up (2), then replayed steps
        _step(opt, w, b, x)
    replayed0 = engine.replay.replayed_steps
    d0 = engine.dispatch_count
    _step(opt, w, b, x)
    assert engine.replay.replayed_steps == replayed0 + 1
    assert engine.dispatch_count - d0 == 2
    inval0 = _ctr("hvd_tpu_overlap_prefetch_invalidations_total")
    for _ in range(2):
        _step(opt, w, b, x)
    assert _ctr("hvd_tpu_overlap_prefetch_total") - legs0 >= 3
    assert len(engine._zero1_prefetch) == 1
    assert _ctr("hvd_tpu_overlap_prefetch_invalidations_total") == inval0
    replayed = engine.replay.replayed_steps - start
    assert _stages("replay_zupd") - zupd0 == replayed
    assert _stages("replay_zag") - zag0 == replayed
    _equal(p_off, _sharded_run(engine, "staged"))


def test_staged_replay_honors_prefetch_disabled(engine):
    """HOROVOD_TPU_ZERO1_PREFETCH=0 under "staged": the replayed sharded
    step stays one launch (one seg stage), no leg is launched or held."""
    p_off = _sharded_run(engine, "off", prefetch=False)
    legs0 = _ctr("hvd_tpu_overlap_prefetch_total")
    seg0 = _stages("replay_seg")
    engine.config.overlap_pipeline = "staged"
    engine.config.zero1_prefetch = False
    engine.replay.invalidate_all("staged no-prefetch test")
    w, b = _params()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([w, b], lr=0.1, momentum=0.9), sharded=True)
    x = torch.ones(2, 4)
    for _ in range(4):
        _step(opt, w, b, x)
    replayed0 = engine.replay.replayed_steps
    d0 = engine.dispatch_count
    _step(opt, w, b, x)
    assert engine.replay.replayed_steps == replayed0 + 1
    assert engine.dispatch_count - d0 == 1
    assert _ctr("hvd_tpu_overlap_prefetch_total") == legs0
    assert not engine._zero1_prefetch
    assert _stages("replay_seg") > seg0
    _step(opt, w, b, x)
    _equal(p_off, _sharded_run(engine, "staged", prefetch=False))


def test_prefetch_invalidates_on_world_version_bump(engine):
    """A held leg does not survive a world-version bump, and the bump
    invalidates, never poisons: the trajectory stays the serial one."""
    p_ref = _sharded_run(engine, "off", steps=8, prefetch=False)
    engine.config.overlap_pipeline = "staged"
    engine.config.zero1_prefetch = True
    engine.replay.invalidate_all("bump test")
    w, b = _params()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([w, b], lr=0.1, momentum=0.9), sharded=True)
    x = torch.ones(2, 4)
    for _ in range(4):
        _step(opt, w, b, x)
    assert engine._zero1_prefetch, "no leg held before the bump"
    inval0 = _ctr("hvd_tpu_overlap_prefetch_invalidations_total")
    os.environ["HOROVOD_TPU_WORLD_VERSION"] = str(engine.world_version + 3)
    for _ in range(4):
        _step(opt, w, b, x)
    assert _ctr("hvd_tpu_overlap_prefetch_invalidations_total") > inval0
    _equal(p_ref, [w.detach(), b.detach()])


def test_prefetch_gc_outside_step_markers(engine):
    """A bump seen by an eager sharded step outside the step markers
    drops the stale leg there (the reference's _prefetch_gc)."""
    engine.config.overlap_pipeline = "staged"
    engine.config.step_replay = False
    w, b = _params()
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w, b], lr=0.1),
                                   sharded=True)
    x = torch.ones(2, 4)
    _step(opt, w, b, x)
    assert len(engine._zero1_prefetch) == 1
    inval0 = _ctr("hvd_tpu_overlap_prefetch_invalidations_total")
    engine.world_version += 1
    engine._prefetch_gc()
    assert not engine._zero1_prefetch
    assert _ctr("hvd_tpu_overlap_prefetch_invalidations_total") == \
        inval0 + 1
    events = []
    engine.on_replay = lambda event, detail: events.append(event)
    _step(opt, w, b, x)
    engine.join()        # size 1: drops the held leg with the streams
    assert "prefetch-invalidate" in events
    assert not engine._zero1_prefetch


def test_invalidated_sharded_program_is_freed(engine):
    """After invalidate_all nothing holds a staged sharded program: on the
    card its CUDA graph holds NCCL work, and a graph alive at shutdown
    hung the process group's teardown on 2 cards. The last step's replay
    handles stay behind until the next step, so a bound result must not
    hold the program."""
    import gc
    import weakref
    engine.config.overlap_pipeline = "staged"
    engine.replay.invalidate_all("freed test")
    w, b = _params()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([w, b], lr=0.1, momentum=0.9), sharded=True)
    x = torch.ones(2, 4)
    for _ in range(4):
        _step(opt, w, b, x)
    assert engine.replay.replayed_steps >= 1
    program = weakref.ref(next(e["armed"].program
                               for e in engine.replay._seen.values()))
    assert program().zag
    engine.replay.invalidate_all("freed test")
    gc.collect()
    assert program() is None


@pytest.mark.chaos
def test_overlap_prefetch_failpoint_raises_cleanly(engine):
    """overlap.prefetch armed with raise(): HorovodInternalError reaches
    the caller, and the next step succeeds (nothing is poisoned)."""
    engine.config.overlap_pipeline = "staged"
    engine.config.zero1_prefetch = True
    engine.replay.invalidate_all("failpoint test")
    w, b = _params()
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w, b], lr=0.1),
                                   sharded=True)
    x = torch.ones(2, 4)
    faults.arm("overlap.prefetch=1*raise(HorovodInternalError)")
    try:
        with pytest.raises(HorovodInternalError):
            _step(opt, w, b, x)
    finally:
        faults.disarm()
    _step(opt, w, b, x)
    assert bool(torch.isfinite(w).all())


@pytest.mark.perf
def test_perf_smoke_pipelined_step_one_iteration(engine):
    """The interleaved and staged replay programs build, launch and give
    the serial path's values (one replayed iteration each)."""
    rng = np.random.RandomState(7)
    arrays = [rng.randn(8, 2).astype(np.float32) for _ in range(6)]
    engine.config.fusion_threshold_bytes = 48   # several buckets
    for mode in ("interleave", "staged"):
        engine.config.overlap_pipeline = mode
        engine.replay.invalidate_all("perf smoke")
        replayed0 = engine.replay.replayed_steps
        steps0 = _ctr("hvd_tpu_overlap_steps_total")
        for i in range(3):   # 2 warm-up + 1 replayed iteration
            engine.step_begin()
            hs = engine.grouped_allreduce(
                [torch.from_numpy(a) for a in arrays], name=f"perf.{i}",
                op=ReduceOp.SUM)
            out = [h.synchronize().numpy() for h in hs]
            engine.step_end()
        assert engine.replay.replayed_steps == replayed0 + 1
        for a, b in zip(out, arrays):
            assert np.array_equal(a, b)
        # two single-launch warm-up steps count interleave, the replayed
        # one its own mode
        assert _ctr("hvd_tpu_overlap_steps_total") - steps0 == 3


def test_staged_replay_is_one_dispatch_a_bucket(engine):
    """A staged replayed grouped step is one stage (and one dispatch) a
    bucket, each counted as replay_seg; interleave stays one dispatch."""
    from horovod_tpu_torch.core.engine import bucket_by_size
    tensors = [torch.full((8, 2), float(i)) for i in range(6)]
    engine.config.fusion_threshold_bytes = 48
    n_buckets = len(bucket_by_size(tensors, 48))
    assert n_buckets > 1
    for mode, want in (("off", 1), ("interleave", 1),
                       ("staged", n_buckets)):
        engine.config.overlap_pipeline = mode
        engine.replay.invalidate_all(mode)
        seg0 = _stages("replay_seg")
        for i in range(3):
            d0 = engine.dispatch_count
            engine.step_begin()
            hs = engine.grouped_allreduce(tensors, name=f"st.{i}",
                                          op=ReduceOp.SUM)
            [h.synchronize() for h in hs]
            engine.step_end()
        assert engine.dispatch_count - d0 == want, mode
        assert _stages("replay_seg") - seg0 == (want if mode == "staged"
                                                else 0)


def test_mode_move_rearms_the_stream(engine):
    """The mode and zero1_prefetch are part of the armed key: moving either
    rebuilds the program before its next launch."""
    tensors = [torch.ones(8, 2), torch.ones(5)]
    engine.config.fusion_threshold_bytes = 48
    engine.config.overlap_pipeline = "off"

    def step(i):
        engine.step_begin()
        hs = engine.grouped_allreduce(tensors, name=f"rm.{i}",
                                      op=ReduceOp.SUM)
        [h.synchronize() for h in hs]
        engine.step_end()

    for i in range(3):
        step(i)
    armed = [e["armed"] for e in engine.replay._seen.values()][0]
    assert armed.mode == "off"
    engine.config.overlap_pipeline = "staged"
    step(3)
    armed = [e["armed"] for e in engine.replay._seen.values()][0]
    assert armed.mode == "staged" and len(armed.program.stages) == 2
    engine.config.zero1_prefetch = False
    step(4)
    assert [e["armed"] for e in engine.replay._seen.values()][0].prefetch \
        is False
    assert engine.replay.fallbacks == 0


# ---------------------------------------------------------------------------
# the JAX package's sharded optimizer under staged with the prefetch on
# ---------------------------------------------------------------------------


def test_staged_prefetch_matches_the_jax_package(engine):
    rng = np.random.RandomState(11)
    p0 = {"w": rng.randn(6, 5).astype(np.float32),
          "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(6)]
    ref_hvd.init()
    ref = ref_hvd._engine()
    saved = (ref.config.overlap_pipeline, ref.config.zero1_prefetch,
             ref.config.step_replay_warmup, ref.config.step_replay)
    try:
        ref.config.overlap_pipeline = "staged"
        ref.config.zero1_prefetch = True
        ref.config.step_replay_warmup = 2
        ref.config.step_replay = True
        ref.replay.invalidate_all("parity")
        ropt = DistributedEagerOptimizer(optax.sgd(0.1, momentum=0.9),
                                         sharded=True)
        rp = {k: jnp.asarray(v) for k, v in p0.items()}
        rs = ropt.init(rp)
        for g in grads:
            rp, rs = ropt.update_and_apply(
                {k: jnp.asarray(v) for k, v in g.items()}, rs, rp)
        jax.block_until_ready(rp["w"])
        ref_legs = len(ref._zero1_prefetch)
    finally:
        ref.replay.invalidate_all("parity done")
        (ref.config.overlap_pipeline, ref.config.zero1_prefetch,
         ref.config.step_replay_warmup, ref.config.step_replay) = saved
    engine.config.overlap_pipeline = "staged"
    engine.config.zero1_prefetch = True
    legs0 = _ctr("hvd_tpu_overlap_prefetch_total")
    w = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
    b = torch.nn.Parameter(torch.from_numpy(p0["b"].copy()))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([w, b], lr=0.1, momentum=0.9), sharded=True)
    for g in grads:
        w.grad = torch.from_numpy(g["w"].copy())
        b.grad = torch.from_numpy(g["b"].copy())
        opt.step()
    assert engine.replay.replayed_steps >= 1
    assert _ctr("hvd_tpu_overlap_prefetch_total") - legs0 == len(grads)
    assert len(engine._zero1_prefetch) == ref_legs == 1
    for got, want in ((w, rp["w"]), (b, rp["b"])):
        want = np.asarray(want)
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= PARITY_TOL * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# np=2 (torch_worker's overlap scenario)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def overlap_world(tmp_path_factory):
    return run_world("overlap", 2, tmp_path_factory.mktemp("overlap"),
                     env={"HOROVOD_JOIN_DISABLE": "1"})


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("run", ["on", "flip"])
def test_single_launch_is_bitwise_the_per_bucket_form(overlap_world, codec,
                                                      run):
    """Every step's outputs and the last residuals of single_launch on (or
    flipped off after OVERLAP_FLIP steps) equal those of the per-bucket
    form, bitwise: the residual keys are the same in both forms, so the
    int8 lineage runs on across the flip."""
    for res in overlap_world:
        got, want = res[(codec, run)], res[(codec, "off")]
        assert len(got["steps"]) == OVERLAP_STEPS
        for a, b in zip(got["steps"], want["steps"]):
            assert len(a) == len(OVERLAP_SIZES)
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
        assert sorted(got["residuals"]) == sorted(want["residuals"])
        assert len(got["residuals"]) == (0 if codec == "none" else 4)
        for k, v in got["residuals"].items():
            assert np.array_equal(v, want["residuals"][k])
            if codec == "int8":
                assert np.abs(v).max() > 0


def test_single_launch_sums_the_ranks(overlap_world):
    from torch_worker import overlap_input
    for res in overlap_world:
        for step, outs in enumerate(res[("none", "on")]["steps"]):
            for i, got in enumerate(outs):
                want = overlap_input(0, step, i) + overlap_input(1, step, i)
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_staged_zero1_bitwise_off_across_a_bump(overlap_world):
    """ZeRO-1 under "staged" with the prefetch leg: every step's
    parameters bitwise the "off" run's on every rank; the legs were
    launched (one a step) and held, the bump dropped the held one, and
    both runs armed and replayed (before and after the bump)."""
    for res in overlap_world:
        off, staged = res[("zero1", "off")], res[("zero1", "staged")]
        assert len(staged["params"]) == OVERLAP_ZERO1_STEPS
        for a, b in zip(staged["params"], off["params"]):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
        assert staged["legs"] == OVERLAP_ZERO1_STEPS
        assert staged["held_before_bump"] == 1
        assert staged["invalidations"] >= 1
        assert staged["held_after"] == 1
        assert off["legs"] == 0 and off["held_before_bump"] == 0
        assert staged["replay"] == off["replay"]
        assert staged["replay"][1] >= 2 and staged["replay"][2] == 0
    for a, b in zip(overlap_world[0][("zero1", "staged")]["params"],
                    overlap_world[1][("zero1", "staged")]["params"]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert OVERLAP_BUMP < OVERLAP_ZERO1_STEPS


@pytest.mark.parametrize("n", [2, 4])
def test_overlap_cards_rehearsal(tmp_path, n):
    """The card scenario on gloo with a tiny LM: every run of
    OVERLAP_CARD_RUNS bitwise the first on every rank, each replayed twice
    after the warm-up with no fallback."""
    res = run_world("overlap_cards", n, tmp_path,
                    env={"HOROVOD_JOIN_DISABLE": "1"})
    runs = [r for r, *_ in OVERLAP_CARD_RUNS]
    assert len({r[k]["digest"] for r in res for k in runs}) == 1
    for r in res:
        for k in runs:
            assert r[k]["replay"] == (1, 2, 0), (k, r[k]["replay"])
            assert r[k]["losses"] == r[runs[0]]["losses"]
        stages, steps, legs = r["sharded_staged"]["counters"]
        assert legs == 5 and stages == 3 * 2 + 2 * 2
        for k in ("dense_staged", "dense_single_staged"):
            assert r[k]["counters"][0] == 2 * r[k]["buckets"]
            assert r[k]["dispatches"] == 5 * r[k]["buckets"]
