"""horovod_tpu_torch's step-capture replay (core/replay.py) on gloo/CPU,
against the JAX package's (``tests/test_replay.py``'s cases that apply).

At size 1 both packages' engines run each case in this process on the same
numpy inputs: the values every step returns and the sequence of
``(captured_streams, replayed_steps, fallbacks)`` after every step must be
equal, the values bitwise (size-1 collectives return their inputs, scaled
by exact powers of two). On CPU tensors the armed program is the recorded
plan issued eagerly; the card's CUDA graph is held to the eager path in
``tests/test_torch_cuda.py -k replay``.

At np=2 (``torch_worker.py``'s ``optimizer`` and ``replay`` scenarios):
DistributedOptimizer's trajectory with replay on is bitwise the trajectory
with it off; a per-leaf allreduce stream arms and replays with exact sums
(small-integer-valued fp32 sums of two ranks are exact); a rank that joins
after the warm-up completes while its peer replays against its zero
substitutes (the one advertisement a step, with its overflow rows).
"""

import numpy as np
import pytest
import jax.numpy as jnp

import horovod_tpu as ref_hvd
from horovod_tpu.common.reduce_ops import ReduceOp as RefOp
import horovod_tpu_torch as hvd
import torch
from horovod_tpu_torch.common.reduce_ops import ReduceOp
from horovod_tpu_torch.core.engine import bucket_by_size
from horovod_tpu_torch.core.state import engine as port_engine
from torch_worker import (JOIN_TENSORS, OPT_STEPS, REPLAY_EXTRA,
                          REPLAY_STEPS, replay_leaf, run_world)

WARMUP = 2


class _Side:
    """One package's size-1 engine behind a common surface: tensors in from
    numpy, results out to numpy, the replay counters."""

    def __init__(self, eng, tensor, op):
        self.eng = eng
        self.tensor = tensor
        self.op = op
        self.trail = []       # the counters after each step

    def counters(self):
        r = self.eng.replay
        return (r.captured_streams, r.replayed_steps, r.fallbacks)

    def step_end(self):
        self.eng.step_end()
        self.trail.append(self.counters())


def _reset(eng):
    eng.replay.invalidate_all("test isolation")
    eng.replay.replayed_steps = 0
    eng.replay.captured_streams = 0
    eng.replay.fallbacks = 0


@pytest.fixture
def sides(monkeypatch):
    """Both packages' size-1 engines, replay on with a warm-up of 2."""
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_PALLAS_PACK",
                "HOROVOD_TPU_STEP_REPLAY", "HOROVOD_TPU_WORLD_VERSION"):
        monkeypatch.delenv(var, raising=False)
    ref_hvd.init()
    hvd.init(device="cpu")
    ref_eng = ref_hvd._engine()
    saved = (ref_eng.config.step_replay_warmup, ref_eng.config.step_replay,
             ref_eng.config.fusion_threshold_bytes)
    out = [_Side(ref_eng, jnp.asarray, lambda o: RefOp[o]),
           _Side(port_engine(), torch.from_numpy, lambda o: ReduceOp[o])]
    for side in out:
        side.eng.config.step_replay_warmup = WARMUP
        side.eng.config.step_replay = True
        _reset(side.eng)
    try:
        yield out
    finally:
        _reset(ref_eng)
        (ref_eng.config.step_replay_warmup, ref_eng.config.step_replay,
         ref_eng.config.fusion_threshold_bytes) = saved
        hvd.shutdown()


def _data():
    rng = np.random.RandomState(0)
    return rng.randn(4, 3).astype(np.float32), rng.randn(7).astype(np.float32)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _grouped(s, xs, tag, op="SUM", post=1.0):
    s.eng.step_begin()
    hs = s.eng.grouped_allreduce([s.tensor(x) for x in xs], name=tag,
                                 op=s.op(op), postscale_factor=post)
    out = [_np(h.synchronize()) for h in hs]
    s.step_end()
    return out


def _leaves(s, xs, tag, gather=None):
    """Per-leaf allreduces (each awaited after all are submitted), and an
    allgather after the first when ``gather`` is given."""
    s.eng.step_begin()
    hs = [s.eng.allreduce(s.tensor(x), name=f"{tag}.{i}", op=s.op("SUM"))
          for i, x in enumerate(xs[:1])]
    if gather is not None:
        hs.append(s.eng.allgather(s.tensor(gather), name=f"{tag}.gather"))
    hs += [s.eng.allreduce(s.tensor(x), name=f"{tag}.{i + 1}",
                           op=s.op("SUM")) for i, x in enumerate(xs[1:])]
    out = [_np(h.synchronize()) for h in hs]
    s.step_end()
    return out


def _early_wait(s, a, b, tag):
    """A wait on the first handle before the second call is submitted."""
    s.eng.step_begin()
    o1 = _np(s.eng.allreduce(s.tensor(a), name=f"{tag}.x",
                             op=s.op("SUM")).synchronize())
    o2 = _np(s.eng.allreduce(s.tensor(b), name=f"{tag}.y",
                             op=s.op("SUM")).synchronize())
    s.step_end()
    return [o1, o2]


def _broadcast(s, xs, tag):
    s.eng.step_begin()
    hs = s.eng.grouped_broadcast([s.tensor(x) for x in xs], root_rank=0,
                                 name=tag)
    out = [_np(h.synchronize()) for h in hs]
    s.step_end()
    return out


def _case_capture_then_replay(s, a, b):
    return [_grouped(s, (a, b), f"g.{i}", "AVERAGE", 0.5) for i in range(4)]


def _case_per_leaf_stream_fuses(s, a, b):
    return [_leaves(s, (a, b), f"x{i}") for i in range(4)]


def _case_signature_divergence(s, a, b):
    return ([_grouped(s, (a, b), f"g.{i}") for i in range(3)]
            + [_grouped(s, (b, a), "div"), _grouped(s, (a, b), "g.9")])


def _case_midstream_divergence_flushes_prefix(s, a, b):
    return ([_leaves(s, (a, b), f"x{i}") for i in range(3)]
            + [_leaves(s, (a, b), "x9", gather=b)])


def _case_early_wait_forces_launch(s, a, b):
    return ([_leaves(s, (a, b), f"x{i}") for i in range(3)]
            + [_early_wait(s, a, b, "x9")])


def _case_join_invalidates(s, a, b):
    out = [_grouped(s, (a, b), f"g.{i}") for i in range(3)]
    assert s.eng.join() == 0
    assert not any(e.get("armed") for e in s.eng.replay._seen.values())
    return out + [_grouped(s, (a, b), f"h.{i}") for i in range(3)]


def _case_world_version_bump_invalidates(s, a, b):
    out = [_grouped(s, (a, b), f"g.{i}") for i in range(3)]
    s.eng.world_version += 1     # what an elastic reset does via env
    return out + [_grouped(s, (a, b), f"g.{i}") for i in range(3, 5)]


def _case_unreplayable_op_blocks_arming(s, a, b):
    return [_leaves(s, (a,), f"x{i}", gather=b) for i in range(5)]


def _case_alternating_signatures_each_arm(s, a, b):
    return [_grouped(s, (a, b) if i % 2 == 0 else (b,), f"t.{i}")
            for i in range(6)]


def _case_disabled_never_arms(s, a, b):
    s.eng.config.step_replay = False
    return [_grouped(s, (a, b), f"g.{i}") for i in range(5)]


def _case_broadcast_stream_replays(s, a, b):
    return [_broadcast(s, (a, b), f"bc.{i}") for i in range(4)]


def _case_fusion_threshold_move_rearms(s, a, b):
    out = [_grouped(s, (a, b), f"g.{i}") for i in range(3)]
    s.eng.config.fusion_threshold_bytes = 16      # a bucket a tensor
    out += [_grouped(s, (a, b), f"g.{i}") for i in range(3, 5)]
    armed = [e["armed"] for e in s.eng.replay._seen.values() if e["armed"]]
    assert len(armed) == 1 and armed[0].threshold == 16
    return out


# case -> (its steps, the counters after the last step)
CASES = {
    "capture_then_replay": (_case_capture_then_replay, (1, 2, 0)),
    "per_leaf_stream_fuses": (_case_per_leaf_stream_fuses, (1, 2, 0)),
    "signature_divergence": (_case_signature_divergence, (1, 2, 1)),
    "midstream_divergence_flushes_prefix": (
        _case_midstream_divergence_flushes_prefix, (1, 1, 1)),
    "early_wait_forces_launch": (_case_early_wait_forces_launch, (1, 1, 1)),
    "join_invalidates": (_case_join_invalidates, (2, 2, 0)),
    "world_version_bump_invalidates": (
        _case_world_version_bump_invalidates, (2, 1, 0)),
    "unreplayable_op_blocks_arming": (
        _case_unreplayable_op_blocks_arming, (0, 0, 0)),
    "alternating_signatures_each_arm": (
        _case_alternating_signatures_each_arm, (2, 2, 1)),
    "disabled_never_arms": (_case_disabled_never_arms, (0, 0, 0)),
    "broadcast_stream_replays": (_case_broadcast_stream_replays, (1, 2, 0)),
    "fusion_threshold_move_rearms": (
        _case_fusion_threshold_move_rearms, (1, 3, 0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_size1_matches_the_reference(sides, case):
    """Each step's values and the counters after each step, the port's
    against the JAX package's on the same inputs, and the counters the
    reference's own test asserts at the end."""
    fn, final = CASES[case]
    a, b = _data()
    ref, port = sides
    want, got = fn(ref, a, b), fn(port, a, b)
    assert len(got) == len(want)
    for g_step, w_step in zip(got, want):
        assert len(g_step) == len(w_step)
        for g, w in zip(g_step, w_step):
            np.testing.assert_array_equal(g, w)
    assert port.trail == ref.trail
    assert port.trail[-1] == final


def test_events_and_one_dispatch_a_replayed_step(sides):
    """``on_replay`` sees capture, replay, fallback (with its reason) and
    invalidate; a replayed step is one engine dispatch, the eager grouped
    call one a bucket."""
    port = sides[1]
    eng = port.eng
    events = []
    eng.on_replay = lambda event, detail: events.append((event, detail))
    a, b = _data()
    for i in range(WARMUP):
        _grouped(port, (a, b), f"g.{i}")
    d0 = eng.dispatch_count
    _grouped(port, (a, b), "g.9")
    assert eng.dispatch_count - d0 == 1
    eng.config.step_replay = False
    d0 = eng.dispatch_count
    _grouped(port, (a, b), "g.off")
    assert eng.dispatch_count - d0 == len(bucket_by_size(
        [torch.from_numpy(a), torch.from_numpy(b)],
        eng.config.fusion_threshold_bytes))
    eng.config.step_replay = True
    _grouped(port, (b, a), "div")
    eng.join()
    assert [e for e, _ in events] == ["capture", "replay", "fallback",
                                      "invalidate"]
    assert "signature divergence at op 0" in events[2][1]


def test_step_context_manager_and_module_surface(sides):
    for name in ("step", "step_begin", "step_end", "optimizer"):
        assert name in hvd.__all__ and hasattr(hvd, name)
    port = sides[1]
    a, b = _data()
    for i in range(WARMUP + 1):
        with hvd.step():
            hs = hvd.grouped_allreduce_async(
                [torch.from_numpy(a), torch.from_numpy(b)], name=f"cm.{i}",
                op=hvd.Sum)
        out = [h.synchronize() for h in hs]
        np.testing.assert_array_equal(out[0].numpy(), a)
    assert port.counters() == (1, 1, 0)
    hvd.step_begin()
    hvd.allreduce(torch.from_numpy(a), name="cm.x", op=hvd.Sum)
    hvd.step_end()
    hvd.step_end()           # no step open: a no-op
    assert port.counters() == (1, 1, 1)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("replay2")
    return {"optimizer": run_world("optimizer", 2, out),
            "replay": run_world("replay", 2, out)}


def _assert_trajectories_equal(t1, t2):
    assert len(t1) == len(t2)
    for s1, s2 in zip(t1, t2):
        for x, y in zip(s1, s2):
            np.testing.assert_array_equal(x, y)


def test_np2_optimizer_brackets_its_steps_and_replays_bitwise(world2):
    """DistributedOptimizer's OPT_STEPS steps: the warm-up records, the
    stream arms once, the later steps replay, and the trajectory is
    bitwise the one with replay off."""
    warm = 3                                   # the default warm-up
    for r in world2["optimizer"]:
        assert len(r["traj"]) == OPT_STEPS
        assert r["replay"] == (1, OPT_STEPS - warm, 0)
        assert r["replay_off"] == (0, 0, 0)
        _assert_trajectories_equal(r["traj"], r["traj_off"])


def test_np2_replay_world(world2):
    """The replay scenario on gloo: the optimizer with replay on, off and
    off again agree bitwise; the per-leaf stream arms, replays and sums
    exactly; rank 0 joins after the warm-up and rank 1's replayed steps
    reduce against its zero substitutes."""
    warm = 3
    res = world2["replay"]
    for r in res:
        assert r["on"]["replay"] == (1, REPLAY_STEPS - warm, 0)
        assert r["off"]["replay"] == r["off2"]["replay"] == (0, 0, 0)
        _assert_trajectories_equal(r["on"]["traj"], r["off"]["traj"])
        _assert_trajectories_equal(r["off"]["traj"], r["off2"]["traj"])
        assert r["leaf"]["replay"] == (1, 2, 0)
        want = [replay_leaf(0, i) + replay_leaf(1, i) for i in range(3)]
        for sums in r["leaf"]["sums"]:
            for got, w in zip(sums, want):
                np.testing.assert_array_equal(got, w)
    _assert_trajectories_equal(res[0]["on"]["traj"], res[1]["on"]["traj"])
    r0, r1 = (r["early_join"] for r in res)
    assert r0["replay"] == (1, 0, 0) and r1["replay"] == (1, REPLAY_EXTRA, 0)
    assert r0["sums"] == [[3.0] * JOIN_TENSORS] * warm
    assert r1["sums"] == ([[3.0] * JOIN_TENSORS] * warm
                          + [[2.0] * JOIN_TENSORS] * REPLAY_EXTRA)
    assert r0["last"] == r1["last"] == 1
