"""horovod_tpu_torch's world and eager engine on gloo/CPU, at np=1 (in this
process) and np=2 (two fresh processes, tests/torch_worker.py).

Reference results are computed with numpy from every rank's inputs; fp32
sums over two ranks are exact to rounding (rtol 1e-6). ``bucket_by_size`` is
held against ``horovod_tpu.core.engine.bucket_by_size`` on the same shapes.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.core.engine import bucket_by_size as jax_bucket_by_size
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import (DuplicateNameError,
                                                 HorovodInternalError)
from horovod_tpu_torch.core import backend as backend_mod
from horovod_tpu_torch.core.engine import (Handle, LaunchGroup,
                                           bucket_by_size)
from torch_worker import run_world

RTOL = 1e-6


@pytest.fixture
def world1(monkeypatch):
    """A size-1 world on the CPU in this process."""
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_PALLAS_PACK"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        hvd.shutdown()


# -- np=1 -------------------------------------------------------------------


def test_size1_world_and_build_flags(world1):
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size()) == \
        (0, 1, 0, 1)
    assert (hvd.cross_rank(), hvd.cross_size()) == (0, 1)
    assert hvd.device() == torch.device("cpu")
    assert hvd.cuda_built() and hvd.nccl_built() and not hvd.xla_built()


@pytest.mark.parametrize("op", [hvd.Sum, hvd.Average])
def test_size1_collectives_return_their_inputs(world1, op):
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(4, 3).astype(np.float32))
    assert torch.equal(hvd.allreduce(x, op=op), x)
    np.testing.assert_allclose(
        hvd.allreduce(x, op=op, prescale_factor=2.0,
                      postscale_factor=0.25).numpy(), x.numpy() * 0.5,
        rtol=RTOL)
    group = [torch.tensor(np.asarray(rng.randn(*s), np.float32))
             for s in [(3,), (2, 5), (7,), ()]]
    hvd.global_state().config.fusion_threshold_bytes = 32   # several buckets
    outs = hvd.grouped_allreduce(group, op=op)
    assert all(torch.equal(o, g) for o, g in zip(outs, group))
    assert [tuple(o.shape) for o in outs] == [tuple(g.shape) for g in group]
    assert torch.equal(hvd.broadcast(x, 0), x)
    assert torch.equal(hvd.allgather(x), x)


@pytest.mark.parametrize("pack_kernel,threshold",
                         [(False, 16), (True, 16), (True, 64 << 20)])
def test_size1_grouped_allreduce_forms(world1, pack_kernel, threshold):
    """The plain pack and the pack-kernel form (its plain version on the
    CPU), over several buckets and over one, give the same results."""
    cfg = hvd.global_state().config
    cfg.pack_kernel, cfg.fusion_threshold_bytes = pack_kernel, threshold
    rng = np.random.RandomState(1)
    group = [torch.tensor(rng.randn(*s).astype(np.float32))
             for s in [(2,), (3, 2), (5,)]]
    outs = hvd.grouped_allreduce(group, op=hvd.Sum, prescale_factor=2.0)
    for o, g in zip(outs, group):
        np.testing.assert_allclose(o.numpy(), 2 * g.numpy(), rtol=RTOL)


def test_size1_async_handles(world1):
    x = torch.arange(6, dtype=torch.float32)
    h = hvd.allreduce_async(x, name="h")
    out = hvd.synchronize(h)
    assert hvd.poll(h) and torch.equal(out, x)
    hs = hvd.grouped_allreduce_async([x, x[:2]], name="g")
    assert [torch.equal(hvd.synchronize(a), b)
            for a, b in zip(hs, [x, x[:2]])] == [True, True]
    # a completed name may be reused
    hvd.synchronize(hvd.allreduce_async(x, name="h"))


def test_size1_numpy_inputs_and_object_helpers(world1):
    out = hvd.allreduce(np.ones(3, np.float32), op=hvd.Sum)
    assert isinstance(out, torch.Tensor) and out.tolist() == [1, 1, 1]
    assert hvd.broadcast_object({"a": 1}) == {"a": 1}
    assert hvd.allgather_object(5) == [5]
    hvd.barrier()


class _InFlight:
    """A collective work object that never completes."""

    def is_completed(self):
        return False

    def wait(self):
        raise AssertionError("not waited in this test")


def test_duplicate_name_in_flight_raises(world1):
    eng = hvd.global_state().engine
    eng._track(Handle("grad.0", LaunchGroup(_InFlight()), lambda: None, eng))
    with pytest.raises(DuplicateNameError):
        hvd.allreduce_async(torch.ones(2), name="grad.0")
    with pytest.raises(DuplicateNameError):
        hvd.grouped_allreduce_async([torch.ones(2)], name="grad")


def test_average_of_integers_raises(world1):
    ints = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="integer"):
        hvd.allreduce(ints, op=hvd.Average)
    with pytest.raises(ValueError, match="integer"):
        hvd.grouped_allreduce([torch.ones(2), ints], op=hvd.Average)
    assert hvd.allreduce(ints, op=hvd.Sum).tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        hvd.allreduce(ints, op=hvd.Sum, average=True)


def test_hierarchical_sum_warns_once_that_it_runs_flat(monkeypatch, caplog):
    """HOROVOD_HIERARCHICAL_ALLREDUCE with a Sum or Average allreduce in a
    world of one rank: the two-level ladder needs more than one rank, so
    the allreduce runs flat, with the right result, and says so once per
    process (the reference's one-time demotion warning, naming the knob);
    Max, which never takes the ladder, and a world without the knob say
    nothing. Worlds that factorize run the ladder
    (tests/test_torch_topology.py)."""
    from horovod_tpu_torch.core import engine as engine_mod
    monkeypatch.setattr(engine_mod, "_warned_demotions", set())
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    x = torch.arange(6, dtype=torch.float32)
    for knob, ops, warnings in (("0", (hvd.Sum, hvd.Average), 0),
                                ("1", (hvd.Max,), 0),
                                ("1", (hvd.Sum, hvd.Average, hvd.Sum), 1)):
        monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", knob)
        hvd.init(device="cpu")
        caplog.clear()
        try:
            with caplog.at_level("WARNING", logger="horovod_tpu_torch"):
                for op in ops:
                    assert torch.equal(hvd.allreduce(x, op=op), x)
                    outs = hvd.grouped_allreduce([x, 2 * x], op=op)
                    assert torch.equal(outs[1], 2 * x)
        finally:
            hvd.shutdown()
        flat = [r for r in caplog.records if "using flat" in r.getMessage()]
        assert len(flat) == warnings, (knob, ops, caplog.text)
        if warnings:
            assert "HOROVOD_HIERARCHICAL_ALLREDUCE" in flat[0].getMessage()


def test_uninitialized_use_raises():
    assert not hvd.is_initialized()
    with pytest.raises(ValueError, match="init"):
        hvd.allreduce(torch.ones(1))


def test_cuda_is_the_default_and_its_absence_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HorovodInternalError, match="CUDA"):
        backend_mod.resolve_device()
    assert backend_mod.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("threshold", [1, 40, 100, 64 << 20])
def test_bucket_by_size_matches_jax(threshold):
    rng = np.random.RandomState(0)
    dtypes = [np.float32, np.float32, np.float16, np.float16, np.float32,
              np.int32, np.float32]
    arrs = [rng.randn(int(rng.randint(1, 9))).astype(dt) for dt in dtypes]
    want = jax_bucket_by_size(arrs, threshold)
    got = bucket_by_size([torch.from_numpy(a) for a in arrs], threshold)
    assert got == want


# -- np=2 -------------------------------------------------------------------


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world("engine", 2, tmp_path_factory.mktemp("engine2"))


def test_np2_ranks_follow_the_env_contract(world2):
    for r, res in enumerate(world2):
        assert (res["rank"], res["size"]) == (r, 2)
        assert (res["local_rank"], res["local_size"]) == (r, 2)
        assert (res["cross_rank"], res["cross_size"]) == (0, 1)


def test_np2_allreduce(world2):
    xs = [res["x"] for res in world2]
    for res in world2:
        np.testing.assert_allclose(res["allreduce_sum"], xs[0] + xs[1],
                                   rtol=RTOL)
        # prescale 2, Average, postscale 0.5
        np.testing.assert_allclose(res["allreduce_avg"],
                                   (2 * xs[0] + 2 * xs[1]) / 2 * 0.5,
                                   rtol=RTOL)
        np.testing.assert_array_equal(res["allreduce_max"],
                                      np.maximum(xs[0], xs[1]))


@pytest.mark.parametrize("op", ["sum", "avg"])
def test_np2_grouped_allreduce_several_buckets(world2, op):
    groups = [res["group"] for res in world2]
    div = 2 if op == "avg" else 1
    want = [(3 * a + 3 * b) / div * 0.25 for a, b in zip(*groups)]
    for res in world2:
        got = res[f"grouped_{op}"]
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7)
        for out in res["grouped_int_sum"]:
            assert out.dtype == np.int32
        np.testing.assert_array_equal(res["grouped_int_sum"][0],
                                      np.arange(6) * 3)


def test_np2_broadcast_allgather_async_objects(world2):
    rows = np.concatenate([res["gather_in"] for res in world2])
    for res in world2:
        np.testing.assert_array_equal(res["broadcast"], [2.0, 2.0, 2.0])
        np.testing.assert_array_equal(res["allgather"], rows)
        # the default op is Average: (1 + 2) / 2
        np.testing.assert_array_equal(res["async"], [1.5] * 4)
        assert res["async_poll_after"]
        assert res["objects"] == [{"rank": 0}, {"rank": 1}]
        assert res["object_bcast"] == {"from": 0}
