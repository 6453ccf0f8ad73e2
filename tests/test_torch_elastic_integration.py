"""End-to-end elastic training of horovod_tpu_torch on localhost: real
worker processes on gloo, launched by ``python -m horovod_tpu_torch.runner
--elastic`` with a discovery script whose output changes mid-run, full
re-rendezvous (the port's mirror of ``tests/test_elastic_integration.py``
and of ``tests/test_multiprocess.py::test_run_elastic_programmatic``).

The workers are ``tests/torch_worker.py elastic``: a tiny LM under
``hvd.elastic.run`` with a ``TPUState`` committed every batch, each rank on
its own tokens. Each test keeps its processes under a timeout of its own.
"""

import os

import pytest

from torch_worker import run_elastic_job, set_hosts


def test_elastic_scale_down(tmp_path):
    """3 workers start; one slot is scaled away mid-run; the removed
    worker exits cleanly and the remaining two finish at size 2 with
    equal parameters."""
    def shrink(hostsfile):
        set_hosts(hostsfile, "localhost:2\n")

    rc, log, done, removed, lingering = run_elastic_job(
        tmp_path, "localhost:3\n", np_=2, max_np=3, total=60,
        env={"TEST_BATCH_SLEEP": "0.05"}, timeout=120, on_world=shrink)
    assert rc == 0, log
    assert not lingering, log
    assert len(done) == 2, log
    assert all(r["size"] == 2 and r["batch"] == 60 for r in done), done
    assert sorted(r["rank"] for r in done) == [0, 1]
    assert len({r["digest"] for r in done}) == 1
    assert removed == [{"removed": True}], log


def test_elastic_crash_recovery(tmp_path):
    """Rank 2 is hard-killed at batch 10 of 30. The survivors see the
    failed collective as HorovodInternalError, restore their commit in
    process and re-rendezvous; the driver relaunches the slot, whose new
    process takes rank 0's state at the sync. All finish at size 3 with
    no lost batch and equal parameters."""
    rc, log, done, removed, lingering = run_elastic_job(
        tmp_path, "localhost:3\n", np_=3, max_np=3, total=30,
        env={"TEST_CRASH_RANK": "2", "TEST_CRASH_BATCH": "10"},
        timeout=120)
    assert rc == 0, log
    assert not lingering, log
    assert (tmp_path / "crashed.marker").exists(), log
    assert len(done) == 3 and not removed, log
    assert all(r["size"] == 3 and r["batch"] == 30 for r in done), done
    assert sorted(r["rank"] for r in done) == [0, 1, 2]
    assert len({r["digest"] for r in done}) == 1
    # the survivors lived two worlds; the relaunched rank 2 one
    lives = {r["rank"]: r["lives"] for r in done}
    assert lives[0] == [(0, 3), (0, 3)] and lives[1] == [(1, 3), (1, 3)]
    assert lives[2] == [(2, 3)]


@pytest.mark.slow
def test_elastic_scale_up(tmp_path):
    """2 workers start; a third slot appears mid-run; all finish at
    size 3."""
    def grow(hostsfile):
        set_hosts(hostsfile, "localhost:3\n")

    rc, log, done, removed, lingering = run_elastic_job(
        tmp_path, "localhost:2\n", np_=2, max_np=3, total=80,
        env={"TEST_BATCH_SLEEP": "0.05"}, timeout=180, on_world=grow)
    assert rc == 0, log
    assert not lingering, log
    assert len(done) == 3, log
    assert all(r["size"] == 3 and r["batch"] == 80 for r in done), done
    assert len({r["digest"] for r in done}) == 1


def _elastic_fn(total):
    import torch
    import horovod_tpu_torch as hvd

    state = hvd.elastic.ObjectState(batch=0)

    @hvd.elastic.run
    def train(state):
        while state.batch < total:
            out = hvd.allreduce(torch.ones(2), name=f"b{state.batch}",
                                op=hvd.Sum)
            assert out[0] == hvd.size()
            state.batch += 1
            state.commit()
        return {"rank": hvd.rank(), "size": hvd.size(), "batch": state.batch}

    return train(state)


def test_run_elastic_programmatic():
    """The programmatic elastic API: the function runs under the elastic
    runtime on port workers (on the CPU, as the env asks) and per-final-rank
    results come back in order."""
    from horovod_tpu_torch.runner import run_elastic
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"HOROVOD_TPU_PLATFORM": "cpu", "HOROVOD_STALL_CHECK_DISABLE": "1",
           "PYTHONPATH": os.pathsep.join(
               [repo, os.path.join(repo, "tests"),
                os.environ.get("PYTHONPATH", "")])}
    results = run_elastic(_elastic_fn, args=(10,), np=2, max_np=2, env=env,
                          timeout=120)
    assert results == [{"rank": 0, "size": 2, "batch": 10},
                       {"rank": 1, "size": 2, "batch": 10}], results


def test_run_static_programmatic():
    """``run()``: a fixed world of 2 port workers on the CPU."""
    from horovod_tpu_torch.runner import run
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"HOROVOD_TPU_PLATFORM": "cpu", "HOROVOD_STALL_CHECK_DISABLE": "1",
           "PYTHONPATH": os.pathsep.join(
               [repo, os.path.join(repo, "tests"),
                os.environ.get("PYTHONPATH", "")])}
    results = run(_static_fn, np=2, env=env)
    assert results == [(0, 2, 3.0), (1, 2, 3.0)], results


def _static_fn():
    import torch
    import horovod_tpu_torch as hvd
    out = hvd.allreduce(torch.tensor([float(hvd.rank() + 1)]), name="r",
                        op=hvd.Sum)
    return hvd.rank(), hvd.size(), float(out[0])
