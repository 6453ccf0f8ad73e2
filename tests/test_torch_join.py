"""horovod_tpu_torch's join protocol on gloo/CPU, against the values the JAX
package's tests assert (``tests/test_join.py``, and
``tests/test_multiprocess.py``'s np=4 round test) and the port's own
references.

One np=2 world (``torch_worker.py``'s ``join`` scenario; rank 0 runs out
of data first) runs the cases in turn: ragged allreduce and grouped
allreduce, broadcast, allgather, reducescatter and alltoall after a join,
a broadcast from a joined root (both ranks raise), a grouped call of 24
tensors (the metadata overflow exchange), Adasum, a ragged
``DistributedOptimizer`` whose Average counts the joined rank's zeros,
the active path's host reads, and ``HOROVOD_JOIN_DISABLE``. An np=4 world
runs the round test: rank r runs r + 1 allreduces, then joins.

Sums of small integers are exact: equality. The Adasum reduction is held
to the float64 reference within 1e-6 of its largest entry; a combine with
a zero vector returns the vector bitwise. The optimizer's trajectory is
held to a one-process torch reference within rtol 1e-5, atol 1e-6 (SGD
momentum on fp32 sums of two ranks in another order).
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.engine import _JOIN_META_LEN, _join_meta_row
from horovod_tpu_torch.ops.adasum import adasum_reference
from torch_worker import (JOIN_TENSORS, World, join_adasum_inputs, mlp_data,
                          mlp_params, shard_rows)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("join")
    started = {n: World("join", n, out) for n in (2, 4)}
    return {n: w.results() for n, w in started.items()}


def test_single_process_join(monkeypatch):
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        assert hvd.join() == 0
        hvd.barrier()
        assert hvd.join() == 0
    finally:
        hvd.shutdown()


def test_meta_row_encodes_op_dtype_and_shape():
    row = _join_meta_row(torch.zeros(2, 3, dtype=torch.bfloat16), 5)
    assert row.tolist() == [5, 4, 2, 2, 3, -1, -1, -1, -1, -1]
    assert len(row) == _JOIN_META_LEN
    with pytest.raises(ValueError, match="ndim 8"):
        _join_meta_row(torch.zeros((1,) * 8), 0)
    with pytest.raises(ValueError, match="HOROVOD_JOIN_DISABLE"):
        _join_meta_row(torch.zeros(2, dtype=torch.complex64), 0)


def test_ragged_batches_allreduce(worlds):
    (r0, last0), (r1, last1) = (r["ragged"] for r in worlds[2])
    assert r0 == [3.0] * 3
    assert r1 == [3.0] * 3 + [2.0] * 3
    assert last0 == last1 == 1


def test_ragged_batches_grouped(worlds):
    (s0, last0), (s1, last1) = (r["grouped"] for r in worlds[2])
    assert s0 == [[3.0, 3.0]] * 2
    assert s1 == [[3.0, 3.0]] * 2 + [[2.0, 2.0]] * 2
    assert last0 == last1 == 1


def test_mixed_ops_under_join(worlds):
    r0, r1 = (r["mixed"] for r in worlds[2])
    assert r0 == {"last": 1}
    assert r1["bcast"] == 7.0
    assert r1["gather_rows"] == 4        # 2 rows from rank 1 + 2 zero rows
    assert r1["rs"] == 1.0               # zeros from rank 0 add nothing
    # rank 0's substitute spreads rank 1's 3 rows as [2, 1]: 1 zero row to
    # rank 1, then rank 1's own last 2 rows
    assert r1["alltoall"] == ([0.0, 2.0, 3.0], [1, 2])
    assert r1["last"] == 1


def test_broadcast_from_joined_root_errors(worlds):
    r0, r1 = (r["dead_root"] for r in worlds[2])
    assert "no data to broadcast" in r0
    assert "has already joined" in r1


def test_ragged_grouped_metadata_overflow(worlds):
    (s0, last0), (s1, last1) = (r["overflow"] for r in worlds[2])
    assert JOIN_TENSORS > 16
    assert s0 == [[3.0] * JOIN_TENSORS] * 2
    assert s1 == [[3.0] * JOIN_TENSORS] * 2 + [[2.0] * JOIN_TENSORS] * 2
    assert last0 == last1 == 1


def test_adasum_under_join(worlds):
    """Both ranks' first reduction is their Adasum; rank 1's second, with
    rank 0 joined, combines with a zero vector and returns its own."""
    (a0, last0), (a1, last1) = (r["adasum"] for r in worlds[2])
    x0, x1 = join_adasum_inputs(0), join_adasum_inputs(1)
    want = adasum_reference([x0[0], x1[0]])
    for got in (a0[0], a1[0]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(a1[1], x1[1])
    assert (len(a0), len(a1), last0, last1) == (1, 2, 1, 1)


def test_optimizer_average_counts_the_joined_rank(worlds):
    """Rank 0 steps once, rank 1 three times: the Average divides by 2 on
    every step, so rank 1's later steps take half its own gradient."""
    (t0, last0), (t1, last1) = (r["optimizer"] for r in worlds[2])
    x, y = (torch.tensor(a) for a in mlp_data())
    ref = torch.nn.Sequential(torch.nn.Linear(4, 8, bias=False),
                              torch.nn.Tanh(),
                              torch.nn.Linear(8, 2, bias=False))
    with torch.no_grad():
        ref[0].weight.copy_(torch.tensor(mlp_params()[0].T))
        ref[2].weight.copy_(torch.tensor(mlp_params()[1].T))
    opt = torch.optim.SGD(ref.parameters(), lr=0.01, momentum=0.9)
    shards = [shard_rows(r, 2, len(x)) for r in range(2)]
    for step in range(3):
        opt.zero_grad()
        for r in (0, 1) if step == 0 else (1,):
            s = shards[r]
            (((ref(x[s]) - y[s]) ** 2).mean() / 2).backward()
        opt.step()
        for got, p in zip(t1[step], (ref[0].weight, ref[2].weight)):
            np.testing.assert_allclose(got, p.detach().numpy().T,
                                       rtol=1e-5, atol=1e-6)
        if step == 0:
            for a, b in zip(t0[0], t1[0]):
                np.testing.assert_array_equal(a, b)
    assert (len(t0), len(t1), last0, last1) == (1, 3, 1, 1)


def test_active_round_reads_nothing_on_the_host(worlds):
    """Issuing an allreduce at size 2 under join (its round included)
    calls no item, tolist, cpu or numpy."""
    assert [r["reads"] for r in worlds[2]] == [[], []]


def test_join_disabled_is_a_barrier(worlds):
    assert [r["disabled"] for r in worlds[2]] == [1, 1]


def test_four_process_allreduce_join(worlds):
    expect = [10.0, 9.0, 7.0, 4.0]
    for rank, r in enumerate(worlds[4]):
        assert r["sums"] == expect[:rank + 1]
        assert r["last"] == 3


def test_resnet_cards_scenario_rehearsal_on_gloo(tmp_path):
    """The card test's ``resnet_cards`` scenario (the join round's cost on
    a ResNet-50 step) on gloo with a tiny ResNet: every window runs, the
    join round on and off in turns, losses finite on both ranks."""
    res = World("resnet_cards", 2, tmp_path).results()
    for r in res:
        assert [on for on, _ in r["windows"]] == \
            [True, False, False, True] * 2
        assert all(rate > 0 for _, rate in r["windows"])
        assert np.isfinite(r["losses"]).all()
