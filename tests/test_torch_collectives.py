"""horovod_tpu_torch's alltoall, allreduce_sparse and HandleManager on
gloo/CPU, against the values the JAX package's tests assert and numpy
constructions from every rank's inputs.

- size 1 (this process): ``tests/test_api.py``'s alltoall and sparse
  cases, and the reference's ``HandleManager`` driven alike;
- np=2 and np=4 (``torch_worker.py``'s ``collectives`` scenario): the
  even and uneven alltoall of ``tests/test_multiprocess.py`` (rank r sends
  ``100 r + dest`` to each dest; rank r sends r + 1 rows to each), a
  seeded uneven alltoall against numpy, its two ValueError paths, and the
  sparse allreduce of ``test_multiprocess.py`` and of seeded inputs
  against the dense allreduce.

alltoall moves values unchanged: equality. The sparse allreduce sums
fp32 rows of the ranks in another order than the dense one: rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.core.engine import HandleManager as JaxHandleManager
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.engine import HandleManager
from torch_worker import World, alltoall_input, sparse_input

RTOL = 1e-6
SIZES = [2, 4]


@pytest.fixture
def world1(monkeypatch):
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    started = {n: World("collectives", n, out) for n in SIZES}
    return {n: w.results() for n, w in started.items()}


# -- size 1 -----------------------------------------------------------------


def test_size1_alltoall_returns_its_input(world1):
    x = torch.arange(6, dtype=torch.float32)
    assert torch.equal(hvd.alltoall(x, name="a2a1"), x)
    out, splits = hvd.alltoall(x, splits=[6], name="a2a2")
    assert torch.equal(out, x) and splits.tolist() == [6]
    out, splits = hvd.alltoall_async(x, splits=torch.tensor([6])).synchronize()
    assert torch.equal(out, x) and splits.tolist() == [6]


@pytest.mark.parametrize("bad,match", [
    (dict(tensor=torch.ones(3), splits=[2]), "sum to tensor dim 0"),
    (dict(tensor=torch.ones(3), splits=[1, 2]), "non-negative row counts"),
    (dict(tensor=torch.ones(())), "dim 0"),
])
def test_size1_alltoall_rejects_bad_splits(world1, bad, match):
    with pytest.raises(ValueError, match=match):
        hvd.alltoall(**bad)


def test_size1_allreduce_sparse_matches_the_dense_allreduce(world1):
    idx = np.array([3, 1, 3, 7])
    val = np.array([[1.0, 1.0], [2.0, 2.0], [10.0, 10.0], [4.0, 4.0]],
                   np.float32)
    u, c = hvd.allreduce_sparse(idx, val, n_rows=10, average=False)
    assert u.dtype == torch.int64 and u.tolist() == [1, 3, 7]
    np.testing.assert_allclose(c.numpy(), [[2, 2], [11, 11], [4, 4]])
    dense = np.zeros((10, 2), np.float32)
    np.add.at(dense, idx, val)
    dense_out = hvd.allreduce(torch.from_numpy(dense), name="sparse.ref",
                              op=hvd.Sum).numpy()
    rebuilt = np.zeros_like(dense)
    rebuilt[u.numpy()] = c.numpy()
    np.testing.assert_allclose(rebuilt, dense_out)
    u, c = hvd.allreduce_sparse(idx, val, n_rows=10)    # average, size 1
    np.testing.assert_allclose(c.numpy(), [[2, 2], [11, 11], [4, 4]])
    with pytest.raises(ValueError, match="out of range"):
        hvd.allreduce_sparse(np.array([11]), np.ones((1, 2)), n_rows=10)
    with pytest.raises(ValueError, match="agree on dim 0"):
        hvd.allreduce_sparse(np.array([1, 2]), np.ones((1, 2)), n_rows=10)


@pytest.mark.parametrize("cls", [HandleManager, JaxHandleManager])
def test_handle_manager(cls):
    """The port's HandleManager against the reference's, driven alike."""
    hm = cls()
    a, b = object(), object()
    assert (hm.allocate(a), hm.allocate(b)) == (0, 1)
    assert hm.get(0) is a and hm.get(1) is b
    hm.release(0)
    hm.release(0)                      # releasing twice is no error
    with pytest.raises(ValueError, match="unknown handle 0"):
        hm.get(0)
    assert hm.allocate(a) == 2         # ids are never reused


# -- np=2, np=4 -------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_alltoall_even_and_uneven(worlds, n):
    """Rank r receives row ``100 s + r`` from each rank s; with splits
    ``[s + 1] * n`` it receives s + 1 rows from rank s."""
    for rank, r in enumerate(worlds[n]):
        want = np.stack([np.full(2, 100.0 * s + rank) for s in range(n)])
        np.testing.assert_array_equal(r["even"], want)
        assert r["recv_counts"] == list(range(1, n + 1))
        assert r["recv_rows"] == n * (n + 1) // 2


@pytest.mark.parametrize("n", SIZES)
def test_alltoall_seeded_uneven_matches_numpy(worlds, n):
    ins = [alltoall_input(s, n) for s in range(n)]
    for rank, r in enumerate(worlds[n]):
        parts, counts = [], []
        for t, splits in ins:
            start = sum(splits[:rank])
            parts.append(t[start:start + splits[rank]])
            counts.append(splits[rank])
        np.testing.assert_array_equal(r["random"], np.concatenate(parts))
        assert r["random_counts"] == counts


@pytest.mark.parametrize("n", SIZES)
def test_alltoall_value_errors(worlds, n):
    for r in worlds[n]:
        assert r["errors"] == [
            f"alltoall without splits requires dim0 ({n + 1}) divisible "
            f"by size ({n})", "splits must sum to tensor dim 0"]


@pytest.mark.parametrize("n", SIZES)
def test_allreduce_sparse_matches_numpy_and_the_dense_allreduce(worlds, n):
    ins = [sparse_input(s) for s in range(n)]
    idx = np.concatenate([i for i, _ in ins])
    val = np.concatenate([v for _, v in ins])
    rows = np.unique(idx)
    want = np.zeros((len(rows), 2), np.float64)
    np.add.at(want, np.searchsorted(rows, idx), val)
    for r in worlds[n]:
        u, c = r["sparse_sum"]
        np.testing.assert_array_equal(u, rows)
        np.testing.assert_allclose(c, want, rtol=RTOL, atol=1e-7)
        u, c = r["sparse_avg"]
        np.testing.assert_array_equal(u, rows)
        np.testing.assert_allclose(c, want / n, rtol=RTOL, atol=1e-7)
        rebuilt = np.zeros_like(r["dense"])
        rebuilt[u] = r["sparse_sum"][1]
        np.testing.assert_allclose(rebuilt, r["dense"], rtol=RTOL,
                                   atol=1e-7)


@pytest.mark.parametrize("n", SIZES)
def test_allreduce_sparse_reference_values(worlds, n):
    """tests/test_multiprocess.py's case: rank 0 touches rows {1, 3}, the
    others {3, 5}, each row full of rank + 1."""
    for r in worlds[n]:
        u, c = r["sparse_ref"]
        assert u.tolist() == [1, 3, 5]
        rest = sum(range(2, n + 1))
        assert c[:, 0].tolist() == [1.0, 1.0 + rest, float(rest)]
