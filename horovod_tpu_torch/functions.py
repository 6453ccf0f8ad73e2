"""State-sync helpers (parity: horovod/torch/functions.py —
broadcast_parameters :30, broadcast_optimizer_state :62, broadcast_object
:186, allgather_object :229; the port's counterpart of
``horovod_tpu/functions.py``), the step markers of step-capture replay
(``step_begin``, ``step_end``, ``step``), and the sparse allreduce of
row-indexed updates (``allreduce_sparse``)."""

from __future__ import annotations

import contextlib
import pickle
from typing import Any, Optional

import numpy as np
import torch

from .core.state import engine as _engine


def step_begin():
    """Mark the start of one training step for step-capture replay
    (core/replay.py): the engine records the ordered (kind, op, dtype,
    shape, name) collective stream between ``step_begin()`` and
    ``step_end()``; once the same signature repeats
    ``HOROVOD_TPU_STEP_REPLAY_WARMUP`` times (default 3; master switch
    ``HOROVOD_TPU_STEP_REPLAY``), matching steps are serviced by the armed
    program, one CUDA graph on the card, with a counted zero-padded
    fallback on any divergence or early wait and invalidation under
    ``join()`` and elastic world-version bumps.

    ``DistributedOptimizer`` wraps its reduction in these markers at size >
    1; a loop that calls ``allreduce_async`` itself opts in by bracketing
    the step (or with :func:`step`)."""
    _engine().step_begin()


def step_end():
    """Close the step opened by :func:`step_begin` (records, arms or
    launches as appropriate; safe to call with no step open)."""
    _engine().step_end()


@contextlib.contextmanager
def step():
    """The ``with hvd.step():`` form of :func:`step_begin` and
    :func:`step_end`::

        with hvd.step():
            handles = [hvd.allreduce_async(g, name=n) for n, g in grads]
    """
    eng = _engine()
    eng.step_begin()
    try:
        yield
    finally:
        eng.step_end()


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast tensors from ``root_rank`` to every process, in place.
    ``params`` is a ``state_dict()``-style mapping or an iterable of
    ``(name, tensor)`` pairs such as ``model.named_parameters()``. Tensors
    travel as fused per-dtype buckets, one collective per bucket."""
    eng = _engine()
    items = list(params.items() if hasattr(params, "items") else params)
    tensors = [t for _, t in items]
    if eng.backend.size() == 1 or not tensors:
        return
    handles = eng.grouped_broadcast([t.detach() for t in tensors], root_rank,
                                    name="broadcast.param")
    with torch.no_grad():
        for t, h in zip(tensors, handles):
            t.copy_(h.synchronize())


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Make every process's optimizer state equal to ``root_rank``'s, in
    place (``load_state_dict`` moves the state tensors to the parameters'
    devices).

    A ZeRO-1 sharded optimizer is refused (the reference's
    ``functions.py:104-110``): its state is rank-local shards, and rank 0's
    would overwrite every other rank's slice. Broadcast the parameters and
    build the optimizer anew instead."""
    is_sharded = getattr(optimizer, "_is_sharded", None)
    if is_sharded is not None and is_sharded():
        raise ValueError(
            "broadcast_optimizer_state cannot broadcast a ZeRO-1 sharded "
            "state: its leaves are rank-local shards, and overwriting them "
            "with rank 0's would corrupt every other rank's parameter "
            "slice. Use broadcast_parameters(model.state_dict()) and build "
            "the sharded optimizer anew")
    eng = _engine()
    if eng.backend.size() == 1:
        return
    state = broadcast_object(_to_cpu(optimizer.state_dict()), root_rank,
                             name="broadcast.optimizer_state")
    optimizer.load_state_dict(state)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """Pickle an object on ``root_rank`` and broadcast its length, then its
    bytes as a uint8 tensor."""
    eng = _engine()
    if eng.backend.size() == 1:
        return obj
    name = name or "broadcast_object"
    if eng.backend.rank() == root_rank:
        data = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
    else:
        data = np.zeros(0, np.uint8)
    sz = eng.broadcast(torch.tensor([data.size], dtype=torch.int64),
                       root_rank, name=f"{name}.sz").synchronize()
    nbytes = int(sz.item())
    if data.size != nbytes:
        data = np.zeros(nbytes, np.uint8)
    out = eng.broadcast(torch.from_numpy(data.copy()), root_rank,
                        name=f"{name}.data").synchronize()
    return pickle.loads(out.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> list:
    """Gather arbitrary objects from every process into a list ordered by
    rank."""
    eng = _engine()
    if eng.backend.size() == 1:
        return [obj]
    data = np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy()
    h = eng.allgather(torch.from_numpy(data), name=name or "allgather_object")
    gathered = h.synchronize().cpu().numpy()
    out, off = [], 0
    for s in h.recv_sizes:
        out.append(pickle.loads(gathered[off:off + int(s)].tobytes()))
        off += int(s)
    return out


def allreduce_sparse(indices, values, n_rows: int,
                     name: Optional[str] = None, average: bool = True):
    """Sparse (row-indexed) reduction by allgather, the reference's
    ``allreduce_sparse`` (its IndexedSlices fallback,
    tensorflow/__init__.py:52-131): every rank's ``indices`` (rows of an
    ``n_rows``-row tensor) and ``values`` (one row each) are gathered, the
    indices as int64, duplicate rows summed on the device with
    ``index_add_`` and divided by the size when ``average``. Returns
    ``(rows, values)``, sorted by row: scattered into zeros they give the
    dense allreduce's Sum (or Average)."""
    eng = _engine()
    indices = eng._tensor(indices).to(torch.int64)
    values = eng._tensor(values)
    if indices.shape[0] != values.shape[0]:
        raise ValueError(
            f"indices ({indices.shape[0]}) and values ({values.shape[0]}) "
            f"must agree on dim 0")
    if indices.numel() and (int(indices.min()) < 0
                            or int(indices.max()) >= n_rows):
        raise ValueError(f"indices out of range [0, {n_rows})")
    size = eng.backend.size()
    name = name or "allreduce_sparse"
    if size > 1:
        hi = eng.allgather(indices, name=f"{name}.idx")
        hv = eng.allgather(values, name=f"{name}.val")
        indices, values = hi.synchronize(), hv.synchronize()
    rows, inverse = torch.unique(indices, sorted=True, return_inverse=True)
    combined = values.new_zeros((rows.numel(),) + tuple(values.shape[1:]))
    combined.index_add_(0, inverse, values)
    if average:
        combined = (combined / size).to(values.dtype)
    return rows, combined
