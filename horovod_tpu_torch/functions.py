"""State-sync helpers (parity: horovod/torch/functions.py —
broadcast_parameters :30, broadcast_optimizer_state :62, broadcast_object
:186, allgather_object :229; the port's counterpart of
``horovod_tpu/functions.py``)."""

from __future__ import annotations

import pickle
from typing import Any, Optional

import numpy as np
import torch

from .core.state import engine as _engine


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
    devices)."""
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
