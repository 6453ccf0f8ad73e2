"""Eager collective engine on ``torch.distributed``.

The port's counterpart of ``horovod_tpu/core/engine.py``, plain path only:
named async collectives returning handles, duplicate-name detection,
tensor fusion (per-dtype buckets of at most ``HOROVOD_FUSION_THRESHOLD``
bytes, one collective per bucket), reducescatter, and the collectively
agreed hierarchy (local and cross process groups) that hierarchical Adasum
runs on. An async handle wraps the ``async_op=True`` work object of its
collective: ``poll()`` is ``is_completed()`` and ``synchronize()`` is
``wait()``, then the Average divide and the postscale, once per launch.
Adasum (``ops/adasum.py``) issues its own exchanges and registers its
result through :meth:`Engine.track_result`.

Not ported yet (the reference's other engine paths): join, alltoall, the
ZeRO-1 sharded step, step replay, overlap, wire codecs, algorithm selection
(hierarchical Sum/Average), autotune, metrics and tracing. Until algorithm
selection is ported, a Sum/Average allreduce under
``HOROVOD_HIERARCHICAL_ALLREDUCE`` runs flat and says so once per process,
as the reference does when it demotes an algorithm.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import env as env_mod
from ..common.exceptions import DuplicateNameError, HorovodInternalError
from ..common.reduce_ops import ReduceOp
from ..ops import collectives as C
from .backend import Backend

logger = logging.getLogger("horovod_tpu_torch")

_warned_demotions: set = set()


def _demote(key: tuple, msg: str):
    """One WARNING per process and reason that a collective runs flat (the
    reference's ``_demote``, ``horovod_tpu/ops/collectives.py``)."""
    if key not in _warned_demotions:
        _warned_demotions.add(key)
        logger.warning("collective algorithm selection: %s; using flat", msg)


_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    # Average is SUM then a divide by the world size, as the reference
    # computes it (gloo has no AVG)
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def _translate_failure(fn, *args, **kwargs):
    """Run a collective call or completion wait, turning a runtime failure
    into HorovodInternalError (the exception an elastic loop catches)."""
    try:
        return fn(*args, **kwargs)
    except (DuplicateNameError, HorovodInternalError):
        raise
    except RuntimeError as e:
        raise HorovodInternalError(
            f"collective execution failed (peer crashed or runtime error): "
            f"{type(e).__name__}: {e}") from e


def _check_average_dtype(x: torch.Tensor, op):
    """User-argument validation before dispatch, so it surfaces as a plain
    ValueError."""
    if op == ReduceOp.AVERAGE and not (x.is_floating_point()
                                       or x.is_complex()):
        raise ValueError(
            "Averaging is not supported for integer tensors; use op=Sum "
            "(parity with the reference frontends' integer-average rejection)")


def _dist_op(op: ReduceOp):
    if op == ReduceOp.ADASUM:
        raise ValueError("op=Adasum is not a torch.distributed reduction: "
                         "hvd.allreduce and hvd.grouped_allreduce route it "
                         "through horovod_tpu_torch.ops.adasum")
    if op not in _DIST_OPS:
        raise NotImplementedError(
            f"op {ReduceOp(op).name} is not ported to horovod_tpu_torch yet")
    return _DIST_OPS[op]


class LaunchGroup:
    """Shared completion latch for every handle born from one collective
    launch: the work object is waited once and the finish step (Average
    divide, postscale) runs once, whichever handle gets there first."""

    def __init__(self, work, finish: Optional[Callable[[], None]] = None):
        self._work = work
        self._finish = finish
        self._done = False
        self._lock = threading.Lock()

    def ready(self) -> bool:
        if self._done:
            return True
        if not _translate_failure(self._work.is_completed):
            return False
        self.wait()
        return True

    def wait(self):
        with self._lock:
            if not self._done:
                _translate_failure(self._work.wait)
                if self._finish is not None:
                    self._finish()
                self._done = True


class _StreamWork:
    """The work object of a result computed on this process's current
    stream: complete when the stream has run the work issued up to now (on
    the CPU, at once). ``wait()`` orders the current stream after it
    without blocking the host, as an NCCL work object's does."""

    def __init__(self, device: torch.device):
        self._device = device
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def is_completed(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self):
        if self._event is not None:
            torch.cuda.current_stream(self._device).wait_event(self._event)


class Handle:
    """Async op handle: completion is its launch group's; the result is
    extracted once, after it."""

    def __init__(self, name: str, group: LaunchGroup, extract: Callable,
                 engine: "Engine"):
        self.name = name
        self._group = group
        self._extract = extract
        self._engine = engine
        self._done = False
        self._result = None
        self._error = None
        self._finish_lock = threading.Lock()
        self.recv_sizes = None  # per-rank dim-0 sizes for allgather results

    def poll(self) -> bool:
        if not self._done and self._group.ready():
            self._finish()
        return self._done

    def synchronize(self):
        if not self._done:
            self._group.wait()
            self._finish()
        if self._error is not None:
            raise self._error
        return self._result

    def _finish(self):
        with self._finish_lock:
            if self._done:
                return
            try:
                self._result = self._extract()
            # the error stays on the handle: every later synchronize()
            # re-raises it (handle-manager semantics)
            except Exception as e:  # noqa: BLE001
                self._error = e
            self._done = True
        self._engine._on_complete(self)


class Engine:
    """Named eager collectives over the default process group."""

    def __init__(self, backend: Backend, config: env_mod.Config):
        self.backend = backend
        self.config = config
        self._outstanding: Dict[str, Handle] = {}
        self._lock = threading.Lock()
        self._auto_counter: Dict[str, int] = {}
        self._hier_ok: Optional[bool] = None
        self._hier_groups = None

    # -- internals ---------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.backend.device)

    def _auto_name(self, kind: str) -> str:
        n = self._auto_counter.get(kind, 0)
        self._auto_counter[kind] = n + 1
        return f"{kind}.noname.{n}"

    def _register(self, name: Optional[str], kind: str) -> str:
        name = name or self._auto_name(kind)
        with self._lock:
            existing = self._outstanding.get(name)
        # a prior op that already completed is no conflict; only one still
        # in flight is (common.h:163-166 DUPLICATE_NAME_ERROR)
        if existing is not None and not existing.poll():
            raise DuplicateNameError(
                f"Duplicate tensor name {name!r} submitted before the prior "
                f"operation completed (common.h:163-166)")
        return name

    def _track(self, h: Handle) -> Handle:
        with self._lock:
            self._outstanding[h.name] = h
        return h

    def _on_complete(self, h: Handle):
        with self._lock:
            if self._outstanding.get(h.name) is h:
                del self._outstanding[h.name]

    def _reduce_launch(self, flat: torch.Tensor, op: ReduceOp,
                       prescale_factor: float,
                       postscale_factor: float) -> LaunchGroup:
        """Launch the in-place allreduce of one private flat buffer."""
        if self.config.hierarchical_allreduce and op in (ReduceOp.SUM,
                                                         ReduceOp.AVERAGE):
            _demote(("allreduce", "hierarchical"),
                    "HOROVOD_HIERARCHICAL_ALLREDUCE asks for the two-level "
                    "Sum/Average allreduce, which is not ported yet "
                    "(ROADMAP A11; it selects hierarchical Adasum only)")
        C.prescale(flat, prescale_factor)
        work = _translate_failure(dist.all_reduce, flat, op=_dist_op(op),
                                  async_op=True)
        n = self.backend.size() if op == ReduceOp.AVERAGE else 1
        return LaunchGroup(
            work, lambda: C.finish_reduce(flat, n, postscale_factor))

    # -- collectives -------------------------------------------------------

    def allreduce(self, tensor, name: Optional[str] = None,
                  op: ReduceOp = ReduceOp.SUM,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0) -> Handle:
        x = self._tensor(tensor)
        _check_average_dtype(x, op)
        name = self._register(name, "allreduce")
        buf = x.clone(memory_format=torch.contiguous_format)
        group = self._reduce_launch(buf, op, prescale_factor,
                                    postscale_factor)
        return self._track(Handle(name, group, lambda: buf, self))

    def grouped_allreduce(self, tensors: Sequence,
                          name: Optional[str] = None,
                          op: ReduceOp = ReduceOp.SUM,
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0) -> List[Handle]:
        """Fused allreduce: per-dtype buckets of at most the fusion
        threshold, one pack and one collective per bucket; each output is a
        view of its bucket's reduced buffer."""
        tensors = [self._tensor(t) for t in tensors]
        for t in tensors:
            _check_average_dtype(t, op)
        _dist_op(op)
        names = [self._register(None if name is None else f"{name}.{i}",
                                "grouped_allreduce")
                 for i in range(len(tensors))]
        if not tensors:
            return []
        buckets = bucket_by_size(tensors, self.config.fusion_threshold_bytes)
        handles: List[Optional[Handle]] = [None] * len(tensors)
        for idxs in buckets:
            # per bucket: pack, then reduce (the form the reference takes
            # with its Pallas pack, whose packing is its own launch)
            flat = C.pack_bucket([tensors[i] for i in idxs],
                                 self.config.pack_kernel)
            group = self._reduce_launch(flat, op, prescale_factor,
                                        postscale_factor)
            views = C.unpack_flat(flat, [tuple(tensors[i].shape)
                                         for i in idxs])
            for i, v in zip(idxs, views):
                handles[i] = self._track(
                    Handle(names[i], group, lambda v=v: v, self))
        return handles

    def broadcast(self, tensor, root_rank: int,
                  name: Optional[str] = None) -> Handle:
        x = self._tensor(tensor)
        self._check_root(root_rank)
        name = self._register(name, "broadcast")
        buf = x.clone(memory_format=torch.contiguous_format)
        work = _translate_failure(dist.broadcast, buf, src=root_rank,
                                  async_op=True)
        return self._track(Handle(name, LaunchGroup(work), lambda: buf, self))

    def grouped_broadcast(self, tensors: Sequence, root_rank: int,
                          name: Optional[str] = None) -> List[Handle]:
        """Fused broadcast: one plain pack and one collective per bucket."""
        tensors = [self._tensor(t) for t in tensors]
        self._check_root(root_rank)
        names = [self._register(None if name is None else f"{name}.{i}",
                                "grouped_broadcast")
                 for i in range(len(tensors))]
        handles: List[Optional[Handle]] = [None] * len(tensors)
        for idxs in bucket_by_size(tensors,
                                   self.config.fusion_threshold_bytes):
            flat = C.pack_bucket([tensors[i] for i in idxs], False)
            work = _translate_failure(dist.broadcast, flat, src=root_rank,
                                      async_op=True)
            group = LaunchGroup(work)
            views = C.unpack_flat(flat, [tuple(tensors[i].shape)
                                         for i in idxs])
            for i, v in zip(idxs, views):
                handles[i] = self._track(
                    Handle(names[i], group, lambda v=v: v, self))
        return handles

    def allgather(self, tensor, name: Optional[str] = None) -> Handle:
        """Allgather along dim 0 with possibly different dim-0 sizes per rank
        (a size exchange, a padded gather, then trim and concatenate)."""
        x = self._tensor(tensor)
        name = self._register(name, "allgather")
        if x.dim() == 0:
            x = x[None]
        sizes = self._exchange_sizes(int(x.shape[0]))
        max_d0 = max(sizes)
        pad = max_d0 - int(x.shape[0])
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in sizes]
        work = _translate_failure(dist.all_gather, outs, x, async_op=True)

        def extract():
            if all(s == max_d0 for s in sizes):
                return torch.cat(outs)
            return torch.cat([o[:s] for o, s in zip(outs, sizes)])

        h = Handle(name, LaunchGroup(work), extract, self)
        h.recv_sizes = np.asarray(sizes)
        return self._track(h)

    def reducescatter(self, tensor, name: Optional[str] = None,
                      op: ReduceOp = ReduceOp.SUM) -> Handle:
        """Sum (or Average) over the world, scattered along dim 0: rank r
        gets rows [r·c, min((r+1)·c, d0)) with c = ceil(d0 / size), so
        trailing ranks may get fewer (or no) rows and the ranks' outputs
        concatenate to the whole reduced tensor."""
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(
                f"reducescatter supports Sum and Average, got {op!r}")
        x = self._tensor(tensor)
        _check_average_dtype(x, op)
        if x.dim() == 0:
            raise ValueError("reducescatter requires a tensor with dim 0")
        name = self._register(name, "reducescatter")
        size, rank = self.backend.size(), self.backend.rank()
        d0 = int(x.shape[0])
        chunk = -(-d0 // size)
        rows = [min(chunk, max(d0 - r * chunk, 0)) for r in range(size)]
        flat = x.contiguous()
        if chunk * size != d0:
            flat = torch.cat([flat, flat.new_zeros(
                (chunk * size - d0,) + tuple(x.shape[1:]))])
        out = x.new_empty((chunk,) + tuple(x.shape[1:]))
        work = _translate_failure(C.reduce_scatter, out, flat, None,
                                  async_op=True)
        n = size if op == ReduceOp.AVERAGE else 1
        group = LaunchGroup(work, lambda: C.finish_reduce(out, n, 1.0))
        h = Handle(name, group, lambda: out[:rows[rank]], self)
        h.recv_sizes = np.asarray(rows)
        return self._track(h)

    def track_result(self, name: str, out: torch.Tensor) -> Handle:
        """Register ``out``, computed under the name ``name`` on this
        process's current stream (the Adasum path), as a handle: it
        completes when the stream has run that work."""
        return self._track(Handle(name, LaunchGroup(_StreamWork(out.device)),
                                  lambda: out, self))

    def barrier(self):
        """Blocks until every rank has reached it."""
        z = torch.zeros(1, dtype=torch.int32, device=self.backend.device)
        _translate_failure(dist.all_reduce, z)
        z.item()  # host-side completion on every backend

    # -- helpers -----------------------------------------------------------

    def _check_root(self, root_rank: int):
        if not 0 <= root_rank < self.backend.size():
            raise ValueError(f"root_rank {root_rank} is outside the world "
                             f"[0, {self.backend.size()})")

    def _hierarchical_ok(self) -> bool:
        """Whether the world has a usable (cross, local) layout, decided
        once and agreed by every rank: an allgather of the local sizes,
        true only when they are equal and 1 < local < size, size % local
        == 0 (a rank-local test could pick different programs on
        different ranks)."""
        if self._hier_ok is None:
            size = self.backend.size()
            local = self.backend.local_size()
            sizes = self._exchange_sizes(local) if size > 1 else [local]
            self._hier_ok = (all(s == sizes[0] for s in sizes)
                             and 1 < local < size and size % local == 0)
        return self._hier_ok

    def hierarchical_groups(self):
        """(local group, cross group) of this rank, ranks laid out as
        c·local + l: local group c holds the ranks of node c, cross group l
        the l-th rank of every node. Created the first time they are asked
        for (after :meth:`_hierarchical_ok`, which every rank passes),
        every group on every rank in one order: ``dist.new_group`` is
        collective."""
        if self._hier_groups is None:
            local = self.backend.local_size()
            cross = self.backend.size() // local
            rank = self.backend.rank()
            local_groups = [dist.new_group([c * local + l
                                            for l in range(local)])
                            for c in range(cross)]
            cross_groups = [dist.new_group([c * local + l
                                            for c in range(cross)])
                            for l in range(local)]
            self._hier_groups = (local_groups[rank // local],
                                 cross_groups[rank % local])
        return self._hier_groups

    def _exchange_sizes(self, d0: int) -> List[int]:
        mine = torch.tensor([d0], dtype=torch.int64,
                            device=self.backend.device)
        got = [torch.empty_like(mine) for _ in range(self.backend.size())]
        _translate_failure(dist.all_gather, got, mine)
        return [int(g.item()) for g in got]


def bucket_by_size(tensors: Sequence[torch.Tensor],
                   threshold_bytes: int) -> List[List[int]]:
    """Group tensor indices into fusion buckets: same dtype, cumulative size
    <= threshold (the reference's per-dtype bucketing)."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, t in enumerate(tensors):
        nb = t.nbytes
        if cur and (t.dtype != cur_dtype or cur_bytes + nb > threshold_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
        cur_dtype = t.dtype
    if cur:
        buckets.append(cur)
    return buckets
