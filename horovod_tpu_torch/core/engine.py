"""Eager collective engine on ``torch.distributed``.

The port's counterpart of ``horovod_tpu/core/engine.py``, plain path only:
named async collectives returning handles, duplicate-name detection,
tensor fusion (per-dtype buckets of at most ``HOROVOD_FUSION_THRESHOLD``
bytes, one collective per bucket), reducescatter, alltoall with uneven
splits, the join protocol, and the collectively agreed hierarchy (local and
cross process groups) that hierarchical Adasum runs on. An async handle
wraps the ``async_op=True`` work objects of its collective: ``poll()`` is
``is_completed()`` and ``synchronize()`` is ``wait()``, then the Average
divide and the postscale, once per launch. Adasum (``ops/adasum.py``)
issues its own exchanges and registers its result through
:meth:`Engine.track_result`.

Join (the reference's :1279-1480, operations.cc:1004-1040): at size > 1
every collective first posts a fixed-shape round, an allgather of int64
``[active flag, rounds, kind, k, k metadata rows]`` (a row is the op or
root, dtype code, ndim and up to 7 dims); a grouped call of more than
``HOROVOD_JOIN_META_SLOTS`` tensors posts the rest in one overflow
exchange. Active ranks never read the round: it is built in a pinned
host buffer and copied without a host wait, and its tensors are kept
until the work completes. A rank in :meth:`Engine.join` reads each round
and runs the advertised collective through the same engine method with
zero tensors, so every internal exchange lines up, until every rank has
joined. ``HOROVOD_JOIN_DISABLE=1`` drops the round, and ``join()`` is a
barrier. A sharded step has no substitute (a joined rank owns a shard):
its round is read by every rank before any exchange, and every rank
raises. The reference's ``grouped_alltoall`` substitute comes with that
collective (ROADMAP A16).

ZeRO-1 (the reference's ``sharded_step``, :1911-2164): per bucket of the
caller's frozen layout, K1 packs the gradients into a padded buffer and a
reduce-scatter sums it into this rank's shard in place; the caller's
update steps the shards; an all-gather writes every rank's shard into the
flat parameter buffer in place (``ops/collectives.py``).

Step replay (the reference's :1015-1060, ``core/replay.py``): between
:meth:`Engine.step_begin` and :meth:`Engine.step_end` every collective
first reports to :class:`~.replay.StepReplay` (``intercept`` for the
replayable kinds, before any registration or join round; ``observe`` for
the others), which services a matching step from its armed program.

Wire codecs (the reference's :742-886 and the codec arms of ``allreduce``,
``grouped_allreduce`` and ``sharded_step``): a call's codec is its
``codec=`` argument (the optimizer's ``compression=``) or
``HOROVOD_TPU_COMPRESSION``, ``none`` at size 1 and for ops other than
Sum and Average. Each fusion bucket resolves it by dtype
(``ops/compression.py``) and a bucket with a codec runs the flat
compressed reduction (``ops/collectives.py``: K1 into a zero-tailed
padded buffer, encode, all-to-all, decode-sum, all-gather; on a sharded
step the reduce-scatter leg alone). fp8 and int8 carry an error-feedback
residual a bucket: a device buffer in the engine's table, updated in
place, zeros on first use, after :meth:`Engine.invalidate_residuals`
(``join()``, a world-version bump), on a shape drift or another world
version. Join's op field carries the call codec in bits 4 and up, so a
joined rank's zero substitute runs the same compressed program.

Not ported yet (the reference's other engine paths): the ZeRO-1
all-gather prefetch leg, replay's overlap modes and single-launch form,
alltoall's codec and steady-state splits cache, algorithm selection
(hierarchical Sum/Average and alltoall, and the hierarchical codec arm),
autotune, metrics and tracing: ``codec_selections`` and
``residual_invalidations`` are plain counters until the metric
instruments come (ROADMAP A12). Until algorithm selection is ported, a
Sum/Average allreduce under ``HOROVOD_HIERARCHICAL_ALLREDUCE`` runs flat
and says so once per process, as the reference does when it demotes an
algorithm.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import env as env_mod
from ..common.exceptions import DuplicateNameError, HorovodInternalError
from ..common.reduce_ops import ReduceOp
from ..ops import collectives as C
from ..ops import compression as comp
from .backend import Backend
from .replay import _DIGITS, StepReplay

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
    launch: its work objects (one, or a list) are waited once and the
    finish step (Average divide, postscale) runs once, whichever handle
    gets there first."""

    def __init__(self, work, finish: Optional[Callable[[], None]] = None):
        self._works = list(work) if isinstance(work, (list, tuple)) \
            else [work]
        self._finish = finish
        self._done = False
        self._lock = threading.Lock()

    def ready(self) -> bool:
        if self._done:
            return True
        if not all(_translate_failure(w.is_completed) for w in self._works):
            return False
        self.wait()
        return True

    def wait(self):
        with self._lock:
            if not self._done:
                for w in self._works:
                    _translate_failure(w.wait)
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


class HandleManager:
    """int handle -> :class:`Handle` map (the reference's, parity:
    torch/handle_manager.{h,cc})."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._handles: Dict[int, Handle] = {}

    def allocate(self, h: Handle) -> int:
        with self._lock:
            hid = self._next
            self._next += 1
            self._handles[hid] = h
            return hid

    def get(self, hid: int) -> Handle:
        with self._lock:
            if hid not in self._handles:
                raise ValueError(f"unknown handle {hid}")
            return self._handles[hid]

    def release(self, hid: int):
        with self._lock:
            self._handles.pop(hid, None)


# Join-protocol metadata (the reference's codes, core/engine.py:264-300).
# The reference's kind 11 (grouped_alltoall) comes with that collective
# (ROADMAP A16).
_KIND_CODES = {"allreduce": 1, "grouped_allreduce": 2, "allgather": 3,
               "broadcast": 4, "alltoall": 5, "reducescatter": 6,
               "barrier": 7, "adasum": 8, "grouped_broadcast": 9,
               "sharded_step": 10}
_CODE_KINDS = {v: k for k, v in _KIND_CODES.items()}
_DTYPE_CODES = {torch.float32: 1, torch.float64: 2, torch.float16: 3,
                torch.bfloat16: 4, torch.int8: 5, torch.int16: 6,
                torch.int32: 7, torch.int64: 8, torch.uint8: 9,
                torch.uint16: 10, torch.uint32: 11, torch.uint64: 12,
                torch.bool: 13}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_JOIN_META_DIMS = 7
_JOIN_META_LEN = 3 + _JOIN_META_DIMS  # [op_or_root, dtype, ndim, d0..d6]

# what every rank raises when join() meets a sharded step (the reference's
# text, core/engine.py:1453-1461)
SHARDED_JOIN_ERROR = (
    "sharded optimizer steps cannot be matched by a join() zero substitute: "
    "a rank without data still owns a parameter shard that must keep "
    "receiving real updates. Keep stepping with zero gradients instead of "
    "join(), or use the replicated (sharded=False) optimizer for "
    "ragged-batch workloads")


def _meta_row(shape, dtype: torch.dtype, op_or_root: int) -> np.ndarray:
    """One tensor's metadata row of a join round."""
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise ValueError(f"dtype {dtype} unsupported under the Join "
                         f"protocol; set HOROVOD_JOIN_DISABLE=1")
    if len(shape) > _JOIN_META_DIMS:
        raise ValueError(f"ndim {len(shape)} > {_JOIN_META_DIMS} "
                         f"unsupported under the Join protocol")
    dims = [int(d) for d in shape] + [-1] * (_JOIN_META_DIMS - len(shape))
    return np.array([op_or_root, code, len(shape)] + dims, dtype=np.int64)


def _join_meta_row(x: torch.Tensor, op_or_root: int) -> np.ndarray:
    return _meta_row(tuple(x.shape), x.dtype, op_or_root)


def _op_field(op: ReduceOp, call_codec: str) -> int:
    """A reduction's join op field: the op in bits 0-3, the call codec's
    index in CODECS above them (the reference's :1672-1679)."""
    return int(op) | (comp.CODECS.index(call_codec) << 4)


def _split_op_field(code: int):
    """``(op, call codec)`` of a join op field."""
    return ReduceOp(code & 15), comp.CODECS[(code >> 4) % len(comp.CODECS)]


class Engine:
    """Named eager collectives over the default process group."""

    def __init__(self, backend: Backend, config: env_mod.Config):
        self.backend = backend
        self.config = config
        self.handles = HandleManager()
        self._outstanding: Dict[str, Handle] = {}
        self._lock = threading.Lock()
        self._auto_counter: Dict[str, int] = {}
        self._hier_ok: Optional[bool] = None
        self._hier_groups = None
        # the next engine call is a joined rank's zero substitute
        self._join_substitute = False
        # (work, tensors) of posted join rounds, kept until the work is done
        self._posted = collections.deque()
        # collective launches: one a bucket of a fused call, one a call
        # otherwise, one a replayed step
        self.dispatch_count = 0
        # elastic world identity: a bump invalidates every armed replay
        # stream (HOROVOD_TPU_WORLD_VERSION; it only moves forward)
        self.world_version = int(
            os.environ.get(env_mod.HOROVOD_TPU_WORLD_VERSION, "0") or 0)
        # on_replay(event, detail): capture, replay, fallback, invalidate
        self.on_replay: Optional[Callable[[str, str], None]] = None
        self._replay = StepReplay(self)
        # the side stream a sharded step's join round runs on (the card)
        self._guard_stream = None
        # error-feedback residuals: key -> {"world_version", "buf"}, the
        # buffers updated in place (insertion order: the oldest first)
        self._residuals: Dict[tuple, dict] = {}
        # plain counters: codec selections by (kind, codec), a bucket
        # each; residual buffers dropped or zeroed by an invalidation
        self.codec_selections = collections.Counter()
        self.residual_invalidations = 0

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

    # -- step-capture replay (core/replay.py) ------------------------------

    def step_begin(self):
        """Mark the start of one training step. Between step_begin and
        step_end the engine records the ordered collective stream; once the
        same signature repeats ``step_replay_warmup`` times, matching steps
        are serviced by the armed program (one CUDA graph on the card; see
        core/replay.py)."""
        self._replay.step_begin()

    def step_end(self):
        self._replay.step_end()

    @property
    def replay(self) -> StepReplay:
        return self._replay

    def _refresh_world_version(self) -> int:
        """Pick up an elastic world-version bump from
        ``HOROVOD_TPU_WORLD_VERSION``, which the rendezvous sets before any
        rank re-enters a step. The attribute only moves forward (tests may
        bump it directly)."""
        v = os.environ.get(env_mod.HOROVOD_TPU_WORLD_VERSION)
        if v:
            try:
                ev = int(v)
            except ValueError:
                return self.world_version
            if ev > self.world_version:
                self.world_version = ev
        return self.world_version

    def _emit_replay(self, event: str, detail: str):
        if self.on_replay is not None:
            self.on_replay(event, detail)

    def _flat_only(self, op: ReduceOp):
        """Warn once that a Sum/Average allreduce under
        ``HOROVOD_HIERARCHICAL_ALLREDUCE`` runs flat (C3)."""
        if self.config.hierarchical_allreduce and op in (ReduceOp.SUM,
                                                         ReduceOp.AVERAGE):
            _demote(("allreduce", "hierarchical"),
                    "HOROVOD_HIERARCHICAL_ALLREDUCE asks for the two-level "
                    "Sum/Average allreduce, which is not ported yet "
                    "(ROADMAP A11; it selects hierarchical Adasum only)")

    def _reduce_launch(self, flat: torch.Tensor, op: ReduceOp,
                       prescale_factor: float,
                       postscale_factor: float) -> LaunchGroup:
        """Launch the in-place allreduce of one private flat buffer."""
        self._flat_only(op)
        C.prescale(flat, prescale_factor)
        work = _translate_failure(dist.all_reduce, flat, op=_dist_op(op),
                                  async_op=True)
        n = self.backend.size() if op == ReduceOp.AVERAGE else 1
        return LaunchGroup(
            work, lambda: C.finish_reduce(flat, n, postscale_factor))

    # -- wire codecs (the reference's :742-886) ------------------------------

    def _call_codec(self, override: Optional[str],
                    op: Optional[ReduceOp] = None) -> str:
        """The call's wire codec: ``override`` (the optimizer's
        ``compression=``, carried in the replay signature) or
        ``HOROVOD_TPU_COMPRESSION``; "none" at size <= 1 and for ops other
        than Sum and Average (only they have a decode-sum form)."""
        if self.backend.size() <= 1:
            return comp.CODEC_NONE
        if op is not None and op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            return comp.CODEC_NONE
        base = override if override is not None else self.config.compression
        return base if base in comp.CODECS else comp.CODEC_NONE

    def _bucket_codecs(self, kind: str, dtypes: Sequence[torch.dtype],
                       call_codec: str, count: bool = True) -> tuple:
        """Each bucket's codec (one of ``dtypes``, a bucket's, each), the
        same on every rank: ``resolve_codec(call_codec, dtype)``. With
        ``count`` the selections go into ``codec_selections``."""
        if call_codec == comp.CODEC_NONE:
            return (comp.CODEC_NONE,) * len(dtypes)
        out = tuple(comp.resolve_codec(call_codec, d) for d in dtypes)
        if count:
            for c in out:
                self.codec_selections[(kind, c)] += 1
        return out

    def _residual_key(self, tag: str, name: Optional[str], bucket: int,
                      codec: str, elems: int, dtype_str: str) -> tuple:
        """The identity of one error-feedback lineage: the call's name with
        its digit runs made ``#`` (the optimizer's per-step names collapse
        to one template), the bucket's position, codec, length and dtype.
        Replay derives the same keys from its signatures, so a single-call
        step's lineage carries from the eager warm-up into the replayed
        steps."""
        return (tag, _DIGITS.sub("#", name or ""), int(bucket), codec,
                int(elems), dtype_str)

    def _grouped_residuals(self, tag: str, name: Optional[str], sizes,
                           dtypes, codecs) -> list:
        """``(bucket, key, elems, dtype)`` of each error-feedback bucket of
        one call (``sizes``: the buckets' element counts), in bucket
        order."""
        n = self.backend.size()
        out = []
        for b, (total, dtype, codec) in enumerate(zip(sizes, dtypes,
                                                      codecs)):
            elems = C.codec_residual_elems("reduce", total, n, codec)
            if elems is not None:
                out.append((b, self._residual_key(tag, name, b, codec, elems,
                                                  str(dtype)),
                            elems, dtype))
        return out

    def _fetch_residuals(self, rows) -> dict:
        """``{bucket: residual buffer}`` of ``rows`` (``(bucket, key, elems,
        dtype)``, as :meth:`_grouped_residuals` gives them), after a sweep
        of another world version's."""
        if not rows:
            return {}
        self._residual_gc()
        return {b: self._residual_fetch(key, elems, dtype)
                for b, key, elems, dtype in rows}

    def _residual_fetch(self, key: tuple, elems: int,
                        dtype: torch.dtype) -> torch.Tensor:
        """This rank's residual buffer for one error-feedback bucket, which
        the codec updates in place: the table's, or a new one of zeros
        (first use, after invalidation, on a shape drift or another world
        version: starting fresh costs one step of compression error)."""
        with self._lock:
            ent = self._residuals.get(key)
            if (ent is not None and ent["world_version"] == self.world_version
                    and ent["buf"].numel() == int(elems)
                    and ent["buf"].dtype == dtype):
                return ent["buf"]
        buf = torch.zeros(int(elems), dtype=dtype, device=self.backend.device)
        self._residual_store(key, buf)
        return buf

    def _residual_store(self, key: tuple, buf: torch.Tensor):
        """Make ``buf`` the residual of ``key``; past ``cache_capacity``
        entries the oldest go, but never a buffer an armed replay program
        holds (its graph would keep updating a buffer the eager path no
        longer reads)."""
        held = self._replay.held_residuals()
        with self._lock:
            self._residuals.pop(key, None)
            self._residuals[key] = {"world_version": self.world_version,
                                    "buf": buf}
            over = len(self._residuals) - max(self.config.cache_capacity, 1)
            if over > 0:
                for old in [k for k in self._residuals
                            if k not in held and k != key][:over]:
                    del self._residuals[old]

    def invalidate_residuals(self, reason: str):
        """Drop every error-feedback residual (``join()``, a world-version
        bump, explicit resets): the next compressed step starts a fresh
        lineage. A buffer an armed program holds is zeroed in place and
        kept, so its graph and the eager path go on sharing it."""
        held = self._replay.held_residuals()
        with self._lock:
            dropped = len(self._residuals)
            for key in list(self._residuals):
                if key in held:
                    self._residuals[key]["buf"].zero_()
                else:
                    del self._residuals[key]
        if dropped:
            self.residual_invalidations += dropped
            self._emit_replay("residual-invalidate", reason)

    def _residual_gc(self):
        """Drop the residuals of another world version (an elastic bump
        seen outside the step markers)."""
        v = self._refresh_world_version()
        with self._lock:
            stale = [k for k, ent in self._residuals.items()
                     if ent["world_version"] != v]
            for k in stale:
                del self._residuals[k]
        if stale:
            self.residual_invalidations += len(stale)
            self._emit_replay("residual-invalidate",
                              f"world-version bump (-> {v})")

    def _codec_launch(self, tensors: Sequence[torch.Tensor], codec: str,
                      residual: Optional[torch.Tensor], op: ReduceOp,
                      prescale_factor: float, postscale_factor: float):
        """One bucket's compressed allreduce: K1 (under
        ``HOROVOD_PALLAS_PACK``) into a zero-tailed padded buffer, then the
        flat codec reduction (``C.codec_allreduce``), ordered on this
        process's stream. Returns the reduced prefix and its launch
        group."""
        self._flat_only(op)
        n, rank = self.backend.size(), self.backend.rank()
        total = sum(t.numel() for t in tensors)
        flat = C.padded_bucket(total, n, tensors[0].dtype,
                               tensors[0].device)
        C.pack_padded(tensors, flat, self.config.pack_kernel)
        _translate_failure(C.codec_allreduce, flat, total, residual, codec,
                           n, rank, n if op == ReduceOp.AVERAGE else 1,
                           prescale_factor, postscale_factor, None)
        return flat[:total], LaunchGroup(_StreamWork(flat.device))

    # -- collectives -------------------------------------------------------

    def allreduce(self, tensor, name: Optional[str] = None,
                  op: ReduceOp = ReduceOp.SUM,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0,
                  codec: Optional[str] = None) -> Handle:
        """``codec`` overrides ``HOROVOD_TPU_COMPRESSION`` for this call."""
        x = self._tensor(tensor)
        orig_name = name
        sub = self._consume_substitute()
        _check_average_dtype(x, op)
        _dist_op(op)
        call_codec = self._call_codec(codec, op)
        r = self._replay.intercept("allreduce", [x], int(op),
                                   prescale_factor, postscale_factor, name,
                                   sub, codec=call_codec)
        if r is not None:
            return r[0]
        name = self._register(name, "allreduce")
        self._join_sync("allreduce",
                        [_join_meta_row(x, _op_field(op, call_codec))], sub)
        bucket_codec = self._bucket_codecs("allreduce", [x.dtype],
                                           call_codec)[0]
        self.dispatch_count += 1
        if bucket_codec != comp.CODEC_NONE:
            residuals = self._fetch_residuals(self._grouped_residuals(
                "gar", orig_name, [x.numel()], [x.dtype], [bucket_codec]))
            flat, group = self._codec_launch(
                [x.contiguous()], bucket_codec, residuals.get(0), op,
                prescale_factor, postscale_factor)
            return self._track(Handle(name, group,
                                      lambda: flat.view(x.shape), self))
        buf = x.clone(memory_format=torch.contiguous_format)
        group = self._reduce_launch(buf, op, prescale_factor,
                                    postscale_factor)
        return self._track(Handle(name, group, lambda: buf, self))

    def grouped_allreduce(self, tensors: Sequence,
                          name: Optional[str] = None,
                          op: ReduceOp = ReduceOp.SUM,
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          codec: Optional[str] = None) -> List[Handle]:
        """Fused allreduce: per-dtype buckets of at most the fusion
        threshold, one pack and one collective per bucket (the compressed
        reduction for a bucket with a wire codec: ``codec`` overrides
        ``HOROVOD_TPU_COMPRESSION``); each output is a view of its
        bucket's reduced buffer."""
        tensors = [self._tensor(t) for t in tensors]
        sub = self._consume_substitute()
        for t in tensors:
            _check_average_dtype(t, op)
        _dist_op(op)
        if not tensors:
            return []
        call_codec = self._call_codec(codec, op)
        r = self._replay.intercept("grouped_allreduce", tensors, int(op),
                                   prescale_factor, postscale_factor, name,
                                   sub, codec=call_codec)
        if r is not None:
            return r
        names = [self._register(None if name is None else f"{name}.{i}",
                                "grouped_allreduce")
                 for i in range(len(tensors))]
        self._join_sync("grouped_allreduce",
                        [_join_meta_row(t, _op_field(op, call_codec))
                         for t in tensors], sub)
        buckets = bucket_by_size(tensors, self.config.fusion_threshold_bytes)
        codecs = self._bucket_codecs(
            "grouped_allreduce", [tensors[idxs[0]].dtype for idxs in buckets],
            call_codec)
        residuals = self._fetch_residuals(self._grouped_residuals(
            "gar", name, [sum(tensors[i].numel() for i in idxs)
                          for idxs in buckets],
            [tensors[idxs[0]].dtype for idxs in buckets], codecs))
        handles: List[Optional[Handle]] = [None] * len(tensors)
        for b, idxs in enumerate(buckets):
            # per bucket: pack, then reduce (the form the reference takes
            # with its Pallas pack, whose packing is its own launch)
            bucket = [tensors[i] for i in idxs]
            if codecs[b] != comp.CODEC_NONE:
                flat, group = self._codec_launch(
                    bucket, codecs[b], residuals.get(b), op,
                    prescale_factor, postscale_factor)
            else:
                flat = C.pack_bucket(bucket, self.config.pack_kernel)
                group = self._reduce_launch(flat, op, prescale_factor,
                                            postscale_factor)
            self.dispatch_count += 1
            views = C.unpack_flat(flat, [tuple(tensors[i].shape)
                                         for i in idxs])
            for i, v in zip(idxs, views):
                handles[i] = self._track(
                    Handle(names[i], group, lambda v=v: v, self))
        return handles

    def broadcast(self, tensor, root_rank: int,
                  name: Optional[str] = None) -> Handle:
        x = self._tensor(tensor)
        sub = self._consume_substitute()
        self._check_root(root_rank)
        r = self._replay.intercept("broadcast", [x], root_rank, 1.0, 1.0,
                                   name, sub)
        if r is not None:
            return r[0]
        name = self._register(name, "broadcast")
        self._join_sync("broadcast", [_join_meta_row(x, root_rank)], sub)
        buf = x.clone(memory_format=torch.contiguous_format)
        work = _translate_failure(dist.broadcast, buf, src=root_rank,
                                  async_op=True)
        self.dispatch_count += 1
        flag_works, root_active = self._root_flag(root_rank, sub)

        def extract():
            root_active()
            return buf

        return self._track(Handle(name, LaunchGroup([work] + flag_works),
                                  extract, self))

    def grouped_broadcast(self, tensors: Sequence, root_rank: int,
                          name: Optional[str] = None) -> List[Handle]:
        """Fused broadcast: one plain pack and one collective per bucket."""
        tensors = [self._tensor(t) for t in tensors]
        sub = self._consume_substitute()
        self._check_root(root_rank)
        if not tensors:
            return []
        r = self._replay.intercept("grouped_broadcast", tensors, root_rank,
                                   1.0, 1.0, name, sub)
        if r is not None:
            return r
        names = [self._register(None if name is None else f"{name}.{i}",
                                "grouped_broadcast")
                 for i in range(len(tensors))]
        self._join_sync("grouped_broadcast",
                        [_join_meta_row(t, root_rank) for t in tensors], sub)
        launches = []
        for idxs in bucket_by_size(tensors,
                                   self.config.fusion_threshold_bytes):
            flat = C.pack_bucket([tensors[i] for i in idxs], False)
            work = _translate_failure(dist.broadcast, flat, src=root_rank,
                                      async_op=True)
            self.dispatch_count += 1
            launches.append((idxs, flat, work))
        # one root-active flag for the call: every handle of a joined
        # root's call raises
        _, root_active = self._root_flag(root_rank, sub)
        handles: List[Optional[Handle]] = [None] * len(tensors)
        for idxs, flat, work in launches:
            group = LaunchGroup(work)
            views = C.unpack_flat(flat, [tuple(tensors[i].shape)
                                         for i in idxs])
            for i, v in zip(idxs, views):
                def extract(v=v):
                    root_active()
                    return v
                handles[i] = self._track(
                    Handle(names[i], group, extract, self))
        return handles

    def allgather(self, tensor, name: Optional[str] = None) -> Handle:
        """Allgather along dim 0 with possibly different dim-0 sizes per rank
        (a size exchange, a padded gather, then trim and concatenate)."""
        x = self._tensor(tensor)
        sub = self._consume_substitute()
        self._replay.observe("allgather", sub, [x], name)
        name = self._register(name, "allgather")
        if x.dim() == 0:
            x = x[None]
        self._join_sync("allgather", [_join_meta_row(x, 0)], sub)
        sizes = self._exchange_sizes(int(x.shape[0]))
        max_d0 = max(sizes)
        pad = max_d0 - int(x.shape[0])
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in sizes]
        work = _translate_failure(dist.all_gather, outs, x, async_op=True)
        self.dispatch_count += 1

        def extract():
            if all(s == max_d0 for s in sizes):
                return torch.cat(outs)
            return torch.cat([o[:s] for o, s in zip(outs, sizes)])

        h = Handle(name, LaunchGroup(work), extract, self)
        h.recv_sizes = np.asarray(sizes)
        return self._track(h)

    def alltoall(self, tensor, splits=None,
                 name: Optional[str] = None) -> Handle:
        """Alltoall with optional uneven splits (the reference's :2384,
        operations.cc:951): rank r gets ``splits[r]`` rows of this rank's
        dim 0, in rank order; without ``splits`` dim 0 must divide by the
        size and goes out in equal blocks. The splits matrix is exchanged
        once (``recv_splits[r]`` = rank r's ``splits[me]``), then one
        ``all_to_all_single`` with uneven sizes. The handle's result is
        ``(received tensor, recv_splits)``, the splits an int64 CPU tensor.
        At size 1 the result is the input. Not ported: the reference's
        steady-state splits cache (ROADMAP A10), its hierarchical selection
        (A11) and its wire codec (A11: hierarchical buckets only)."""
        x = self._tensor(tensor)
        sub = self._consume_substitute()
        self._replay.observe("alltoall", sub, [x], name)
        if x.dim() == 0:
            raise ValueError("alltoall requires a tensor with dim 0")
        size, rank = self.backend.size(), self.backend.rank()
        d0 = int(x.shape[0])
        if splits is None:
            if d0 % size:
                raise ValueError(
                    f"alltoall without splits requires dim0 ({d0}) "
                    f"divisible by size ({size})")
            send = np.full(size, d0 // size, dtype=np.int64)
        else:
            send = np.asarray(torch.as_tensor(splits).cpu(),
                              dtype=np.int64).reshape(-1)
            if send.size != size or (send < 0).any():
                raise ValueError(f"splits must be {size} non-negative row "
                                 f"counts, got {send.tolist()}")
            if int(send.sum()) != d0:
                raise ValueError("splits must sum to tensor dim 0")
        name = self._register(name, "alltoall")
        self._join_sync("alltoall", [_join_meta_row(x, 0)], sub)
        if size == 1:
            recv = torch.from_numpy(send)
            return self._track(Handle(name, LaunchGroup(_StreamWork(x.device)),
                                      lambda: (x, recv), self))
        recv = self._exchange_rows(send)[:, rank]
        out = x.new_empty((int(recv.sum()),) + tuple(x.shape[1:]))
        work = _translate_failure(C.all_to_all, out, x.contiguous(),
                                  recv.tolist(), send.tolist(), None,
                                  async_op=True)
        self.dispatch_count += 1
        recv = torch.from_numpy(recv)
        return self._track(Handle(name, LaunchGroup(work),
                                  lambda: (out, recv), self))

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
        sub = self._consume_substitute()
        self._replay.observe("reducescatter", sub, [x], name)
        _check_average_dtype(x, op)
        if x.dim() == 0:
            raise ValueError("reducescatter requires a tensor with dim 0")
        name = self._register(name, "reducescatter")
        self._join_sync("reducescatter", [_join_meta_row(x, int(op))], sub)
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
        self.dispatch_count += 1
        n = size if op == ReduceOp.AVERAGE else 1
        group = LaunchGroup(work, lambda: C.finish_reduce(out, n, 1.0))
        h = Handle(name, group, lambda: out[:rows[rank]], self)
        h.recv_sizes = np.asarray(rows)
        return self._track(h)

    def shard_layout(self, total: int) -> tuple:
        """``(padded, shard)`` of ``total`` elements over this world
        (:func:`~..ops.collectives.shard_spec`): the ZeRO-1 padding rule."""
        return C.shard_spec(int(total), self.backend.size())

    def sharded_step(self, grads: Sequence, buckets: Sequence,
                     update: Callable[[], object],
                     name: Optional[str] = None,
                     op: ReduceOp = ReduceOp.AVERAGE,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     codec: Optional[str] = None):
        """One ZeRO-1 step over the world (the reference's :1911-2164,
        without the prefetch leg): for each of ``buckets``
        (:class:`~..ops.collectives.ShardBucket`, the caller's frozen
        layout, whose ``idxs`` index ``grads``) pack the gradients into its
        padded buffer (K1 under ``HOROVOD_PALLAS_PACK``), prescale,
        reduce-scatter into this rank's shard in place and finish it
        (Average's divide, the postscale); then ``update()`` (the wrapped
        optimizer's step on the shards); then all-gather every rank's
        updated shard into the bucket's parameter buffer in place. The host
        waits on no device work: each completion is a stream dependency.
        A bucket with a wire codec (``codec``, else
        ``HOROVOD_TPU_COMPRESSION``) runs the compressed reduce-scatter, its
        residual covering the whole padded bucket; the parameter
        all-gather stays full precision (the reference's :1956-2050).

        Inside a step the first half reports to replay as kind
        ``sharded_step``; a step that is one sharded step arms after the
        warm-up, and its packs, reduce-scatters and finishes then run as
        the armed program (one CUDA graph on the card). ``update`` always
        runs eagerly: an optimizer reads its hyperparameters as Python
        numbers at every step. At size > 1 with join live the step's join
        round is read first (a wait for the peers), and a joined peer makes
        every rank raise :data:`SHARDED_JOIN_ERROR`."""
        grads = [self._tensor(g) for g in grads]
        if not grads:
            raise ValueError("sharded_step needs at least one gradient")
        sub = self._consume_substitute()
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(
                f"sharded_step supports Sum and Average, got {op!r}")
        for g in grads:
            _check_average_dtype(g, op)
        call_codec = self._call_codec(codec, op)
        r = self._replay.intercept("sharded_step", grads, int(op),
                                   prescale_factor, postscale_factor, name,
                                   sub, layout=buckets, codec=call_codec)
        if r is not None:
            # the armed program ran the first half (its one dispatch
            # covers the gathers too); this orders the stream after it
            r[0].synchronize()
            update()
            _translate_failure(C.gather_shards, buckets, None)
            return
        for i in range(len(grads)):
            self._register(None if name is None else f"{name}.{i}",
                           "sharded_step")
        self._join_guard("sharded_step")
        n = self.backend.size() if op == ReduceOp.AVERAGE else 1
        codecs = self._bucket_codecs("sharded_step",
                                     [b.grads.dtype for b in buckets],
                                     call_codec)
        residuals = self._sharded_residuals(buckets, codecs)
        self.dispatch_count += _translate_failure(
            C.scatter_shards, buckets, grads, self.config.pack_kernel, n,
            prescale_factor, postscale_factor, None, True, codecs, residuals)
        update()
        self.dispatch_count += _translate_failure(C.gather_shards, buckets,
                                                  None)

    def _sharded_residual_key(self, bucket, codec: str) -> Optional[tuple]:
        """The residual of a sharded step's bucket (``cls`` "sharded": the
        whole padded bucket), keyed by the bucket's own token, as the
        reference keys it by its optimizer's."""
        elems = C.codec_residual_elems("sharded", bucket.total, bucket.n,
                                       codec)
        if elems is None:
            return None
        return ("zrs", "", bucket.token, codec, elems,
                str(bucket.grads.dtype))

    def _sharded_residuals(self, buckets, codecs) -> Optional[list]:
        """Each bucket's residual buffer (None without error feedback), or
        None when no bucket has a codec."""
        if all(c == comp.CODEC_NONE for c in codecs):
            return None
        keys = [self._sharded_residual_key(b, c)
                for b, c in zip(buckets, codecs)]
        bufs = self._fetch_residuals([(i, k, k[4], b.grads.dtype)
                                      for i, (b, k) in enumerate(zip(buckets,
                                                                     keys))
                                      if k is not None])
        return [bufs.get(i) for i in range(len(buckets))]

    def track_result(self, name: str, out: torch.Tensor) -> Handle:
        """Register ``out``, computed under the name ``name`` on this
        process's current stream (the Adasum path), as a handle: it
        completes when the stream has run that work."""
        return self._track(Handle(name, LaunchGroup(_StreamWork(out.device)),
                                  lambda: out, self))

    def barrier(self):
        """Blocks until every rank has reached it."""
        sub = self._consume_substitute()
        self._replay.observe("barrier", sub)
        self._join_sync("barrier", [], sub)
        z = torch.zeros(1, dtype=torch.int32, device=self.backend.device)
        _translate_failure(dist.all_reduce, z)
        self.dispatch_count += 1
        z.item()  # host-side completion on every backend

    # -- join (the reference's :1279-1480) ---------------------------------

    def join(self) -> int:
        """This rank is out of data: match the other ranks' collectives with
        zero tensors until every rank has joined. Returns the last rank to
        join, the same on every rank: the one that served the fewest
        rounds, the highest such rank on a tie. 0 at size 1; ``size - 1``
        under ``HOROVOD_JOIN_DISABLE=1``, where join is a barrier. Every
        armed replay stream is dropped first: the world enters a ragged
        phase (the reference's :1331)."""
        self._replay.invalidate_all("join() entered")
        size = self.backend.size()
        if size <= 1:
            return 0
        if not self.config.join_enabled:
            self.barrier()
            return size - 1
        return self._join_loop(size)

    def _join_loop(self, size: int) -> int:
        slots = self.config.join_meta_slots
        rounds = 0
        while True:
            head = self._exchange_rows(self._join_head(1, rounds, 0, []))
            joined = head[:, 0] == 1
            if joined.all():
                least = head[:, 1].min()
                return max(r for r in range(size) if head[r, 1] == least)
            act = int(np.argmin(joined))   # the first active rank
            kind_code, k = int(head[act, 2]), int(head[act, 3])
            metas = head[act, 4:4 + min(k, slots) * _JOIN_META_LEN] \
                .reshape(-1, _JOIN_META_LEN)
            if k > slots:
                rest = self._exchange_rows(np.zeros(
                    (k - slots) * _JOIN_META_LEN, dtype=np.int64))
                metas = np.concatenate(
                    [metas, rest[act].reshape(-1, _JOIN_META_LEN)])
            dead_root = None
            if kind_code in (_KIND_CODES["broadcast"],
                             _KIND_CODES["grouped_broadcast"]):
                root = int(metas[0][0])
                if head[root, 0] == 1:
                    # the active ranks' call still has to be matched (their
                    # root flag reads 0 and they raise); then this rank
                    # raises too
                    dead_root = root
            self._dispatch_substitute(kind_code, metas)
            if dead_root is not None:
                raise HorovodInternalError(
                    f"broadcast root rank {dead_root} has already joined; "
                    f"it has no data to broadcast")
            rounds += 1

    def _dispatch_substitute(self, kind_code: int, metas: np.ndarray):
        """Run the advertised collective with zero tensors through the
        engine method the active ranks ran, so every internal exchange and
        collective lines up (tensor_queue.h:39-41)."""
        kind = _CODE_KINDS.get(kind_code)
        if kind is None:
            raise HorovodInternalError(
                f"unknown substitute kind code {kind_code}")
        if kind == "sharded_step":
            # this rank owns a shard: a zero substitute would publish it
            # stale into every peer's parameters. The active ranks read
            # this round too (_join_guard) and raise the same error
            raise HorovodInternalError(SHARDED_JOIN_ERROR)
        dev = self.backend.device

        def zero(row):
            shape = tuple(int(d) for d in row[3:3 + int(row[2])])
            return torch.zeros(shape, dtype=_CODE_DTYPES[int(row[1])],
                               device=dev)

        self._join_substitute = True
        if kind == "barrier":
            self.barrier()
            return
        arg = int(metas[0][0])
        if kind == "allreduce":
            # the op field carries the call codec: the substitute runs the
            # active ranks' compressed program (the reference's :1412-1429)
            op, codec = _split_op_field(arg)
            hs = [self.allreduce(zero(metas[0]), op=op, codec=codec)]
        elif kind == "grouped_allreduce":
            op, codec = _split_op_field(arg)
            hs = self.grouped_allreduce([zero(r) for r in metas], op=op,
                                        codec=codec)
        elif kind == "adasum":
            from ..ops.adasum import adasum_allreduce_handle
            hs = [adasum_allreduce_handle(self, zero(metas[0]))]
        elif kind == "allgather":
            hs = [self.allgather(zero(metas[0]))]
        elif kind == "broadcast":
            hs = [self.broadcast(zero(metas[0]), root_rank=arg)]
        elif kind == "grouped_broadcast":
            hs = self.grouped_broadcast([zero(r) for r in metas],
                                        root_rank=arg)
        elif kind == "reducescatter":
            hs = [self.reducescatter(zero(metas[0]), op=ReduceOp(arg))]
        else:   # alltoall: the rows spread evenly, the first ranks one more
            z = zero(metas[0])
            base, rem = divmod(int(z.shape[0]), self.backend.size())
            hs = [self.alltoall(z, splits=[
                base + (r < rem) for r in range(self.backend.size())])]
        for h in hs:
            h.synchronize()

    def _consume_substitute(self) -> bool:
        sub = self._join_substitute
        self._join_substitute = False
        return sub

    def _join_head(self, flag: int, rounds: int, kind_code: int,
                   metas) -> np.ndarray:
        """The fixed-shape round: [flag, rounds, kind, k, the first
        ``join_meta_slots`` metadata rows, zero padding]."""
        slots = self.config.join_meta_slots
        vec = np.zeros(4 + slots * _JOIN_META_LEN, dtype=np.int64)
        vec[0:4] = (flag, rounds, kind_code, len(metas))
        if metas:
            inline = np.concatenate(metas[:slots])
            vec[4:4 + inline.size] = inline
        return vec

    def _join_sync(self, kind: str, metas, sub: bool):
        """Post this collective's join round, and the overflow rows when
        there are more than the round holds; nothing for a substitute,
        whose round ran in :meth:`_join_loop`, or at size 1."""
        if sub or not self.config.join_enabled or self.backend.size() <= 1:
            return
        slots = self.config.join_meta_slots
        self._post_exchange(self._join_head(0, 0, _KIND_CODES[kind], metas))
        if len(metas) > slots:
            self._post_exchange(np.concatenate(metas[slots:]))

    def _join_guard(self, kind: str):
        """The round of a collective no zero substitute can stand in for (a
        sharded step): posted as :meth:`_join_sync` posts one, with no
        metadata rows, but read here before any of the collective's
        exchanges. A rank in :meth:`join` reads the same round and raises,
        and so does every active rank here, so nothing is exchanged and
        no rank hangs. On the card the round runs on a side stream: the
        read waits for the peers, not for the work queued on the current
        stream."""
        if not self.config.join_enabled or self.backend.size() <= 1:
            return
        vec = self._join_head(0, 0, _KIND_CODES[kind], [])
        if self.backend.device.type == "cuda":
            if self._guard_stream is None:
                self._guard_stream = torch.cuda.Stream(self.backend.device)
            with torch.cuda.stream(self._guard_stream):
                rows = self._exchange_rows(vec)
        else:
            rows = self._exchange_rows(vec)
        if (rows[:, 0] == 1).any():
            raise HorovodInternalError(SHARDED_JOIN_ERROR)

    def _root_flag(self, root_rank: int, sub: bool):
        """Under join at size > 1 broadcast the root's active flag (0 from
        a joined root's substitute) after a broadcast's data: returns the
        flag's work objects and a check that waits for the flag and raises
        on the active ranks when the root had joined (the reference's
        ``build_broadcast_flagged``). A substitute does not check: its
        join loop raises."""
        if not self.config.join_enabled or self.backend.size() <= 1:
            return [], lambda: None
        flag = torch.full((1,), 0 if sub else 1, dtype=torch.int32,
                          device=self.backend.device)
        work = _translate_failure(dist.broadcast, flag, src=root_rank,
                                  async_op=True)
        state = {}

        def root_active():
            if sub:
                return
            if "ok" not in state:
                work.wait()
                state["ok"] = int(flag.item()) == 1
            if not state["ok"]:
                raise HorovodInternalError(
                    f"broadcast root rank {root_rank} has already joined "
                    f"and has no data to broadcast")

        return [work], root_active

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
        return self._exchange_rows(np.array([d0]))[:, 0].tolist()

    def _exchange_rows(self, vec: np.ndarray) -> np.ndarray:
        """Allgather of every rank's int64 vector (one length on every
        rank), read on the host: (size, len)."""
        mine = torch.from_numpy(np.ascontiguousarray(vec, dtype=np.int64))
        mine = mine.to(self.backend.device)
        out = mine.new_empty(self.backend.size() * mine.numel())
        _translate_failure(C.all_gather, out, mine, None)
        return out.cpu().numpy().reshape(self.backend.size(), -1)

    def _post_exchange(self, vec: np.ndarray):
        """The same allgather, posted and never read (a join round on an
        active rank): on the card the vector goes through a pinned host
        buffer and an async copy, so nothing waits on the host; its tensors
        are kept until the work completes."""
        while self._posted and self._posted[0][0].is_completed():
            self._posted.popleft()
        mine = torch.from_numpy(vec)
        keep = [mine]
        if self.backend.device.type == "cuda":
            mine = mine.pin_memory()
            keep.append(mine)
            mine = mine.to(self.backend.device, non_blocking=True)
        out = mine.new_empty(self.backend.size() * mine.numel())
        work = _translate_failure(C.all_gather, out, mine, None,
                                  async_op=True)
        self._posted.append((work, keep + [mine, out]))


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
