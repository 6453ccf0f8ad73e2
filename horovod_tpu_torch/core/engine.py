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
raises. A grouped alltoall's substitute (kind 11) is a zero group of the
advertised shapes, whose buckets and exchanges are the active ranks'.

ZeRO-1 (the reference's ``sharded_step``, :1911-2164): per bucket of the
caller's frozen layout, K1 packs the gradients into a padded buffer and a
reduce-scatter sums it into this rank's shard in place; the caller's
update steps the shards; an all-gather writes every rank's shard into the
flat parameter buffer in place (``ops/collectives.py``), as the prefetch
leg under the staged schedule.

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

Algorithm selection (the reference's :396-413, :646-738, :775-795): the
engine resolves its :class:`~..parallel.mesh.Topology` at init (host names
gathered once at size > 1), agrees on whether every rank sees the same
two-level layout (``_hierarchical_ok``, one allgather of the local sizes)
and creates every process group a selection can need, on every rank in
one order: the local and cross groups when the world factorizes, the pair
groups of every tree round when its size is a power of two. Each fusion
bucket of a Sum or Average then picks flat, tree or the ladder
(``_choose_algo``, ``ops/collectives.py`` ``choose_algorithm``); a codec
bucket on the ladder runs the codec's hierarchical arm; allgather picks
flat or the two-level gather; an alltoall whose exchanged splits matrix is
uniform picks flat or the two-phase exchange, with
``HOROVOD_TPU_ALLTOALL_CODEC`` on its cross phase; a sharded step's
all-gather picks per bucket while its reduce-scatter stays flat. The
choice is a function of the advertised shapes, the topology and the
knobs, so a joined rank's zero substitute runs the same programs.
``algo_selections[(kind, algo)]`` (a bucket each), ``link_bytes[link]``
(``link_split``'s attribution of each bucket), ``codec_selections`` and
``residual_invalidations`` are the engine's own tallies; the metric
instruments beside them count by the reference's rules.

Observability (the reference's :368-446, :950-1033, :1245-1270,
:1486-1577): every call counts into the metrics registry (``metrics.py``)
before replay sees it, as the reference does: ``hvd_tpu_collectives_total``
by kind, ``hvd_tpu_wire_bytes_total`` by kind, dtype and link (each tensor
split by its bucket's algorithm and codec, per ``link_split``),
``hvd_tpu_collective_algo_total`` and ``hvd_tpu_compression_codec_total``
(a bucket each, at size > 1 where the reference counts them),
``hvd_tpu_compression_bytes_saved_total``, the fusion-bucket counters and
fill gauge, and ``hvd_tpu_dispatches_total`` beside ``dispatch_count``. A
launch's handles complete together where the host learns that the launch
is done (the first ``poll`` or ``synchronize`` of any of them), and their
enqueue-to-complete latencies are observed there, so no instrument adds a
host-device synchronization; a grouped call's trace stamps, like its
completions, take the recorder's lock once. With tracing on (``engine.trace``, a
:class:`~..trace.TraceRecorder`) each submission is stamped with its
correlation id and its launch and completion recorded; the hooks
``on_enqueue``, ``on_done``, ``on_activity`` and ``on_replay`` feed the
timeline and the stall inspector; ``health`` (the step-health monitor)
runs at ``step_end``. Failpoints ``engine.enqueue`` (registration),
``engine.dispatch`` (each launch), ``engine.complete`` (``synchronize``)
and ``compression.encode`` (each compressed launch) sit where the
reference's do. :meth:`Engine.poison` (the collective watchdog's
escalation) makes every later submission, ``synchronize`` and ``join``
raise. With ``HOROVOD_TPU_DEBUG_CONSISTENCY=1`` every collective first
allgathers a fingerprint of its name, kind, op, dtype and shape
(:meth:`Engine._debug_check`) and every rank raises the same error on a
mismatch; a joined rank's zero substitute sends wildcard rows.

Launch shapes and overlap (the reference's :1065-1160, :1806-1850,
:2050-2160): with ``HOROVOD_TPU_SINGLE_LAUNCH`` on (the default) and the
pack kernel off, a grouped allreduce packs every bucket into one buffer
with one plain pack (a codec's or the ladder's padded bucket into its
own) and issues the buckets' collectives back to back; with
``HOROVOD_PALLAS_PACK=1`` each bucket is packed (K1) and reduced in turn.
:meth:`Engine._overlap_mode` resolves ``HOROVOD_TPU_OVERLAP_PIPELINE``
for a step (off, interleave, staged; auto by bytes, buckets and world),
and replay arms its program in that mode (``core/replay.py``). Under
staged with ``HOROVOD_TPU_ZERO1_PREFETCH`` on, a sharded step's
all-gathers after the update are the prefetch leg, held in
``_zero1_prefetch`` across the step boundary and dropped by a
world-version bump, ``join()`` or a reset
(:meth:`Engine.invalidate_prefetch`); the values are those of the
unsplit step. ``hvd_tpu_overlap_*`` count stages, steps and legs.

The steady-state size cache (the reference's :2681-2780): allgather's
sizes and the uneven alltoall's splits matrix are exchanged under their
name's hash; after ``HOROVOD_TPU_META_CACHE_WARMUP`` identical exchanges
the exchange is posted, not read, the collective is built from the cached
world, and the posted world is checked when the result is read. A
mismatch raises :class:`HorovodInternalError` on every rank (the rank
whose sizes changed knows it at once) and the next call negotiates
again. ``host_fetches`` counts the blocking host reads of a metadata
exchange, ``deferred_meta_checks`` the checks.

Not ported yet: the calibration probe and autotune (ROADMAP A15).
"""

from __future__ import annotations

import collections
import datetime
import hashlib
import logging
import os
import socket
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import env as env_mod
from ..common.exceptions import (ConsistencyError, DuplicateNameError,
                                 HorovodInternalError,
                                 TensorDtypeMismatchError,
                                 TensorShapeMismatchError)
from ..common.lru import lru_put, lru_touch
from ..common.reduce_ops import ReduceOp
from ..faults import failpoint
from ..metrics import registry as metrics_registry
from ..ops import collectives as C
from ..ops import compression as comp
from ..parallel.mesh import detect_topology
from .backend import Backend, new_group
from .replay import _DIGITS, StepReplay

logger = logging.getLogger("horovod_tpu_torch")

_warned_demotions: set = set()


def _demote(key: tuple, msg: str):
    """One WARNING per process and reason that a collective runs flat (the
    reference's ``_demote``, ``horovod_tpu/ops/collectives.py``): the
    engine's own, for a forced form a world of one rank cannot express."""
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


def _wait_bound() -> Optional[datetime.timedelta]:
    """The running world's bound on a completion wait
    (``Backend.wait_timeout``: an elastic NCCL world's, None elsewhere)."""
    from .state import global_state
    return global_state().backend.wait_timeout


class LaunchGroup:
    """Shared completion latch for every handle born from one collective
    launch: its work objects (one, or a list) are waited once and the
    finish step (Average divide, postscale) runs once, whichever handle
    gets there first; then every handle of the launch (``handles``)
    completes at once."""

    _GUARDED_BY = {"_done": "_lock"}

    def __init__(self, work, finish: Optional[Callable[[], None]] = None):
        self._works = list(work) if isinstance(work, (list, tuple)) \
            else [work]
        self._finish = finish
        self._done = False
        self._lock = threading.Lock()
        self.handles: List["Handle"] = []

    def ready(self) -> bool:
        # lockcheck: ignore[double-checked fast path: _done only transitions False->True, a stale read just re-polls]
        if self._done:
            return True
        if not all(_translate_failure(w.is_completed) for w in self._works):
            return False
        self.wait()
        return True

    def wait(self):
        with self._lock:
            if not self._done:
                timeout = _wait_bound()
                for w in self._works:
                    if timeout is not None and \
                            isinstance(w, dist.Work) and \
                            not torch.cuda.is_current_stream_capturing():
                        _translate_failure(w.wait, timeout)
                    else:
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
            timeout = _wait_bound()
            if timeout is not None and \
                    not torch.cuda.is_current_stream_capturing():
                # an elastic world's bounded wait (Backend.wait_timeout)
                deadline = time.monotonic() + timeout.total_seconds()
                pause = 5e-5
                while not self._event.query():
                    if time.monotonic() > deadline:
                        raise HorovodInternalError(
                            f"a collective did not complete within "
                            f"{timeout.total_seconds():.0f} s (a peer died "
                            f"or stopped contributing)")
                    time.sleep(pause)
                    pause = min(2 * pause, 1e-3)
            torch.cuda.current_stream(self._device).wait_event(self._event)


_DTYPE_NAMES: Dict[torch.dtype, str] = {}


def _dtype_name(dtype: torch.dtype) -> str:
    """The reference's dtype label (``float32``, ``bfloat16``), the one the
    metric series and the consistency fingerprint carry."""
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype).removeprefix("torch.")
    return name


class Handle:
    """Async op handle: completion is its launch group's; the result is
    extracted once, after it. ``kind`` labels its enqueue-to-complete
    latency (None: not observed)."""

    def __init__(self, name: str, group: LaunchGroup, extract: Callable,
                 engine: "Engine", kind: Optional[str] = None):
        self.name = name
        self.kind = kind
        self._group = group
        self._extract = extract
        self._engine = engine
        self._done = False
        self._result = None
        self._error = None
        self._finish_lock = threading.Lock()
        self._enqueue_mono = time.monotonic()
        self.recv_sizes = None  # per-rank dim-0 sizes for allgather results
        group.handles.append(self)

    def poll(self) -> bool:
        group = self._group   # None once finished
        if group is not None and not self._done and group.ready():
            self._engine._complete_group(group)
        return self._done

    def synchronize(self):
        # the user-visible completion edge: a hang armed here stalls the
        # training loop as a peer that stopped contributing would
        failpoint("engine.complete")
        self._engine._check_poison()
        group = self._group   # None once finished
        if group is not None and not self._done:
            group.wait()
            self._engine._complete_group(group)
        if self._error is not None:
            raise self._error
        return self._result

    def _finish(self) -> bool:
        """Extract the result once; True if this call did."""
        with self._finish_lock:
            if self._done:
                return False
            try:
                self._result = self._extract()
            # the error stays on the handle: every later synchronize()
            # re-raises it (handle-manager semantics)
            except Exception as e:  # noqa: BLE001
                self._error = e
            self._done = True
            # the group lists its handles: dropping it here breaks the
            # cycle, so a launch's buffers go with its last handle
            self._group = None
            return True


class HandleManager:
    """int handle -> :class:`Handle` map (the reference's, parity:
    torch/handle_manager.{h,cc})."""

    _GUARDED_BY = {"_next": "_lock", "_handles": "_lock"}

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
_KIND_CODES = {"allreduce": 1, "grouped_allreduce": 2, "allgather": 3,
               "broadcast": 4, "alltoall": 5, "reducescatter": 6,
               "barrier": 7, "adasum": 8, "grouped_broadcast": 9,
               "sharded_step": 10, "grouped_alltoall": 11}
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

    # lock discipline (analysis/lockcheck.py): the outstanding table and
    # the residuals are shared with handle completion; the ZeRO-1 prefetch
    # registry is written on the dispatch path and cleared from the
    # replay, join and elastic invalidation edges. Everything else (the
    # size cache, replay state, counters) is the dispatching thread's
    _GUARDED_BY = {
        "_outstanding": "_lock",
        "_residuals": "_lock",
        "_zero1_prefetch": "_lock",
    }

    def __init__(self, backend: Backend, config: env_mod.Config):
        self.backend = backend
        self.config = config
        if backend.wait_timeout is not None and \
                env_mod.HOROVOD_TPU_STEP_REPLAY not in os.environ:
            # a collective launched inside a CUDA graph is invisible to
            # the NCCL watchdog and its wait: a dead peer would hang the
            # replayed step for good. An elastic NCCL world replays only
            # when HOROVOD_TPU_STEP_REPLAY asks for it
            config.step_replay = False
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
        # otherwise, one a replayed step (one a stage of a staged one)
        self.dispatch_count = 0
        # blocking host reads of a metadata exchange (_exchange_rows): the
        # steady-state allgather and uneven alltoall must not grow this
        self.host_fetches = 0
        # the steady-state size cache (the reference's ResponseCache role,
        # response_cache.h:45-102): (kind, name hash) -> the last world
        # observation, this rank's own row and the streak; a hot entry
        # posts its exchange and checks it when the result is read
        self._meta_cache: Dict[tuple, dict] = {}
        # those extract-time checks of a posted exchange
        self.deferred_meta_checks = 0
        # metrics registry instruments (metrics.py). With
        # HOROVOD_TPU_METRICS=0 every one is a shared lock-free no-op and
        # _m_enabled short-circuits the bookkeeping branches
        _reg = metrics_registry()
        self._m_enabled = _reg.enabled
        self._m_dispatches = _reg.counter("hvd_tpu_dispatches_total")
        self._m_wire = _reg.counter("hvd_tpu_wire_bytes_total")
        self._m_collectives = _reg.counter("hvd_tpu_collectives_total")
        self._m_buckets = _reg.counter("hvd_tpu_fusion_buckets_total")
        self._m_bucket_bytes = _reg.counter(
            "hvd_tpu_fusion_bucket_bytes_total")
        self._m_fill = _reg.gauge("hvd_tpu_fusion_bucket_fill_pct")
        self._m_latency = _reg.histogram("hvd_tpu_op_latency_seconds")
        self._m_algo = _reg.counter("hvd_tpu_collective_algo_total")
        self._m_codec = _reg.counter("hvd_tpu_compression_codec_total")
        self._m_saved = _reg.counter("hvd_tpu_compression_bytes_saved_total")
        self._m_res_inval = _reg.counter(
            "hvd_tpu_compression_residual_invalidations_total")
        # the bucket-pipelined overlap (Engine._overlap_mode): the held
        # ZeRO-1 all-gather prefetch legs, update key -> {"world_version"}
        # (the leg's buffers are the layout's own: the row is only the
        # accounting), and the latch that counts one overlap step a
        # bracketed step
        self._zero1_prefetch: Dict[tuple, dict] = {}
        self._in_step_bracket = False
        self._overlap_step_noted = False
        self._m_overlap_stages = _reg.counter(
            "hvd_tpu_overlap_stage_launches_total")
        self._m_overlap_steps = _reg.counter("hvd_tpu_overlap_steps_total")
        self._m_prefetch = _reg.counter("hvd_tpu_overlap_prefetch_total")
        self._m_prefetch_inval = _reg.counter(
            "hvd_tpu_overlap_prefetch_invalidations_total")
        # the trace recorder (trace.py) and the step-health monitor
        # (observability/), wired by GlobalState; None when switched off
        self.trace = None
        self.health = None
        # observability hooks, wired by GlobalState: the timeline and the
        # stall inspector
        self.on_enqueue: Optional[Callable[[str, str, int], None]] = None
        self.on_done: Optional[Callable[[str], None]] = None
        self.on_activity: Optional[Callable[[str, str, float], None]] = None
        self.replay_fallback_counter: Optional[Callable[[str], None]] = None
        # a rank parked in join() stops advancing its heartbeat on purpose
        self.on_join_state: Optional[Callable[[bool], None]] = None
        # completed steps (step_end), and the hook called with the count
        # after each one (GlobalState wires it to the checkpoint manager's
        # on_step: interval snapshots ride the step boundary, never the
        # step body)
        self.step_index = 0
        self.on_step_complete: Optional[Callable[[int], None]] = None
        # the collective watchdog's escalation: once set, every submission,
        # synchronize and join raises it
        self._poison: Optional[Exception] = None
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
        # plain counters of the algorithm selection: buckets by (kind,
        # algo) and submitted bytes by fabric link (link_split)
        self.algo_selections = collections.Counter()
        self.link_bytes = collections.Counter()
        # the topology, resolved once (an elastic reset builds a new
        # engine), and the process groups its algorithms run on
        size = backend.size()
        hosts = None
        if size > 1:
            hosts = self._exchange_rows(np.array([_host_key()]))[:, 0]
        self.topology = detect_topology(
            size, backend.local_size(),
            None if hosts is None else hosts.tolist(),
            "gpu" if backend.device.type == "cuda" else "cpu")
        self._tree_groups: Optional[list] = None
        # ids of the groups a captured program has warmed (every group a
        # graph's leg runs on ran a collective eagerly first)
        self._warmed: set = set()
        if size > 1:
            # agreed here, where every rank arrives before any collective,
            # so no join() loop or replay capture is ever what runs it
            self._hierarchical_ok()
            self._make_groups()

    # -- internals ---------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.backend.device)

    def _auto_name(self, kind: str) -> str:
        n = self._auto_counter.get(kind, 0)
        self._auto_counter[kind] = n + 1
        return f"{kind}.noname.{n}"

    def _claim(self, name: Optional[str], kind: str) -> str:
        """A submission's name (``name`` or an auto name), checked: every
        collective submission funnels through here, the failpoint of "this
        rank's op never starts"."""
        failpoint("engine.enqueue")
        self._check_poison()
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

    def _register_many(self, names, kind: str, tensors,
                       links=None) -> List[str]:
        """:meth:`_register` for a grouped call's tensors (``names`` the
        caller's, a None entry auto-named): each name checked, then the
        trace's stamps under one lock, then the hooks."""
        names = [self._claim(n, kind) for n in names]
        nbytes = [t.nbytes for t in tensors]
        if self.trace is not None:
            self.trace.record_enqueue_many(names, kind, nbytes,
                                           self.world_version, links)
        if self.on_enqueue is not None:
            for n, b in zip(names, nbytes):
                self.on_enqueue(n, kind, b)
        return names

    def _register(self, name: Optional[str], kind: str, nbytes: int = 0,
                  link_bytes: Optional[dict] = None) -> str:
        name = self._claim(name, kind)
        if self.trace is not None:
            # stamp the correlation id BEFORE the on_enqueue hook, so the
            # timeline tags its span with trace.live_corr(name)
            self.trace.record_enqueue(name, kind, nbytes, self.world_version,
                                      link_bytes=link_bytes)
        if self.on_enqueue is not None:
            self.on_enqueue(name, kind, nbytes)
        return name

    def _track(self, h: Handle) -> Handle:
        with self._lock:
            self._outstanding[h.name] = h
        return h

    def _complete_group(self, group: LaunchGroup):
        """A launch's work is done (the host learns it here, at a poll or a
        synchronize): every handle of the launch not finished yet extracts
        its result, leaves the outstanding table and is reported complete,
        together: the latencies, the trace and the hooks see the launch's
        handles at once."""
        done = [h for h in group.handles if h._finish()]
        if not done:
            return
        with self._lock:
            for h in done:
                if self._outstanding.get(h.name) is h:
                    del self._outstanding[h.name]
        if self._m_enabled:
            now = time.monotonic()
            by_kind: Dict[str, list] = {}
            for h in done:
                if h.kind is not None:
                    by_kind.setdefault(h.kind, []).append(
                        now - h._enqueue_mono)
            for kind, waits in by_kind.items():
                self._m_latency.observe_many(waits, kind=kind)
        self._note_done([h.name for h in done])

    def _note_done(self, names):
        """The completion edge of ``names`` for the trace and the hooks."""
        if self.trace is not None:
            self.trace.record_done_many(names)
        if self.on_done is not None:
            for n in names:
                self.on_done(n)

    def poison(self, err: Exception):
        """Mark the engine dead (the collective watchdog's escalation):
        every later submission, synchronize, barrier or join raises
        ``err``. Irreversible for this engine: an elastic reset builds a
        new one."""
        self._poison = err

    def _check_poison(self):
        if self._poison is not None:
            raise self._poison

    # -- launches and their accounting (the reference's _dispatch,
    # _m_account, _tensor_links, _m_codec_saved, _m_buckets_obs) ----------

    def _pre_launch(self) -> float:
        """Before a collective launch: the ``engine.dispatch`` failpoint (a
        hang here models a peer wedged mid-launch: the op is already in the
        outstanding table, so the watchdog can escalate), then the start
        time of the launch when anything records its span."""
        failpoint("engine.dispatch")
        if self.trace is not None or self.on_activity is not None:
            return time.perf_counter()
        return 0.0

    def _count_dispatch(self, n: int = 1):
        """``n`` engine-issued launches: ``dispatch_count`` and
        ``hvd_tpu_dispatches_total``."""
        self.dispatch_count += n
        self._m_dispatches.inc(n)

    def _launched(self, names, t0: float, n: int = 1,
                  activity: str = "XLA_DISPATCH"):
        """After ``n`` collective launches for ``names``: count them, and
        record the launch span of each name (the reference's activity names,
        which the trace tools read)."""
        self._count_dispatch(n)
        if self.trace is None and self.on_activity is None:
            return
        dur = time.perf_counter() - t0
        if isinstance(names, str):
            names = [names]
        if self.trace is not None:
            self.trace.record_dispatch(names, activity, dur)
        if self.on_activity is not None:
            for nm in names:
                self.on_activity(nm, activity, dur * 1e6)

    def _m_account(self, kind: str, tensors, links=None):
        """Wire-byte accounting at submission: the payload bytes this rank
        hands to the collective, by op kind, dtype and fabric link (each
        tensor split by ``links``, else all of it on link "flat"), summed
        per series before it meets the counter's lock. Counted before
        replay interception: a replayed step moves the same bytes."""
        if not self._m_enabled:
            return
        self._m_collectives.inc(1.0, kind=kind)
        self._m_wire_bytes(kind, tensors, links)

    def _m_wire_bytes(self, kind: str, tensors, links=None):
        """:meth:`_m_account`'s wire bytes, without the call's count (a
        sharded step counts each leg under its own kind)."""
        per = {}
        for i, t in enumerate(tensors):
            dt = _dtype_name(t.dtype)
            split = links[i] if links else None
            if split:
                for link, b in split.items():
                    if b:
                        per[(dt, link)] = per.get((dt, link), 0) + b
            else:
                per[(dt, "flat")] = per.get((dt, "flat"), 0) + t.nbytes
        for (dt, link), b in per.items():
            self._m_wire.inc(b, kind=kind, dtype=dt, link=link)

    def _tensor_links(self, kind: str, tensors, buckets, algos, codecs=None,
                      size: int = 0):
        """Each tensor's link-byte split (its bucket's algorithm and codec,
        per ``link_split``), for wire accounting and trace stamping; None
        where nobody consumes it (size <= 1, or metrics and tracing both
        off: the derivation must cost nothing on a quiet path)."""
        if self.topology.size <= 1 or not tensors:
            return None
        if not self._m_enabled and self.trace is None:
            return None
        codecs = codecs or (comp.CODEC_NONE,) * len(buckets)
        local = self.topology.local_size
        links = [None] * len(tensors)
        for idxs, algo, codec in zip(buckets, algos, codecs):
            for i in idxs:
                t = tensors[i]
                if algo != C.ALGO_HIERARCHICAL and codec == comp.CODEC_NONE:
                    links[i] = {"flat": t.nbytes}
                else:
                    links[i] = C.link_split(algo, t.nbytes, local, kind=kind,
                                            codec=codec,
                                            itemsize=t.element_size(),
                                            size=size)
        return links

    def _m_codec_saved(self, kind: str, tensors, buckets, algos, codecs,
                       links=None, size: int = 0):
        """Wire bytes the codecs removed, by link: each encoded tensor's
        uncompressed split minus its encoded one."""
        if not self._m_enabled:
            return
        local = self.topology.local_size
        saved = {}
        for idxs, algo, codec in zip(buckets, algos, codecs):
            if codec == comp.CODEC_NONE:
                continue
            for i in idxs:
                t = tensors[i]
                orig = C.link_split(algo, t.nbytes, local, kind=kind,
                                    size=size)
                enc = (links[i] if links is not None and links[i]
                       else C.link_split(algo, t.nbytes, local, kind=kind,
                                         codec=codec,
                                         itemsize=t.element_size(),
                                         size=size))
                for link, b in orig.items():
                    d = b - enc.get(link, 0)
                    if d > 0:
                        saved[link] = saved.get(link, 0) + d
        for link, d in saved.items():
            self._m_saved.inc(d, link=link)

    def _m_buckets_obs(self, tensors, buckets):
        """Fusion-bucket fill efficiency of one grouped or sharded call."""
        if not self._m_enabled or not buckets:
            return
        total = 0
        for idxs in buckets:
            b = sum(tensors[i].nbytes for i in idxs)
            total += b
            self._m_bucket_bytes.inc(b)
        self._m_buckets.inc(len(buckets))
        thr = max(self.config.fusion_threshold_bytes, 1)
        self._m_fill.set(100.0 * total / (len(buckets) * thr))

    def _m_selections(self, kind: str, algos, codec_kind: Optional[str] = None,
                      codecs=(), call_codec: str = comp.CODEC_NONE):
        """The metric side of a call's selections: a bucket each by (kind,
        algo), and by (codec_kind, codec) where the call has a codec."""
        if not self._m_enabled:
            return
        for a in algos:
            self._m_algo.inc(kind=kind, algo=a)
        if codec_kind is not None and call_codec != comp.CODEC_NONE:
            for c in codecs:
                self._m_codec.inc(kind=codec_kind, codec=c)

    # -- debug-mode cross-rank consistency (controller.cc:380-623) ---------

    @staticmethod
    def _h63(s: str) -> int:
        return int.from_bytes(hashlib.md5(s.encode()).digest()[:8],
                              "little") >> 1

    _META_DIMS = 6

    def _debug_check(self, name: str, kind: str, tensors, op_code: int = -1,
                     check_dim0: bool = True, wildcard: bool = False):
        """With HOROVOD_TPU_DEBUG_CONSISTENCY=1, allgather a compact (name
        hash, kind, op, dtype, shape) fingerprint before the launch and
        raise the same descriptive error on every rank on any mismatch
        (the reference's :1498, standing in for the coordinator's
        submission validation). ``check_dim0=False`` exempts dim 0
        (allgather's and alltoall's per-rank row counts); a joined rank's
        zero substitute (``wildcard``) takes part with sentinel rows every
        rank skips."""
        if not self.config.debug_consistency or self.backend.size() <= 1:
            return
        rows = []
        for t in tensors:
            if wildcard:
                rows.append([-9] * (5 + self._META_DIMS))
                continue
            dims = [int(d) for d in t.shape[:self._META_DIMS]]
            dims += [-1] * (self._META_DIMS - len(dims))
            if not check_dim0 and t.dim():
                dims[0] = -2  # wildcard
            rows.append([self._h63(name), self._h63(kind), op_code,
                         self._h63(_dtype_name(t.dtype)), t.dim()] + dims)
        local = np.asarray(rows, dtype=np.int64).reshape(-1)
        world = self._exchange_rows(local)  # (size, k)
        me = self.backend.rank()
        if wildcard:
            return
        for r in range(world.shape[0]):
            if world[r][0] == -9:  # a joined rank's sentinel
                continue
            if (world[r] == world[me]).all():
                continue
            a = world[me].reshape(len(tensors), -1)
            b = world[r].reshape(len(tensors), -1)
            for i in range(len(tensors)):
                if (a[i] == b[i]).all():
                    continue
                loc = (f"rank {me}: name={name!r} kind={kind} op={op_code} "
                       f"dtype={_dtype_name(tensors[i].dtype)} "
                       f"shape={tuple(tensors[i].shape)}")
                if a[i][0] != b[i][0] or a[i][1] != b[i][1]:
                    raise ConsistencyError(
                        f"Mismatched collective submissions: rank {r} "
                        f"submitted a different tensor name or operation "
                        f"type at this call index ({loc}); every rank must "
                        f"submit the same named collectives in the same "
                        f"order (controller.cc:380-623)")
                if a[i][2] != b[i][2]:
                    raise ConsistencyError(
                        f"Mismatched reduce op for tensor {name!r}: rank {r} "
                        f"used op code {int(b[i][2])}, this rank "
                        f"{int(a[i][2])} ({loc})")
                if a[i][3] != b[i][3]:
                    raise TensorDtypeMismatchError(
                        f"Mismatched dtype for tensor {name!r}: rank {r} "
                        f"disagrees with this rank's "
                        f"{_dtype_name(tensors[i].dtype)} ({loc})")
                raise TensorShapeMismatchError(
                    f"Mismatched shape for tensor {name!r}: rank {r} sent "
                    f"ndim={int(b[i][4])} dims="
                    f"{[int(d) for d in b[i][5:] if d != -1]} vs this "
                    f"rank's {tuple(tensors[i].shape)} ({loc})")
            # rows differed but per-tensor comparison found no cause
            raise ConsistencyError(
                f"Mismatched collective submission metadata with rank {r} "
                f"for {name!r} ({kind})")

    # -- step-capture replay (core/replay.py) ------------------------------

    def step_begin(self):
        """Mark the start of one training step. Between step_begin and
        step_end the engine records the ordered collective stream; once the
        same signature repeats ``step_replay_warmup`` times, matching steps
        are serviced by the armed program (one CUDA graph on the card; see
        core/replay.py)."""
        if self.trace is not None:
            self.trace.record_step(begin=True)
        self._in_step_bracket = True
        self._overlap_step_noted = False
        self._replay.step_begin()

    def step_end(self):
        self._replay.step_end()
        self._in_step_bracket = False
        if self.trace is not None:
            self.trace.record_step(begin=False)
        self.step_index += 1
        if self.health is not None:
            self.health.on_step_end()
        if self.on_step_complete is not None:
            try:
                self.on_step_complete(self.step_index)
            except HorovodInternalError:
                # the recovery carrier reaches the elastic loop
                raise
            # errflow: ignore[the recovery carrier is re-raised by the clause above; any other hook failure (a snapshot the checkpoint manager cannot stamp) must not fail the completed step and is WARNING-logged]
            except Exception as e:
                logger.warning("step-complete hook failed: %r", e)

    @property
    def replay(self) -> StepReplay:
        return self._replay

    def _refresh_world_version(self) -> int:
        """Pick up an elastic world-version bump from
        ``HOROVOD_TPU_WORLD_VERSION``, which the rendezvous sets before any
        rank re-enters a step. The attribute only moves forward (tests may
        bump it directly)."""
        # divcheck: ignore[this re-read IS the replay re-arm edge: the rendezvous stamps the bump before any rank re-enters a step, and the value only moves forward]
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

    # -- bucket-pipelined overlap (the reference's :1065-1160) --------------

    def _overlap_mode(self, nbytes: int = 0, n_buckets: int = 1,
                      sharded: bool = False) -> str:
        """The collective schedule of one step: "off" (each bucket's pack,
        collective and finish in turn), "interleave" (every pack, then the
        collectives back to back, then the finishes) or "staged" (replay
        splits the step into per-bucket sub-launches). "auto" picks staged
        only when the world has peers, the step has more than one stage to
        overlap (several buckets, or a sharded step) and its bytes reach
        ``overlap_stage_bytes``; interleave otherwise. In a join-live world
        with peers staged demotes to interleave on every path: a joined
        peer's zero substitute services the advertisement with one grouped
        call. The eager path and replay's stage plan both resolve here, so
        the warm-up and the steady state pick the same schedule.

        On a CUDA device "auto" is off: every mode's launches go to the
        one stream the single graph uses, so a staged or interleaved
        schedule overlaps nothing there and staged adds a graph launch a
        bucket (PERF.md, phase 26). The explicit modes still pass
        through."""
        base = self.config.overlap_pipeline
        if base == "off" or (base == "auto"
                             and self.backend.device.type == "cuda"):
            return "off"
        mode = base
        if base == "auto":
            mode = ("staged"
                    if (self.backend.size() > 1 and (sharded or n_buckets > 1)
                        and nbytes >= self.config.overlap_stage_bytes)
                    else "interleave")
        if (mode == "staged" and self.config.join_enabled
                and self.backend.size() > 1):
            return "interleave"
        return mode

    def _note_overlap_step(self, mode: str) -> None:
        """Count a step serviced by a pipelined schedule: once a bracketed
        step (the latch), once a call outside the brackets. Replayed steps
        count in core/replay.py: interception returns before this path
        runs, so the two never count one step twice."""
        if self._in_step_bracket:
            if self._overlap_step_noted:
                return
            self._overlap_step_noted = True
        self._m_overlap_steps.inc(mode=mode)

    def _note_prefetch(self, update_key: tuple) -> None:
        """Record a launched ZeRO-1 all-gather prefetch leg, held across
        the step boundary. The row is retired, without counting an
        invalidation, when the next sharded step of ``update_key`` arrives
        (its gradients were computed from the leg's parameters: the leg
        was used); a world-version bump, ``join()`` or a reset drops it
        (:meth:`invalidate_prefetch`)."""
        with self._lock:
            self._zero1_prefetch[update_key] = {
                "world_version": self.world_version}
        self._m_prefetch.inc()

    def invalidate_prefetch(self, reason: str) -> None:
        """Drop every held prefetch leg (invalidate, never poison: the next
        sharded step gathers again)."""
        with self._lock:
            dropped = len(self._zero1_prefetch)
            self._zero1_prefetch.clear()
        if not dropped:
            return
        self._m_prefetch_inval.inc(dropped)
        self._emit_replay("prefetch-invalidate", reason)

    def _prefetch_gc(self) -> None:
        """Drop held legs of another world version (an elastic bump seen
        outside the step markers)."""
        v = self._refresh_world_version()
        with self._lock:
            stale = [k for k, ent in self._zero1_prefetch.items()
                     if ent["world_version"] != v]
            for k in stale:
                del self._zero1_prefetch[k]
        if stale:
            self._m_prefetch_inval.inc(len(stale))
            self._emit_replay("prefetch-invalidate",
                              f"world-version bump (-> {v})")

    def _reduce_launch(self, flat: torch.Tensor, op: ReduceOp,
                       prescale_factor: float,
                       postscale_factor: float,
                       algo: str = C.ALGO_FLAT,
                       total: Optional[int] = None) -> LaunchGroup:
        """Launch the in-place allreduce of one private flat buffer under
        ``algo``: one async ``all_reduce`` (flat, and every op other than
        Sum and Average), the tree's pair rounds, or the ladder on a
        buffer padded to the world size whose first ``total`` elements are
        the bucket (its tail zero)."""
        view = flat if total is None else flat[:total]
        C.prescale(view, prescale_factor)
        n = self.backend.size() if op == ReduceOp.AVERAGE else 1
        if algo == C.ALGO_FLAT or op not in (ReduceOp.SUM,
                                             ReduceOp.AVERAGE):
            work = _translate_failure(dist.all_reduce, flat,
                                      op=_dist_op(op), async_op=True)
            return LaunchGroup(
                work, lambda: C.finish_reduce(view, n, postscale_factor))
        if algo == C.ALGO_TREE:
            _translate_failure(C.tree_allreduce, flat, self._tree_groups)
        else:
            _translate_failure(C.hier_allreduce, flat,
                               *self.hierarchical_groups(),
                               *self._hier_sizes())
        return LaunchGroup(_StreamWork(flat.device),
                           lambda: C.finish_reduce(view, n,
                                                   postscale_factor))

    # -- algorithm selection (the reference's :646-738) --------------------

    def _choose_algo(self, kind: str, nbytes: int) -> str:
        """The algorithm of one collective of ``kind`` moving ``nbytes``
        (the reference's engine face of ``choose_algorithm``): the legacy
        ``HOROVOD_HIERARCHICAL_ALLREDUCE``/``_ALLGATHER`` act as a forced
        preference for their kind, alltoall has its own knob and
        threshold, and a hierarchical outcome also needs the agreed
        ``_hierarchical_ok``, read whatever this rank's own view says (a
        rank-local read could pick different programs on different ranks).
        A world of one rank runs every collective flat; a forced tree or
        hierarchical form says so once (a port addition: the reference
        is silent there)."""
        topo, cfg = self.topology, self.config
        if topo.size <= 1:
            self._note_single_rank(kind)
            return C.ALGO_FLAT
        hier_ok = self._hierarchical_ok()
        if kind == "alltoall":
            force = cfg.alltoall_algo
            if force != "auto":
                algo = C.validate_algorithm(kind, force, topo.size,
                                            topo.local_size)
            else:
                algo = C.choose_algorithm(
                    kind, nbytes, topo,
                    tree_threshold_bytes=cfg.tree_threshold_bytes,
                    hier_threshold_bytes=cfg.alltoall_hier_threshold_bytes)
        else:
            force = cfg.collective_algo
            if force != "auto":
                algo = C.validate_algorithm(kind, force, topo.size,
                                            topo.local_size)
            elif (kind == "allreduce" and cfg.hierarchical_allreduce
                  and hier_ok):
                algo = C.ALGO_HIERARCHICAL
            elif (kind == "allgather" and cfg.hierarchical_allgather
                  and hier_ok):
                algo = C.ALGO_HIERARCHICAL
            else:
                algo = C.choose_algorithm(
                    kind, nbytes, topo,
                    tree_threshold_bytes=cfg.tree_threshold_bytes,
                    hier_threshold_bytes=cfg.hier_threshold_bytes)
        if algo == C.ALGO_HIERARCHICAL and not hier_ok:
            return C.ALGO_FLAT
        return algo

    def _note_single_rank(self, kind: str):
        """The one warning that a forced tree or two-level form runs flat
        in a world of one rank."""
        cfg = self.config
        forced = []
        if kind == "alltoall":
            forced.append((env_mod.HOROVOD_TPU_ALLTOALL_ALGO,
                           cfg.alltoall_algo))
        else:
            forced.append((env_mod.HOROVOD_TPU_COLLECTIVE_ALGO,
                           cfg.collective_algo))
            if kind == "allreduce" and cfg.hierarchical_allreduce:
                forced.append((env_mod.HOROVOD_HIERARCHICAL_ALLREDUCE,
                               C.ALGO_HIERARCHICAL))
            if kind == "allgather" and cfg.hierarchical_allgather:
                forced.append((env_mod.HOROVOD_HIERARCHICAL_ALLGATHER,
                               C.ALGO_HIERARCHICAL))
        for knob, algo in forced:
            if algo in (C.ALGO_TREE, C.ALGO_HIERARCHICAL):
                _demote((kind, algo, knob),
                        f"{knob} asks for the {algo} {kind}, which a world "
                        f"of one rank cannot express")

    def _bucket_algos(self, kind: str, nbytes: Sequence[int],
                      op: Optional[ReduceOp] = None) -> tuple:
        """Each bucket's algorithm (``nbytes``: the buckets' payload
        bytes), its own (bytes, topology) decision: a step's small bucket
        can take the tree while its large one takes the ladder. Ops other
        than Sum and Average run flat."""
        if op is not None and op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            return (C.ALGO_FLAT,) * len(nbytes)
        return tuple(self._choose_algo(kind, int(b)) for b in nbytes)

    def _algo_sig(self) -> tuple:
        """The knobs the selection reads: replay rebuilds an armed program
        on any move of them (the reference's :722-740, the pipeline's
        schedule knobs included)."""
        cfg = self.config
        return (cfg.collective_algo, cfg.tree_threshold_bytes,
                cfg.hier_threshold_bytes,
                cfg.hierarchical_allreduce, cfg.hierarchical_allgather,
                cfg.compression,
                cfg.alltoall_algo, cfg.alltoall_codec,
                cfg.alltoall_hier_threshold_bytes,
                # a pipeline schedule or boundary-codec move changes the
                # step's program: an armed one is rebuilt
                cfg.pipeline_schedule, cfg.pipeline_virtual_stages,
                cfg.pipeline_boundary_codec)

    def _a2a_codecs(self, dtypes: Sequence[torch.dtype],
                    algos: Sequence[str], count: bool = True) -> tuple:
        """Each alltoall bucket's wire codec (the reference's :775-795):
        ``HOROVOD_TPU_ALLTOALL_CODEC`` resolved by the bucket's dtype, on
        hierarchical buckets only (a flat one has no cross leg to
        encode); no residual. With ``count`` the selections go into
        ``codec_selections``."""
        base = self.config.alltoall_codec
        if base == comp.CODEC_NONE or self.topology.size <= 1:
            return (comp.CODEC_NONE,) * len(algos)
        out = tuple(comp.resolve_codec(base, d)
                    if a == C.ALGO_HIERARCHICAL else comp.CODEC_NONE
                    for d, a in zip(dtypes, algos))
        if count:
            for c in out:
                if c != comp.CODEC_NONE:
                    self.codec_selections[("alltoall", c)] += 1
        return out

    def _selection_counts(self, kind: str, nbytes: Sequence[int],
                          itemsizes: Sequence[int], algos,
                          codecs=None):
        """``(algo_selections, link_bytes)`` increments of one call: a
        bucket each by (kind, algo), and each bucket's payload bytes
        (``nbytes``, its elements of ``itemsizes`` bytes) split by its
        algorithm and codec (``link_split``). The reference splits each
        tensor; a bucket at once costs the host two calls where ResNet-50's
        161 tensors cost 0.4 ms, and differs from the sum of its tensors'
        splits by the rounding of ``nbytes // local_size``."""
        sel = collections.Counter((kind, a) for a in algos)
        links = collections.Counter()
        local, size = self.topology.local_size, self.topology.size
        codecs = codecs or (comp.CODEC_NONE,) * len(algos)
        for b, item, algo, codec in zip(nbytes, itemsizes, algos, codecs):
            for link, v in C.link_split(algo, b, local, kind=kind,
                                        codec=codec, itemsize=item,
                                        size=size).items():
                links[link] += v
        return sel, links

    def _count(self, counts):
        """Add :meth:`_selection_counts`' increments to the counters."""
        sel, links = counts
        self.algo_selections.update(sel)
        self.link_bytes.update(links)

    def _hier_sizes(self) -> tuple:
        local = self.topology.local_size
        return local, self.topology.size // local

    def _warm_groups(self, algos: Sequence[str]):
        """Run one collective on every process group ``algos`` need that
        no captured program has warmed yet: NCCL creates a group's
        communicator at its first collective, which cannot happen inside a
        CUDA graph capture. Called by every rank at the same point (a
        program's build), so the warm-ups line up."""
        groups = []
        if C.ALGO_TREE in algos:
            groups.extend(self._tree_groups or ())
        if C.ALGO_HIERARCHICAL in algos:
            groups.extend(self.hierarchical_groups())
        for g in groups:
            if g is None or id(g) in self._warmed:
                continue
            _translate_failure(dist.all_reduce, torch.zeros(
                1, device=self.backend.device), group=g)
            self._warmed.add(id(g))

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
                           dtypes, codecs, algos=None) -> list:
        """``(bucket, key, elems, dtype)`` of each error-feedback bucket of
        one call (``sizes``: the buckets' element counts; ``algos`` their
        algorithms, flat when None), in bucket order. The length tells
        the ladder's residual from the flat arm's (``codec_residual_elems``),
        so the key needs no algorithm."""
        n, local = self.backend.size(), self.topology.local_size
        algos = algos or (C.ALGO_FLAT,) * len(sizes)
        out = []
        for b, (total, dtype, codec, algo) in enumerate(zip(
                sizes, dtypes, codecs, algos)):
            elems = C.codec_residual_elems("reduce", total, n, local, algo,
                                           codec)
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
            self._m_res_inval.inc(dropped)
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
            self._m_res_inval.inc(len(stale))
            self._emit_replay("residual-invalidate",
                              f"world-version bump (-> {v})")

    @staticmethod
    def _padded(op: ReduceOp, algo: str, codec: str) -> bool:
        """Whether a bucket packs into a padded buffer of its own: a wire
        codec's zero-tailed one, or the ladder's, padded to the world size
        (a Sum or Average on the hierarchical algorithm)."""
        return codec != comp.CODEC_NONE or (
            algo == C.ALGO_HIERARCHICAL
            and op in (ReduceOp.SUM, ReduceOp.AVERAGE))

    def _bucket_pack(self, tensors: Sequence[torch.Tensor], op: ReduceOp,
                     algo: str, codec: str) -> torch.Tensor:
        """One bucket's tensors packed into a buffer of its own (K1 under
        ``HOROVOD_PALLAS_PACK``): a new flat buffer, or where
        :meth:`_padded` says so K1's ``out=`` form into a zero-tailed
        buffer padded to the local size (a codec's hierarchical arm) or to
        the world size (the flat codec arm, the ladder)."""
        if not self._padded(op, algo, codec):
            return C.pack_bucket(tensors, self.config.pack_kernel)
        hier = algo == C.ALGO_HIERARCHICAL
        n = (self._hier_sizes()[0] if hier and codec != comp.CODEC_NONE
             else self.backend.size())
        padded = C.padded_bucket(sum(t.numel() for t in tensors), n,
                                 tensors[0].dtype, tensors[0].device)
        return C.pack_padded(tensors, padded, self.config.pack_kernel)

    def _codec_launch(self, flat: torch.Tensor, total: int, codec: str,
                      residual: Optional[torch.Tensor], op: ReduceOp,
                      prescale_factor: float, postscale_factor: float,
                      algo: str = C.ALGO_FLAT):
        """One bucket's compressed allreduce on its packed zero-tailed
        buffer (:meth:`_bucket_pack`), ordered on this process's stream:
        the hierarchical arm (``C.codec_hier_allreduce``) on the ladder,
        the flat one (``C.codec_allreduce``) on flat and tree, whose pair
        rounds would compound the quantization error. Returns the reduced
        prefix and its launch group."""
        n, rank = self.backend.size(), self.backend.rank()
        avg = n if op == ReduceOp.AVERAGE else 1
        if algo == C.ALGO_HIERARCHICAL:
            local, cross = self._hier_sizes()
            _translate_failure(C.codec_hier_allreduce, flat, total,
                               residual, codec, local, cross, avg,
                               prescale_factor, postscale_factor,
                               *self.hierarchical_groups())
        else:
            _translate_failure(C.codec_allreduce, flat, total, residual,
                               codec, n, rank, avg, prescale_factor,
                               postscale_factor, None)
        return flat[:total], LaunchGroup(_StreamWork(flat.device))

    def _bucket_launch(self, buf: torch.Tensor, total: int, op: ReduceOp,
                       prescale_factor: float, postscale_factor: float,
                       algo: str, codec: str = comp.CODEC_NONE,
                       residual: Optional[torch.Tensor] = None):
        """One bucket's reduction on its packed buffer (its first ``total``
        elements; :meth:`_bucket_pack`, or a slice of the single-launch
        form's group buffer): the compressed one for a bucket with a wire
        codec, else the reduction under ``algo``, the ladder's on the
        buffer padded to the world size. Returns the reduced elements and
        their launch group."""
        if codec != comp.CODEC_NONE:
            return self._codec_launch(buf, total, codec, residual, op,
                                      prescale_factor, postscale_factor,
                                      algo)
        if buf.numel() == total:
            return buf, self._reduce_launch(buf, op, prescale_factor,
                                            postscale_factor, algo)
        return buf[:total], self._reduce_launch(
            buf, op, prescale_factor, postscale_factor, algo, total)

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
        links = None
        if self.topology.size > 1:
            algo = self._bucket_algos("allreduce", [x.nbytes], op)[0]
            m_codec = self._bucket_codecs("allreduce", [x.dtype], call_codec,
                                          count=False)
            self._m_selections("allreduce", [algo], "allreduce", m_codec,
                               call_codec)
            links = self._tensor_links("allreduce", [x], [[0]], [algo],
                                       m_codec)
            self._m_codec_saved("allreduce", [x], [[0]], [algo], m_codec,
                                links)
        self._m_account("allreduce", [x], links)
        r = self._replay.intercept("allreduce", [x], int(op),
                                   prescale_factor, postscale_factor, name,
                                   sub, codec=call_codec)
        if r is not None:
            return r[0]
        name = self._register(name, "allreduce", x.nbytes,
                              links[0] if links else None)
        self._join_sync("allreduce",
                        [_join_meta_row(x, _op_field(op, call_codec))], sub)
        self._debug_check(name, "allreduce", [x], op_code=int(op),
                          wildcard=sub)
        bucket_codec = self._bucket_codecs("allreduce", [x.dtype],
                                           call_codec)[0]
        algo = self._bucket_algos("allreduce", [x.nbytes], op)[0]
        self._count(self._selection_counts(
            "allreduce", [x.nbytes], [x.element_size()], [algo],
            [bucket_codec]))
        residual = None
        if bucket_codec != comp.CODEC_NONE:
            failpoint("compression.encode")
            residual = self._fetch_residuals(self._grouped_residuals(
                "gar", orig_name, [x.numel()], [x.dtype], [bucket_codec],
                [algo])).get(0)
        t0 = self._pre_launch()
        if bucket_codec != comp.CODEC_NONE or algo == C.ALGO_HIERARCHICAL:
            buf = self._bucket_pack([x.contiguous()], op, algo, bucket_codec)
            flat, group = self._bucket_launch(
                buf, x.numel(), op, prescale_factor, postscale_factor, algo,
                bucket_codec, residual)
            self._launched(name, t0)
            return self._track(Handle(name, group,
                                      lambda: flat.view(x.shape), self,
                                      "allreduce"))
        buf = x.clone(memory_format=torch.contiguous_format)
        group = self._reduce_launch(buf, op, prescale_factor,
                                    postscale_factor, algo)
        self._launched(name, t0)
        return self._track(Handle(name, group, lambda: buf, self,
                                  "allreduce"))

    def grouped_allreduce(self, tensors: Sequence,
                          name: Optional[str] = None,
                          op: ReduceOp = ReduceOp.SUM,
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          codec: Optional[str] = None) -> List[Handle]:
        """Fused allreduce: per-dtype buckets of at most the fusion
        threshold, one collective per bucket (the compressed reduction for
        a bucket with a wire codec: ``codec`` overrides
        ``HOROVOD_TPU_COMPRESSION``); each output is a view of its
        bucket's reduced buffer. With ``HOROVOD_TPU_SINGLE_LAUNCH`` on
        (the default) and ``HOROVOD_PALLAS_PACK`` off one plain pack fills
        every bucket's slice of one buffer before the collectives; with
        the pack kernel each bucket is packed (K1) and reduced in turn."""
        tensors = [self._tensor(t) for t in tensors]
        sub = self._consume_substitute()
        for t in tensors:
            _check_average_dtype(t, op)
        _dist_op(op)
        if not tensors:
            return []
        call_codec = self._call_codec(codec, op)
        links = None
        derived = None
        if self.topology.size > 1:
            # selection and link attribution ride the live bucketing,
            # counted before replay sees the call (a replayed step moves
            # the same bytes); reused by the eager path below
            buckets = bucket_by_size(tensors,
                                     self.config.fusion_threshold_bytes)
            nbytes = [sum(tensors[i].nbytes for i in idxs)
                      for idxs in buckets]
            algos = self._bucket_algos("allreduce", nbytes, op)
            m_codecs = self._bucket_codecs(
                "grouped_allreduce",
                [tensors[idxs[0]].dtype for idxs in buckets], call_codec,
                count=False)
            self._m_selections("allreduce", algos, "grouped_allreduce",
                               m_codecs, call_codec)
            links = self._tensor_links("allreduce", tensors, buckets, algos,
                                       m_codecs)
            self._m_codec_saved("allreduce", tensors, buckets, algos,
                                m_codecs, links)
            derived = (buckets, nbytes, algos)
        self._m_account("grouped_allreduce", tensors, links)
        r = self._replay.intercept("grouped_allreduce", tensors, int(op),
                                   prescale_factor, postscale_factor, name,
                                   sub, codec=call_codec)
        if r is not None:
            return r
        names = self._register_many(
            [None if name is None else f"{name}.{i}"
             for i in range(len(tensors))], "grouped_allreduce", tensors,
            links)
        self._join_sync("grouped_allreduce",
                        [_join_meta_row(t, _op_field(op, call_codec))
                         for t in tensors], sub)
        self._debug_check(names[0], "grouped_allreduce", tensors,
                          op_code=int(op), wildcard=sub)
        if derived is not None:
            buckets, nbytes, algos = derived
        else:
            buckets = bucket_by_size(tensors,
                                     self.config.fusion_threshold_bytes)
            nbytes = [sum(tensors[i].nbytes for i in idxs)
                      for idxs in buckets]
            algos = self._bucket_algos("allreduce", nbytes, op)
        codecs = self._bucket_codecs(
            "grouped_allreduce", [tensors[idxs[0]].dtype for idxs in buckets],
            call_codec)
        self._m_buckets_obs(tensors, buckets)
        if any(c != comp.CODEC_NONE for c in codecs):
            failpoint("compression.encode")
        self._count(self._selection_counts(
            "allreduce", nbytes,
            [tensors[idxs[0]].element_size() for idxs in buckets], algos,
            codecs))
        # one derivation of the residual rows for both forms below: a
        # codec's lineage runs on across a single_launch flip
        sizes = [sum(tensors[i].numel() for i in idxs) for idxs in buckets]
        residuals = self._fetch_residuals(self._grouped_residuals(
            "gar", name, sizes, [tensors[idxs[0]].dtype for idxs in buckets],
            codecs, algos))
        bufs = pres = None
        if self.config.single_launch and not self.config.pack_kernel:
            # the single-launch form (the reference's :1806-1850): one pack
            # of every bucket into one buffer, prescaled once (a padded
            # bucket, a codec's or the ladder's, packs into its own), then
            # the buckets' collectives back to back, nothing between two
            if self._overlap_mode(sum(t.nbytes for t in tensors),
                                  len(buckets)) != "off":
                self._note_overlap_step("interleave")
            padded = [self._padded(op, a, c) for a, c in zip(algos, codecs)]
            shared = iter(C.pack_group(
                tensors, [idxs for idxs, p in zip(buckets, padded) if not p],
                prescale_factor))
            bufs = [self._bucket_pack([tensors[i] for i in idxs], op,
                                      algos[b], codecs[b]) if padded[b]
                    else next(shared) for b, idxs in enumerate(buckets)]
            pres = [prescale_factor if p else 1.0 for p in padded]
        handles: List[Optional[Handle]] = [None] * len(tensors)
        for b, idxs in enumerate(buckets):
            t0 = self._pre_launch()
            buf, pre = (bufs[b], pres[b]) if bufs is not None else (
                # per bucket: pack, then reduce (the form the reference
                # takes with its Pallas pack, whose packing is its own
                # launch)
                self._bucket_pack([tensors[i] for i in idxs], op, algos[b],
                                  codecs[b]), prescale_factor)
            flat, group = self._bucket_launch(
                buf, sizes[b], op, pre, postscale_factor, algos[b],
                codecs[b], residuals.get(b))
            self._launched([names[i] for i in idxs], t0)
            views = C.unpack_flat(flat, [tuple(tensors[i].shape)
                                         for i in idxs])
            for i, v in zip(idxs, views):
                handles[i] = self._track(
                    Handle(names[i], group, lambda v=v: v, self,
                           "grouped_allreduce"))
        return handles

    def broadcast(self, tensor, root_rank: int,
                  name: Optional[str] = None) -> Handle:
        x = self._tensor(tensor)
        sub = self._consume_substitute()
        self._check_root(root_rank)
        self._m_account("broadcast", [x])
        r = self._replay.intercept("broadcast", [x], root_rank, 1.0, 1.0,
                                   name, sub)
        if r is not None:
            return r[0]
        name = self._register(name, "broadcast", x.nbytes)
        self._join_sync("broadcast", [_join_meta_row(x, root_rank)], sub)
        self._debug_check(name, "broadcast", [x], op_code=root_rank,
                          wildcard=sub)
        buf = x.clone(memory_format=torch.contiguous_format)
        t0 = self._pre_launch()
        work = _translate_failure(dist.broadcast, buf, src=root_rank,
                                  async_op=True)
        self._launched(name, t0)
        flag_works, root_active = self._root_flag(root_rank, sub)

        def extract():
            root_active()
            return buf

        return self._track(Handle(name, LaunchGroup([work] + flag_works),
                                  extract, self, "broadcast"))

    def grouped_broadcast(self, tensors: Sequence, root_rank: int,
                          name: Optional[str] = None) -> List[Handle]:
        """Fused broadcast: one plain pack and one collective per bucket."""
        tensors = [self._tensor(t) for t in tensors]
        sub = self._consume_substitute()
        self._check_root(root_rank)
        if not tensors:
            return []
        self._m_account("grouped_broadcast", tensors)
        r = self._replay.intercept("grouped_broadcast", tensors, root_rank,
                                   1.0, 1.0, name, sub)
        if r is not None:
            return r
        names = self._register_many(
            [None if name is None else f"{name}.{i}"
             for i in range(len(tensors))], "grouped_broadcast", tensors)
        self._join_sync("grouped_broadcast",
                        [_join_meta_row(t, root_rank) for t in tensors], sub)
        self._debug_check(names[0], "grouped_broadcast", tensors,
                          op_code=root_rank, wildcard=sub)
        launches = []
        buckets = bucket_by_size(tensors, self.config.fusion_threshold_bytes)
        self._m_buckets_obs(tensors, buckets)
        for idxs in buckets:
            flat = C.pack_bucket([tensors[i] for i in idxs], False)
            t0 = self._pre_launch()
            work = _translate_failure(dist.broadcast, flat, src=root_rank,
                                      async_op=True)
            self._launched([names[i] for i in idxs], t0)
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
                    Handle(names[i], group, extract, self,
                           "grouped_broadcast"))
        return handles

    def allgather(self, tensor, name: Optional[str] = None,
                  _sub_hash: Optional[int] = None) -> Handle:
        """Allgather along dim 0 with possibly different dim-0 sizes per rank
        (a size exchange, a padded gather, then trim and concatenate). The
        gather is flat or, where the selection says so (the reference's
        :2185-2244), two-level: a local gather, then a cross gather of the
        islands' blocks. The choice reads the agreed padded size, so every
        rank makes it alike. The size exchange goes through the
        steady-state cache (:meth:`_exchange_sizes_cached`): once hot it
        is posted and checked when the result is read.

        ``_sub_hash`` (internal): a joined rank's zero substitute passes the
        advertised name hash, so it contributes zeros of the size it
        advertised for that name before and replays its hot peers' posted
        exchange (the reference's :2168-2183)."""
        x = self._tensor(tensor)
        sub = self._consume_substitute()
        links = None
        if self.topology.size > 1:
            # the reference's rank-local hint, from this rank's own bytes
            hint = self._choose_algo("allgather", x.nbytes)
            self._m_selections("allgather", [hint])
            if self._m_enabled or self.trace is not None:
                links = [C.link_split(hint, x.nbytes,
                                      self.topology.local_size,
                                      kind="allgather")]
        self._m_account("allgather", [x], links)
        self._replay.observe("allgather", sub, [x], name)
        name = self._register(name, "allgather", x.nbytes,
                              links[0] if links else None)
        if x.dim() == 0:
            x = x[None]
        key_hash = (_sub_hash if _sub_hash is not None
                    else self._meta_hash(name))
        # the join row's op field carries the name hash (bit 0, the
        # reference's equal-sizes flag, stays clear)
        self._join_sync("allgather", [_join_meta_row(x, key_hash << 1)],
                        sub)
        self._debug_check(name, "allgather", [x], check_dim0=False,
                          wildcard=sub)
        if _sub_hash is not None:
            ent = self._meta_cache.get(("allgather", _sub_hash))
            if ent is not None:
                x = x.new_zeros((int(ent["local"][0]),) + tuple(x.shape[1:]))
        d0 = int(x.shape[0])
        world, deferred = self._exchange_sizes_cached(
            "allgather", key_hash, np.array([d0]))
        sizes = world[:, 0].tolist()
        max_d0 = max(sizes)
        if d0 > max_d0:
            # this rank's rows grew past its hot peers' cached shape: that
            # shape goes out all the same (every rank raises at extract)
            x, d0 = x[:max_d0], max_d0
        algo = self._choose_algo(
            "allgather", x.nbytes // max(d0, 1) * max_d0)
        self._count(self._selection_counts("allgather", [x.nbytes],
                                           [x.element_size()], [algo]))
        pad = max_d0 - d0
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        x = x.contiguous()
        t0 = self._pre_launch()
        if algo == C.ALGO_HIERARCHICAL:
            gathered = x.new_empty((len(sizes) * max_d0,)
                                   + tuple(x.shape[1:]))
            _translate_failure(C.hier_all_gather, gathered, x,
                               *self.hierarchical_groups(),
                               *self._hier_sizes())
            outs = list(gathered.split(max_d0))
            work = _StreamWork(x.device)
        else:
            outs = [torch.empty_like(x) for _ in sizes]
            work = _translate_failure(dist.all_gather, outs, x,
                                      async_op=True)
        self._launched(name, t0)

        def extract():
            self._verify_deferred(name, deferred)
            if all(s == max_d0 for s in sizes):
                return torch.cat(outs)
            return torch.cat([o[:s] for o, s in zip(outs, sizes)])

        h = Handle(name, LaunchGroup(work), extract, self, "allgather")
        h.recv_sizes = np.asarray(sizes)
        return self._track(h)

    def alltoall(self, tensor, splits=None, name: Optional[str] = None,
                 _sub_hash: Optional[int] = None) -> Handle:
        """Alltoall with optional uneven splits (the reference's :2384,
        operations.cc:951): rank r gets ``splits[r]`` rows of this rank's
        dim 0, in rank order; without ``splits`` dim 0 must divide by the
        size and goes out in equal blocks. The splits matrix is exchanged
        once (``recv_splits[r]`` = rank r's ``splits[me]``), then one
        ``all_to_all_single`` with uneven sizes. The handle's result is
        ``(received tensor, recv_splits)``, the splits an int64 CPU tensor.
        At size 1 the result is the input. When the exchanged splits matrix
        is uniform (an agreed predicate: then every rank's bytes, hence its
        selection, are alike) the exchange is flat or the two-phase one
        (the reference's :2384-2500), with ``HOROVOD_TPU_ALLTOALL_CODEC``
        on the two-phase exchange's cross phase; other splits keep the
        flat exchange. The splits matrix goes through the steady-state
        size cache (:meth:`_exchange_sizes_cached`), as allgather's sizes
        do; ``_sub_hash`` is :meth:`allgather`'s."""
        x = self._tensor(tensor)
        sub = self._consume_substitute()
        self._replay.observe("alltoall", sub, [x], name)
        if x.dim() == 0:
            raise ValueError("alltoall requires a tensor with dim 0")
        size, rank = self.backend.size(), self.backend.rank()
        if _sub_hash is not None:
            ent = self._meta_cache.get(("alltoall", _sub_hash))
            if ent is not None:
                # zeros under the joined rank's own earlier splits, so its
                # hot peers' cached matrix (and shapes) still hold
                splits = ent["local"]
                x = x.new_zeros((int(splits.sum()),) + tuple(x.shape[1:]))
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
        links = None
        if size > 1 and bool((send == send[0]).all()):
            # the reference's rank-local hint, from this rank's own splits
            hint = self._choose_algo("alltoall", x.nbytes)
            hint_codec = self._a2a_codecs([x.dtype], [hint], count=False)
            self._m_selections("alltoall", [hint], "alltoall",
                               [c for c in hint_codec
                                if c != comp.CODEC_NONE],
                               self.config.alltoall_codec)
            links = self._tensor_links("alltoall", [x], [[0]], [hint],
                                       hint_codec, size=size)
            self._m_codec_saved("alltoall", [x], [[0]], [hint], hint_codec,
                                links, size=size)
        self._m_account("alltoall", [x], links)
        name = self._register(name, "alltoall", x.nbytes,
                              links[0] if links else None)
        key_hash = (_sub_hash if _sub_hash is not None
                    else self._meta_hash(name))
        self._join_sync("alltoall", [_join_meta_row(x, key_hash << 1)], sub)
        self._debug_check(name, "alltoall", [x], check_dim0=False,
                          wildcard=sub)
        if size == 1:
            self._note_single_rank("alltoall")
            recv = torch.from_numpy(send)
            # nothing to launch: the call's span, no launch counted
            self._launched(name, self._pre_launch(), 0)
            return self._track(Handle(name, LaunchGroup(_StreamWork(x.device)),
                                      lambda: (x, recv), self, "alltoall"))
        matrix, deferred = self._exchange_sizes_cached("alltoall", key_hash,
                                                       send)
        if deferred is not None and deferred["stale_local"]:
            # this rank's splits changed while its peers are hot: its
            # cached row goes out, the rows cut or zero-padded to it (every
            # rank raises at extract)
            send = matrix[rank].copy()
            rows = int(send.sum())
            x = x[:rows] if rows <= x.shape[0] else torch.cat(
                [x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])
        recv = matrix[:, rank]
        algo, codec = C.ALGO_FLAT, comp.CODEC_NONE
        if (matrix == matrix[0, 0]).all():
            algo = self._choose_algo("alltoall", x.nbytes)
            codec = self._a2a_codecs([x.dtype], [algo])[0]
        self._count(self._selection_counts("alltoall", [x.nbytes],
                                           [x.element_size()], [algo],
                                           [codec]))
        t0 = self._pre_launch()
        if algo == C.ALGO_HIERARCHICAL:
            out = _translate_failure(C.hier_alltoall, x.contiguous(),
                                     *self.hierarchical_groups(),
                                     *self._hier_sizes(), codec)
            work = _StreamWork(x.device)
        else:
            out = x.new_empty((int(recv.sum()),) + tuple(x.shape[1:]))
            work = _translate_failure(C.all_to_all, out, x.contiguous(),
                                      recv.tolist(), send.tolist(), None,
                                      async_op=True)
        self._launched(name, t0)
        recv = torch.from_numpy(recv)

        def extract():
            self._verify_deferred(name, deferred)
            return out, recv

        return self._track(Handle(name, LaunchGroup(work), extract, self,
                                  "alltoall"))

    def grouped_alltoall(self, tensors: Sequence,
                         name: Optional[str] = None) -> List[Handle]:
        """Fused even-split alltoall of many tensors (the reference's
        :2504-2590): every tensor's dim 0 must divide by the world size
        (the capacity-routed MoE dispatch shape: fixed a step and alike on
        every rank, which makes the call replayable). Per fusion bucket
        the members' ``(n, w_i)`` chunk matrices (row j the chunk bound for
        rank j) are concatenated into one ``(n, R_b)`` buffer and exchanged
        once (``ops/collectives.py`` ``a2a_pack``), flat or two-phase by
        the bucket's bytes and the topology, with
        ``HOROVOD_TPU_ALLTOALL_CODEC`` on a two-phase bucket's cross phase
        only; the columns unpack into each tensor's shape. One handle a
        tensor, whose result is the received tensor (the splits are even
        by contract). At size 1 the result is the input."""
        tensors = [self._tensor(t) for t in tensors]
        sub = self._consume_substitute()
        size = self.backend.size()
        for t in tensors:
            if t.dim() == 0 or int(t.shape[0]) % size:
                raise ValueError(
                    f"grouped_alltoall requires every tensor's dim 0 "
                    f"divisible by size ({size}); got {tuple(t.shape)}. "
                    f"Use alltoall(splits=...) for ragged dispatch.")
        links = None
        buckets = None
        if tensors:
            if self.topology.size > 1:
                # selection and link attribution, counted before replay
                # sees the call; the buckets are reused below
                buckets = bucket_by_size(tensors,
                                         self.config.fusion_threshold_bytes)
                _, algos, codecs = self._a2a_plan(tensors, buckets,
                                                  count=False)
                self._m_selections("alltoall", algos, "alltoall",
                                   [c for c in codecs
                                    if c != comp.CODEC_NONE],
                                   self.config.alltoall_codec)
                links = self._tensor_links("alltoall", tensors, buckets,
                                           algos, codecs, size=size)
                self._m_codec_saved("alltoall", tensors, buckets, algos,
                                    codecs, links, size=size)
            self._m_account("grouped_alltoall", tensors, links)
            r = self._replay.intercept("grouped_alltoall", tensors, 0, 1.0,
                                       1.0, name, sub)
            if r is not None:
                return r
        names = self._register_many(
            [None if name is None else f"{name}.{i}"
             for i in range(len(tensors))], "grouped_alltoall", tensors,
            links)
        self._join_sync("grouped_alltoall",
                        [_join_meta_row(t, 0) for t in tensors], sub)
        self._debug_check(names[0] if names else "empty",
                          "grouped_alltoall", tensors, wildcard=sub)
        if not tensors:
            return []
        if buckets is None:
            buckets = bucket_by_size(tensors,
                                     self.config.fusion_threshold_bytes)
        nbytes, algos, codecs = self._a2a_plan(tensors, buckets)
        self._m_buckets_obs(tensors, buckets)
        self._count(self._selection_counts(
            "alltoall", nbytes,
            [tensors[idxs[0]].element_size() for idxs in buckets], algos,
            codecs))
        if size == 1:
            self._note_single_rank("alltoall")
            # nothing to launch: the call's span, no launch counted
            self._launched(names, self._pre_launch(), 0)
            group = LaunchGroup(_StreamWork(tensors[0].device))
            return [self._track(Handle(nm, group, lambda t=t: t, self,
                                       "grouped_alltoall"))
                    for nm, t in zip(names, tensors)]
        handles: List[Optional[Handle]] = [None] * len(tensors)
        for idxs, algo, codec in zip(buckets, algos, codecs):
            members = [tensors[i] for i in idxs]
            t0 = self._pre_launch()
            out, group = self._a2a_launch(C.a2a_pack(members, size), algo,
                                          codec)
            self._launched([names[i] for i in idxs], t0)
            # the columns are read once the exchange is done
            unpack = C.lazy_a2a_unpack(out, [tuple(t.shape)
                                             for t in members])
            for j, i in enumerate(idxs):
                handles[i] = self._track(Handle(
                    names[i], group, lambda j=j, f=unpack: f()[j], self,
                    "grouped_alltoall"))
        return handles

    def _a2a_plan(self, tensors, buckets, count: bool = True) -> tuple:
        """``(nbytes, algos, codecs)`` of a grouped alltoall's buckets: each
        bucket's algorithm by its bytes and the topology, its codec on a
        two-phase bucket (``count``: into ``codec_selections``)."""
        nbytes = [sum(tensors[i].nbytes for i in idxs) for idxs in buckets]
        algos = tuple(self._choose_algo("alltoall", b) for b in nbytes)
        codecs = self._a2a_codecs([tensors[idxs[0]].dtype
                                   for idxs in buckets], algos, count=count)
        return nbytes, algos, codecs

    def _a2a_launch(self, packed: torch.Tensor, algo: str, codec: str):
        """One bucket's exchange of its ``(n, R_b)`` buffer (the
        reference's ``_a2a_exchange``): the two-phase exchange on a
        hierarchical bucket, else one ``all_to_all_single``. Returns the
        received buffer and its launch group."""
        if algo == C.ALGO_HIERARCHICAL:
            out = _translate_failure(C.hier_alltoall, packed,
                                     *self.hierarchical_groups(),
                                     *self._hier_sizes(), codec)
            return out, LaunchGroup(_StreamWork(packed.device))
        out = torch.empty_like(packed)
        rows = [1] * packed.shape[0]
        work = _translate_failure(C.all_to_all, out, packed, rows, rows, None,
                                  async_op=True)
        return out, LaunchGroup(work)

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
        _check_average_dtype(x, op)
        self._m_account("reducescatter", [x])
        self._replay.observe("reducescatter", sub, [x], name)
        if x.dim() == 0:
            raise ValueError("reducescatter requires a tensor with dim 0")
        name = self._register(name, "reducescatter", x.nbytes)
        self._join_sync("reducescatter", [_join_meta_row(x, int(op))], sub)
        self._debug_check(name, "reducescatter", [x], op_code=int(op),
                          wildcard=sub)
        size, rank = self.backend.size(), self.backend.rank()
        d0 = int(x.shape[0])
        chunk = -(-d0 // size)
        rows = [min(chunk, max(d0 - r * chunk, 0)) for r in range(size)]
        flat = x.contiguous()
        if chunk * size != d0:
            flat = torch.cat([flat, flat.new_zeros(
                (chunk * size - d0,) + tuple(x.shape[1:]))])
        out = x.new_empty((chunk,) + tuple(x.shape[1:]))
        t0 = self._pre_launch()
        work = _translate_failure(C.reduce_scatter, out, flat, None,
                                  async_op=True)
        self._launched(name, t0)
        n = size if op == ReduceOp.AVERAGE else 1
        group = LaunchGroup(work, lambda: C.finish_reduce(out, n, 1.0))
        h = Handle(name, group, lambda: out[:rows[rank]], self,
                   "reducescatter")
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
        all-gather stays full precision (the reference's :1956-2050). The
        reduce-scatter is always flat (shard ownership); each bucket's
        all-gather picks flat or the two-level gather (:1951-1975).

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
        ag_algos = self._sharded_ag_algos(grads, buckets)
        self._m_sharded(grads, buckets, call_codec, ag_algos)
        r = self._replay.intercept("sharded_step", grads, int(op),
                                   prescale_factor, postscale_factor, name,
                                   sub, layout=buckets, codec=call_codec)
        if r is not None:
            self._count(self._sharded_counts(
                grads, buckets, self._bucket_codecs(
                    "sharded_step", [b.grads.dtype for b in buckets],
                    call_codec, count=False), ag_algos))
            # the armed program ran the first half (its one dispatch
            # covers the gathers too, but for the staged prefetch leg's);
            # this orders the stream after it
            zag = r[0].synchronize()
            update()
            if zag:
                # the staged program's second stage: the prefetch leg
                self._prefetch_leg(buckets, ag_algos)
                self._count_dispatch()
                self._m_overlap_stages.inc(kind="replay_zag")
            else:
                self._gather_shards(buckets, ag_algos)
            return
        names = self._register_many(
            [None if name is None else f"{name}.{i}"
             for i in range(len(grads))], "sharded_step", grads)
        self._join_guard("sharded_step")
        self._debug_check(names[0], "sharded_step", grads, op_code=int(op),
                          wildcard=sub)
        n = self.backend.size() if op == ReduceOp.AVERAGE else 1
        codecs = self._bucket_codecs("sharded_step",
                                     [b.grads.dtype for b in buckets],
                                     call_codec)
        residuals = self._sharded_residuals(buckets, codecs)
        self._count(self._sharded_counts(grads, buckets, codecs, ag_algos))
        if any(c != comp.CODEC_NONE for c in codecs):
            failpoint("compression.encode")
        # a world-version bump drops held prefetch legs outside the step
        # markers too; then this layout's own leg is retired: the
        # gradients arriving now were computed from its parameters
        self._prefetch_gc()
        with self._lock:
            self._zero1_prefetch.pop(_update_key(buckets), None)
        mode = self._overlap_mode(sum(g.nbytes for g in grads), len(buckets),
                                  sharded=True)
        # the split leg belongs to the staged schedule, the one replay
        # sustains with its zupd and zag stages
        prefetch = self.config.zero1_prefetch and mode == "staged"
        if mode != "off" and not prefetch:
            self._note_overlap_step("interleave")
        t0 = self._pre_launch()
        launches = _translate_failure(
            C.scatter_shards, buckets, grads, self.config.pack_kernel, n,
            prescale_factor, postscale_factor, None, True, codecs, residuals,
            interleave=mode != "off")
        self._launched(names, t0, launches)
        update()
        t0 = self._pre_launch()
        if prefetch:
            self._launched(names, t0, self._prefetch_leg(buckets, ag_algos))
            # the two sub-launches of the split step
            self._m_overlap_stages.inc(2.0, kind="sharded_prefetch")
            self._note_overlap_step("staged")
        else:
            self._launched(names, t0, self._gather_shards(buckets, ag_algos))
        # no handle waits on a sharded step: its completion is ordered on
        # the stream, and the host's edge is here
        self._note_done(names)

    def _m_sharded(self, grads, buckets, call_codec: str, ag_algos):
        """A sharded step's metric accounting (the reference's
        :1965-1988): the call, each bucket once as a flat reduce-scatter
        and once as an all-gather, each gradient's bytes on both legs (the
        reduce-scatter's encoded), the codecs' savings and the buckets."""
        if not self._m_enabled:
            return
        idxs = [list(b.idxs) for b in buckets]
        rs_codecs = self._bucket_codecs(
            "reducescatter", [b.grads.dtype for b in buckets], call_codec,
            count=False)
        self._m_collectives.inc(1.0, kind="sharded_step")
        self._m_selections("reducescatter", [C.ALGO_FLAT] * len(buckets),
                           "reducescatter", rs_codecs, call_codec)
        self._m_selections("allgather", ag_algos)
        rs_links = [None] * len(grads)
        for bi, codec in zip(idxs, rs_codecs):
            for i in bi:
                g = grads[i]
                rs_links[i] = C.link_split(
                    C.ALGO_FLAT, g.nbytes, self.topology.local_size,
                    kind="reducescatter", codec=codec,
                    itemsize=g.element_size())
        self._m_wire_bytes("reducescatter", grads, rs_links)
        ag_links = self._tensor_links("allgather", grads, idxs, ag_algos)
        self._m_wire_bytes("allgather", grads, ag_links)
        self._m_codec_saved("reducescatter", grads, idxs,
                            [C.ALGO_FLAT] * len(buckets), rs_codecs)
        self._m_buckets_obs(grads, idxs)

    def _sharded_ag_algos(self, grads, buckets) -> tuple:
        """Each ZeRO-1 bucket's all-gather algorithm, by its gradients'
        bytes."""
        return self._bucket_algos("allgather", [
            sum(grads[i].nbytes for i in b.idxs) for b in buckets])

    def _sharded_counts(self, grads, buckets, codecs, ag_algos):
        """A sharded step's selection counts: each bucket once flat as a
        reduce-scatter (its codec's bytes) and once as an all-gather."""
        nbytes = [sum(grads[i].nbytes for i in b.idxs) for b in buckets]
        items = [b.grads.element_size() for b in buckets]
        sel, links = self._selection_counts(
            "reducescatter", nbytes, items, (C.ALGO_FLAT,) * len(buckets),
            codecs)
        sel2, links2 = self._selection_counts("allgather", nbytes, items,
                                              ag_algos)
        return sel + sel2, links + links2

    def _gather_shards(self, buckets, algos) -> int:
        """The sharded step's second half: each bucket's all-gather, flat
        or two-level, into its parameter buffer in place. Returns the
        collectives launched (one a bucket)."""
        hier = None
        if C.ALGO_HIERARCHICAL in algos:
            hier = (*self.hierarchical_groups(), *self._hier_sizes())
        return _translate_failure(C.gather_shards, buckets, None, True,
                                  algos, hier)

    def _prefetch_leg(self, buckets, algos) -> int:
        """The ZeRO-1 all-gather prefetch leg (the reference's :2127-2152):
        after the ``overlap.prefetch`` failpoint every bucket's all-gather
        issues as one leg into the layout's parameter buffers, and the leg
        is held (:meth:`_note_prefetch`). The parameters are views of those
        buffers, so nothing may read them before the leg lands: the
        current stream waits on its works before this returns (a stream
        dependency on the card, never a host wait; on gloo the works are
        waited). Returns the collectives launched."""
        failpoint("overlap.prefetch")
        launched = self._gather_shards(buckets, algos)
        self._note_prefetch(_update_key(buckets))
        return launched

    def _sharded_residual_key(self, bucket, codec: str) -> Optional[tuple]:
        """The residual of a sharded step's bucket (``cls`` "sharded": the
        whole padded bucket), keyed by the bucket's own token, as the
        reference keys it by its optimizer's."""
        elems = C.codec_residual_elems("sharded", bucket.total, bucket.n,
                                       0, None, codec)
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
                                  lambda: out, self, "adasum"))

    def barrier(self):
        """Blocks until every rank has reached it."""
        self._check_poison()
        sub = self._consume_substitute()
        self._m_account("barrier", [])
        self._replay.observe("barrier", sub)
        self._join_sync("barrier", [], sub)
        z = torch.zeros(1, dtype=torch.int32, device=self.backend.device)
        _translate_failure(dist.all_reduce, z)
        self._count_dispatch()
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
        self._check_poison()
        size = self.backend.size()
        if size <= 1:
            return 0
        if self.on_join_state is not None:
            self.on_join_state(True)
        try:
            if not self.config.join_enabled:
                self.barrier()
                return size - 1
            return self._join_loop(size)
        finally:
            if self.on_join_state is not None:
                self.on_join_state(False)

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
            hs = [self.allgather(zero(metas[0]), _sub_hash=arg >> 1)]
        elif kind == "broadcast":
            hs = [self.broadcast(zero(metas[0]), root_rank=arg)]
        elif kind == "grouped_broadcast":
            hs = self.grouped_broadcast([zero(r) for r in metas],
                                        root_rank=arg)
        elif kind == "reducescatter":
            hs = [self.reducescatter(zero(metas[0]), op=ReduceOp(arg))]
        elif kind == "grouped_alltoall":
            # the advertised shapes divide the world (the even-split
            # contract), so a zero group runs the active ranks' buckets
            hs = self.grouped_alltoall([zero(r) for r in metas])
        else:   # alltoall: the rows spread evenly, the first ranks one
            # more (alltoall takes this rank's own earlier splits instead
            # where its size cache holds the advertised name)
            z = zero(metas[0])
            base, rem = divmod(int(z.shape[0]), self.backend.size())
            hs = [self.alltoall(z, splits=[
                base + (r < rem) for r in range(self.backend.size())],
                _sub_hash=arg >> 1)]
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
        once and agreed by every rank (the reference's :1591-1607,
        mpi_controller.cc:26-82): an allgather of every rank's topology
        local size, true only when they are equal and 1 < local < size,
        size % local == 0. Resolved at init; a rank-local test could pick
        different programs on different ranks."""
        if self._hier_ok is None:
            size = self.backend.size()
            local = self.topology.local_size
            sizes = self._exchange_sizes(local) if size > 1 else [local]
            self._hier_ok = (all(s == sizes[0] for s in sizes)
                             and 1 < local < size and size % local == 0)
        return self._hier_ok

    def _make_groups(self):
        """Create every process group a selection can need, on every rank
        in one order (``dist.new_group`` is collective): the pair groups of
        each tree round when the size is a power of two (a pair that is
        the whole world is the default group), and the local and cross
        groups when the agreed layout has two levels."""
        size, rank = self.backend.size(), self.backend.rank()
        if C._is_pow2(size):
            self._tree_groups = []
            for pairs in C.tree_groups(size):
                mine = None
                for pair in pairs:
                    g = None if len(pair) == size else new_group(pair)
                    if rank in pair:
                        mine = g
                self._tree_groups.append(mine)
        if self._hier_ok:
            self.hierarchical_groups()

    def hierarchical_groups(self):
        """(local group, cross group) of this rank under ``slice_groups``'
        layout (island c holds ranks c·local + l; cross group l the l-th
        rank of every island), the one layout the ladder, the two-level
        gather and alltoall and hierarchical Adasum share. Created at init
        where the agreed layout has two levels (or the first time they are
        asked for after every rank agreed on one): every group on every
        rank in one order."""
        if self._hier_groups is None:
            if not self._hierarchical_ok():
                raise HorovodInternalError(
                    "the world has no agreed two-level layout "
                    f"(topology {self.topology.describe()})")
            rank = self.backend.rank()
            locals_, crosses = C.slice_groups(self.backend.size(),
                                              self.topology.local_size)
            mine = [None, None]
            for i, lists in enumerate((locals_, crosses)):
                for ranks in lists:
                    g = new_group(ranks)
                    if rank in ranks:
                        mine[i] = g
            self._hier_groups = tuple(mine)
        return self._hier_groups

    def _exchange_sizes(self, d0: int) -> List[int]:
        return self._exchange_rows(np.array([d0]))[:, 0].tolist()

    def _exchange_rows(self, vec: np.ndarray) -> np.ndarray:
        """Allgather of every rank's int64 vector (one length on every
        rank), read on the host: (size, len). Each call is one blocking
        host read, counted in ``host_fetches``."""
        mine = torch.from_numpy(np.ascontiguousarray(vec, dtype=np.int64))
        mine = mine.to(self.backend.device)
        out = mine.new_empty(self.backend.size() * mine.numel())
        _translate_failure(C.all_gather, out, mine, None)
        self.host_fetches += 1
        return out.cpu().numpy().reshape(self.backend.size(), -1)

    def _dispatch_exchange(self, vec: np.ndarray):
        """The same allgather, posted and not read here (a join round on an
        active rank, a hot size cache's advertisement): on the card the
        vector goes through a pinned host buffer and an async copy, so
        nothing waits on the host; its tensors are kept until the work
        completes. Returns ``(work, gathered)``: a later read of the
        gathered (size * len) tensor waits on ``work`` first."""
        while self._posted and self._posted[0][0].is_completed():
            self._posted.popleft()
        mine = torch.from_numpy(np.ascontiguousarray(vec, dtype=np.int64))
        keep = [mine]
        if self.backend.device.type == "cuda":
            mine = mine.pin_memory()
            keep.append(mine)
            mine = mine.to(self.backend.device, non_blocking=True)
        out = mine.new_empty(self.backend.size() * mine.numel())
        work = _translate_failure(C.all_gather, out, mine, None,
                                  async_op=True)
        self._posted.append((work, keep + [mine, out]))
        return work, out

    def _post_exchange(self, vec: np.ndarray):
        """:meth:`_dispatch_exchange` whose result nobody reads (a join
        round on an active rank)."""
        self._dispatch_exchange(vec)

    # -- the steady-state size cache (the reference's :2681-2780) ----------

    def _meta_hash(self, name: str) -> int:
        """The 30-bit name hash that keys the size cache and rides a join
        row (shifted left one bit), so a joined rank's substitute finds
        its own entry for the op it matches. A collision merges two
        names' entries; differing sizes then surface through the deferred
        check as a loud mismatch, never as silent corruption."""
        return self._h63(name) & ((1 << 30) - 1)

    def _exchange_sizes_cached(self, kind: str, key_hash: int,
                               local_vec: np.ndarray):
        """The size exchange of ``kind`` under one name, with the
        steady-state cache: after ``meta_cache_warmup`` identical world
        observations the exchange is posted (:meth:`_dispatch_exchange`)
        and the cached world shapes the collective now; the posted one is
        checked when the result is read (:meth:`_verify_deferred`).
        Returns ``(world, deferred)``, world an int64 (size, len) array."""
        local_vec = np.asarray(local_vec, dtype=np.int64).reshape(-1)
        if self.backend.size() == 1:
            return local_vec[None], None
        key = (kind, key_hash)
        ent = self._meta_cache.get(key)
        if (self.config.meta_cache and ent is not None
                and ent["streak"] >= self.config.meta_cache_warmup):
            lru_touch(self._meta_cache, key, ent)
            work, gathered = self._dispatch_exchange(local_vec)
            # this rank's sizes changed while its peers are hot: a blocking
            # exchange here would build another collective than theirs (a
            # hang), so the cached world stands on every rank (the call
            # fits its input to it; the data is garbage) and the check
            # fails everywhere: the peers see the changed advertisement,
            # this rank knows it changed
            stale = not np.array_equal(ent["local"], local_vec)
            deferred = {"key": key, "work": work, "gathered": gathered,
                        "expected": ent["world"], "error": None,
                        "checked": False, "stale_local": stale}
            return ent["world"], deferred
        world = self._exchange_rows(local_vec)
        if ent is not None and np.array_equal(ent["world"], world):
            ent["streak"] += 1
            ent["local"] = local_vec.copy()
            lru_touch(self._meta_cache, key, ent)
        else:
            lru_put(self._meta_cache, key,
                    {"world": world, "streak": 1, "local": local_vec.copy()},
                    self.config.cache_capacity)
        return world, None

    def _verify_deferred(self, name: str, deferred) -> None:
        """The extract-time check of a posted size exchange: what the peers
        advertised against the cached world the collective was built from.
        A mismatch drops the entry (the next call negotiates) and raises
        on every rank. The outcome is remembered: every later extract of
        the handle raises again."""
        if deferred is None:
            return
        if deferred["checked"]:
            if deferred["error"] is not None:
                raise deferred["error"]
            return
        mismatch = deferred["stale_local"]
        if not mismatch:
            self.deferred_meta_checks += 1
            _translate_failure(deferred["work"].wait)
            world = deferred["gathered"].cpu().numpy().reshape(
                self.backend.size(), -1)
            mismatch = not np.array_equal(world, deferred["expected"])
        deferred["checked"] = True
        if mismatch:
            self._meta_cache.pop(deferred["key"], None)
            deferred["error"] = HorovodInternalError(
                f"steady-state size cache mismatch for {name!r}: tensor "
                f"sizes changed after {self.config.meta_cache_warmup} "
                f"identical exchanges (cached "
                f"{deferred['expected'].tolist()}). The op's result was "
                f"discarded on every rank. Use distinct tensor names for "
                f"varying-size collectives, or set "
                f"HOROVOD_TPU_META_CACHE=0.")
            raise deferred["error"]


def _update_key(buckets) -> tuple:
    """The identity of one ZeRO-1 layout's update (the reference's
    ``update_key``): its buckets' tokens, the key of its held prefetch
    leg."""
    return ("zero1",) + tuple(b.token for b in buckets)


def _host_key() -> int:
    """This process's host, as an int64 an allgather can carry."""
    return zlib.crc32(socket.gethostname().encode())


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
