"""Step-capture replay: record a step's collective stream, then service
matching steps with one armed program.

The port of ``horovod_tpu/core/replay.py`` (the reference's answer to
per-step host cost, there one fused XLA launch; here one CUDA graph):

- ``Engine.step_begin()``/``step_end()`` mark a step (``hvd.step_begin``,
  ``hvd.step_end``, ``hvd.step()``; ``DistributedOptimizer`` brackets its
  reduction at size > 1). Between them every engine collective reports a
  :class:`CallSig` here — (kind, op or root, shapes, dtypes, scale factors,
  digit-normalized name) — and the ordered tuple of them is the step's
  **signature**.
- Once one signature repeats ``HOROVOD_TPU_STEP_REPLAY_WARMUP`` times
  (default 3; ``HOROVOD_TPU_STEP_REPLAY=0`` disables) the stream is
  **armed**. Consecutive calls of one class (reduce or broadcast), op or
  root and scale factors form a segment; a segment's tensors are cut into
  the eager path's buckets (``bucket_by_size`` at the fusion threshold),
  and the plan — per bucket the pack, the prescale, the collective and the
  finish (Average's divide, the postscale) — becomes the armed program:

  * on the card, one CUDA graph (:class:`_GraphProgram`) captured into a
    private pool: K1's packs (``HOROVOD_PALLAS_PACK=1``) read the step's
    tensors through a persistent table (``kernels.PackTable``) refreshed
    before each launch, and with the knob off the plain pack fills the
    graph's input buffer before the launch; the NCCL collectives are graph
    nodes, and so is the step's one join advertisement at size > 1 with
    join live (a posted all_gather of constant metadata rows kept on the
    device). A matching step costs the table refreshes, one graph launch
    and one copy of each bucket's reduced buffer into a fresh one, so a
    result held from one step keeps its values when the next replays. A
    capture or launch that fails raises: a CUDA tensor never takes the
    eager plan;
  * on CPU tensors (gloo) the same plan issued eagerly
    (:class:`_EagerProgram`): the same buckets and one advertisement a
    step, without the per-tensor registration and join rounds.
- Any divergence — another op, a wait before the recorded stream
  completes, a join substitute, ops after it — falls back: the tensors
  buffered so far go through the armed program with the missing slots
  zero-padded (slot results are independent, so the prefix is exact), the
  step finishes on the eager path, and the fallback is counted. In a world
  with join live only a stream that is one reduce segment arms, so a
  joined rank's zero substitute (one grouped allreduce of the advertised
  rows) issues the graph's collectives: the same buckets in the same order.
- ``join()`` and an elastic world-version bump invalidate every armed
  stream and every error-feedback residual; a move of the fusion
  threshold, the pack knob, the join switch or any knob the algorithm
  selection reads (``Engine._algo_sig``: ``HOROVOD_TPU_COLLECTIVE_ALGO``,
  the thresholds, the legacy hierarchy switches, ``HOROVOD_TPU_COMPRESSION``
  and the alltoall knobs) rebuilds the armed program before its next
  launch.
- Algorithms (the reference's :704-760): a segment carries each bucket's
  algorithm beside its codec, as the eager calls resolve them, and the
  program runs that bucket's legs: the flat ``all_reduce``, the tree's
  pair rounds, the ladder's four legs on a buffer padded to the world
  size, or the codec's hierarchical arm. Before a capture every process
  group a graph's legs run on has run one collective eagerly
  (``Engine._warm_groups``): NCCL creates a group's communicator at its
  first collective, which a capture cannot hold. A sharded step's
  all-gathers, run eagerly after the wrapped update, pick flat or the
  two-level gather per bucket.
- Wire codecs (the reference's :187-192, :574-701): the call's codec is
  part of each :class:`CallSig` and of a segment's key. A bucket whose
  codec is not ``none`` runs the flat compressed reduction
  (``ops/collectives.py``) in the program, on the card inside the graph:
  K1 into a zero-tailed padded buffer, the encode, the all-to-all, the
  scales' all-gather, the decode-sum and the all-gather; a sharded step's
  bucket its compressed reduce-scatter. fp8 and int8 read and update, in
  place, the engine's own residual buffer of the bucket's key (fetched
  when the program is built, before any capture), so a single-call
  step's lineage runs on bitwise from the eager warm-up into the replayed
  steps; a buffer an armed program holds is never evicted or swapped
  (``held_residuals``), and an invalidation zeroes it in place.
- The sharded arm (the reference's ``intercept("sharded_step", ...)``,
  ``core/engine.py:1996``): a step that is one ``Engine.sharded_step``
  (ZeRO-1) arms after the warm-up like any other. Its program holds the
  first half of the step over the caller's frozen buckets: on the card one
  CUDA graph (:class:`_ShardedGraphProgram`: per bucket K1 from its
  ``PackTable`` into the bucket's padded gradient buffer, whose tail stays
  zero, the prescale, the NCCL reduce-scatter into this rank's shard in
  place and the finish), on gloo the same issued eagerly
  (:class:`_ShardedEagerProgram`). The wrapped optimizer's update is not
  captured (it reads ``lr`` and the other hyperparameters as Python
  numbers at every step, so a scheduler's moves must reach it): it runs
  eagerly after the launch, and the all-gathers after it as eager NCCL
  calls, all within the step's one dispatch. With join live, the step's
  join round is read on the host before the launch
  (``Engine._join_guard``), outside the graph.

Replayable kinds: allreduce, grouped_allreduce, broadcast,
grouped_broadcast, grouped_alltoall and sharded_step. allgather, the
uneven alltoall, reducescatter, barrier and Adasum go through
:meth:`StepReplay.observe`: a step holding one never arms.
- The grouped-alltoall arm (the reference's "a2a" segments): its buckets
  carry the eager call's algorithm and cross-phase codec; the program
  packs each bucket's members into a static (n, R) buffer (before the
  launch on the card, where the graph holds the ``all_to_all_single`` or
  the two-phase exchange), and each result is a column block of a fresh
  copy of the received buffer. With join live at size > 1 such a stream
  stays unarmed, as in the reference (a joined rank's substitute would
  post its own round mid-step); the MoE-EP step replays under
  ``HOROVOD_JOIN_DISABLE=1``.

Not ported: the reference's overlap modes, staged sub-launches, the
ZeRO-1 prefetch leg and the single-launch form (A10's remainder).

Observability (the reference's :227-235, :771-875): the registry counts
bracketed steps, armed streams, replayed steps, fallbacks (by reason,
digit runs made ``#``) and invalidations beside the plain counters
(``captured_streams``, ``replayed_steps``, ``fallbacks``); a fallback also
reaches the stall inspector (``engine.replay_fallback_counter``) and every
event the timeline (``engine.on_replay``). A replayed step is stamped as
one collective ``replay.step.<n>`` (trace enqueue, its launch span
``XLA_REPLAY_DISPATCH``, and a tracked handle whose completion the first
wait on any of the step's results reports): all of it on the host, once a
step, none of it inside the CUDA graph. ``HOROVOD_TPU_DEBUG_CONSISTENCY=1``
keeps every stream unarmed, so every call is checked.
"""

from __future__ import annotations

import collections
import re
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common.lru import lru_get, lru_put
from ..common.reduce_ops import ReduceOp
from ..faults import failpoint
from ..metrics import registry as metrics_registry
from ..ops import collectives as C
from ..ops import compression as _comp
from ..ops import kernels

# step counters in tensor names ("grad.s17") must not make otherwise
# identical steps look distinct: digit runs are normalized away
_DIGITS = re.compile(r"\d+")

_REDUCE_KINDS = ("allreduce", "grouped_allreduce")
_BCAST_KINDS = ("broadcast", "grouped_broadcast")
# the even-split grouped alltoall (the MoE dispatch): fixed shapes a step,
# so it replays; the uneven eager alltoall stays on the observe path
_A2A_KINDS = ("grouped_alltoall",)
_SHARDED = "sharded_step"
_REPLAYABLE = _REDUCE_KINDS + _BCAST_KINDS + _A2A_KINDS + (_SHARDED,)
_MAX_STREAMS = 16  # bound on the per-signature table (LRU)


class CallSig(NamedTuple):
    """One recorded engine call: (kind, op, dtype, shape, name) and the
    scale factors, which change the armed program."""
    kind: str
    code: int          # ReduceOp code, or root rank for broadcasts
    shapes: tuple      # per-tensor shape tuples
    dtypes: tuple      # per-tensor dtype strings ("torch.float32")
    pre: float
    post: float
    name: str          # digit-normalized name template
    replayable: bool
    # a sharded step's buckets (collectives.ShardBucket, the caller's
    # frozen layout), compared by identity: another optimizer's step is
    # another signature
    layout: object = None
    # the call's wire codec (the reference's extra=(call_codec,))
    codec: str = "none"


def _make_sig(kind: str, tensors, code: int, pre: float, post: float,
              name: Optional[str], replayable: bool,
              layout=None, codec: str = "none") -> CallSig:
    return CallSig(
        kind, int(code),
        tuple(tuple(t.shape) for t in tensors),
        tuple(str(t.dtype) for t in tensors),
        float(pre), float(post),
        _DIGITS.sub("#", name or ""), replayable,
        None if layout is None else tuple(layout), codec)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name.rsplit(".", 1)[-1])


class _LeafProxy:
    """Shape/dtype stand-in with the ``.nbytes``/``.dtype`` surface
    ``bucket_by_size`` consumes, so arming can bucket without tensors."""
    __slots__ = ("shape", "dtype", "nbytes")

    def __init__(self, shape, dtype_str):
        self.shape = shape
        self.dtype = _torch_dtype(dtype_str)
        self.nbytes = int(np.prod(shape)) * self.dtype.itemsize


class _Bound:
    """Result of one replayed tensor: its value (or a function that reads
    it once the launch is done) and the launch's shared completion (one
    :class:`~.engine.LaunchGroup` a launch). ``rep`` is the step's tracked
    handle: the first wait that sees the launch complete reports its
    completion."""
    __slots__ = ("_group", "_value", "rep")

    def __init__(self, group, value):
        self._group = group
        self._value = value
        self.rep = None

    def poll(self) -> bool:
        done = self._group.ready()
        if done and self.rep is not None:
            self.rep.poll()
        return done

    def synchronize(self):
        self._group.wait()
        if self.rep is not None:
            self.rep.poll()
        if callable(self._value):
            self._value = self._value()
        return self._value


class ReplayHandle:
    """Handle returned while a step is being replayed. Until the recorded
    stream completes the armed program has not launched yet: any wait
    forces it (zero-padding the slots not submitted yet, a counted
    fallback)."""
    __slots__ = ("_replay", "name", "_bound")

    def __init__(self, replay: "StepReplay", name: str):
        self._replay = replay
        self.name = name
        self._bound: Optional[_Bound] = None

    def _require(self) -> _Bound:
        if self._bound is None:
            self._replay.force_launch()
        return self._bound

    def poll(self) -> bool:
        return self._require().poll()

    def synchronize(self):
        return self._require().synchronize()


class _Segment(NamedTuple):
    """Consecutive recorded calls of one class, op or root, scales and
    call codec."""
    cls: str           # "reduce", "bcast" or "a2a"
    code: int          # ReduceOp code, or the root rank
    pre: float
    post: float
    shapes: tuple
    dtypes: tuple
    buckets: tuple     # tuples of indices into shapes
    base: int          # the segment's first slot in the step's tensors
    codecs: tuple      # each bucket's wire codec
    residuals: tuple   # each bucket's (residual key, elems) or None
    algos: tuple       # each bucket's collective algorithm


def _stream_nbytes(stream) -> int:
    """The payload bytes of a recorded stream's tensors."""
    return sum(_LeafProxy(s, d).nbytes
               for sig in stream for s, d in zip(sig.shapes, sig.dtypes))


class _Bucket(NamedTuple):
    seg: _Segment
    slots: tuple       # slots of the step's tensors, in pack order
    shapes: tuple
    dtype: torch.dtype
    codec: str
    residual: Optional[tuple]   # (engine residual key, elems)
    algo: str

    @property
    def numels(self) -> List[int]:
        return [int(np.prod(s)) for s in self.shapes]


def _buckets(segments) -> List[_Bucket]:
    return [_Bucket(seg, tuple(seg.base + i for i in idxs),
                    tuple(seg.shapes[i] for i in idxs),
                    _torch_dtype(seg.dtypes[idxs[0]]), seg.codecs[j],
                    seg.residuals[j], seg.algos[j])
            for seg in segments for j, idxs in enumerate(seg.buckets)]


def _residual_buffers(engine, buckets) -> list:
    """The engine's residual buffer of each bucket (None without error
    feedback), fetched now: never inside a capture, where a new buffer's
    zero fill would become a node of the graph."""
    bufs = engine._fetch_residuals([(j, b.residual[0], b.residual[1],
                                     b.dtype)
                                    for j, b in enumerate(buckets)
                                    if b.residual is not None])
    return [bufs.get(j) for j in range(len(buckets))]


def _held_keys(buckets) -> frozenset:
    return frozenset(b.residual[0] for b in buckets if b.residual is not None)


def _selection_counts(engine, buckets):
    """The engine's selection counts of one launch of the program's reduce
    and alltoall buckets (``Engine._selection_counts``): a replayed step
    moves the bytes the eager step would."""
    sel, links = collections.Counter(), collections.Counter()
    for kind, cls in (("allreduce", "reduce"), ("alltoall", "a2a")):
        bs = [b for b in buckets if b.seg.cls == cls]
        s, l = engine._selection_counts(
            kind, [sum(b.numels) * b.dtype.itemsize for b in bs],
            [b.dtype.itemsize for b in bs], [b.algo for b in bs],
            [b.codec for b in bs])
        sel.update(s)
        links.update(l)
    return sel, links


class _EagerProgram:
    """The armed plan issued eagerly, for CPU tensors: per bucket the pack,
    the prescale, the collective (or the compressed reduction) and the
    finish, as the eager grouped calls issue them, behind one join
    advertisement a step."""
    tables = 0
    copy_outs = 0

    def __init__(self, engine, segments, join_metas):
        self.engine = engine
        self.buckets = _buckets(segments)
        self.join_metas = join_metas
        self.residual_keys = _held_keys(self.buckets)
        self.codecs = [b.codec for b in self.buckets]
        self.counts = _selection_counts(engine, self.buckets)

    def launch(self, inputs: Sequence[torch.Tensor]) -> List[_Bound]:
        from .engine import LaunchGroup, _translate_failure
        eng = self.engine
        if self.join_metas is not None:
            eng._join_sync("grouped_allreduce", self.join_metas, False)
        residuals = _residual_buffers(eng, self.buckets)
        out: List[Optional[_Bound]] = [None] * len(inputs)
        for b, residual in zip(self.buckets, residuals):
            ts = [inputs[s] for s in b.slots]
            seg = b.seg
            if seg.cls == "a2a":
                size = eng.backend.size()
                packed = C.a2a_pack(ts, size)
                if size == 1:
                    got, group = packed, LaunchGroup(())
                else:
                    got, group = eng._a2a_launch(packed, b.algo, b.codec)
                unpack = C.lazy_a2a_unpack(got, b.shapes)
                for j, s in enumerate(b.slots):
                    out[s] = _Bound(group, lambda j=j, f=unpack: f()[j])
                continue
            if b.codec != _comp.CODEC_NONE:
                flat, group = eng._codec_launch(ts, b.codec, residual,
                                                ReduceOp(seg.code), seg.pre,
                                                seg.post, b.algo)
            elif seg.cls == "reduce":
                flat, group = eng._bucket_launch(ts, ReduceOp(seg.code),
                                                 seg.pre, seg.post, b.algo)
            else:
                flat = C.pack_bucket(ts, False)
                group = LaunchGroup(_translate_failure(
                    dist.broadcast, flat, src=seg.code, async_op=True))
            for s, v in zip(b.slots, C.unpack_flat(flat, b.shapes)):
                out[s] = _Bound(group, v)
        return out


class _GraphProgram:
    """The armed plan as one CUDA graph, captured once into a private pool:
    the join advertisement's all_gathers, then per bucket K1 from its
    :class:`~..ops.kernels.PackTable` (or nothing, where the plain pack
    fills the bucket's buffer before the launch), the prescale, the NCCL
    collectives of the bucket's algorithm (one ``all_reduce``, the tree's
    pair rounds, or the ladder on a buffer padded to the world size) and
    the finish; a bucket with a wire codec packs into a zero-tailed padded
    buffer and runs the compressed reduction (its hierarchical arm on the
    ladder) on the engine's residual buffer. Every process group the legs
    run on has run a collective before the capture. A launch refreshes
    the tables, replays the graph on the current stream and copies each
    bucket's reduced buffer into a fresh one, whose views are the
    results."""

    def __init__(self, engine, segments, join_metas):
        from .engine import _KIND_CODES, _dist_op
        eng = self.engine = engine
        dev = self.device = eng.backend.device
        self.buckets = _buckets(segments)
        self.residual_keys = _held_keys(self.buckets)
        self.codecs = [b.codec for b in self.buckets]
        self.counts = _selection_counts(eng, self.buckets)
        residuals = _residual_buffers(eng, self.buckets)
        size, rank = eng.backend.size(), eng.backend.rank()
        algos = [b.algo for b in self.buckets if b.seg.cls != "bcast"]
        eng._warm_groups(algos)
        hier_groups = (eng.hierarchical_groups()
                       if C.ALGO_HIERARCHICAL in algos else None)
        local, cross = eng._hier_sizes()
        # the step's one advertisement: the join round's head and overflow
        # rows, constant, on the device from pinned memory with no host wait
        self._advert = []
        if join_metas is not None:
            slots = eng.config.join_meta_slots
            vecs = [eng._join_head(0, 0, _KIND_CODES["grouped_allreduce"],
                                   join_metas)]
            if len(join_metas) > slots:
                vecs.append(np.concatenate(join_metas[slots:]))
            for vec in vecs:
                host = torch.from_numpy(vec).pin_memory()
                mine = host.to(dev, non_blocking=True)
                self._advert.append((host, mine,
                                     mine.new_empty(size * mine.numel())))
        use_k1 = eng.config.pack_kernel
        self._tables = [kernels.PackTable(b.numels, b.dtype, dev)
                        if use_k1 and b.seg.cls == "reduce" else None
                        for b in self.buckets]
        self.tables = sum(t is not None for t in self._tables)
        self.copy_outs = len(self.buckets)
        # an alltoall bucket's (n, R) exchange buffer, filled before each
        # launch with its members' chunk matrices
        self._a2a_in = [torch.empty((size, sum(b.numels) // size),
                                    dtype=b.dtype, device=dev)
                        if b.seg.cls == "a2a" else None
                        for b in self.buckets]
        # each bucket's reduced elements: the whole buffer, or the prefix
        # of a codec bucket's padded one
        self._flats: List[torch.Tensor] = []
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                     capture_error_mode="thread_local")
            try:
                for _, mine, gathered in self._advert:
                    C.all_gather(gathered, mine, None)
                for b, table, residual, a2a_in in zip(
                        self.buckets, self._tables, residuals, self._a2a_in):
                    seg = b.seg
                    total = sum(b.numels)
                    if seg.cls == "a2a":
                        if size == 1:
                            got = a2a_in.clone()
                        elif b.algo == C.ALGO_HIERARCHICAL:
                            got = C.hier_alltoall(a2a_in, *hier_groups,
                                                  local, cross, b.codec)
                        else:
                            got = torch.empty_like(a2a_in)
                            C.all_to_all(got, a2a_in, [1] * size,
                                         [1] * size, None)
                        self._flats.append(got)
                        continue
                    avg = size if (seg.cls == "reduce" and seg.code
                                   == ReduceOp.AVERAGE) else 1
                    hier = b.algo == C.ALGO_HIERARCHICAL
                    coded = b.codec != _comp.CODEC_NONE
                    if coded or hier:
                        # the codec's hierarchical arm pads to the local
                        # size, the ladder and the flat arm to the world's
                        padded = C.padded_bucket(
                            total, local if hier and coded else size,
                            b.dtype, dev)
                        flat = padded[:total]
                    else:
                        flat = torch.empty(total, dtype=b.dtype, device=dev)
                    self._flats.append(flat)
                    if table is not None:
                        table.capture(flat)
                    if coded and hier:
                        C.codec_hier_allreduce(
                            padded, total, residual, b.codec, local, cross,
                            avg, seg.pre, seg.post, *hier_groups)
                    elif coded:
                        C.codec_allreduce(
                            padded, total, residual, b.codec, size, rank,
                            avg, seg.pre, seg.post, None)
                    elif seg.cls == "reduce":
                        C.prescale(flat, seg.pre)
                        if b.algo == C.ALGO_TREE:
                            C.tree_allreduce(flat, eng._tree_groups)
                        elif hier:
                            C.hier_allreduce(padded, *hier_groups, local,
                                             cross)
                        else:
                            dist.all_reduce(flat,
                                            op=_dist_op(ReduceOp(seg.code)))
                        C.finish_reduce(flat, avg, seg.post)
                    else:
                        dist.broadcast(flat, src=seg.code)
            finally:
                self.graph.capture_end()

    def launch(self, inputs: Sequence[torch.Tensor]) -> List[_Bound]:
        from .engine import LaunchGroup, _StreamWork
        for b, table, flat, a2a_in in zip(self.buckets, self._tables,
                                          self._flats, self._a2a_in):
            ts = [inputs[s] for s in b.slots]
            if a2a_in is not None:
                n = a2a_in.shape[0]
                torch.cat([t.reshape(n, -1) for t in ts], dim=1, out=a2a_in)
            elif table is not None:
                table.refresh(ts)
            else:
                torch.cat([t.reshape(-1) for t in ts], out=flat)
        self.graph.replay()
        kernels.pack.graph_launches += self.tables
        fresh = [flat.clone() for flat in self._flats]
        group = LaunchGroup(_StreamWork(self.device))
        out: List[Optional[_Bound]] = [None] * len(inputs)
        for b, buf in zip(self.buckets, fresh):
            views = (C.a2a_unpack(buf, b.shapes) if b.seg.cls == "a2a"
                     else C.unpack_flat(buf, b.shapes))
            for s, v in zip(b.slots, views):
                out[s] = _Bound(group, v)
        return out


class _ShardedEagerProgram:
    """The sharded arm on CPU tensors: the step's join round, read
    (``Engine._join_guard``), then per bucket the pack, prescale,
    reduce-scatter (compressed, for a bucket with a wire codec) and finish,
    as ``Engine.sharded_step`` issues them."""
    tables = 0
    copy_outs = 0
    # the engine counts a sharded step's selections on both of its paths
    counts = None

    def __init__(self, engine, sig: CallSig):
        self.engine, self.sig = engine, sig
        # Average's divide
        self.n = engine.backend.size() if sig.code == ReduceOp.AVERAGE else 1
        self.codecs = engine._bucket_codecs(
            _SHARDED, [b.grads.dtype for b in sig.layout], sig.codec,
            count=False)
        self.residual_keys = frozenset(
            k for k in (engine._sharded_residual_key(b, c)
                        for b, c in zip(sig.layout, self.codecs))
            if k is not None)

    def launch(self, inputs: Sequence[torch.Tensor]) -> List[_Bound]:
        from .engine import LaunchGroup, _StreamWork
        eng, sig = self.engine, self.sig
        eng._join_guard(_SHARDED)
        C.scatter_shards(sig.layout, inputs, eng.config.pack_kernel, self.n,
                         sig.pre, sig.post, None, True, self.codecs,
                         eng._sharded_residuals(sig.layout, self.codecs))
        group = LaunchGroup(_StreamWork(eng.backend.device))
        return [_Bound(group, None)] * len(inputs)


class _ShardedGraphProgram(_ShardedEagerProgram):
    """The sharded arm as one CUDA graph, captured once into a private
    pool: per bucket K1 from its :class:`~..ops.kernels.PackTable` into the
    bucket's padded gradient buffer (or nothing, where the plain pack
    fills it before the launch), the prescale, the NCCL reduce-scatter
    into this rank's shard in place (the compressed one on the engine's
    residual buffer, for a bucket with a wire codec) and the finish. The
    buffers are the layout's own, so the graph copies nothing out: the
    wrapped optimizer reads the shard's gradient where the graph left
    it."""

    def __init__(self, engine, sig: CallSig):
        super().__init__(engine, sig)
        dev = self.device = engine.backend.device
        residuals = (engine._sharded_residuals(sig.layout, self.codecs)
                     or [None] * len(sig.layout))
        self._tables = [kernels.PackTable(b.sizes, b.grads.dtype, dev)
                        if engine.config.pack_kernel else None
                        for b in sig.layout]
        self.tables = sum(t is not None for t in self._tables)
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                     capture_error_mode="thread_local")
            try:
                for b, table, codec, residual in zip(
                        sig.layout, self._tables, self.codecs, residuals):
                    if table is not None:
                        table.capture(b.grads[:b.total])
                    C.prescale(b.grads[:b.total], sig.pre)
                    if codec != _comp.CODEC_NONE:
                        C.rs_flat_codec(b.grads, b.grad_shard, residual,
                                        codec, b.n, None)
                    else:
                        C.rs_flat(b.grads, b.grad_shard, None)
                    C.finish_reduce(b.grad_shard, self.n, sig.post)
            finally:
                self.graph.capture_end()

    def launch(self, inputs: Sequence[torch.Tensor]) -> List[_Bound]:
        from .engine import LaunchGroup, _StreamWork
        self.engine._join_guard(_SHARDED)
        for b, table in zip(self.sig.layout, self._tables):
            ts = [inputs[i] for i in b.idxs]
            if table is not None:
                table.refresh(ts)
            else:
                kernels.pack_plain(ts, out=b.grads)
        self.graph.replay()
        kernels.pack.graph_launches += self.tables
        group = LaunchGroup(_StreamWork(self.device))
        return [_Bound(group, None)] * len(inputs)


class _Armed(NamedTuple):
    # the knobs the program was built under: a move rebuilds it
    threshold: int
    pack_kernel: bool
    join_live: bool
    compression: str
    algo_sig: tuple               # Engine._algo_sig() at the build
    program: object               # _GraphProgram or _EagerProgram
    # the step's payload bytes and their split by link (None for the
    # sharded arm), stamped on the replayed step's trace event
    nbytes: int = 0
    link_bytes: Optional[dict] = None


class StepReplay:
    """Per-engine capture/replay state machine. Every mutation happens on
    the thread that issues the collectives; nothing here is locked."""

    def __init__(self, engine):
        self.engine = engine
        # signature -> {"streak": int, "armed": _Armed | None}
        self._seen: Dict[tuple, dict] = {}
        self._mode = "idle"   # idle|off|record|replay|drain
        self._in_step = False
        self._world_version = engine.world_version
        self._recording: List[CallSig] = []
        # replay-mode per-step state
        self._cands: List[tuple] = []
        self._pos = 0
        self._buffered: List[list] = []
        self._handles: List[List[ReplayHandle]] = []
        self._launched = False
        # counters
        self.replayed_steps = 0
        self.captured_streams = 0
        self.fallbacks = 0
        # host-to-device table refreshes and copy-outs of replayed steps
        # on the card (the launches a graph launch brings beside it)
        self.table_copies = 0
        self.copy_outs = 0
        # the step's identity in its replayed launch's name
        self._step_token = 0
        _reg = metrics_registry()
        self._m_steps = _reg.counter("hvd_tpu_steps_total")
        self._m_armed = _reg.counter("hvd_tpu_replay_armed_total")
        self._m_replayed = _reg.counter("hvd_tpu_replay_replayed_steps_total")
        self._m_fallbacks = _reg.counter("hvd_tpu_replay_fallbacks_total")
        self._m_invalidations = _reg.counter(
            "hvd_tpu_replay_invalidations_total")

    # -- step lifecycle ----------------------------------------------------

    def step_begin(self):
        if self._in_step:
            self.step_end()
        eng = self.engine
        self._step_token += 1
        self._in_step = True
        self._recording = []
        self._pos = 0
        self._buffered = []
        self._handles = []
        self._launched = False
        version = eng._refresh_world_version()
        # divcheck: agreed[world-version bumps are rendezvous-stamped before any rank re-enters a step, so every rank compares the same pair at its next step_begin]
        if version != self._world_version:
            self.invalidate_all("world-version bump "
                                f"({self._world_version} -> {version})")
            self._world_version = version
        if not eng.config.step_replay:
            self._mode = "off"
            return
        cands = [s for s, ent in self._seen.items()
                 if self._current_armed(s, ent) is not None]
        if cands:
            self._mode = "replay"
            self._cands = cands
        else:
            self._mode = "record"

    def step_end(self):
        if not self._in_step:
            return
        self._m_steps.inc()
        try:
            if self._mode == "replay" and self._pos > 0 and not self._launched:
                complete = [s for s in self._cands if len(s) == self._pos]
                if complete:
                    # prefix-ambiguity resolved by the step ending here
                    self._launch(complete[0])
                else:
                    self._fallback("step ended before the recorded stream "
                                   "completed")
            stream = tuple(self._recording)
            if stream:
                self._note_stream(stream)
        finally:
            self._mode = "idle"
            self._in_step = False
            self._cands = []

    def _note_stream(self, stream: tuple):
        ent = lru_get(self._seen, stream)
        if ent is None:
            ent = lru_put(self._seen, stream, {"streak": 0, "armed": None},
                          _MAX_STREAMS)
        ent["streak"] += 1
        cfg = self.engine.config
        if (ent["armed"] is None and cfg.step_replay
                and not cfg.debug_consistency
                and ent["streak"] >= max(cfg.step_replay_warmup, 1)):
            ent["armed"] = self._build_armed(stream)
            if ent["armed"] is not None:
                self.captured_streams += 1
                self._m_armed.inc()
                self.engine._emit_replay(
                    "capture",
                    f"armed after {ent['streak']} identical steps: "
                    f"{len(stream)} ops, "
                    f"{sum(len(s.shapes) for s in stream)} tensors")

    def invalidate_all(self, reason: str):
        """Drop every armed stream and recorded streak (join(), elastic
        world-version bumps, explicit resets); the armed graphs and their
        buffers go with them."""
        had_armed = any(e.get("armed") for e in self._seen.values())
        self._seen.clear()
        if self._mode in ("replay", "drain"):
            if self._pos > 0 and not self._launched:
                self._fallback(f"invalidated mid-step: {reason}")
            self._mode = "record" if self._in_step else "idle"
            self._cands = []
        if had_armed:
            self._m_invalidations.inc()
            self.engine._emit_replay("invalidate", reason)
        # the residuals ride the same edge, once no armed program holds one
        self.engine.invalidate_residuals(reason)

    def held_residuals(self) -> set:
        """The residual keys the armed programs hold (their buffers are
        nodes' operands in a graph on the card)."""
        return {k for ent in self._seen.values()
                if ent.get("armed") is not None
                for k in ent["armed"].program.residual_keys}

    # -- per-call interception --------------------------------------------

    def intercept(self, kind: str, tensors: Sequence, code: int, pre: float,
                  post: float, name: Optional[str], sub: bool,
                  layout: Optional[Sequence] = None, codec: str = "none"):
        """Called by every replayable engine entry point before it
        registers anything (a sharded step passes its buckets as
        ``layout``, a reduction its call codec). Returns None to proceed on
        the eager path, or the handles servicing the call from the
        (pending) armed launch."""
        mode = self._mode
        if mode in ("idle", "off"):
            return None
        if sub:
            # a join substitute mid-step: never replayed, and a step
            # holding one is not steady state
            if mode in ("replay", "drain"):
                self._fallback("join substitute dispatched mid-step")
            self._recording.append(_make_sig(kind, tensors, code, pre, post,
                                             name, replayable=False))
            return None
        sig = _make_sig(kind, tensors, code, pre, post, name,
                        replayable=kind in _REPLAYABLE, layout=layout,
                        codec=codec)
        self._recording.append(sig)
        if mode == "record":
            return None
        if mode == "drain":
            # more ops than the replayed stream had: its prefix was
            # serviced; the step finishes on the eager path and the longer
            # signature is learned from _recording
            self._fallback("ops submitted after the replayed stream "
                           "completed")
            return None
        # mode == "replay"
        cands = [s for s in self._cands
                 if len(s) > self._pos and s[self._pos] == sig]
        if not cands:
            self._fallback(f"signature divergence at op {self._pos} "
                           f"({kind})")
            return None
        self._cands = cands
        handles = [ReplayHandle(self, f"{name or kind}.{j}")
                   for j in range(len(tensors))]
        self._buffered.append(list(tensors))
        self._handles.append(handles)
        self._pos += 1
        complete = [s for s in cands if len(s) == self._pos]
        if complete and len(cands) == 1:
            self._launch(complete[0])
            self._mode = "drain"
        return handles

    def observe(self, kind: str, sub: bool, tensors: Sequence = (),
                name: Optional[str] = None):
        """Record (or fall back on) an engine call replay cannot service:
        allgather, alltoall, reducescatter, barrier, Adasum. A step holding
        one never arms; one met while replaying is a divergence."""
        mode = self._mode
        if mode in ("idle", "off"):
            return
        if mode in ("replay", "drain"):
            self._fallback(f"unreplayable op {kind} mid-step")
        self._recording.append(_make_sig(kind, tensors, 0, 1.0, 1.0, name,
                                         replayable=False))

    def force_launch(self):
        """A ReplayHandle was awaited before the recorded stream completed:
        launch now. A candidate complete at this position launches clean;
        otherwise zero-pad (a counted fallback)."""
        if self._launched:
            return
        complete = [s for s in self._cands if len(s) == self._pos]
        if complete:
            self._launch(complete[0])
            self._mode = "drain"
        else:
            self._fallback("handle awaited before the recorded stream "
                           "completed")

    # -- internals ---------------------------------------------------------

    def _join_live(self) -> bool:
        eng = self.engine
        return eng.config.join_enabled and eng.backend.size() > 1

    def _current_armed(self, stream: tuple, ent: dict) -> Optional[_Armed]:
        """The armed program, rebuilt if the fusion threshold, the pack
        knob, the join switch or a knob the selection reads (the wire codec
        knob among them) moved since it was built."""
        armed = ent.get("armed")
        if armed is None:
            return None
        cfg = self.engine.config
        if (armed.threshold != cfg.fusion_threshold_bytes
                or armed.pack_kernel != cfg.pack_kernel
                or armed.join_live != self._join_live()
                or armed.compression != cfg.compression
                or armed.algo_sig != self.engine._algo_sig()):
            ent["armed"] = None      # the old graph goes before the new one
            armed = self._build_armed(stream)
            ent["armed"] = armed
        return armed

    def _build_armed(self, stream: tuple) -> Optional[_Armed]:
        from .engine import _meta_row, _op_field, bucket_by_size
        eng = self.engine
        cfg = eng.config
        if not all(sig.replayable for sig in stream):
            return None
        join_live = self._join_live()
        if any(sig.kind == _SHARDED for sig in stream):
            # the sharded arm: a step that is one sharded step (the update
            # between its halves must run before anything after it)
            if len(stream) != 1:
                return None
            program_cls = (_ShardedGraphProgram
                           if eng.backend.device.type == "cuda"
                           else _ShardedEagerProgram)
            return _Armed(cfg.fusion_threshold_bytes, cfg.pack_kernel,
                          join_live, cfg.compression, eng._algo_sig(),
                          program_cls(eng, stream[0]),
                          nbytes=_stream_nbytes(stream))
        segs: List[dict] = []
        for sig in stream:
            cls = ("reduce" if sig.kind in _REDUCE_KINDS else
                   "a2a" if sig.kind in _A2A_KINDS else "bcast")
            key = (cls, sig.code, sig.pre, sig.post, sig.codec)
            if not segs or segs[-1]["key"] != key:
                segs.append({"key": key, "shapes": [], "dtypes": [],
                             "name": sig.name, "kind": sig.kind})
            segs[-1]["shapes"].extend(sig.shapes)
            segs[-1]["dtypes"].extend(sig.dtypes)
        join_metas = None
        if join_live:
            # a joined peer matches the advertisement with one zero
            # grouped allreduce, whose collectives are the program's only
            # for a single reduce segment; anything else stays unarmed (an
            # alltoall's substitute would post its own round mid-step: MoE
            # replay runs with HOROVOD_JOIN_DISABLE=1, as in the reference)
            if len(segs) != 1 or segs[0]["key"][0] != "reduce":
                return None
            _, code, _, _, codec = segs[0]["key"]
            try:
                join_metas = [_meta_row(s, _torch_dtype(d),
                                        _op_field(ReduceOp(code), codec))
                              for s, d in zip(segs[0]["shapes"],
                                              segs[0]["dtypes"])]
            except ValueError:    # a dtype or rank the join rows cannot carry
                return None
        segments, base = [], 0
        for seg in segs:
            cls, code, pre, post, codec = seg["key"]
            proxies = [_LeafProxy(s, d)
                       for s, d in zip(seg["shapes"], seg["dtypes"])]
            buckets = bucket_by_size(proxies, cfg.fusion_threshold_bytes)
            # the codecs, algorithms and residual rows the eager calls
            # resolve
            dtypes = [proxies[b[0]].dtype for b in buckets]
            nbytes = [sum(proxies[i].nbytes for i in idxs)
                      for idxs in buckets]
            if cls == "a2a":
                # each bucket's algorithm and cross-phase codec, as the
                # eager call resolves them; no residual (stateless codec)
                _, algos, codecs = eng._a2a_plan(proxies, buckets,
                                                 count=False)
            else:
                codecs = eng._bucket_codecs(seg["kind"], dtypes, codec,
                                            count=False)
                algos = ((C.ALGO_FLAT,) * len(buckets) if cls != "reduce"
                         else eng._bucket_algos("allreduce", nbytes,
                                                ReduceOp(code)))
            residuals = [None] * len(buckets)
            for b, key, elems, _ in ([] if cls == "a2a" else
                                     eng._grouped_residuals(
                    "gar", seg["name"],
                    [sum(int(np.prod(proxies[i].shape)) for i in idxs)
                     for idxs in buckets], dtypes, codecs, algos)):
                residuals[b] = (key, elems)
            segments.append(_Segment(cls, code, pre, post,
                                     tuple(seg["shapes"]),
                                     tuple(seg["dtypes"]),
                                     tuple(tuple(b) for b in buckets), base,
                                     codecs, tuple(residuals), algos))
            base += len(seg["shapes"])
        program_cls = (_GraphProgram if eng.backend.device.type == "cuda"
                       else _EagerProgram)
        program = program_cls(eng, segments, join_metas)
        return _Armed(cfg.fusion_threshold_bytes, cfg.pack_kernel, join_live,
                      cfg.compression, eng._algo_sig(), program,
                      nbytes=_stream_nbytes(stream),
                      link_bytes=dict(program.counts[1]))

    def _fallback(self, reason: str):
        self.fallbacks += 1
        # digit runs made "#" keep the label set bounded ("divergence at
        # op 3" and "at op 7" are one series)
        self._m_fallbacks.inc(reason=_DIGITS.sub("#", reason))
        eng = self.engine
        if eng.replay_fallback_counter is not None:
            eng.replay_fallback_counter(reason)
        eng._emit_replay("fallback", reason)
        if self._pos > 0 and not self._launched:
            # flush the buffered prefix through the armed program with
            # zero-padded missing slots: every rank reaches this fallback
            # at the same point, so the launch still matches its peers (and
            # a joined rank's substitute); slot results are independent,
            # so the prefix results are exact
            self._launch(min(self._cands, key=len), padded=True)
        self._mode = "record" if self._in_step else "idle"
        self._cands = []

    def _launch(self, stream: tuple, padded: bool = False):
        from .engine import (Handle, HorovodInternalError, LaunchGroup,
                             _translate_failure)
        eng = self.engine
        ent = self._seen.get(stream)
        armed = self._current_armed(stream, ent) if ent else None
        if armed is None:   # a knob moved to an unarmable config mid-step
            armed = self._build_armed(stream)
        if armed is None:
            raise HorovodInternalError(
                "replay stream lost its armed program mid-step")
        dev = eng.backend.device
        flat = []
        for ci, sig in enumerate(stream):
            bufs = self._buffered[ci] if ci < len(self._buffered) else None
            if bufs is None:
                bufs = [torch.zeros(s, dtype=_torch_dtype(d), device=dev)
                        for s, d in zip(sig.shapes, sig.dtypes)]
            flat.extend(bufs)
        program = armed.program
        # launched once a step, even if the launch raises (a sharded
        # step's join guard): step_end must not issue it again
        self._launched = True
        # the step's inputs are the program's now: holding them until the
        # next step_begin would keep a step's gradients alive through the
        # next backward
        self._buffered = []
        rep_name = f"replay.step.{self._step_token & 1023}"
        if eng.trace is not None:
            # the launch bypasses _register: stamp its correlation id here
            # (every rank replays the same stream in the same step, so the
            # per-name sequence numbers agree)
            eng.trace.record_enqueue(rep_name, "replay", armed.nbytes,
                                     eng.world_version,
                                     link_bytes=armed.link_bytes)
        if eng.on_enqueue is not None:
            eng.on_enqueue(rep_name, "replay", armed.nbytes)
        if any(c != _comp.CODEC_NONE for c in program.codecs):
            failpoint("compression.encode")
        t0 = time.perf_counter()
        bound = _translate_failure(program.launch, flat)
        eng._launched(rep_name, t0, activity="XLA_REPLAY_DISPATCH")
        # one tracked handle a replayed step: its completion reaches the
        # trace, the timeline and the stall inspector
        rep = eng._track(Handle(rep_name, LaunchGroup(()), lambda: None,
                                eng, "replay"))
        for b in bound:
            b.rep = rep
        if program.counts is not None:
            eng._count(program.counts)
        for codec in program.codecs:
            if codec != _comp.CODEC_NONE:
                eng.codec_selections[("replay", codec)] += 1
        self.table_copies += program.tables
        self.copy_outs += program.copy_outs
        k = 0
        for ci, sig in enumerate(stream):
            hs = self._handles[ci] if ci < len(self._handles) else None
            for j in range(len(sig.shapes)):
                if hs is not None:
                    hs[j]._bound = bound[k]
                k += 1
        if not padded:
            self.replayed_steps += 1
            self._m_replayed.inc()
            eng._emit_replay(
                "replay", f"{len(flat)} tensors in one launch "
                f"({type(program).__name__})")
