"""The checkpoint manager: async snapshots, peer-redundant placement,
commit-barrier generations, and elastic-world-resize restore (the port of
``horovod_tpu/checkpoint/manager.py``).

Write path (per generation ``g`` = the snapshot's step):

1. ``snapshot(tree, step)`` on the step path only *stamps* the request.
   Torch tensors are mutable: the next ``optimizer.step()`` overwrites
   parameters and moments in place, so the stamp captures their values —
   one device-side copy of each CUDA leaf into a staging buffer, issued on
   the current stream after the work that produced the values, and an
   event recorded behind the copies (a CPU leaf is cloned, a numpy or
   Python leaf copied). It never waits on the device. The device→host copy
   (into pinned host memory, on a side stream, once the event has fired),
   serialization, file writes, and KV publishes all run on the manager's
   background thread. Double-buffered: one write in flight plus one
   pending slot that a newer request replaces (counted as skipped; the
   newer stamp reuses its staging buffer) — step N+1 never blocks on step
   N's write, and at most two staging copies are alive: the worker drops
   its own once the device→host copy is done.
2. The worker writes this rank's shard + the shared header under
   ``<dir>/rank<r>/gen<g>/``, publishes the shard bytes to the rendezvous
   KV (scope ``ckptshard``, chunked), fetches its ``redundancy`` successor
   ranks' shards (disk, then KV) and stores them as local replicas, then
   writes/publishes its manifest LAST — manifest presence is the
   rank-local commit mark.
3. Old generations (and their KV chunks) are garbage-collected, keeping
   the newest ``keep``; a generation that never completed is deleted as
   soon as a newer one lands.

Restore path: find the newest generation whose manifests pass the
commit barrier (KV manifests first, disk scan fallback), re-publish
every locally-held shard to the KV (so a peer whose disk died can fetch
this rank's replica — the KV-mediated peer transfer), source each
needed shard own-disk → peer-disk (shared fs) → KV, verify checksums,
and re-slice the flat stream against the *current* world's
``shard_spec`` padding — a checkpoint written at np=N restores at any
np=M. With a template, each restored leaf goes to the template leaf's
device; :func:`training_template` and :func:`load_training_state` carry a
module and a ``torch.optim`` optimizer through it.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..faults import DROP, failpoint
from ..metrics import registry as metrics_registry
from . import manifest as mf
from . import shard_io
from .flatten import flatten

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

CKPT_KV_SCOPE = "ckpt"            # manifests: ckpt/<rank>
CKPT_SHARD_KV_SCOPE = "ckptshard"  # shard bytes: ckptshard/g<g>.r<q>

_GEN_PREFIX = "gen"


class CheckpointRestoreError(RuntimeError):
    """No durable generation could be restored (missing shards on every
    source, checksum corruption, an incomplete commit barrier, or a
    template the generation does not fit)."""


class RestoreResult(NamedTuple):
    """One restored generation. ``tree`` is the template's structure with
    the restored leaves (or the raw leaf list, CPU tensors, when no
    template was given); ``extras`` the header's pickled side blob."""
    tree: Any
    extras: Optional[dict]
    step: int
    world_version: int
    mode: str


class _Staged:
    """A stamped request's values: each leaf's :class:`shard_io.LeafSpec`
    and stream offset, the host leaves' copies by index, and the CUDA
    leaves' bytes at their stream offsets in one device staging buffer
    (``stage``, dropped by the worker once it is on the host), with the
    event recorded behind the copies and the (offset, bytes) runs of
    consecutive device leaves."""

    __slots__ = ("specs", "offsets", "host", "stage", "ready", "runs",
                 "total")

    def __init__(self, specs, offsets, host, stage, ready, runs, total):
        self.specs, self.offsets, self.host = specs, offsets, host
        self.stage, self.ready, self.runs = stage, ready, runs
        self.total = total


class _SnapReq(NamedTuple):
    staged: _Staged
    step: int
    extras: Optional[dict]
    zero1: Optional[tuple]  # (layout, n_shards) when ZeRO-1 rank-local


def _is_gen_dir(name: str) -> bool:
    return name.startswith(_GEN_PREFIX) and \
        name[len(_GEN_PREFIX):].isdigit()


def _gen_step(name: str) -> int:
    return int(name[len(_GEN_PREFIX):])


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 view (a copy where the tensor is
    not contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _stamp(leaves: list, spare: Optional[_Staged] = None) -> _Staged:
    """Capture the leaves' values now (see the module docstring): the CUDA
    leaves copied on the current stream into one staging buffer at their
    stream offsets (one multi-tensor copy for those whose offset suits
    their dtype, a byte copy each for the others), an event behind them;
    a clone of a CPU leaf; a copy of anything else. The staging buffer of
    ``spare``, a replaced request that never reached the worker, is
    reused where it is large enough: no allocation on the step path."""
    specs, offsets, host, dev_leaves = [], [], {}, []
    off = 0
    with torch.no_grad():
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor):
                x = x.detach()
                spec = shard_io.LeafSpec(tuple(x.shape),
                                         shard_io.dtype_name(x.dtype),
                                         x.numel() * x.element_size())
                if x.is_cuda:
                    dev_leaves.append((i, x))
                else:
                    host[i] = x.clone()
            else:
                a = np.array(x)
                spec = shard_io.LeafSpec(a.shape,
                                         shard_io.dtype_name(a.dtype),
                                         int(a.nbytes))
                host[i] = a
            specs.append(spec)
            offsets.append(off)
            off += spec.nbytes
        stage = ready = None
        runs: List[List[int]] = []
        if dev_leaves:
            devices = {x.device for _, x in dev_leaves}
            if len(devices) > 1:
                raise ValueError(f"a snapshot's CUDA leaves must lie on one "
                                 f"device, not {sorted(map(str, devices))}")
            dev = devices.pop()
            old = spare.stage if spare is not None else None
            if old is not None and old.device == dev and \
                    old.numel() >= off:
                # the replaced stamp's copies go first, whatever stream
                # they were issued on
                torch.cuda.current_stream(dev).wait_event(spare.ready)
                stage = old[:off]
            else:
                stage = torch.empty(off, dtype=torch.uint8, device=dev)
            dsts, srcs = [], []
            for i, x in dev_leaves:
                o, n = offsets[i], specs[i].nbytes
                if not n:
                    continue
                dst = stage[o:o + n]
                if o % x.element_size() == 0:
                    dsts.append(dst.view(x.dtype).view(x.shape))
                    srcs.append(x)
                else:
                    dst.copy_(_bytes_of(x))
                if runs and runs[-1][0] + runs[-1][1] == o:
                    runs[-1][1] += n
                else:
                    runs.append([o, n])
            if dsts:
                torch._foreach_copy_(dsts, srcs)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
    return _Staged(specs, offsets, host, stage, ready, runs, off)


# the device→host copy goes through a ring of pinned chunks of this size,
# each copied out on the host while the next one crosses: pinning a
# generation's worth of host memory at once holds the driver for about a
# second, stalling the training thread's CUDA calls
_PINNED_CHUNK = 64 * 1024 * 1024
_PINNED_SLOTS = 2


class CheckpointManager:
    """Per-rank async sharded checkpointing (see module docstring).

    ``kv`` is the rendezvous KV server ``(addr, port)`` (or an endpoint
    set, ``runner.http_client.resolve_endpoints``) or None (disk only —
    replicas then come from peer rank directories on a shared
    filesystem). ``trace`` is an optional ``TraceRecorder``: snapshot
    writes and restores record correlated spans (``ckpt.write.g<step>``,
    ``ckpt.restore.g<step>``) so the flight recorder shows the checkpoint
    timeline.
    """

    # lock discipline: the step path stamps requests while the worker
    # thread drains them; the tiny state machine rides one condition
    # variable (its lock). All I/O (the device→host copy, files, KV) is
    # off-lock on the worker thread. Deliberately NOT lock-guarded:
    # ``_provider`` and ``interval_steps`` are single-writer wiring attrs —
    # GlobalState assigns them once, before the first step can call
    # on_step, and the worker thread never touches them; the host buffer,
    # the pinned ring and the side stream are the worker thread's alone
    # once it runs (close() drops them after joining it); everything else
    # on the instance is a construction-time constant (a fresh manager is
    # built per world).
    _GUARDED_BY = {
        "_pending": "_cond",
        "_writing": "_cond",
        "_stopped": "_cond",
        "_last_written_step": "_cond",
        "_last_stages": "_cond",
    }

    def __init__(self, directory: str, rank: int = 0, world_size: int = 1,
                 *, world_version: int = 0, kv: Optional[Tuple[str, int]] = None,
                 redundancy: int = 1, keep: int = 2,
                 kv_chunk_bytes: Optional[int] = None,
                 kv_timeout: float = 30.0, trace=None):
        self.directory = str(directory)
        self.rank = int(rank)
        self.world_size = max(int(world_size), 1)
        self.world_version = int(world_version)
        self.kv = kv
        self.redundancy = max(0, min(int(redundancy), self.world_size - 1))
        self.keep = max(int(keep), 1)
        self.kv_timeout = float(kv_timeout)
        self.trace = trace
        if kv_chunk_bytes is None:
            from ..runner.http_client import DEFAULT_KV_CHUNK_BYTES
            kv_chunk_bytes = DEFAULT_KV_CHUNK_BYTES
        self.kv_chunk_bytes = int(kv_chunk_bytes)
        self._provider: Optional[Callable[[], tuple]] = None
        self.interval_steps = 0
        os.makedirs(self.rank_dir(self.rank), exist_ok=True)
        reg = metrics_registry()
        self._m_snapshots = reg.counter("hvd_tpu_ckpt_snapshots_total")
        self._m_bytes = reg.counter("hvd_tpu_ckpt_bytes_total")
        self._m_restore = reg.histogram("hvd_tpu_ckpt_restore_seconds")
        self._m_gc = reg.counter("hvd_tpu_ckpt_gc_total")
        self._m_stall = reg.histogram("hvd_tpu_ckpt_snapshot_stall_seconds")
        self._m_last_step = reg.gauge("hvd_tpu_ckpt_last_step")
        # the worker's host buffer (the stream), its ring of pinned chunks
        # and its side stream for the device→host copy; the ring is pinned
        # here, off the step path, where CUDA is up
        self._host_buf: Optional[np.ndarray] = None
        self._pinned: List[torch.Tensor] = []
        self._side_stream = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._ring(torch.device("cuda", torch.cuda.current_device()))
        self._cond = threading.Condition()
        self._pending: Optional[_SnapReq] = None
        self._writing = False
        self._stopped = False
        self._last_written_step = -1
        self._last_stages: Optional[dict] = None
        self._thread = threading.Thread(target=self._run,
                                        name="hvd-ckpt", daemon=True)
        self._thread.start()

    # -- paths ---------------------------------------------------------------

    def rank_dir(self, rank: int) -> str:
        """One rank's "disk". Tests model a lost host by deleting it."""
        return os.path.join(self.directory, f"rank{rank}")

    def gen_dir(self, step: int, rank: Optional[int] = None) -> str:
        return os.path.join(self.rank_dir(self.rank if rank is None
                                          else rank),
                            f"{_GEN_PREFIX}{int(step)}")

    @staticmethod
    def shard_file(gen_dir: str, shard_rank: int) -> str:
        return os.path.join(gen_dir, f"shard_{shard_rank}.bin")

    @staticmethod
    def _shard_kv_key(step: int, shard_rank: int) -> str:
        return f"g{int(step)}.r{int(shard_rank)}"

    # -- snapshot (step path) ------------------------------------------------

    def snapshot(self, tree, step: int, extras: Optional[dict] = None
                 ) -> bool:
        """Request an async snapshot of a **replicated** state tree at
        ``step`` (nested dicts, lists, tuples and namedtuples of tensors,
        numpy arrays and scalars; ``{"model": model.state_dict(), "opt":
        optimizer.state_dict()}`` for a torch training loop). The values
        are captured now, without a host wait. Returns False if a pending
        (not yet started) request was replaced — the caller's cadence
        outran the writer and the older request is dropped (counted as
        skipped), never blocked on."""
        t0 = time.perf_counter()
        leaves, _ = flatten(tree)
        spare = self._take_pending()
        accepted = self._enqueue(_SnapReq(_stamp(leaves, spare), int(step),
                                          extras, None))
        self._m_stall.observe(time.perf_counter() - t0)
        return accepted and spare is None

    def snapshot_zero1(self, shards, state_tree, layout, step: int,
                       extras: Optional[dict] = None) -> bool:
        """Request an async snapshot of this rank's **ZeRO-1 rank-local**
        state: per-bucket flat parameter shards + the inner optimizer
        state, with the optimizer's frozen bucket ``layout``
        (``[(idxs, sizes, total, shard)]``; all three as
        ``DistributedOptimizer.checkpoint_payload()`` returns them). The
        payload is already 1/world_size of the job's state; restore at a
        different world size re-slices it (``shard_io.zero1_reshard``)."""
        t0 = time.perf_counter()
        state_leaves, _ = flatten(state_tree)
        layout = tuple((tuple(i), tuple(s), int(t), int(sh))
                       for i, s, t, sh in layout)
        spare = self._take_pending()
        req = _SnapReq(_stamp(list(shards) + list(state_leaves), spare),
                       int(step), extras, (layout, len(shards)))
        accepted = self._enqueue(req)
        self._m_stall.observe(time.perf_counter() - t0)
        return accepted and spare is None

    def _take_pending(self) -> Optional[_Staged]:
        """Drop the pending request (counted skipped) before a newer one
        is stamped, and hand back its values for their staging buffer."""
        with self._cond:
            req, self._pending = self._pending, None
        if req is None:
            return None
        self._m_snapshots.inc(outcome="skipped")
        return req.staged

    def _enqueue(self, req: _SnapReq) -> bool:
        with self._cond:
            if self._stopped:
                return False
            replaced = self._pending is not None
            self._pending = req
            self._cond.notify_all()
        if replaced:
            self._m_snapshots.inc(outcome="skipped")
        return not replaced

    def register_provider(self, fn: Callable[[], tuple]):
        """``fn() -> (tree, step)`` (optionally ``(tree, step, extras)``)
        for interval-driven snapshots via the engine's step hook."""
        self._provider = fn

    def on_step(self, step_index: int):
        """Engine ``on_step_complete`` hook: snapshot the registered
        provider every ``interval_steps`` completed steps."""
        if self._provider is None or self.interval_steps <= 0:
            return
        if step_index % self.interval_steps != 0:
            return
        try:
            got = self._provider()
        except Exception as e:
            logger.warning("checkpoint provider failed: %s", e)
            return
        tree, step = got[0], got[1]
        extras = got[2] if len(got) > 2 else None
        self.snapshot(tree, step, extras=extras)

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until no snapshot is pending or in flight (tests, final
        flush). Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pending is not None or self._writing:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def close(self, flush: bool = True, timeout: float = 60.0):
        if flush:
            self.wait_idle(timeout)
        with self._cond:
            self._stopped = True
            self._pending = None
            self._cond.notify_all()
        self._thread.join(timeout=5)
        if not self._thread.is_alive():
            self._host_buf = None
            self._pinned = []
            self._side_stream = None

    @property
    def last_written_step(self) -> int:
        with self._cond:
            return self._last_written_step

    @property
    def last_write_stages(self) -> Optional[dict]:
        """Seconds by stage of the last generation this rank wrote —
        ``d2h`` (the wait for the stamp and the device→host copy of the
        stream), ``encode`` (the header), ``checksum``, ``files`` (the
        shard, header and manifest files), ``replicas`` (the KV publish
        and the peers' shards) and ``wall`` (all of it) — and ``bytes``,
        this rank's shard."""
        with self._cond:
            return None if self._last_stages is None \
                else dict(self._last_stages)

    # -- worker thread -------------------------------------------------------

    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._stopped:
                    self._cond.wait(0.5)
                if self._stopped:
                    return
                req = self._pending
                self._pending = None
                self._writing = True
            try:
                self._write_generation(req)
                self._m_snapshots.inc(outcome="written")
                with self._cond:
                    self._last_written_step = req.step
            except Exception as e:
                self._m_snapshots.inc(outcome="failed")
                logger.warning("checkpoint write for step %d failed: %s",
                               req.step, e)
            finally:
                req = None   # the staging copy goes with the request
                with self._cond:
                    self._writing = False
                    self._cond.notify_all()

    def _ring(self, dev: torch.device):
        """The side stream and the pinned ring for leaves on ``dev``."""
        if self._side_stream is None or self._side_stream.device != dev:
            self._side_stream = torch.cuda.Stream(dev)
            if not self._pinned:
                self._pinned = [torch.empty(_PINNED_CHUNK, dtype=torch.uint8,
                                            pin_memory=True)
                                for _ in range(_PINNED_SLOTS)]
        return self._side_stream

    def _to_host(self, staged: _Staged) -> memoryview:
        """The stamped values as the logical stream in the worker's host
        buffer (grown as needed): the staging buffer's runs copied
        device→host on the side stream, once the stamp's event has fired,
        through the pinned ring, a chunk's copy crossing while the one
        before is copied out (numpy: one thread, no GIL); the host leaves'
        bytes written beside them. Then the staging buffer is dropped."""
        if self._host_buf is None or self._host_buf.size < staged.total:
            self._host_buf = None
            self._host_buf = np.empty(max(staged.total, 1), np.uint8)
        host = self._host_buf
        if staged.stage is not None:
            stage = staged.stage
            side = self._ring(stage.device)
            side.wait_event(staged.ready)
            pinned = [p.numpy() for p in self._pinned]
            inflight: collections.deque = collections.deque()
            k = 0
            for o0, n0 in staged.runs:
                for o in range(o0, o0 + n0, _PINNED_CHUNK):
                    n = min(_PINNED_CHUNK, o0 + n0 - o)
                    if len(inflight) == _PINNED_SLOTS:
                        slot, ev, po, pn = inflight.popleft()
                        ev.synchronize()
                        host[po:po + pn] = pinned[slot][:pn]
                    slot = k % _PINNED_SLOTS
                    k += 1
                    with torch.cuda.stream(side):
                        self._pinned[slot][:n].copy_(stage[o:o + n],
                                                     non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(side)
                    inflight.append((slot, ev, o, n))
            for slot, ev, po, pn in inflight:
                ev.synchronize()
                host[po:po + pn] = pinned[slot][:pn]
            # every copy out of it has completed: its memory goes back to
            # the training stream's pool now, not after the writes
            staged.stage = None
        for i, leaf in staged.host.items():
            o = staged.offsets[i]
            host[o:o + staged.specs[i].nbytes] = shard_io.leaf_bytes(leaf)
        return memoryview(host)[:staged.total]

    def _write_stream(self, stream: memoryview, lo: int, hi: int,
                      path: str, stages: dict) -> str:
        """Write ``stream[lo:hi]`` (zeros past its end:
        ``shard_io.shard_of``'s padding) to ``path`` atomically, hashing
        it on the way in chunks; returns the sha256 and adds the seconds
        spent hashing and writing to ``stages``."""
        hasher = hashlib.sha256()
        tmp = f"{path}.tmp.{os.getpid()}"
        end = min(hi, len(stream))
        with open(tmp, "wb") as f:
            for o in range(lo, end, _PINNED_CHUNK):
                buf = stream[o:min(o + _PINNED_CHUNK, end)]
                t0 = time.perf_counter()
                hasher.update(buf)
                t1 = time.perf_counter()
                f.write(buf)
                stages["checksum"] += t1 - t0
                stages["files"] += time.perf_counter() - t1
            if hi > max(end, lo):
                pad = bytes(hi - max(end, lo))
                hasher.update(pad)
                f.write(pad)
        os.rename(tmp, path)
        return hasher.hexdigest()

    def _write_generation(self, req: _SnapReq):
        """The full off-step-path write: device→host copy, serialize,
        shard, replicate, manifest. Runs on the worker thread only."""
        if failpoint("checkpoint.write") is DROP:
            # a dropped write models a lost snapshot: no files, no
            # manifest — the generation simply never commits
            raise RuntimeError("checkpoint.write failpoint dropped the "
                               "snapshot")
        corr_name = f"ckpt.write.g{req.step}"
        staged = req.staged
        t0 = time.perf_counter()
        stream = self._to_host(staged)
        t1 = time.perf_counter()
        if req.zero1 is not None:
            layout, n_shards = req.zero1
            header = shard_io.zero1_header(
                layout, staged.specs[:n_shards], staged.specs[n_shards:],
                step=req.step, world_version=self.world_version,
                world_size=self.world_size, extras=req.extras)
            # the whole payload is this rank's shard
            lo, hi = 0, staged.total
        else:
            _, shard = shard_io._shard_spec(staged.total, self.world_size)
            header = shard_io.make_header(
                staged.specs, step=req.step,
                world_version=self.world_version,
                world_size=self.world_size, extras=req.extras)
            lo, hi = self.rank * shard, (self.rank + 1) * shard
        stages = {"d2h": t1 - t0, "encode": time.perf_counter() - t1,
                  "checksum": 0.0, "files": 0.0, "bytes": hi - lo}
        if self.trace is not None:
            self.trace.record_enqueue(corr_name, "checkpoint", hi - lo,
                                      self.world_version)
        try:
            self._write_files(req.step, header, stream, lo, hi, stages)
        finally:
            if self.trace is not None:
                self.trace.record_done(corr_name)
        stages["wall"] = time.perf_counter() - t0
        with self._cond:
            self._last_stages = stages
        self._gc()

    @staticmethod
    def _write_atomic(path: str, data):
        """Temp-file + rename: peers poll this generation directory over
        the shared filesystem the moment a file appears, so a plain
        open+write would let them capture (and checksum into their
        manifests) a torn partial shard — which the cross-rank checksum
        agreement would then reject, making a fully-successful
        generation unrestorable. rename() makes appearance atomic."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.rename(tmp, path)

    def _write_files(self, step: int, header: dict, stream: memoryview,
                     lo: int, hi: int, stages: dict):
        gdir = self.gen_dir(step)
        os.makedirs(gdir, exist_ok=True)
        self._write_atomic(os.path.join(gdir, "header.json"),
                           json.dumps(header).encode())
        own_path = self.shard_file(gdir, self.rank)
        own_sum = self._write_stream(stream, lo, hi, own_path, stages)
        self._m_bytes.inc(hi - lo, kind="shard")
        t2 = time.perf_counter()
        checksums = {self.rank: own_sum}
        sizes = {self.rank: hi - lo}
        holds = [self.rank]
        # publish the shard bytes so successors can take replicas (and a
        # later restore can fetch over the wire); then hold predecessors'
        # peers per the redundancy degree
        if self.kv is not None and self.world_size > 1 and \
                self.redundancy > 0:
            from ..runner.http_client import put_large_value
            try:
                own_shard = bytes(stream[lo:min(hi, len(stream))])
                put_large_value(self.kv[0], self.kv[1],
                                CKPT_SHARD_KV_SCOPE,
                                self._shard_kv_key(step, self.rank),
                                own_shard + bytes(hi - lo - len(own_shard)),
                                chunk_bytes=self.kv_chunk_bytes,
                                timeout=self.kv_timeout)
                del own_shard
            except Exception as e:
                logger.warning("checkpoint shard KV publish failed "
                               "(replicas degraded): %s", e)
        for d in range(1, self.redundancy + 1):
            peer = (self.rank + d) % self.world_size
            if peer == self.rank:
                break
            data = self._await_shard_bytes(step, peer,
                                           timeout=self.kv_timeout)
            if data is None:
                logger.warning(
                    "checkpoint generation %d: could not replicate peer "
                    "rank %d's shard (redundancy degraded)", step, peer)
                continue
            self._write_atomic(self.shard_file(gdir, peer), data)
            self._m_bytes.inc(len(data), kind="replica")
            checksums[peer] = mf.checksum(data)
            sizes[peer] = len(data)
            holds.append(peer)
        t3 = time.perf_counter()
        man = mf.build_manifest(
            self.rank, step=step, world_version=self.world_version,
            world_size=self.world_size,
            layout_digest=header["layout_digest"],
            shard_checksums=checksums, shard_bytes=sizes, holds=holds)
        blob = json.dumps(man).encode()
        # the manifest is written LAST: its presence is the rank-local
        # commit mark the barrier aggregates
        self._write_atomic(os.path.join(gdir, f"manifest_{self.rank}.json"),
                           blob)
        self._m_bytes.inc(len(blob), kind="manifest")
        self._m_last_step.set(float(step))
        t4 = time.perf_counter()
        if self.kv is not None:
            from ..runner.http_client import put_data_into_kvstore
            try:
                # shared header rides the KV next to the manifest (every
                # rank publishes the identical bytes) so a restorer with
                # neither a local nor a shared-fs copy still decodes
                put_data_into_kvstore(self.kv[0], self.kv[1], CKPT_KV_SCOPE,
                                      f"header.g{step}",
                                      json.dumps(header).encode(),
                                      timeout=self.kv_timeout)
                put_data_into_kvstore(self.kv[0], self.kv[1], CKPT_KV_SCOPE,
                                      str(self.rank), blob,
                                      timeout=self.kv_timeout)
            except Exception as e:
                logger.warning("checkpoint manifest KV publish failed: %s",
                               e)
        stages["files"] += t4 - t3
        stages["replicas"] = (t3 - t2) + (time.perf_counter() - t4)

    def _rank_dirs(self) -> List[str]:
        """Every rank directory physically under the checkpoint root —
        NOT bounded by the current world size: after an N→M resize the
        writer world's directories outnumber (or undercount) the
        restorers'."""
        try:
            return sorted(n for n in os.listdir(self.directory)
                          if n.startswith("rank") and
                          os.path.isdir(os.path.join(self.directory, n)))
        except OSError:
            return []

    def _fetch_shard_bytes(self, step: int, shard_rank: int,
                           timeout: Optional[float] = None
                           ) -> Optional[bytes]:
        """Source one shard's bytes: this rank's own files → any rank
        directory on the shared filesystem (owner or replica holder) →
        the KV (chunked). Returns None when no source has it."""
        own = os.path.basename(self.rank_dir(self.rank))
        for name in dict.fromkeys([own] + self._rank_dirs()):
            p = self.shard_file(
                os.path.join(self.directory, name,
                             f"{_GEN_PREFIX}{int(step)}"), shard_rank)
            if os.path.exists(p):
                try:
                    with open(p, "rb") as f:
                        return f.read()
                except OSError:
                    continue
        if self.kv is not None:
            from ..runner.http_client import read_large_value
            try:
                return read_large_value(
                    self.kv[0], self.kv[1], CKPT_SHARD_KV_SCOPE,
                    self._shard_kv_key(step, shard_rank),
                    timeout=self.kv_timeout if timeout is None else timeout)
            except Exception as e:
                logger.debug("KV shard fetch g%d.r%d failed: %s", step,
                             shard_rank, e)
        return None

    def _peer_moved_past(self, step: int, peer: int) -> bool:
        """Whether ``peer`` has already committed a generation NEWER
        than ``step`` — then it skipped ``step`` (its double-buffer
        replaced the request) and this shard will never exist; waiting
        out the full timeout would stall the writer 30s per divergent
        generation. Disk manifests are authoritative on a shared fs; a
        cheap bounded KV manifest read covers the wire-only case."""
        gdir = self.rank_dir(peer)
        try:
            for g in os.listdir(gdir):
                if _is_gen_dir(g) and _gen_step(g) > step and \
                        os.path.exists(os.path.join(
                            gdir, g, f"manifest_{peer}.json")):
                    return True
        except OSError:
            pass
        if self.kv is not None:
            from ..runner.http_client import read_data_from_kvstore
            try:
                m = json.loads(read_data_from_kvstore(
                    self.kv[0], self.kv[1], CKPT_KV_SCOPE, str(peer),
                    timeout=0.3, poll_interval=0.25))
                return int(m.get("step", -1)) > step
            except Exception:
                pass
        return False

    def _await_shard_bytes(self, step: int, shard_rank: int,
                           timeout: float) -> Optional[bytes]:
        """Poll :meth:`_fetch_shard_bytes` inside a deadline — the
        replica-taking side of the write path races the peer's own write
        (each rank snapshots asynchronously). Gives up early when the
        peer is observed past this generation (it skipped it)."""
        deadline = time.monotonic() + timeout
        last_peer_check = 0.0
        while True:
            # the KV leg long-polls internally; bound each pass so the
            # shared-fs legs re-poll too
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            data = self._fetch_shard_bytes(step, shard_rank,
                                           timeout=min(remaining, 2.0))
            if data is not None:
                return data
            now = time.monotonic()
            if now - last_peer_check >= 1.0:
                last_peer_check = now
                if self._peer_moved_past(step, shard_rank):
                    logger.debug("peer %d skipped generation %d; not "
                                 "waiting for its shard", shard_rank,
                                 step)
                    return None
            time.sleep(0.05)

    # -- generation discovery / commit barrier -------------------------------

    def _disk_manifests(self, step: int) -> Dict[int, dict]:
        """Every rank's manifest for one generation, scanned across the
        rank directories under the checkpoint root."""
        out: Dict[int, dict] = {}
        root = self.directory
        try:
            rank_names = os.listdir(root)
        except OSError:
            return out
        for name in rank_names:
            if not name.startswith("rank"):
                continue
            gdir = os.path.join(root, name, f"{_GEN_PREFIX}{step}")
            if not os.path.isdir(gdir):
                continue
            for fn in os.listdir(gdir):
                if not (fn.startswith("manifest_") and
                        fn.endswith(".json")):
                    continue
                try:
                    with open(os.path.join(gdir, fn)) as f:
                        m = json.load(f)
                    out.setdefault(int(m["rank"]), m)
                except Exception:
                    continue
        return out

    def _kv_manifests(self) -> Dict[int, dict]:
        """The latest manifest each rank published to ``ckpt/<rank>``
        (last-writer-wins; only describes the newest generation). Each
        absent key costs one short bounded probe, NOT the long-poll —
        discovery runs on restore/startup paths where an empty store is
        normal, and an O(world_size · long_poll) stall there would
        dwarf the restore itself."""
        if self.kv is None:
            return {}
        from ..runner.http_client import read_data_from_kvstore

        def _probe(r: int) -> Optional[dict]:
            try:
                raw = read_data_from_kvstore(self.kv[0], self.kv[1],
                                             CKPT_KV_SCOPE, str(r),
                                             timeout=0.3,
                                             poll_interval=0.25)
                return json.loads(raw)
            except Exception:
                return None

        out: Dict[int, dict] = {}
        # probe the current world's ranks, then WIDEN to the writer
        # world any hit advertises: after an N->M downsize the old
        # ranks >= M published manifests this restorer still needs for
        # shard coverage when no shared filesystem is present
        probed = 0
        target = self.world_size
        while probed < target:
            m = _probe(probed)
            if m is not None:
                out[int(m["rank"])] = m
                target = max(target, int(m.get("world_size", 0)))
            probed += 1
        return out

    def _candidate_steps(self) -> List[int]:
        """Generation steps visible anywhere under the root, newest
        first."""
        steps = set()
        try:
            rank_names = os.listdir(self.directory)
        except OSError:
            rank_names = []
        for name in rank_names:
            if not name.startswith("rank"):
                continue
            try:
                gens = os.listdir(os.path.join(self.directory, name))
            except OSError:
                continue
            for g in gens:
                if _is_gen_dir(g):
                    steps.add(_gen_step(g))
        return sorted(steps, reverse=True)

    def latest_generation(self) -> Optional[Tuple[int, Dict[int, dict]]]:
        """The newest restorable generation: ``(step,
        manifests_by_rank)`` or None. Both barriers are the relaxed
        :func:`manifest.generation_restorable` form — a lost host's
        manifest may be gone from the KV (server restart) and the disk,
        but the survivors' holdings can still cover every shard. The KV
        candidate (which sees ranks whose disks are reachable only over
        the wire) and the disk scan (which covers a fresh KV server
        after a full-cluster preemption) are BOTH consulted and the
        newer step wins: a generation whose manifest KV publish failed
        on every rank must not hide a newer complete generation that IS
        on disk."""
        best: Optional[Tuple[int, Dict[int, dict]]] = None
        kv_mans = self._kv_manifests()
        if kv_mans:
            ok, _ = mf.generation_restorable(kv_mans)
            if ok:
                best = (kv_mans[min(kv_mans)]["step"], kv_mans)
        for step in self._candidate_steps():   # newest first
            if best is not None and step <= best[0]:
                break
            mans = self._disk_manifests(step)
            ok, errs = mf.generation_restorable(mans)
            if ok:
                best = (step, mans)
                break
            logger.debug("generation %d not restorable: %s", step,
                         errs[:3])
        return best

    # -- restore -------------------------------------------------------------

    def _load_header(self, step: int, world_size: int) -> dict:
        """Load the shared header for one generation, cross-checked
        against the manifests' identity: a header whose (step,
        world_size) disagrees is from a mixed/stale directory and is
        skipped rather than trusted."""
        own = os.path.basename(self.rank_dir(self.rank))
        for name in dict.fromkeys([own] + self._rank_dirs()):
            path = os.path.join(self.directory, name,
                                f"{_GEN_PREFIX}{int(step)}", "header.json")
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        header = json.load(f)
                    if int(header["step"]) == int(step) and \
                            int(header["world_size"]) == int(world_size):
                        return header
                    logger.debug("header %s disagrees with manifests "
                                 "(step %s vs %s, world %s vs %s); "
                                 "skipped", path, header.get("step"),
                                 step, header.get("world_size"),
                                 world_size)
                except Exception:
                    continue
        if self.kv is not None:
            from ..runner.http_client import read_data_from_kvstore
            try:
                header = json.loads(read_data_from_kvstore(
                    self.kv[0], self.kv[1], CKPT_KV_SCOPE,
                    f"header.g{step}", timeout=2.0, poll_interval=0.05))
                if int(header["step"]) == int(step) and \
                        int(header["world_size"]) == int(world_size):
                    return header
            except Exception:
                pass
        raise CheckpointRestoreError(
            f"no readable header for generation {step} under "
            f"{self.directory}")

    def _republish_held(self, step: int, manifests: Dict[int, dict]):
        """The peer side of the KV-mediated fetch: before sourcing its
        own needs, every restoring rank re-publishes the shards it
        physically holds (own + replicas) so a rank whose disk is gone
        finds its shard on the wire."""
        if self.kv is None:
            return
        from ..runner.http_client import (put_data_into_kvstore,
                                          put_large_value)
        gdir = self.gen_dir(step)
        if not os.path.isdir(gdir):
            return
        for fn in os.listdir(gdir):
            path = os.path.join(gdir, fn)
            try:
                if fn.startswith("shard_") and fn.endswith(".bin"):
                    q = int(fn[len("shard_"):-len(".bin")])
                    with open(path, "rb") as f:
                        put_large_value(self.kv[0], self.kv[1],
                                        CKPT_SHARD_KV_SCOPE,
                                        self._shard_kv_key(step, q),
                                        f.read(),
                                        chunk_bytes=self.kv_chunk_bytes,
                                        timeout=self.kv_timeout)
                elif fn == "header.json":
                    with open(path, "rb") as f:
                        put_data_into_kvstore(
                            self.kv[0], self.kv[1], CKPT_KV_SCOPE,
                            f"header.g{step}", f.read(),
                            timeout=self.kv_timeout)
                elif fn.startswith("manifest_") and fn.endswith(".json"):
                    r = fn[len("manifest_"):-len(".json")]
                    with open(path, "rb") as f:
                        put_data_into_kvstore(
                            self.kv[0], self.kv[1], CKPT_KV_SCOPE, r,
                            f.read(), timeout=self.kv_timeout)
            except Exception as e:
                # best-effort: a rank that needs a missing shard fails
                # loudly in _gather_shards
                logger.debug("republish of %s failed: %s", fn, e)

    def _gather_shards(self, step: int, header: dict,
                       manifests: Dict[int, dict],
                       needed: List[int]) -> Dict[int, bytes]:
        """Fetch + checksum-verify the needed writer shards."""
        expect = {}
        for m in manifests.values():
            for q, c in m["shard_checksums"].items():
                expect[int(q)] = c
        out: Dict[int, bytes] = {}
        for q in needed:
            data = self._fetch_shard_bytes(step, q)
            if data is None:
                raise CheckpointRestoreError(
                    f"generation {step}: shard {q} unavailable on disk, "
                    f"peers, and KV (redundancy "
                    f"{self.redundancy} exceeded)")
            if q in expect and mf.checksum(data) != expect[q]:
                raise CheckpointRestoreError(
                    f"generation {step}: shard {q} checksum mismatch "
                    f"(corrupt replica or torn KV write)")
            out[q] = data
            self._m_bytes.inc(len(data), kind="restore")
        return out

    def restore_latest(self, template=None) -> RestoreResult:
        """Restore the newest complete generation. For a replicated
        generation the full flat stream is reassembled from the writer
        world's shards (whatever its size was) and decoded into
        ``template``'s structure when given — each leaf on the template
        leaf's device; a Python scalar leaf comes back as its type; a
        leaf count, shape or dtype that differs raises
        :class:`CheckpointRestoreError` — else returned as a list of CPU
        tensors. A ZeRO-1 generation restores to the reshard dict of
        ``shard_io.zero1_reshard`` plus its ``header``, for
        ``DistributedOptimizer.restore_from_durable``."""
        failpoint("checkpoint.restore")
        t0 = time.perf_counter()
        found = self.latest_generation()
        if found is None:
            raise CheckpointRestoreError(
                f"no complete checkpoint generation under "
                f"{self.directory}")
        step, manifests = found
        header = self._load_header(
            step, manifests[min(manifests)]["world_size"])
        if header["layout_digest"] != \
                manifests[min(manifests)]["layout_digest"]:
            raise CheckpointRestoreError(
                f"generation {step}: header layout digest does not match "
                f"the manifests (mixed generations on disk)")
        corr_name = f"ckpt.restore.g{step}"
        if self.trace is not None:
            self.trace.record_enqueue(corr_name, "checkpoint",
                                      header.get("total_bytes", 0),
                                      self.world_version)
        try:
            self._republish_held(step, manifests)
            old_n = int(header["world_size"])
            payloads = self._gather_shards(step, header, manifests,
                                           list(range(old_n)))
            if header["mode"] == "zero1":
                # tree = the reshard dict: this (new-world) rank's bucket
                # shards + resliced state leaves, plus the unpadded full
                # flat params per bucket (template does not apply — the
                # optimizer rebuilds its sharded state from these)
                re = shard_io.zero1_reshard(header, payloads, self.rank,
                                            self.world_size)
                re["header"] = header
                result = RestoreResult(re, shard_io.header_extras(header),
                                       step, header["world_version"],
                                       "zero1")
            else:
                stream = b"".join(payloads[q] for q in range(old_n))
                del payloads
                leaves = shard_io.decode_leaves(stream, header)
                del stream
                tree = (leaves if template is None
                        else _fit_template(template, leaves))
                result = RestoreResult(tree, shard_io.header_extras(header),
                                       step, header["world_version"],
                                       "replicated")
        finally:
            if self.trace is not None:
                self.trace.record_done(corr_name)
        self._m_restore.observe(time.perf_counter() - t0)
        return result

    def restore_shard_slice(self, new_rank: int, new_n: int) -> bytes:
        """The raw re-slice primitive for a replicated generation: the
        byte range the *new* world assigns to ``new_rank``, assembled
        from the writer world's shards via
        :func:`shard_io.reshard_ranges` (tail re-padded to the new
        ``shard_spec`` boundary)."""
        found = self.latest_generation()
        if found is None:
            raise CheckpointRestoreError("no complete generation")
        step, manifests = found
        header = self._load_header(
            step, manifests[min(manifests)]["world_size"])
        total = int(header["total_bytes"])
        old_n = int(header["world_size"])
        ranges = shard_io.reshard_ranges(total, old_n, new_rank, new_n)
        shards: Dict[int, bytes] = {}
        parts = []
        for old_rank, off, length in ranges:
            if old_rank not in shards:
                data = self._fetch_shard_bytes(step, old_rank)
                if data is None:
                    raise CheckpointRestoreError(
                        f"generation {step}: shard {old_rank} unavailable")
                shards[old_rank] = data
            parts.append(shards[old_rank][off:off + length])
        out = b"".join(parts)
        _, new_shard = shard_io._shard_spec(total, new_n)
        if len(out) < new_shard:
            out += b"\x00" * (new_shard - len(out))
        return out

    # -- garbage collection --------------------------------------------------

    def _gc(self):
        """Keep the newest ``keep`` locally-written generations; delete
        older ones and any partial generation (no local manifest — a
        crashed write) older than the newest kept one. KV shard chunks
        of deleted generations are removed too."""
        rdir = self.rank_dir(self.rank)
        try:
            gens = sorted((g for g in os.listdir(rdir) if _is_gen_dir(g)),
                          key=_gen_step, reverse=True)
        except OSError:
            return
        complete = [g for g in gens if os.path.exists(os.path.join(
            rdir, g, f"manifest_{self.rank}.json"))]
        keep = set(complete[:self.keep])
        newest_kept = _gen_step(complete[0]) if complete else None
        for g in gens:
            if g in keep:
                continue
            if g not in complete and (newest_kept is None or
                                      _gen_step(g) >= newest_kept):
                # an in-flight or future write — never collect it
                continue
            step = _gen_step(g)
            gdir = os.path.join(rdir, g)
            held = []
            try:
                held = [int(fn[len("shard_"):-len(".bin")])
                        for fn in os.listdir(gdir)
                        if fn.startswith("shard_") and fn.endswith(".bin")]
            except OSError:
                pass
            shutil.rmtree(gdir, ignore_errors=True)
            self._m_gc.inc(kind="partial" if g not in complete
                           else "generation")
            if self.kv is not None:
                from ..runner.http_client import delete_large_value
                for q in held:
                    try:
                        delete_large_value(self.kv[0], self.kv[1],
                                           CKPT_SHARD_KV_SCOPE,
                                           self._shard_kv_key(step, q))
                        self._m_gc.inc(kind="kv")
                    except Exception:
                        pass


_SCALARS = (bool, int, float, complex, str)


def _fit_template(template, leaves: list):
    """``template``'s structure around the restored ``leaves``, each
    checked against its template leaf and put where that leaf is: a
    tensor on its device, a numpy leaf as numpy, a Python scalar as its
    type."""
    t_leaves, rebuild = flatten(template)
    if len(t_leaves) != len(leaves):
        raise CheckpointRestoreError(
            f"template has {len(t_leaves)} leaves, checkpoint has "
            f"{len(leaves)}")
    out = []
    for i, (tl, l) in enumerate(zip(t_leaves, leaves)):
        if isinstance(tl, torch.Tensor):
            t_shape, t_dtype = tuple(tl.shape), shard_io.dtype_name(tl.dtype)
        else:
            a = np.asarray(tl)
            t_shape, t_dtype = a.shape, shard_io.dtype_name(a.dtype)
        shape = tuple(l.shape)
        dtype = shard_io.dtype_name(l.dtype)
        if t_shape != shape:
            raise CheckpointRestoreError(
                f"leaf {i}: template shape {t_shape} != checkpoint "
                f"{shape}")
        if t_dtype != dtype:
            raise CheckpointRestoreError(
                f"leaf {i}: template dtype {t_dtype} != checkpoint "
                f"{dtype}")
        if isinstance(tl, torch.Tensor):
            out.append(l.to(tl.device))
        elif isinstance(tl, _SCALARS):
            out.append(type(tl)(l.item()))
        elif isinstance(l, torch.Tensor) and \
                dtype not in shard_io._RAW_DTYPES:
            # numpy holds it without an extension type
            out.append(l.numpy())
        else:
            out.append(l)
    return rebuild(out)


def _inner_optimizer(optimizer) -> torch.optim.Optimizer:
    """The ``torch.optim`` optimizer behind ``optimizer`` (the port's
    distributed wrappers hold theirs as ``.optimizer``)."""
    if isinstance(optimizer, torch.optim.Optimizer):
        return optimizer
    inner = getattr(optimizer, "optimizer", None)
    if not isinstance(inner, torch.optim.Optimizer):
        raise TypeError(f"{type(optimizer).__name__} is not a torch "
                        "optimizer and wraps none")
    if getattr(optimizer, "_is_sharded", lambda: False)():
        raise ValueError(
            "a sharded (ZeRO-1) optimizer checkpoints through "
            "checkpoint_payload() / CheckpointManager.snapshot_zero1 and "
            "restores through restore_from_durable()")
    return inner


def training_state(model: torch.nn.Module, optimizer) -> dict:
    """The tree a training loop snapshots: ``{"model":
    model.state_dict(), "opt": optimizer.state_dict()}``."""
    return {"model": model.state_dict(),
            "opt": _inner_optimizer(optimizer).state_dict()}


def optimizer_template(optimizer) -> dict:
    """The ``state_dict()`` of an optimizer about to be restored into. A
    ``torch.optim`` optimizer makes its state at its first step, so one
    that has not stepped first takes a step at learning rate 0 on zero
    gradients (which leaves the parameters as they are); the restore then
    overwrites that state."""
    opt = _inner_optimizer(optimizer)
    if not opt.state:
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.requires_grad]
        grads = [p.grad for p in params]
        lrs = [g.get("lr") for g in opt.param_groups]
        try:
            with torch.no_grad():
                for p in params:
                    p.grad = torch.zeros_like(p)
            for g in opt.param_groups:
                if "lr" in g:
                    g["lr"] = (torch.zeros_like(g["lr"])
                               if isinstance(g["lr"], torch.Tensor) else 0.0)
            opt.step()
        finally:
            for g, lr in zip(opt.param_groups, lrs):
                if lr is not None:
                    g["lr"] = lr
            for p, g in zip(params, grads):
                p.grad = g
    return opt.state_dict()


def training_template(model: torch.nn.Module, optimizer) -> dict:
    """:func:`training_state` of a model and optimizer about to be
    restored into, for ``restore_latest(template=...)``: the optimizer's
    part is :func:`optimizer_template`."""
    return {"model": model.state_dict(),
            "opt": optimizer_template(optimizer)}


def load_training_state(tree: dict, model: torch.nn.Module, optimizer):
    """Load a restored :func:`training_state` tree into ``model`` and
    ``optimizer`` in place (``load_state_dict``), so training resumes
    where the snapshot was taken."""
    model.load_state_dict(tree["model"])
    _inner_optimizer(optimizer).load_state_dict(tree["opt"])
