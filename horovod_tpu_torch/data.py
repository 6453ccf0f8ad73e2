"""Sharded dataset ingestion for the estimator.

The port's counterpart of ``horovod_tpu/data.py``, a copy of it: numpy and
threading only, so one seed gives the reference's batch sequence exactly
(every ``np.random.RandomState`` call in the same order). It yields numpy
arrays; the estimator moves each batch to its device.

Parity: the reference estimator's per-worker data path — DataFrame →
parquet shards prepared by ``spark/common/util.py``, then a per-worker
Petastorm reader loop inside the training closure
(``spark/torch/remote.py:35-382``). Here it is a directory of
``.npz`` shards read per rank, with NO equal-cardinality
requirement: ranks may own different sample counts, and the estimator
lets the ragged tail flow through the engine's Join protocol
(``core/engine.py`` zero-tensor substitution) instead of dropping data.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import time
from typing import Iterator, List, Sequence, Tuple

import numpy as np


class ShardedNpzDataset:
    """A dataset stored as npz shard files, each holding arrays ``x`` (inputs)
    and ``y`` (labels).

    Ranks take shard files round-robin (file i → rank i % size), mirroring
    the reference's per-worker Petastorm row-group assignment. Shards may
    have different sample counts — the estimator handles the resulting
    ragged batch tails with ``hvd.join()``.
    """

    def __init__(self, paths: Sequence[str]):
        if isinstance(paths, (str, os.PathLike)):
            pattern = os.path.join(str(paths), "*.npz") \
                if os.path.isdir(str(paths)) else str(paths)
            paths = sorted(glob.glob(pattern))
        self.paths: List[str] = [str(p) for p in paths]
        if not self.paths:
            raise ValueError("ShardedNpzDataset: no shard files found")

    @staticmethod
    def write_shards(directory: str, x: np.ndarray, y: np.ndarray,
                     n_shards: int) -> "ShardedNpzDataset":
        """Split (x, y) into ``n_shards`` npz files (the DataFrame→parquet
        preparation role, spark/common/util.py). Shards are as even as
        possible; the remainder makes the first shards one sample longer."""
        os.makedirs(directory, exist_ok=True)
        paths = []
        bounds = np.linspace(0, len(x), n_shards + 1).astype(int)
        for i in range(n_shards):
            lo, hi = bounds[i], bounds[i + 1]
            p = os.path.join(directory, f"shard_{i:05d}.npz")
            np.savez(p, x=x[lo:hi], y=y[lo:hi])
            paths.append(p)
        return ShardedNpzDataset(paths)

    def shard_arrays(self, rank: int, size: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Load this rank's shard files into memory-concatenated arrays."""
        mine = self.paths[rank::size]
        if not mine:
            # more ranks than shards: this rank owns no data and will join()
            # immediately — probe shard 0 for dtypes/shapes
            probe = np.load(self.paths[0])
            return (probe["x"][:0], probe["y"][:0])
        xs, ys = [], []
        for p in mine:
            data = np.load(p)
            xs.append(data["x"])
            ys.append(data["y"])
        return np.concatenate(xs), np.concatenate(ys)

    def iter_batches(self, rank: int, size: int, batch_size: int,
                     shuffle: bool = True, seed: int = 0,
                     prefetch: int = 2
                     ) -> "ShardBatchIterator":
        """Streaming batched reader over this rank's shards — the Petastorm
        reader-loop role (spark/torch/remote.py:35-382: batched, shuffling,
        prefetching reads over on-disk row groups), with bounded host RAM
        (``shard_arrays`` loads a rank's whole partition; this holds at
        most ``prefetch + 2`` shards + one batch carry).

        Resident shards are bounded by ``prefetch + 2`` (the queue, the
        loader's in-hand shard blocked on a full queue, and the consumer's
        current shard). Shard order and within-shard row order reshuffle
        under ``seed`` (pass ``seed + epoch`` for per-epoch reshuffle).
        Batches cross shard boundaries; only the final batch of the epoch
        may be short."""
        return ShardBatchIterator(self.paths[rank::size], batch_size,
                                  shuffle=shuffle, seed=seed,
                                  prefetch=prefetch)

    def __len__(self) -> int:
        return len(self.paths)


class ShardBatchIterator:
    """Iterator of (x_batch, y_batch) over a list of npz shard files with a
    double-buffering loader thread.

    The loader thread reads and row-shuffles the NEXT shards while training
    consumes the current one (the reference reader's background row-group
    fetch); ``max_resident_shards`` records the high-water mark of
    simultaneously-loaded shards (bounded by prefetch + 2) so tests can
    assert boundedness."""

    def __init__(self, paths: Sequence[str], batch_size: int,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2):
        self.paths = list(paths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = max(int(prefetch), 1)
        self.max_resident_shards = 0
        self._resident = 0
        self._lock = threading.Lock()

    def _note_resident(self, delta: int):
        with self._lock:
            self._resident += delta
            self.max_resident_shards = max(self.max_resident_shards,
                                           self._resident)

    def _loader(self, order: List[str], rng: np.random.RandomState,
                q: "queue.Queue", stop: threading.Event):
        try:
            for p in order:
                if stop.is_set():
                    return
                data = np.load(p)
                x, y = data["x"], data["y"]
                if self.shuffle:
                    perm = rng.permutation(len(x))
                    x, y = x[perm], y[perm]
                self._note_resident(1)
                q.put((x, y))
            q.put(None)
        except Exception as e:  # surface IO errors on the consumer side
            q.put(e)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if not self.paths:
            # more ranks than shards: nothing to yield (the rank joins
            # immediately; dtype probing is shard_arrays' job)
            return
        rng = np.random.RandomState(self.seed)
        order = list(self.paths)
        if self.shuffle:
            order = [order[i] for i in rng.permutation(len(order))]
        # queue slots = prefetch; with the loader's in-hand shard (blocked
        # on a full queue) and the consumer's current shard, residency is
        # bounded at prefetch + 2
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._loader, args=(order, rng, q, stop),
                             name="hvd-data-loader", daemon=True)
        t.start()
        carry_x, carry_y = [], []
        carried = 0
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                x, y = item
                lo = 0
                # emit full batches straight out of the shard; only the
                # inter-shard remainder rides the carry buffer
                if carried:
                    need = self.batch_size - carried
                    carry_x.append(x[:need])
                    carry_y.append(y[:need])
                    carried += min(need, len(x))
                    lo = need
                    if carried >= self.batch_size:
                        yield (np.concatenate(carry_x),
                               np.concatenate(carry_y))
                        carry_x, carry_y, carried = [], [], 0
                while lo + self.batch_size <= len(x):
                    yield x[lo:lo + self.batch_size], y[lo:lo + self.batch_size]
                    lo += self.batch_size
                if lo < len(x):
                    carry_x.append(x[lo:])
                    carry_y.append(y[lo:])
                    carried += len(x) - lo
                self._note_resident(-1)
            if carried:
                yield np.concatenate(carry_x), np.concatenate(carry_y)
        finally:
            stop.set()
            # drain so a blocked loader thread can exit, then JOIN it —
            # an abandoned iterator (elastic reset, user break) must not
            # leave a zombie loader reading shards against the next
            # world's epoch. The loader can
            # re-fill freed slots before it sees the stop event, so drain
            # and join alternate until it exits.
            deadline = time.monotonic() + 5.0
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
