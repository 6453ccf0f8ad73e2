"""Flat-stream checkpoint serialization + N→M reshard math (the port's copy
of ``horovod_tpu/checkpoint/shard_io.py``).

The durable layout reuses the ZeRO-1 flat param/opt convention
(``ops.collectives.shard_spec``): the state tree is flattened into one
logical byte stream, zero-padded to ``shard_spec(total_bytes, N)``
divisibility, and rank r owns the contiguous slice ``[r*shard,
(r+1)*shard)`` — checkpointing costs 1/world_size of the bytes per rank,
and restore at a different world size is pure byte-range re-slicing
against the new world's padding (:func:`reshard_ranges`), no collective
required.

Two layouts:

- ``"replicated"`` — every rank holds the same full tree (the eager
  data-parallel case): the stream is world-independent, so any world size
  can both write shards of it and reassemble it.
- ``"zero1"`` — each rank's tree is its rank-local ZeRO-1 shard state
  (per-bucket flat parameter shards + shard-shaped inner optimizer
  state): the header records the frozen bucket layout so
  :func:`zero1_reshard` can reassemble the logical per-bucket streams,
  trim the old world's padding, and re-slice for the new world —
  optimizer momenta survive an N→M resize without re-initialization.

The bytes on disk are the reference's: the same header JSON, the same
padding, each leaf's raw bytes in tree order. Leaves are torch CPU
tensors, numpy arrays or anything with ``shape``/``dtype``/``nbytes``
(:class:`LeafSpec`); dtypes go by name (:func:`dtype_name`). A
``bfloat16`` or float8 leaf is written as its raw words and read back as
a torch tensor of that dtype through an unsigned-integer view, so no
numpy extension type is needed. Decoded leaves are torch CPU tensors.
"""

from __future__ import annotations

import base64
import hashlib
import json
import pickle
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

HEADER_VERSION = 1

# dtypes numpy holds only through an extension type: their storage words
# and the torch dtype they decode to
_RAW_DTYPES = {"bfloat16": (np.dtype(np.uint16), torch.bfloat16),
               "float8_e4m3fn": (np.dtype(np.uint8), torch.float8_e4m3fn),
               "float8_e5m2": (np.dtype(np.uint8), torch.float8_e5m2)}


class LeafSpec(NamedTuple):
    """What the header records of one leaf: its shape, dtype name and
    byte count (a staged leaf whose bytes live elsewhere)."""
    shape: tuple
    dtype: str
    nbytes: int

    @property
    def ndim(self) -> int:
        return len(self.shape)


def dtype_name(dt) -> str:
    """A dtype's name as the header writes it: numpy's ``str(dtype)``
    (``"float32"``, ``"bfloat16"``, ``"bool"``), from a torch dtype, a
    numpy dtype or a name."""
    if isinstance(dt, str):
        return dt
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(np.dtype(dt))


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a leaf of dtype ``name``'s bytes."""
    raw = _RAW_DTYPES.get(name)
    return raw[0] if raw is not None else np.dtype(name)


def torch_dtype(name: str) -> Optional[torch.dtype]:
    """The torch dtype of ``name``, or None where torch has none (a
    string leaf)."""
    raw = _RAW_DTYPES.get(name)
    if raw is not None:
        return raw[1]
    dt = getattr(torch, name, None)
    return dt if isinstance(dt, torch.dtype) else None


def _shard_spec(total: int, n: int) -> Tuple[int, int]:
    """The ZeRO-1 shard assignment (``ops.collectives.shard_spec``):
    ``(padded, shard)`` with ``shard = ceil(total/n)``, ``padded =
    shard*n``."""
    from ..ops.collectives import shard_spec
    return shard_spec(total, n)


def leaf_bytes(leaf) -> np.ndarray:
    """One leaf's raw bytes as a flat uint8 array (a view where the leaf
    is contiguous): a torch CPU tensor, a numpy array or a scalar."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().reshape(-1).view(
            torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def _nbytes(leaf) -> int:
    return int(leaf.nbytes)


# ---------------------------------------------------------------------------
# Replicated layout: one world-independent flat byte stream
# ---------------------------------------------------------------------------

def encode_leaves(leaves: Sequence) -> bytes:
    """Concatenate the raw bytes of every leaf in tree order — the
    logical checkpoint stream the shards slice."""
    return b"".join(leaf_bytes(l).tobytes() for l in leaves)


def leaf_meta(leaves: Sequence) -> List[dict]:
    return [{"shape": [int(s) for s in l.shape],
             "dtype": dtype_name(l.dtype), "bytes": _nbytes(l)}
            for l in leaves]


def layout_digest(header: dict) -> str:
    """Digest of the layout-identifying header fields (shapes, dtypes,
    bucket structure, writer world size) — the manifest's
    ``shard_spec`` digest. Generation-varying fields (step,
    world_version, extras) are excluded so two checkpoints of the same
    model compare equal."""
    ident = {k: header.get(k) for k in
             ("version", "mode", "world_size", "leaves", "total_bytes",
              "buckets", "state_leaves")}
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def make_header(leaves: Sequence, *, step: int, world_version: int,
                world_size: int, extras: Optional[dict] = None) -> dict:
    """Shared-metadata header for a replicated-layout generation. Every
    rank writes an identical copy next to its shard (header loss must
    not correlate with shard loss)."""
    total = int(sum(_nbytes(l) for l in leaves))
    padded, shard = _shard_spec(total, world_size)
    header = {
        "version": HEADER_VERSION,
        "mode": "replicated",
        "step": int(step),
        "world_version": int(world_version),
        "world_size": int(world_size),
        "leaves": leaf_meta(leaves),
        "total_bytes": total,
        "padded_bytes": int(padded),
        "shard_bytes": int(shard),
    }
    if extras is not None:
        header["extras_b64"] = base64.b64encode(
            pickle.dumps(extras)).decode("ascii")
    header["layout_digest"] = layout_digest(header)
    return header


def header_extras(header: dict) -> Optional[dict]:
    raw = header.get("extras_b64")
    if not raw:
        return None
    return pickle.loads(base64.b64decode(raw))


def shard_of(stream: bytes, rank: int, world_size: int) -> bytes:
    """Rank ``rank``'s byte shard of the logical stream, zero-padded at
    the tail to the ``shard_spec`` divisibility boundary."""
    padded, shard = _shard_spec(len(stream), world_size)
    lo = rank * shard
    hi = lo + shard
    chunk = stream[lo:hi]
    if len(chunk) < shard:
        chunk = chunk + b"\x00" * (shard - len(chunk))
    return chunk


def reshard_ranges(total: int, old_n: int, new_rank: int,
                   new_n: int) -> List[Tuple[int, int, int]]:
    """The elastic-resize re-slice: which old shards cover the byte range
    the *new* world assigns to ``new_rank``.

    Returns ``[(old_rank, offset_in_old_shard, length), ...]`` segments
    that, concatenated, equal ``stream[new_rank*new_shard :
    min((new_rank+1)*new_shard, total)]`` — the new rank's unpadded
    slice. Old-world tail padding is never referenced (ranges stop at
    ``total``); the new world re-pads its own tail."""
    _, old_shard = _shard_spec(total, old_n)
    _, new_shard = _shard_spec(total, new_n)
    lo = new_rank * new_shard
    hi = min(lo + new_shard, total)
    out: List[Tuple[int, int, int]] = []
    pos = lo
    while pos < hi:
        old_rank = pos // old_shard
        off = pos - old_rank * old_shard
        length = min(old_shard - off, hi - pos)
        out.append((old_rank, off, length))
        pos += length
    return out


def _leaf_from(buf, offset: int, shape, name: str, nbytes: int):
    """One leaf decoded from ``buf`` at ``offset``: a torch CPU tensor
    that owns its memory, or a numpy array where torch has no dtype."""
    st = storage_dtype(name)
    arr = np.frombuffer(buf, dtype=st, count=nbytes // st.itemsize,
                        offset=offset).reshape(shape).copy()
    td = torch_dtype(name)
    if td is None:
        return arr
    t = torch.from_numpy(arr)
    return t.view(td) if t.dtype != td else t


def decode_leaves(stream: bytes, header: dict) -> list:
    """Split the (unpadded) logical stream back into leaves per the
    header's shapes/dtypes."""
    metas = header["leaves"]
    total = header["total_bytes"]
    if len(stream) < total:
        raise ValueError(
            f"checkpoint stream truncated: {len(stream)} bytes < "
            f"header total {total}")
    out = []
    off = 0
    for m in metas:
        n = int(m["bytes"])
        out.append(_leaf_from(stream, off, m["shape"], m["dtype"], n))
        off += n
    return out


# ---------------------------------------------------------------------------
# ZeRO-1 layout: rank-local shard state with a frozen bucket layout
# ---------------------------------------------------------------------------

def _assign_state_buckets(state_leaves: Sequence,
                          buckets: Sequence[dict]) -> List[Optional[int]]:
    """Map each shard-shaped inner-state leaf to its fusion bucket.

    Optax state trees mirror the ``shards`` list structure (tree_map), so
    shard-shaped leaves appear in *runs* in bucket order (mu[0..B-1],
    nu[0..B-1], ...); ``DistributedOptimizer.checkpoint_payload`` lists a
    torch optimizer's state in the same order. Within each run of
    consecutive leaves whose shape is 1-D and matches some bucket's shard
    size, buckets with that shard size are assigned cyclically in
    declaration order; leaves matching no bucket (scalars like step
    counts, oddly-shaped state) stay replicated (bucket = None)."""
    by_size: Dict[int, List[int]] = {}
    for b, spec in enumerate(buckets):
        by_size.setdefault(int(spec["shard"]), []).append(b)
    out: List[Optional[int]] = []
    run_size: Optional[int] = None
    run_pos = 0
    for l in state_leaves:
        if l.ndim == 1 and int(l.shape[0]) in by_size:
            s = int(l.shape[0])
            if s != run_size:
                run_size, run_pos = s, 0
            cands = by_size[s]
            out.append(cands[run_pos % len(cands)])
            run_pos += 1
        else:
            run_size = None
            out.append(None)
    return out


def zero1_header(layout: Sequence[Tuple], shard_arrays: Sequence,
                 state_leaves: Sequence, *, step: int,
                 world_version: int, world_size: int,
                 extras: Optional[dict] = None) -> dict:
    """Header for a rank-local ZeRO-1 generation. ``layout`` is the
    optimizer's frozen bucket layout ``[(idxs, sizes, total, shard)]``;
    ``shard_arrays`` this rank's per-bucket flat parameter shards;
    ``state_leaves`` the flattened inner optimizer state."""
    buckets = [{"idxs": [int(i) for i in idxs],
                "sizes": [int(s) for s in sizes],
                "total": int(total), "shard": int(shard),
                "dtype": dtype_name(arr.dtype)}
               for (idxs, sizes, total, shard), arr
               in zip(layout, shard_arrays)]
    header = {
        "version": HEADER_VERSION,
        "mode": "zero1",
        "step": int(step),
        "world_version": int(world_version),
        "world_size": int(world_size),
        "buckets": buckets,
        "state_leaves": [
            {"shape": [int(s) for s in l.shape],
             "dtype": dtype_name(l.dtype), "bytes": _nbytes(l), "bucket": b}
            for l, b in zip(state_leaves,
                            _assign_state_buckets(state_leaves, buckets))],
        "total_bytes": int(sum(_nbytes(a) for a in shard_arrays)
                           + sum(_nbytes(l) for l in state_leaves)),
    }
    if extras is not None:
        header["extras_b64"] = base64.b64encode(
            pickle.dumps(extras)).decode("ascii")
    header["layout_digest"] = layout_digest(header)
    return header


def zero1_payload(shard_arrays: Sequence, state_leaves: Sequence) -> bytes:
    """This rank's shard payload: bucket shards then state leaves, raw
    bytes in order — already 1/world_size of the job's state."""
    return encode_leaves(list(shard_arrays) + list(state_leaves))


def _zero1_parse(header: dict, payload: bytes) -> Tuple[list, list]:
    """Split one rank's payload back into (bucket shards, state leaves)."""
    shards = []
    off = 0
    for spec in header["buckets"]:
        n = int(spec["shard"]) * storage_dtype(spec["dtype"]).itemsize
        shards.append(_leaf_from(payload, off, (int(spec["shard"]),),
                                 spec["dtype"], n))
        off += n
    state = []
    for m in header["state_leaves"]:
        state.append(_leaf_from(payload, off, m["shape"], m["dtype"],
                                int(m["bytes"])))
        off += int(m["bytes"])
    return shards, state


def _reslice(full: torch.Tensor, total: int, new_rank: int,
             new_n: int) -> torch.Tensor:
    """Trim old padding off a reassembled flat vector and slice the new
    world's zero-padded shard — the element-level twin of
    :func:`reshard_ranges`."""
    full = full[:total]
    _, new_shard = _shard_spec(total, new_n)
    pad = new_shard * new_n - total
    if pad:
        full = torch.cat([full, torch.zeros((pad,), dtype=full.dtype)])
    return full[new_rank * new_shard:(new_rank + 1) * new_shard].clone()


def _state_leaf_buckets(header: dict) -> List[Optional[int]]:
    """The bucket each state leaf of a ZeRO-1 header reshards with.

    The header's own map (``_assign_state_buckets``, kept byte for byte
    the reference's) restarts its count at every change of shard size, so
    buckets of one shard size that are not adjacent take each other's
    index: shards [5, 2, 5] map mu/nu to buckets [0, 1, 0] and [2, 1, 0].
    The reader repairs it where the layout is the one both optimizers
    write (optax's count, mu[0..B-1], nu[0..B-1]; ``checkpoint_payload``'s
    step, every ``exp_avg``, every ``exp_avg_sq``, ``max_exp_avg_sq``):
    the shard-shaped leaves (1-D, with a bucket in the header) are k·B in
    number for B buckets, and leaf i is as long as bucket i mod B's
    shard. Then leaf i takes bucket i mod B. Any other layout keeps the
    header's map."""
    buckets = header["buckets"]
    metas = header["state_leaves"]
    mapped = [j for j, m in enumerate(metas)
              if m["bucket"] is not None and len(m["shape"]) == 1]
    out = [None if m["bucket"] is None else int(m["bucket"])
           for m in metas]
    n_b = len(buckets)
    if not mapped or not n_b or len(mapped) % n_b:
        return out
    if any(int(metas[j]["shape"][0]) != int(buckets[i % n_b]["shard"])
           for i, j in enumerate(mapped)):
        return out
    for i, j in enumerate(mapped):
        out[j] = i % n_b
    return out


def zero1_reshard(header: dict, payloads: Dict[int, bytes],
                  new_rank: int, new_n: int) -> Dict[str, Any]:
    """N→M reshard of a ZeRO-1 generation: reassemble each bucket's
    logical flat parameter vector (and each shard-shaped state leaf)
    from the N writer payloads, trim the old padding, and re-slice for
    ``(new_rank, new_n)``.

    Returns ``{"shards": [per-bucket new shard], "state_leaves": [...],
    "full_buckets": [per-bucket unpadded flat params]}``, torch CPU
    tensors — ``shards`` / ``state_leaves`` rebuild the sharded optimizer
    state of the new world (optimizer momenta survive the resize),
    ``full_buckets`` unpack into full parameter leaves via the header's
    idxs/sizes."""
    n = int(header["world_size"])
    missing = [r for r in range(n) if r not in payloads]
    if missing:
        raise ValueError(f"zero1 reshard needs every writer rank's "
                         f"payload; missing {missing}")
    parsed = {r: _zero1_parse(header, payloads[r]) for r in range(n)}
    new_shards = []
    full_buckets = []
    for b, spec in enumerate(header["buckets"]):
        full = torch.cat([parsed[r][0][b] for r in range(n)])
        full_buckets.append(full[:int(spec["total"])].clone())
        new_shards.append(_reslice(full, int(spec["total"]), new_rank,
                                   new_n))
    leaf_bucket = _state_leaf_buckets(header)
    new_state = []
    for j, m in enumerate(header["state_leaves"]):
        if leaf_bucket[j] is None:
            # replicated state leaf (e.g. the step count): identical on
            # every writer, take rank 0's
            new_state.append(parsed[0][1][j])
            continue
        spec = header["buckets"][leaf_bucket[j]]
        full = torch.cat([parsed[r][1][j] for r in range(n)])
        new_state.append(_reslice(full, int(spec["total"]), new_rank,
                                  new_n))
    return {"shards": new_shards, "state_leaves": new_state,
            "full_buckets": full_buckets}


def unpack_bucket(flat, spec: dict) -> dict:
    """Split one unpadded flat bucket back into its leaves: ``{leaf_index:
    flat leaf values}`` per the header bucket's idxs/sizes (shapes are
    the caller's — the template's)."""
    out = {}
    off = 0
    for i, sz in zip(spec["idxs"], spec["sizes"]):
        out[int(i)] = flat[off:off + int(sz)]
        off += int(sz)
    return out
