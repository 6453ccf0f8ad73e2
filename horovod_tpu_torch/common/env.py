"""Environment-variable knobs of the PyTorch port.

A trimmed copy of ``horovod_tpu/common/env.py``: the same ``HOROVOD_*`` names,
so a launch environment written for the JAX package carries over unchanged,
and only the :class:`Config` fields the port reads so far.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

# --- knob names (the JAX package's names) ---
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_TPU_COORDINATOR = "HOROVOD_TPU_COORDINATOR"      # host:port of rank 0
HOROVOD_TPU_NUM_PROCESSES = "HOROVOD_TPU_NUM_PROCESSES"
HOROVOD_TPU_PROCESS_ID = "HOROVOD_TPU_PROCESS_ID"
HOROVOD_TPU_SHUTDOWN_TIMEOUT = "HOROVOD_TPU_SHUTDOWN_TIMEOUT"
HOROVOD_PALLAS_PACK = "HOROVOD_PALLAS_PACK"
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_HIERARCHICAL_ALLGATHER = "HOROVOD_HIERARCHICAL_ALLGATHER"
HOROVOD_JOIN_DISABLE = "HOROVOD_JOIN_DISABLE"
HOROVOD_JOIN_META_SLOTS = "HOROVOD_JOIN_META_SLOTS"
# step-capture replay (core/replay.py): record the collective stream between
# hvd.step_begin()/step_end() and, once the same signature repeats WARMUP
# times, service the whole step as one armed program; =0 disables
HOROVOD_TPU_STEP_REPLAY = "HOROVOD_TPU_STEP_REPLAY"
HOROVOD_TPU_STEP_REPLAY_WARMUP = "HOROVOD_TPU_STEP_REPLAY_WARMUP"
# ZeRO-1: DistributedOptimizer(sharded=None) shards the optimizer state
# when this is on (an optimizer it does not suit stays replicated)
HOROVOD_TPU_SHARD_OPTIMIZER = "HOROVOD_TPU_SHARD_OPTIMIZER"
# elastic world identity: a bump invalidates every armed replay stream
HOROVOD_TPU_WORLD_VERSION = "HOROVOD_TPU_WORLD_VERSION"
# the wire codec of Sum/Average reductions (ops/compression.py): "none",
# "bf16" (2 bytes an element), or the error-feedback "fp8"/"int8" (1 byte,
# a residual carried per bucket); the optimizer's compression= argument
# overrides it per call (the reference's common/env.py:223-233)
HOROVOD_TPU_COMPRESSION = "HOROVOD_TPU_COMPRESSION"
# bounds the engine's table of error-feedback residuals
HOROVOD_CACHE_CAPACITY = "HOROVOD_CACHE_CAPACITY"
# the collective algorithm of every reduction and gather bucket (the
# reference's common/env.py:160-167): "auto" picks per (bytes, topology),
# the recursive-doubling tree for small buckets on power-of-two worlds of
# four or more ranks, the two-level (local, cross) ladder where the
# topology factorizes, the flat ring otherwise; "flat", "tree" and
# "hierarchical" force one form (a form the world cannot express demotes
# to flat with one warning)
HOROVOD_TPU_COLLECTIVE_ALGO = "HOROVOD_TPU_COLLECTIVE_ALGO"
# alltoall's own choice ("auto", "flat" or "hierarchical": the two-phase
# exchange, local then cross), its wire codec (the cross phase of a
# hierarchical alltoall only, no residual) and its flat/hierarchical
# crossover in bytes (0: hierarchical wherever the topology factorizes)
HOROVOD_TPU_ALLTOALL_ALGO = "HOROVOD_TPU_ALLTOALL_ALGO"
HOROVOD_TPU_ALLTOALL_CODEC = "HOROVOD_TPU_ALLTOALL_CODEC"
HOROVOD_TPU_ALLTOALL_HIER_THRESHOLD_BYTES = \
    "HOROVOD_TPU_ALLTOALL_HIER_THRESHOLD_BYTES"
# ranks on one fast-fabric island (an NVLink box): overrides the
# launcher's HOROVOD_LOCAL_SIZE and the ranks' host names
# (parallel/mesh.py detect_topology)
HOROVOD_TPU_LOCAL_SIZE = "HOROVOD_TPU_LOCAL_SIZE"
# "auto" takes the tree for a reduction bucket of at most this many bytes
HOROVOD_TPU_TREE_THRESHOLD_BYTES = "HOROVOD_TPU_TREE_THRESHOLD_BYTES"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024
DEFAULT_JOIN_META_SLOTS = 16
DEFAULT_CACHE_CAPACITY = 1024
COMPRESSION_MODES = ("none", "bf16", "fp8", "int8")
DEFAULT_TREE_THRESHOLD_BYTES = 256 * 1024
COLLECTIVE_ALGO_MODES = ("auto", "flat", "tree", "hierarchical")
ALLTOALL_ALGO_MODES = ("auto", "flat", "hierarchical")


def _get_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _get_choice(name: str, default: str, choices) -> str:
    """``name``'s value, lower-cased, if it is one of ``choices``; else
    ``default``, with a warning for a value outside them."""
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    v = v.strip().lower()
    if v not in choices:
        logging.getLogger("horovod_tpu_torch").warning(
            "%s=%r is not one of %s; using %r", name, v, list(choices),
            default)
        return default
    return v


def _get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return int(v)
    except ValueError:
        return default


@dataclass
class Config:
    """The knobs the port reads, parsed once at ``init``."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    # HOROVOD_PALLAS_PACK keeps the JAX package's name so launch scripts run
    # unchanged; in the port it selects the hand-written CUDA pack kernel
    pack_kernel: bool = False
    # HOROVOD_HIERARCHICAL_ALLREDUCE / _ALLGATHER: a forced preference for
    # the two-level (local, cross) form of their kind where the agreed
    # topology has one (core/engine.py _choose_algo); the first also
    # selects hierarchical Adasum
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # the join protocol's per-collective round (off with
    # HOROVOD_JOIN_DISABLE=1: join() is then a barrier)
    join_enabled: bool = True
    # metadata rows carried inline in a join round; a grouped call with
    # more tensors sends the rest in one overflow exchange
    join_meta_slots: int = DEFAULT_JOIN_META_SLOTS
    # step replay: on by default, armed after this many identical steps
    step_replay: bool = True
    step_replay_warmup: int = 3
    # the default of DistributedOptimizer(sharded=None): ZeRO-1 off
    shard_optimizer: bool = False
    # the engine's wire codec when a call names none (CODECS of
    # ops/compression.py); read per call, so a live move takes effect at
    # the next collective and rebuilds an armed replay program
    compression: str = "none"
    # the most error-feedback residual buffers the engine keeps
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    # algorithm selection (ops/collectives.py choose_algorithm), read per
    # call; a move rebuilds an armed replay program
    collective_algo: str = "auto"
    tree_threshold_bytes: int = DEFAULT_TREE_THRESHOLD_BYTES
    # the flat/hierarchical crossover: 0 (hierarchical wherever it can be
    # expressed) until a calibration probe derives one (ROADMAP A15); not
    # a knob, as in the reference
    hier_threshold_bytes: int = 0
    alltoall_algo: str = "auto"
    alltoall_codec: str = "none"
    alltoall_hier_threshold_bytes: int = 0

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            fusion_threshold_bytes=_get_int(HOROVOD_FUSION_THRESHOLD,
                                            DEFAULT_FUSION_THRESHOLD_BYTES),
            pack_kernel=_get_bool(HOROVOD_PALLAS_PACK),
            hierarchical_allreduce=_get_bool(HOROVOD_HIERARCHICAL_ALLREDUCE),
            hierarchical_allgather=_get_bool(HOROVOD_HIERARCHICAL_ALLGATHER),
            join_enabled=not _get_bool(HOROVOD_JOIN_DISABLE),
            join_meta_slots=_get_int(HOROVOD_JOIN_META_SLOTS,
                                     DEFAULT_JOIN_META_SLOTS),
            step_replay=_get_bool(HOROVOD_TPU_STEP_REPLAY, True),
            step_replay_warmup=_get_int(HOROVOD_TPU_STEP_REPLAY_WARMUP, 3),
            shard_optimizer=_get_bool(HOROVOD_TPU_SHARD_OPTIMIZER, False),
            compression=_get_choice(HOROVOD_TPU_COMPRESSION, "none",
                                    COMPRESSION_MODES),
            cache_capacity=_get_int(HOROVOD_CACHE_CAPACITY,
                                    DEFAULT_CACHE_CAPACITY),
            collective_algo=_get_choice(HOROVOD_TPU_COLLECTIVE_ALGO, "auto",
                                        COLLECTIVE_ALGO_MODES),
            tree_threshold_bytes=_get_int(HOROVOD_TPU_TREE_THRESHOLD_BYTES,
                                          DEFAULT_TREE_THRESHOLD_BYTES),
            alltoall_algo=_get_choice(HOROVOD_TPU_ALLTOALL_ALGO, "auto",
                                      ALLTOALL_ALGO_MODES),
            alltoall_codec=_get_choice(HOROVOD_TPU_ALLTOALL_CODEC, "none",
                                       COMPRESSION_MODES),
            alltoall_hier_threshold_bytes=_get_int(
                HOROVOD_TPU_ALLTOALL_HIER_THRESHOLD_BYTES, 0),
        )
