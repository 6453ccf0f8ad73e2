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

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024
DEFAULT_JOIN_META_SLOTS = 16
DEFAULT_CACHE_CAPACITY = 1024
COMPRESSION_MODES = ("none", "bf16", "fp8", "int8")


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
    # HOROVOD_HIERARCHICAL_ALLREDUCE: the two-level (local, cross) form where
    # the agreed topology has one. So far it selects hierarchical Adasum
    # only; hierarchical Sum/Average is not ported (ROADMAP A11), and such
    # an allreduce warns once that it runs flat (core/engine.py)
    hierarchical_allreduce: bool = False
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

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            fusion_threshold_bytes=_get_int(HOROVOD_FUSION_THRESHOLD,
                                            DEFAULT_FUSION_THRESHOLD_BYTES),
            pack_kernel=_get_bool(HOROVOD_PALLAS_PACK),
            hierarchical_allreduce=_get_bool(HOROVOD_HIERARCHICAL_ALLREDUCE),
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
        )
