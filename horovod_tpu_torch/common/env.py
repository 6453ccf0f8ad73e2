"""Environment-variable knobs of the PyTorch port.

A trimmed copy of ``horovod_tpu/common/env.py``: the same ``HOROVOD_*`` names,
so a launch environment written for the JAX package carries over unchanged,
and only the :class:`Config` fields the port reads so far.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

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
HOROVOD_TPU_MOE_CAPACITY_FACTOR = "HOROVOD_TPU_MOE_CAPACITY_FACTOR"
# pipeline schedules (parallel/pipeline.py; the reference's
# common/env.py:234-251): SCHEDULE picks the microbatch schedule, "1f1b"
# (the default), "interleaved" (virtual-stage round-robin chunks), "zb"
# (the backward split into its activation and weight halves) or "auto"
# (the cheapest under the predictor); a degenerate combination demotes to
# 1f1b with one warning. VIRTUAL_STAGES is the chunks a stage v (>= 2
# interleaves), MICROBATCHES the microbatch count m (0: the caller's), and
# BOUNDARY_CODEC the wire codec of the stage-boundary hops that cross
# islands (the others stay raw)
HOROVOD_TPU_PIPELINE_SCHEDULE = "HOROVOD_TPU_PIPELINE_SCHEDULE"
HOROVOD_TPU_PIPELINE_VIRTUAL_STAGES = "HOROVOD_TPU_PIPELINE_VIRTUAL_STAGES"
HOROVOD_TPU_PIPELINE_MICROBATCHES = "HOROVOD_TPU_PIPELINE_MICROBATCHES"
HOROVOD_TPU_PIPELINE_BOUNDARY_CODEC = "HOROVOD_TPU_PIPELINE_BOUNDARY_CODEC"
# ranks on one fast-fabric island (an NVLink box): overrides the
# launcher's HOROVOD_LOCAL_SIZE and the ranks' host names
# (parallel/mesh.py detect_topology)
HOROVOD_TPU_LOCAL_SIZE = "HOROVOD_TPU_LOCAL_SIZE"
# "auto" takes the tree for a reduction bucket of at most this many bytes
HOROVOD_TPU_TREE_THRESHOLD_BYTES = "HOROVOD_TPU_TREE_THRESHOLD_BYTES"
# observability (the reference's common/env.py:21-31, :67, :87-153): the
# Chrome-trace timeline (a path; ranks other than 0 suffix it with
# .rank<r>) and its CYCLE marks; the stall inspector's warning and
# shutdown thresholds (seconds) and its off switch; the cross-rank
# consistency check of every submission (debug mode: one allgather a
# call); the metrics registry's on/off switch, JSONL file and emitter
# interval (seconds); a failpoint spec (faults.py, read at import); the
# trace recorder's on/off switch, ring size, the trace-segment KV
# publisher's interval (seconds) and the flight-dump directory;
# the step-health monitor's switch, baseline window, warm-up, spike
# threshold in MADs and flight-dump interval (seconds); the device-memory
# sampler; the collective watchdog's deadline (seconds, 0 = off)
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
HOROVOD_TPU_DEBUG_CONSISTENCY = "HOROVOD_TPU_DEBUG_CONSISTENCY"
HOROVOD_TPU_METRICS = "HOROVOD_TPU_METRICS"
HOROVOD_TPU_METRICS_FILE = "HOROVOD_TPU_METRICS_FILE"
HOROVOD_TPU_METRICS_INTERVAL = "HOROVOD_TPU_METRICS_INTERVAL"
HOROVOD_TPU_FAULTS = "HOROVOD_TPU_FAULTS"
HOROVOD_TPU_TRACE = "HOROVOD_TPU_TRACE"
HOROVOD_TPU_TRACE_RING = "HOROVOD_TPU_TRACE_RING"
HOROVOD_TPU_TRACE_INTERVAL = "HOROVOD_TPU_TRACE_INTERVAL"
HOROVOD_TPU_TRACE_DUMP_DIR = "HOROVOD_TPU_TRACE_DUMP_DIR"
HOROVOD_TPU_STEP_HEALTH = "HOROVOD_TPU_STEP_HEALTH"
HOROVOD_TPU_STEP_HEALTH_WINDOW = "HOROVOD_TPU_STEP_HEALTH_WINDOW"
HOROVOD_TPU_STEP_HEALTH_WARMUP = "HOROVOD_TPU_STEP_HEALTH_WARMUP"
HOROVOD_TPU_STEP_HEALTH_MAD_K = "HOROVOD_TPU_STEP_HEALTH_MAD_K"
HOROVOD_TPU_STEP_HEALTH_DUMP_INTERVAL = (
    "HOROVOD_TPU_STEP_HEALTH_DUMP_INTERVAL")
HOROVOD_TPU_HBM = "HOROVOD_TPU_HBM"
HOROVOD_TPU_COLLECTIVE_DEADLINE = "HOROVOD_TPU_COLLECTIVE_DEADLINE"
# durable checkpointing (checkpoint/; the reference's common/env.py:256,
# :304-307): setting the directory builds the CheckpointManager at init;
# INTERVAL_STEPS snapshots the registered provider every k completed steps
# (0: only explicit snapshots), REDUNDANCY is how many successor ranks'
# shards each rank holds, KEEP the generations kept, KV_CHUNK_BYTES the
# chunk of a shard published to the rendezvous KV
HOROVOD_TPU_CHECKPOINT_DIR = "HOROVOD_TPU_CHECKPOINT_DIR"
HOROVOD_TPU_CHECKPOINT_INTERVAL_STEPS = "HOROVOD_TPU_CHECKPOINT_INTERVAL_STEPS"
HOROVOD_TPU_CHECKPOINT_REDUNDANCY = "HOROVOD_TPU_CHECKPOINT_REDUNDANCY"
HOROVOD_TPU_CHECKPOINT_KEEP = "HOROVOD_TPU_CHECKPOINT_KEEP"
HOROVOD_TPU_CHECKPOINT_KV_CHUNK_BYTES = "HOROVOD_TPU_CHECKPOINT_KV_CHUNK_BYTES"
# the rendezvous KV (runner/; the reference's common/env.py:51-52,
# :268-275): the server's address and port, or ENDPOINTS, a replica set
# "h1:p1,h2:p2" that overrides them; the client's circuit breaker
# (consecutive failures that trip an endpoint open, the base reopen delay
# in seconds) and the server's per-scope byte budget behind its 429
# answer (0: unlimited). Resolved once at init
HOROVOD_GLOO_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_GLOO_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
HOROVOD_KV_ENDPOINTS = "HOROVOD_KV_ENDPOINTS"
HOROVOD_KV_BREAKER_FAILURES = "HOROVOD_KV_BREAKER_FAILURES"
HOROVOD_KV_BREAKER_RESET = "HOROVOD_KV_BREAKER_RESET"
HOROVOD_KV_SCOPE_BUDGET_BYTES = "HOROVOD_KV_SCOPE_BUDGET_BYTES"
# replicated control plane (runner/replication.py; the reference's
# common/env.py:258-277): LEASE_* drive the primary heartbeat stream and
# the standby's staggered promotion timeout; ACK_REPLICAS overrides the
# write-ack quorum (0 = majority of the replica set); JOURNAL_MAX bounds
# the in-memory replication journal. All resolved once at init — never
# re-read on a request or step path
HOROVOD_KV_LEASE_TIMEOUT = "HOROVOD_KV_LEASE_TIMEOUT"
HOROVOD_KV_LEASE_INTERVAL = "HOROVOD_KV_LEASE_INTERVAL"
HOROVOD_KV_ACK_REPLICAS = "HOROVOD_KV_ACK_REPLICAS"
HOROVOD_KV_JOURNAL_MAX = "HOROVOD_KV_JOURNAL_MAX"
# survivable elastic driver (elastic/failover.py; the reference's
# common/env.py:276-287): JOURNAL gates the driver-state journal (world
# versions, strikes, host deltas, results — replicated through the
# "driver" KV scope so a standby can reconstruct the driver after a
# crash); LEASE_TIMEOUT is how stale the driver's journaled lease
# heartbeat may be before a standby considers the driver dead and
# promotes; LEASE_INTERVAL paces that heartbeat. Distinct from
# HOROVOD_KV_LEASE_* (the replication tier's own lease): the KV lease
# elects a new PRIMARY REPLICA, the driver lease elects a new ELASTIC
# DRIVER on top of it. All resolved once at init
HOROVOD_TPU_DRIVER_JOURNAL = "HOROVOD_TPU_DRIVER_JOURNAL"
HOROVOD_TPU_DRIVER_LEASE_TIMEOUT = "HOROVOD_TPU_DRIVER_LEASE_TIMEOUT"
HOROVOD_TPU_DRIVER_LEASE_INTERVAL = "HOROVOD_TPU_DRIVER_LEASE_INTERVAL"
# hierarchical telemetry fabric (runner/aggregator.py; the reference's
# common/env.py:288-303): AGG_ENABLE turns on the per-slice aggregator
# tier — each slice's lowest-rank worker hosts a SliceAggregator that
# receives slice-local metrics/trace/stall publishes and rolls ONE merged
# payload per stream per AGG_INTERVAL to the replicated root (O(slices)
# root load instead of O(ranks)); only effective when the topology
# factorizes (1 < local_size < size). AGG_CARDINALITY picks the metrics
# rollup shape: "rank" preserves per-rank snapshots inside the rollup,
# "slice" pre-sums them to one synthetic slice<k> series set.
# AGG_FALLBACK governs what a publisher does when its aggregator is dead:
# =1 (default) degrades loudly to direct-to-root (counted in
# hvd_tpu_agg_fallback_total), =0 raises to the caller. All resolved once
# at init — the elastic driver re-hosts aggregators per world
HOROVOD_TPU_AGG_ENABLE = "HOROVOD_TPU_AGG_ENABLE"
HOROVOD_TPU_AGG_INTERVAL = "HOROVOD_TPU_AGG_INTERVAL"
HOROVOD_TPU_AGG_CARDINALITY = "HOROVOD_TPU_AGG_CARDINALITY"
HOROVOD_TPU_AGG_FALLBACK = "HOROVOD_TPU_AGG_FALLBACK"
# the launcher and elastic training (runner/, elastic/; the reference's
# common/env.py:43-66, :154-158): the launch contract's size and host
# name, the elastic switch (set by the elastic launcher: the rank comes
# from the rendezvous at every init), the rendezvous wait, the NICs the
# driver may advertise, and the device a world runs on when init() is
# given none ("cpu" or "cuda"; the reference's test override). The
# driver's slot-failure backoff (base seconds, doubling per strike) and
# strike limit (past it the slot's host is blacklisted), its wait for
# slots (seconds), the run loop's bound on consecutive recoveries from a
# raw torch.distributed error, and how long rank 0 of an elastic NCCL
# world waits for its peers' teardown before its store goes (seconds)
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_HOSTNAME = "HOROVOD_HOSTNAME"
HOROVOD_ELASTIC = "HOROVOD_ELASTIC"
HOROVOD_GLOO_TIMEOUT_SECONDS = "HOROVOD_GLOO_TIMEOUT_SECONDS"
HOROVOD_GLOO_IFACE = "HOROVOD_GLOO_IFACE"
HOROVOD_TPU_PLATFORM = "HOROVOD_TPU_PLATFORM"
HOROVOD_ELASTIC_FAILURE_BACKOFF = "HOROVOD_ELASTIC_FAILURE_BACKOFF"
HOROVOD_ELASTIC_SLOT_FAILURE_LIMIT = "HOROVOD_ELASTIC_SLOT_FAILURE_LIMIT"
HOROVOD_ELASTIC_TIMEOUT = "HOROVOD_ELASTIC_TIMEOUT"
HOROVOD_ELASTIC_MAX_RUNTIME_RETRIES = "HOROVOD_ELASTIC_MAX_RUNTIME_RETRIES"
HOROVOD_TPU_SHUTDOWN_ORDER_TIMEOUT = "HOROVOD_TPU_SHUTDOWN_ORDER_TIMEOUT"
# knobs the launcher's flags export for the workers (launch.py
# env_from_args); the port's workers read them with ROADMAP A15
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
# the level of the horovod_tpu_torch logger, applied at init
# (core/state.py _apply_log_level; the reference's core/state.py:527-550)
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024
DEFAULT_JOIN_META_SLOTS = 16
DEFAULT_CACHE_CAPACITY = 1024
COMPRESSION_MODES = ("none", "bf16", "fp8", "int8")
DEFAULT_TREE_THRESHOLD_BYTES = 256 * 1024
COLLECTIVE_ALGO_MODES = ("auto", "flat", "tree", "hierarchical")
ALLTOALL_ALGO_MODES = ("auto", "flat", "hierarchical")
PIPELINE_SCHEDULE_MODES = ("1f1b", "interleaved", "zb", "auto")
DEFAULT_STALL_WARNING_SECONDS = 60.0
DEFAULT_CHECKPOINT_KV_CHUNK_BYTES = 4 * 1024 * 1024
AGG_CARDINALITY_MODES = ("rank", "slice")


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


def _get_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return float(v)
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
    # the MoE-EP train step's capacity factor when above 0, else the
    # model config's (models/transformer.py make_moe_ep_train_step)
    moe_capacity_factor: float = 0.0
    # the pipeline's schedule knobs (parallel/pipeline.py), read by
    # make_pp_engine_train_step when the caller names no schedule
    pipeline_schedule: str = "1f1b"
    pipeline_virtual_stages: int = 1
    pipeline_microbatches: int = 0
    pipeline_boundary_codec: str = "none"
    # observability (the reference's Config:431-622, its defaults); the
    # HOROVOD_TPU_METRICS switch is read by metrics.metrics_enabled(): the
    # registry is process-wide and outlives any Config
    timeline_path: Optional[str] = None
    timeline_mark_cycles: bool = False
    stall_check_disable: bool = False
    stall_warning_seconds: float = DEFAULT_STALL_WARNING_SECONDS
    stall_shutdown_seconds: float = 0.0
    collective_deadline: float = 0.0
    debug_consistency: bool = False
    metrics_file: Optional[str] = None
    metrics_interval: float = 10.0
    trace_enabled: bool = True
    trace_ring: int = 4096
    trace_interval: float = 5.0
    trace_dump_dir: Optional[str] = None
    step_health: bool = True
    step_health_window: int = 64
    step_health_warmup: int = 8
    step_health_mad_k: float = 3.0
    step_health_dump_interval: float = 60.0
    hbm_telemetry: bool = True
    # the hierarchical telemetry fabric (the reference's Config:495-498)
    agg_enable: bool = True
    agg_interval: float = 5.0
    agg_cardinality: str = "rank"
    agg_fallback: bool = True
    # durable checkpointing (the reference's Config:499-503)
    checkpoint_dir: Optional[str] = None
    checkpoint_interval_steps: int = 0
    checkpoint_redundancy: int = 1
    checkpoint_keep: int = 2
    checkpoint_kv_chunk_bytes: int = DEFAULT_CHECKPOINT_KV_CHUNK_BYTES
    # elastic training (elastic/): the launcher's HOROVOD_ELASTIC
    elastic: bool = False

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
            moe_capacity_factor=_get_float(
                HOROVOD_TPU_MOE_CAPACITY_FACTOR, 0.0),
            pipeline_schedule=_get_choice(
                HOROVOD_TPU_PIPELINE_SCHEDULE, "1f1b",
                PIPELINE_SCHEDULE_MODES),
            pipeline_virtual_stages=_get_int(
                HOROVOD_TPU_PIPELINE_VIRTUAL_STAGES, 1),
            pipeline_microbatches=_get_int(
                HOROVOD_TPU_PIPELINE_MICROBATCHES, 0),
            pipeline_boundary_codec=_get_choice(
                HOROVOD_TPU_PIPELINE_BOUNDARY_CODEC, "none",
                COMPRESSION_MODES),
            timeline_path=os.environ.get(HOROVOD_TIMELINE) or None,
            timeline_mark_cycles=_get_bool(HOROVOD_TIMELINE_MARK_CYCLES),
            stall_check_disable=_get_bool(HOROVOD_STALL_CHECK_DISABLE),
            stall_warning_seconds=_get_float(
                HOROVOD_STALL_CHECK_TIME_SECONDS,
                DEFAULT_STALL_WARNING_SECONDS),
            stall_shutdown_seconds=_get_float(
                HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, 0.0),
            collective_deadline=_get_float(HOROVOD_TPU_COLLECTIVE_DEADLINE,
                                           0.0),
            debug_consistency=_get_bool(HOROVOD_TPU_DEBUG_CONSISTENCY),
            metrics_file=os.environ.get(HOROVOD_TPU_METRICS_FILE) or None,
            metrics_interval=_get_float(HOROVOD_TPU_METRICS_INTERVAL, 10.0),
            trace_enabled=_get_bool(HOROVOD_TPU_TRACE, True),
            trace_ring=_get_int(HOROVOD_TPU_TRACE_RING, 4096),
            trace_interval=_get_float(HOROVOD_TPU_TRACE_INTERVAL, 5.0),
            trace_dump_dir=os.environ.get(HOROVOD_TPU_TRACE_DUMP_DIR) or None,
            step_health=_get_bool(HOROVOD_TPU_STEP_HEALTH, True),
            step_health_window=_get_int(HOROVOD_TPU_STEP_HEALTH_WINDOW, 64),
            step_health_warmup=_get_int(HOROVOD_TPU_STEP_HEALTH_WARMUP, 8),
            step_health_mad_k=_get_float(HOROVOD_TPU_STEP_HEALTH_MAD_K, 3.0),
            step_health_dump_interval=_get_float(
                HOROVOD_TPU_STEP_HEALTH_DUMP_INTERVAL, 60.0),
            hbm_telemetry=_get_bool(HOROVOD_TPU_HBM, True),
            agg_enable=_get_bool(HOROVOD_TPU_AGG_ENABLE, True),
            agg_interval=_get_float(HOROVOD_TPU_AGG_INTERVAL, 5.0),
            agg_cardinality=_get_choice(
                HOROVOD_TPU_AGG_CARDINALITY, "rank", AGG_CARDINALITY_MODES),
            agg_fallback=_get_bool(HOROVOD_TPU_AGG_FALLBACK, True),
            checkpoint_dir=os.environ.get(HOROVOD_TPU_CHECKPOINT_DIR)
            or None,
            checkpoint_interval_steps=_get_int(
                HOROVOD_TPU_CHECKPOINT_INTERVAL_STEPS, 0),
            checkpoint_redundancy=_get_int(
                HOROVOD_TPU_CHECKPOINT_REDUNDANCY, 1),
            checkpoint_keep=_get_int(HOROVOD_TPU_CHECKPOINT_KEEP, 2),
            checkpoint_kv_chunk_bytes=_get_int(
                HOROVOD_TPU_CHECKPOINT_KV_CHUNK_BYTES,
                DEFAULT_CHECKPOINT_KV_CHUNK_BYTES),
            elastic=_get_bool(HOROVOD_ELASTIC),
        )
