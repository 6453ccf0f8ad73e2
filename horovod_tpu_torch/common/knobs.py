"""The port's configuration-knob registry.

Every ``HOROVOD_*`` / ``HOROVOD_TPU_*`` environment variable the port reads
or exports is declared here, at the port's own default: name ->
``{"type", "default", "help"}``, plus ``"choices"`` for choice knobs,
``"internal": True`` for plumbing the launcher or the rendezvous sets
rather than users, and ``"export": True`` for a variable the port only
*sets* for its workers (part of the launch contract, never read back).
The entry schema is the reference's (``horovod_tpu/common/knobs.py``), so
a launch environment written for the reference carries over.

Two more tables account for the reference's knobs the port does not read:

- :data:`OWED`: a knob a named ROADMAP item will port, mapped to that
  item (A10: the overlap pipeline and the launch shapes; A15: autotune and
  calibration). The launcher already writes ``HOROVOD_AUTOTUNE``,
  ``HOROVOD_CYCLE_TIME`` and ``HOROVOD_AUTOTUNE_LOG`` for its workers; no
  port module reads them until A15.
- :data:`NOT_OWED`: a knob with no meaning on CUDA, mapped to the reason.

:mod:`horovod_tpu_torch.analysis.knobcheck` lints the three tables: every
read under ``horovod_tpu_torch/`` declared, every declared knob read
(or exported), defaults consistent with their types, choice knobs read
through ``common/env.py``'s ``_get_choice``, and the three tables pairwise
disjoint. Parsing stays where it was (``common/env.py`` and the read
sites); this table adds no runtime indirection.
"""

from __future__ import annotations

from typing import Dict

KNOB_SPECS: Dict[str, dict] = {
    # -- engine / fusion ---------------------------------------------------
    "HOROVOD_FUSION_THRESHOLD": {
        "type": "int", "default": str(64 * 1024 * 1024),
        "help": "Fusion bucket size in bytes for grouped and sharded "
                "collectives."},
    "HOROVOD_CACHE_CAPACITY": {
        "type": "int", "default": "1024",
        "help": "Most error-feedback residual buffers the engine keeps "
                "(an LRU table)."},
    "HOROVOD_JOIN_DISABLE": {
        "type": "bool", "default": "0",
        "help": "Disable the per-collective join round; join() is then a "
                "barrier."},
    "HOROVOD_JOIN_META_SLOTS": {
        "type": "int", "default": "16",
        "help": "Inline metadata rows in a join round; a larger grouped "
                "call sends the rest in one overflow exchange."},
    "HOROVOD_HIERARCHICAL_ALLREDUCE": {
        "type": "bool", "default": "0",
        "help": "Prefer the two-level (local, cross) reduction where the "
                "agreed topology has one; also selects hierarchical "
                "Adasum."},
    "HOROVOD_HIERARCHICAL_ALLGATHER": {
        "type": "bool", "default": "0",
        "help": "Prefer the two-level (local, cross) allgather where the "
                "agreed topology has one."},
    "HOROVOD_PALLAS_PACK": {
        "type": "bool", "default": "0",
        "help": "Pack grouped collectives' fusion buckets with the "
                "hand-written CUDA pack kernel (the reference's name, kept "
                "so launch scripts run unchanged)."},
    "HOROVOD_TPU_DEBUG_CONSISTENCY": {
        "type": "bool", "default": "0",
        "help": "Allgather a fingerprint of every submission and raise a "
                "descriptive error on a cross-rank mismatch (debug "
                "mode)."},
    # -- step replay -------------------------------------------------------
    "HOROVOD_TPU_STEP_REPLAY": {
        "type": "bool", "default": "1",
        "help": "Record the collective stream between step_begin() and "
                "step_end() and service a repeating step as one armed "
                "program."},
    "HOROVOD_TPU_STEP_REPLAY_WARMUP": {
        "type": "int", "default": "3",
        "help": "Identical step signatures before a replay stream arms."},
    # -- collective algorithm selection ------------------------------------
    "HOROVOD_TPU_COLLECTIVE_ALGO": {
        "type": "choice", "default": "auto",
        "choices": ("auto", "flat", "tree", "hierarchical"),
        "help": "Algorithm of every reduction and gather bucket: auto "
                "picks per (bytes, topology); a forced form the world "
                "cannot express demotes to flat with one warning."},
    "HOROVOD_TPU_TREE_THRESHOLD_BYTES": {
        "type": "int", "default": "262144",
        "help": "auto takes the recursive-doubling tree for a reduction "
                "bucket of at most this many bytes."},
    "HOROVOD_TPU_COMPRESSION": {
        "type": "choice", "default": "none",
        "choices": ("none", "bf16", "fp8", "int8"),
        "help": "Wire codec of Sum/Average reductions: bf16 (2 bytes an "
                "element) or the error-feedback fp8/int8 (1 byte, a "
                "residual per bucket); the optimizer's compression= "
                "argument overrides it."},
    "HOROVOD_TPU_ALLTOALL_ALGO": {
        "type": "choice", "default": "auto",
        "choices": ("auto", "flat", "hierarchical"),
        "help": "Alltoall's form: flat, or the two-phase exchange (local, "
                "then cross)."},
    "HOROVOD_TPU_ALLTOALL_CODEC": {
        "type": "choice", "default": "none",
        "choices": ("none", "bf16", "fp8", "int8"),
        "help": "Wire codec of a hierarchical alltoall's cross phase only "
                "(stateless, no residual)."},
    "HOROVOD_TPU_ALLTOALL_HIER_THRESHOLD_BYTES": {
        "type": "int", "default": "0 (hierarchical whenever possible)",
        "help": "auto keeps the flat alltoall for a payload of at most "
                "this many bytes."},
    "HOROVOD_TPU_LOCAL_SIZE": {
        "type": "int", "default": "derived",
        "help": "Ranks on one fast-fabric island (an NVLink box); wins "
                "over the launcher's HOROVOD_LOCAL_SIZE and the ranks' "
                "host names."},
    "HOROVOD_TPU_MOE_CAPACITY_FACTOR": {
        "type": "float", "default": "0 (model config decides)",
        "help": "Capacity-factor override of the expert-parallel MoE "
                "train step; 0 defers to the model config."},
    # -- pipeline schedules ------------------------------------------------
    "HOROVOD_TPU_PIPELINE_SCHEDULE": {
        "type": "choice", "default": "1f1b",
        "choices": ("1f1b", "interleaved", "zb", "auto"),
        "help": "Microbatch schedule of the pipeline train step; a "
                "degenerate combination demotes to 1f1b with one "
                "warning."},
    "HOROVOD_TPU_PIPELINE_VIRTUAL_STAGES": {
        "type": "int", "default": "1",
        "help": "Virtual chunks a stage (>= 2 interleaves)."},
    "HOROVOD_TPU_PIPELINE_MICROBATCHES": {
        "type": "int", "default": "0",
        "help": "Microbatch count override (0: the caller's)."},
    "HOROVOD_TPU_PIPELINE_BOUNDARY_CODEC": {
        "type": "choice", "default": "none",
        "choices": ("none", "bf16", "fp8", "int8"),
        "help": "Wire codec of the stage-boundary hops that cross "
                "islands (the others stay raw)."},
    # -- ZeRO-1 ------------------------------------------------------------
    "HOROVOD_TPU_SHARD_OPTIMIZER": {
        "type": "bool", "default": "0",
        "help": "Default of DistributedOptimizer(sharded=None): shard the "
                "optimizer state (reduce-scatter, shard update, "
                "allgather)."},
    # -- stall inspector / collective watchdog -----------------------------
    "HOROVOD_STALL_CHECK_DISABLE": {
        "type": "bool", "default": "0",
        "help": "Disable the stall warning and shutdown tiers (the "
                "watchdog still arms when a deadline is set)."},
    "HOROVOD_STALL_CHECK_TIME_SECONDS": {
        "type": "float", "default": "60.0",
        "help": "Outstanding-collective age before a stall warning."},
    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": {
        "type": "float", "default": "0.0",
        "help": "Outstanding-collective age before the process aborts (0 "
                "disables)."},
    "HOROVOD_TPU_COLLECTIVE_DEADLINE": {
        "type": "float", "default": "0.0",
        "help": "Seconds a collective may stay outstanding before the "
                "watchdog poisons the engine and raises the "
                "elastic-recoverable error; 0 disables."},
    # -- durable checkpointing ---------------------------------------------
    "HOROVOD_TPU_CHECKPOINT_DIR": {
        "type": "str", "default": "",
        "help": "Checkpoint root; setting it builds the CheckpointManager "
                "at init."},
    "HOROVOD_TPU_CHECKPOINT_INTERVAL_STEPS": {
        "type": "int", "default": "0",
        "help": "Snapshot the registered provider every k completed steps "
                "(0: explicit snapshots only)."},
    "HOROVOD_TPU_CHECKPOINT_REDUNDANCY": {
        "type": "int", "default": "1",
        "help": "Successor ranks whose shards each rank also holds."},
    "HOROVOD_TPU_CHECKPOINT_KEEP": {
        "type": "int", "default": "2",
        "help": "Complete generations kept per rank."},
    "HOROVOD_TPU_CHECKPOINT_KV_CHUNK_BYTES": {
        "type": "int", "default": "4194304",
        "help": "Chunk of a shard published to the rendezvous KV."},
    # -- the rendezvous KV and its replicas --------------------------------
    "HOROVOD_KV_ENDPOINTS": {
        "type": "str", "default": "",
        "help": "Replica set 'h1:p1,h2:p2' every KV client fails over "
                "across; overrides the rendezvous address and port. "
                "Resolved once at init."},
    "HOROVOD_KV_BREAKER_FAILURES": {
        "type": "int", "default": "3",
        "help": "Consecutive failures that trip a KV endpoint's circuit "
                "breaker open."},
    "HOROVOD_KV_BREAKER_RESET": {
        "type": "float", "default": "0.5",
        "help": "Base seconds a tripped breaker stays open (doubling, "
                "jittered)."},
    "HOROVOD_KV_LEASE_TIMEOUT": {
        "type": "float", "default": "2.0",
        "help": "Lease silence a standby replica tolerates before it "
                "promotes itself."},
    "HOROVOD_KV_LEASE_INTERVAL": {
        "type": "float", "default": "0.5",
        "help": "Seconds between the primary replica's lease ticks."},
    "HOROVOD_KV_ACK_REPLICAS": {
        "type": "int", "default": "0",
        "help": "Replicas that must apply a write before it is acked (0: "
                "a majority of the replica set)."},
    "HOROVOD_KV_JOURNAL_MAX": {
        "type": "int", "default": "8192",
        "help": "Replication journal entries kept in memory."},
    "HOROVOD_KV_SCOPE_BUDGET_BYTES": {
        "type": "int", "default": "0",
        "help": "Per-scope KV byte budget behind the server's 429 answer "
                "(0: unlimited)."},
    # -- metrics, tracing, step health, telemetry --------------------------
    "HOROVOD_TPU_METRICS": {
        "type": "bool", "default": "1",
        "help": "Master switch of the metrics registry; =0 makes every "
                "instrument a no-op."},
    "HOROVOD_TPU_METRICS_FILE": {
        "type": "str", "default": "",
        "help": "JSONL file the metrics emitter appends snapshots to."},
    "HOROVOD_TPU_METRICS_INTERVAL": {
        "type": "float", "default": "10.0",
        "help": "Seconds between metrics emitter ticks."},
    "HOROVOD_TPU_TRACE": {
        "type": "bool", "default": "1",
        "help": "Cross-rank collective tracing; =0 leaves engine.trace "
                "None."},
    "HOROVOD_TPU_TRACE_RING": {
        "type": "int", "default": "4096",
        "help": "Events in a rank's trace ring."},
    "HOROVOD_TPU_TRACE_INTERVAL": {
        "type": "float", "default": "5.0",
        "help": "Seconds between trace-segment KV publishes."},
    "HOROVOD_TPU_TRACE_DUMP_DIR": {
        "type": "str", "default": "",
        "help": "Directory of the flight-recorder trace dumps."},
    "HOROVOD_TPU_STEP_HEALTH": {
        "type": "bool", "default": "1",
        "help": "Per-step health digests and the anomaly detector; =0 "
                "leaves engine.health None."},
    "HOROVOD_TPU_STEP_HEALTH_WINDOW": {
        "type": "int", "default": "64",
        "help": "Rolling baseline of the median+MAD detector, in steps."},
    "HOROVOD_TPU_STEP_HEALTH_WARMUP": {
        "type": "int", "default": "8",
        "help": "Steps of history before the detector classifies."},
    "HOROVOD_TPU_STEP_HEALTH_MAD_K": {
        "type": "float", "default": "3.0",
        "help": "Spike threshold in MADs above the rolling median."},
    "HOROVOD_TPU_STEP_HEALTH_DUMP_INTERVAL": {
        "type": "float", "default": "60.0",
        "help": "Least seconds between automatic flight-recorder dumps."},
    "HOROVOD_TPU_HBM": {
        "type": "bool", "default": "1",
        "help": "Sample the device's memory statistics on the metrics "
                "emitter's thread."},
    "HOROVOD_TPU_AGG_ENABLE": {
        "type": "bool", "default": "1",
        "help": "Per-island telemetry aggregators that roll the island's "
                "publishes into one payload a stream; no-op on a flat "
                "topology."},
    "HOROVOD_TPU_AGG_INTERVAL": {
        "type": "float", "default": "5.0",
        "help": "Seconds between an aggregator's rollups."},
    "HOROVOD_TPU_AGG_CARDINALITY": {
        "type": "choice", "default": "rank", "choices": ("rank", "slice"),
        "help": "Metrics rollup shape: per-rank snapshots, or one "
                "pre-summed series set an island."},
    "HOROVOD_TPU_AGG_FALLBACK": {
        "type": "bool", "default": "1",
        "help": "With its aggregator dead, a publisher goes straight to "
                "the root (counted); =0 raises instead."},
    # -- timeline ----------------------------------------------------------
    "HOROVOD_TIMELINE": {
        "type": "str", "default": "",
        "help": "Chrome-trace timeline path (ranks above 0 suffix "
                ".rank<r>)."},
    "HOROVOD_TIMELINE_MARK_CYCLES": {
        "type": "bool", "default": "0",
        "help": "Mark engine cycles in the timeline."},
    "HOROVOD_TIMELINE_NATIVE": {
        "type": "bool", "default": "1",
        "help": "Use the native timeline writer where it builds; =0 forces "
                "the Python writer."},
    # -- fault injection ---------------------------------------------------
    "HOROVOD_TPU_FAULTS": {
        "type": "spec", "default": "",
        "help": "Failpoint spec (name[@rank]=N*action(args)->...), read "
                "at import; unset leaves every failpoint a no-op."},
    # -- elastic -----------------------------------------------------------
    "HOROVOD_ELASTIC": {
        "type": "bool", "default": "0",
        "help": "Elastic mode (set by the elastic launcher): rank and size "
                "come from the rendezvous at every init."},
    "HOROVOD_ELASTIC_TIMEOUT": {
        "type": "float", "default": "600",
        "help": "Seconds to wait for the elastic world to form (falls back "
                "to HOROVOD_GLOO_TIMEOUT_SECONDS)."},
    "HOROVOD_ELASTIC_MAX_RUNTIME_RETRIES": {
        "type": "int", "default": "3",
        "help": "Consecutive raw torch.distributed failures the elastic "
                "run loop recovers before it escalates."},
    "HOROVOD_ELASTIC_FAILURE_BACKOFF": {
        "type": "float", "default": "5.0",
        "help": "Base seconds a failing slot is suspended (doubling a "
                "strike)."},
    "HOROVOD_ELASTIC_SLOT_FAILURE_LIMIT": {
        "type": "int", "default": "4",
        "help": "Slot failure strikes before its host is blacklisted."},
    "HOROVOD_TPU_DRIVER_JOURNAL": {
        "type": "bool", "default": "1",
        "help": "Journal the elastic driver's state through the replicated "
                "'driver' KV scope so a standby can take over."},
    "HOROVOD_TPU_DRIVER_LEASE_TIMEOUT": {
        "type": "float", "default": "2.0",
        "help": "Staleness of the driver's lease before a standby "
                "promotes."},
    "HOROVOD_TPU_DRIVER_LEASE_INTERVAL": {
        "type": "float", "default": "0.5",
        "help": "Seconds between the driver's lease heartbeats."},
    # -- logging -----------------------------------------------------------
    "HOROVOD_LOG_LEVEL": {
        "type": "str", "default": "warning",
        "help": "Level of the horovod_tpu_torch logger "
                "(trace/debug/info/warning/error/fatal), applied at "
                "init."},
    # -- launcher / rendezvous plumbing ------------------------------------
    "HOROVOD_GLOO_RENDEZVOUS_ADDR": {
        "type": "str", "default": "", "internal": True,
        "help": "Rendezvous KV address the launcher hands its workers."},
    "HOROVOD_GLOO_RENDEZVOUS_PORT": {
        "type": "int", "default": "", "internal": True,
        "help": "Rendezvous KV port."},
    "HOROVOD_GLOO_TIMEOUT_SECONDS": {
        "type": "float", "default": "600 (120 for the coordinator lookup)",
        "internal": True,
        "help": "Rendezvous long-poll timeout."},
    "HOROVOD_GLOO_IFACE": {
        "type": "str", "default": "", "internal": True,
        "help": "Network interfaces the driver may advertise."},
    "HOROVOD_HOSTNAME": {
        "type": "str", "default": "derived", "internal": True,
        "help": "This worker's host name as the launcher assigned it."},
    "HOROVOD_RANK": {
        "type": "int", "default": "0", "internal": True,
        "help": "This worker's world rank (launcher-assigned)."},
    "HOROVOD_SIZE": {
        "type": "int", "default": "derived", "internal": True,
        "export": True,
        "help": "World size, exported to the workers (the port reads "
                "HOROVOD_TPU_NUM_PROCESSES)."},
    "HOROVOD_LOCAL_RANK": {
        "type": "int", "default": "0", "internal": True,
        "help": "Rank within this host; picks the card."},
    "HOROVOD_LOCAL_SIZE": {
        "type": "int", "default": "1", "internal": True,
        "help": "Workers on this host."},
    "HOROVOD_CROSS_RANK": {
        "type": "int", "default": "derived", "internal": True,
        "help": "This host's index across hosts."},
    "HOROVOD_CROSS_SIZE": {
        "type": "int", "default": "derived", "internal": True,
        "help": "Number of hosts."},
    "HOROVOD_TASK_SECRET": {
        "type": "str", "default": "", "internal": True,
        "help": "Hex job secret signing task-agent requests (stripped "
                "from worker environments)."},
    "HOROVOD_TPU_SHARED_FS": {
        "type": "bool", "default": "0", "internal": True,
        "help": "Acknowledge that the programmatic run's temporary "
                "directory is shared by every remote host."},
    "HOROVOD_TPU_COORDINATOR": {
        "type": "str", "default": "", "internal": True,
        "help": "host:port of rank 0's TCP store (init_process_group's "
                "init_method), or '@rendezvous'."},
    "HOROVOD_TPU_NUM_PROCESSES": {
        "type": "int", "default": "derived", "internal": True,
        "help": "World size given to init_process_group."},
    "HOROVOD_TPU_PROCESS_ID": {
        "type": "int", "default": "derived", "internal": True,
        "help": "This process's rank given to init_process_group (falls "
                "back to HOROVOD_RANK)."},
    "HOROVOD_TPU_WORLD_VERSION": {
        "type": "int", "default": "0", "internal": True,
        "help": "Elastic world version the rendezvous stamps on every "
                "init; a bump invalidates every armed replay stream."},
    "HOROVOD_TPU_PLATFORM": {
        "type": "str", "default": "cuda", "internal": True,
        "help": "Device a world runs on when init() is given none (cpu or "
                "cuda)."},
    "HOROVOD_TPU_SHUTDOWN_TIMEOUT": {
        "type": "int", "default": "300 (30 when elastic)", "internal": True,
        "help": "The process group's timeout in seconds: a collective or "
                "store wait past it fails."},
    "HOROVOD_TPU_SHUTDOWN_ORDER_TIMEOUT": {
        "type": "float", "default": "10", "internal": True,
        "help": "Seconds rank 0 of an elastic NCCL world waits for its "
                "peers' teardown before its store goes."},
}

# The reference's knobs a named ROADMAP item will port: knob -> item.
OWED: Dict[str, str] = {
    # A10, the overlap remainder: one-launch grouped reductions, the
    # steady-state size cache, the bucket-pipelined overlap and the ZeRO-1
    # prefetch
    "HOROVOD_TPU_SINGLE_LAUNCH": "A10",
    "HOROVOD_TPU_META_CACHE": "A10",
    "HOROVOD_TPU_META_CACHE_WARMUP": "A10",
    "HOROVOD_TPU_OVERLAP_PIPELINE": "A10",
    "HOROVOD_TPU_OVERLAP_STAGE_BYTES": "A10",
    "HOROVOD_TPU_ZERO1_PREFETCH": "A10",
    # A15, autotune and calibration; the launcher already writes the first
    # three for its workers (runner/launch.py env_from_args)
    "HOROVOD_AUTOTUNE": "A15",
    "HOROVOD_CYCLE_TIME": "A15",
    "HOROVOD_AUTOTUNE_LOG": "A15",
    "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "A15",
    "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "A15",
    "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "A15",
    "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE": "A15",
    "HOROVOD_TPU_CALIBRATE": "A15",
    "HOROVOD_TPU_TUNE_PERSIST": "A15",
    "HOROVOD_TPU_TUNE_PERSIST_DIR": "A15",
}

# The reference's knobs with no meaning on CUDA: knob -> reason.
NOT_OWED: Dict[str, str] = {
    "HOROVOD_TPU_XLA_LHS":
        "appends XLA's TPU latency-hiding-scheduler flag to XLA_FLAGS; the "
        "port compiles nothing through XLA",
    "HOROVOD_TPU_HEARTBEAT_TIMEOUT":
        "the heartbeat of jax's coordination service; torch.distributed "
        "has no heartbeat service: a dead peer surfaces through the "
        "process group's timeout (HOROVOD_TPU_SHUTDOWN_TIMEOUT) and the "
        "collective watchdog (HOROVOD_TPU_COLLECTIVE_DEADLINE)",
    "HOROVOD_ADASUM_PALLAS":
        "chooses the Pallas or the lax form of the Adasum combine; on "
        "CUDA the combine always runs its hand-written kernels (K4, K5)",
    "HOROVOD_RING_PALLAS":
        "chooses the Pallas or the pure-JAX ring-attention segment; on "
        "CUDA every segment runs the hand-written kernels (K7)",
    "HOROVOD_RING_CHUNK":
        "the kv rows a Pallas ring step holds in VMEM; the CUDA segment "
        "kernels tile for shared memory at compile time",
    "HOROVOD_RING_SEG_BLOCK":
        "the Pallas ring segment's block size; the CUDA segment kernels' "
        "tiles are fixed by their instances",
    "HOROVOD_SPLASH":
        "selects jax's splash-attention kernel; local attention on CUDA "
        "is the hand-written flash kernels (K6)",
    "HOROVOD_SPLASH_BLOCK_KV":
        "the splash kernel's kv block; the CUDA flash kernels' tiles are "
        "fixed by their instances",
    "HOROVOD_SPLASH_VMEM_LIMIT":
        "the TPU VMEM budget the splash kernel compiles against; CUDA has "
        "no VMEM",
}
