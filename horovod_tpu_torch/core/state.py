"""Process-wide runtime state (the port's ``GlobalState``): the backend, the
engine and the observability around it (the reference's
``core/state.py:44-219``): the slice aggregator tier and the telemetry
route, the timeline, the trace recorder and its KV publisher, the flight
dumper, the stall inspector and collective watchdog with their KV legs,
the metrics emitter with its device-memory sampler and KV sink, the
step-health monitor, and the checkpoint manager with the rendezvous KV
it writes through. An elastic worker scaled out before it joined a world
keeps an inert, removed backend and no engine. Autotune comes with
ROADMAP A15.

Every KV round trip of these consumers runs on its own thread (the
emitter, the trace publisher, the stall inspector's watch thread, the
aggregator's rollup thread), never on the step's, and none of them
touches CUDA state: a snapshot reads host counters, a trace segment is
host data."""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..common import env as env_mod
from .backend import Backend
from .engine import Engine


class GlobalState:
    def __init__(self):
        self._lock = threading.Lock()
        self.backend = Backend()
        self.config: Optional[env_mod.Config] = None
        self.engine: Optional[Engine] = None
        self.timeline = None
        self.stall_inspector = None
        self.metrics_emitter = None
        self.trace_recorder = None
        self.trace_publisher = None
        self.slice_aggregator = None
        self.telemetry_route = None
        self.step_health = None
        self.flight_dumper = None
        self.hbm_sampler = None
        self.checkpoint_manager = None
        # the rendezvous KV, resolved at init: (addr, port), an endpoint
        # set, or None
        self.kv = None

    @property
    def initialized(self) -> bool:
        # a removed backend (an elastic worker scaled out before it joined
        # a world) is initialized with no engine
        return self.engine is not None or (self.backend.initialized
                                           and self.backend.removed)

    def init(self, device=None):
        with self._lock:
            if self.initialized:
                return
            self.config = env_mod.Config.from_env()
            _apply_log_level()
            self.backend.init(device)
            if self.backend.removed:
                # scaled out before joining a world: nothing to run
                return
            self.engine = Engine(self.backend, self.config)
            self._wire_observability()

    def _resolve_kv(self):
        """The rendezvous KV of this world (the reference's
        ``core/state.py:44-63``): ``HOROVOD_KV_ENDPOINTS``, a replica set,
        else ``HOROVOD_GLOO_RENDEZVOUS_ADDR``/``_PORT``, else None.
        Resolved once here, off the step path."""
        spec = os.environ.get(env_mod.HOROVOD_KV_ENDPOINTS)
        addr = os.environ.get(env_mod.HOROVOD_GLOO_RENDEZVOUS_ADDR)
        port = os.environ.get(env_mod.HOROVOD_GLOO_RENDEZVOUS_PORT)
        if spec:
            from ..runner.http_client import resolve_endpoints
            return (resolve_endpoints(spec), None)
        if addr and port:
            return (addr, int(port))
        return None

    def _wire_aggregator(self, kv, cfg, rank):
        """The hierarchical telemetry fabric (runner/aggregator.py; the
        reference's ``core/state.py:64-105``): when the topology factorizes
        into slices, each slice's lowest rank hosts a SliceAggregator and
        every rank routes its metrics/trace/stall publishes through a
        TelemetryRoute that targets it, so the root sees O(slices) rollup
        writes per interval instead of O(ranks) raw publishes. Flat
        topologies and KV-less runs skip the tier: the route is None and
        every publisher keeps its direct-to-root path. Resolved once here;
        the elastic driver clears the ``agg`` scope on world resets, so a
        re-init re-hosts and re-resolves against the new world."""
        topo = self.engine.topology
        if kv is None or not cfg.agg_enable or \
                not getattr(topo, "hierarchical_ok", False):
            return None
        from ..runner.aggregator import SliceAggregator, TelemetryRoute
        slice_idx = rank // topo.local_size
        if rank % topo.local_size != 0:
            return TelemetryRoute.resolve(kv, slice_idx,
                                          fallback=cfg.agg_fallback,
                                          timeout=10.0)
        ranks = list(range(slice_idx * topo.local_size,
                           (slice_idx + 1) * topo.local_size))
        agg = SliceAggregator(kv, slice_index=slice_idx, ranks=ranks,
                              interval=cfg.agg_interval,
                              cardinality=cfg.agg_cardinality, rank=rank)
        try:
            addr = agg.start()
        # a failed start degrades this slice to direct-to-root telemetry
        # (the warning below): init never dies for the telemetry tier
        except Exception as e:
            import logging
            logging.getLogger("horovod_tpu_torch").warning(
                "slice %d aggregator failed to start (%s); telemetry "
                "publishes go direct to the root", slice_idx, e)
            return None
        self.slice_aggregator = agg
        # the host shortcuts its own route: no KV long-poll for a
        # registration it just wrote
        return TelemetryRoute(kv, slice_index=slice_idx, agg_addr=addr,
                              fallback=cfg.agg_fallback)

    def _wire_observability(self):
        cfg = self.config
        rank = self.backend.rank()
        self.kv = kv = self._resolve_kv()
        route = self.telemetry_route = self._wire_aggregator(kv, cfg, rank)
        if cfg.timeline_path:
            from ..timeline import Timeline
            # every rank records its own timeline (pid = rank, so two
            # ranks' files overlay in one viewer); rank 0 keeps the exact
            # path, the others suffix it so a shared filesystem keeps both
            path = (cfg.timeline_path if rank == 0
                    else f"{cfg.timeline_path}.rank{rank}")
            self.timeline = Timeline(path,
                                     mark_cycles=cfg.timeline_mark_cycles,
                                     pid=rank)
            self.timeline.start()
        # the trace recorder stamps every collective with a correlation id
        # and keeps its per-phase events in a bounded ring; a publisher
        # ships segments to the rendezvous KV (trace/<rank>) for the merged
        # GET /trace. HOROVOD_TPU_TRACE=0 leaves engine.trace None
        if cfg.trace_enabled:
            from ..trace import TracePublisher, TraceRecorder
            self.trace_recorder = TraceRecorder(rank=rank,
                                                capacity=cfg.trace_ring)
            self.engine.trace = self.trace_recorder
            if kv is not None:
                self.trace_publisher = TracePublisher(
                    self.trace_recorder, kv, rank=rank,
                    interval=cfg.trace_interval, route=route)
                self.trace_publisher.start()
        # the flight recorder's dump has two callers: the watchdog's
        # one-shot escalation calls it raw (a hang post-mortem is never
        # rate-limited away), the step-health monitor through the
        # rate-limited FlightDumper
        from ..observability import FlightDumper
        self.flight_dumper = FlightDumper(
            self._dump_flight_ring,
            min_interval=cfg.step_health_dump_interval)
        if not cfg.stall_check_disable or cfg.collective_deadline > 0:
            from ..stall_inspector import StallInspector
            # HOROVOD_STALL_CHECK_DISABLE silences the warning and shutdown
            # tiers, but a configured deadline still needs the thread:
            # those thresholds are neutered (inf / 0) instead
            disabled = cfg.stall_check_disable
            self.stall_inspector = StallInspector(
                warning_seconds=(float("inf") if disabled
                                 else cfg.stall_warning_seconds),
                shutdown_seconds=(0.0 if disabled
                                  else cfg.stall_shutdown_seconds),
                kv=kv, rank=rank, size=self.backend.size(),
                collective_deadline=cfg.collective_deadline,
                # the escalation poisons the engine after the dump, so
                # every later submission and synchronize raises
                escalate=self.engine.poison,
                flight_dump=self._dump_flight_ring,
                route=route, topology=self.engine.topology,
                agg_interval=cfg.agg_interval)
        from ..metrics import MetricsEmitter, registry as metrics_registry
        reg = metrics_registry()
        # device memory, sampled on the emitter thread, never the step
        # path; a device without memory stats stops at the first sample
        if cfg.hbm_telemetry and reg.enabled:
            from ..observability import HBMSampler
            self.hbm_sampler = HBMSampler(device=self.backend.device)
        # one thread, three sinks: the JSONL file, the rendezvous-KV
        # publish (the scrape's GET /metrics) and the timeline's counters
        if reg.enabled and (cfg.metrics_file or kv is not None
                            or self.timeline is not None):
            self.metrics_emitter = MetricsEmitter(
                reg, interval=cfg.metrics_interval,
                jsonl_path=cfg.metrics_file, kv=kv, rank=rank,
                timeline=self.timeline, route=route,
                hbm_sampler=self.hbm_sampler)
            self.metrics_emitter.start()
        # per-step digests and the median/MAD anomaly detector, with
        # anomaly-triggered, rate-limited flight dumps; =0 leaves
        # engine.health None
        if cfg.step_health:
            from ..observability import StepHealthMonitor
            self.step_health = StepHealthMonitor(
                self.engine, rank=rank, window=cfg.step_health_window,
                warmup=cfg.step_health_warmup,
                mad_k=cfg.step_health_mad_k, dumper=self.flight_dumper,
                hbm=self.hbm_sampler)
            self.engine.health = self.step_health
        # durable checkpointing (checkpoint/): built at every init so rank,
        # size and world_version track the live world; the engine's step
        # hook drives interval snapshots of a registered provider
        if cfg.checkpoint_dir:
            from ..checkpoint import CheckpointManager
            self.checkpoint_manager = CheckpointManager(
                cfg.checkpoint_dir, rank=rank, world_size=self.backend.size(),
                world_version=self.engine.world_version, kv=self.kv,
                redundancy=cfg.checkpoint_redundancy,
                keep=cfg.checkpoint_keep,
                kv_chunk_bytes=cfg.checkpoint_kv_chunk_bytes,
                trace=self.trace_recorder)
            self.checkpoint_manager.interval_steps = \
                cfg.checkpoint_interval_steps
            self.engine.on_step_complete = self.checkpoint_manager.on_step
        self._wire_hooks()

    def _wire_hooks(self):
        engine = self.engine
        timeline = self.timeline
        stall = self.stall_inspector
        tracer = self.trace_recorder

        def on_enqueue(name, kind, nbytes):
            if timeline is not None:
                # tag the span with the correlation id the engine just
                # stamped, so the timeline joins against a merged trace
                corr = tracer.live_corr(name) if tracer is not None else None
                timeline.record_enqueue(name, kind, nbytes, corr=corr)
            if stall is not None:
                stall.record_enqueue(name)

        def on_done(name):
            if timeline is not None:
                timeline.record_done(name)
            if stall is not None:
                stall.record_done(name)

        if timeline is not None or stall is not None:
            engine.on_enqueue = on_enqueue
            engine.on_done = on_done
        if timeline is not None:
            engine.on_activity = timeline.record_activity
            engine.on_replay = timeline.record_replay
        if stall is not None:
            engine.replay_fallback_counter = stall.record_replay_fallback
            # a rank parked in join() intentionally stops heartbeating
            engine.on_join_state = stall.set_heartbeat_idle

    def _dump_flight_ring(self) -> Optional[str]:
        """Dump the trace ring to this rank's flight-recorder file
        (``$HOROVOD_TPU_TRACE_DUMP_DIR/hvd_tpu_flight_rank<r>.json``, the
        working directory by default) and return its path; None when
        tracing is off."""
        recorder = self.trace_recorder
        if recorder is None:
            return None
        cfg = self.config
        dump_dir = cfg.trace_dump_dir if cfg is not None else None
        path = os.path.join(dump_dir or os.getcwd(),
                            f"hvd_tpu_flight_rank{recorder.rank}.json")
        return recorder.dump(path)

    def shutdown(self):
        with self._lock:
            if self.engine is not None:
                # armed replay graphs hold NCCL work of the process group:
                # they go first (handles may keep the engine alive)
                self.engine.replay.invalidate_all("shutdown")
            if self.checkpoint_manager is not None:
                # flush the pending and in-flight snapshot, bounded: a
                # clean shutdown keeps the last generation, but a write
                # stuck waiting on a dead peer's replica must not hold
                # the shutdown for the whole replica timeout
                self.checkpoint_manager.close(flush=True, timeout=10.0)
                self.checkpoint_manager = None
            # then the publishers, flushed, before the backend goes: the
            # emitter's final tick leaves a JSONL record and a last KV
            # publish of short jobs, the trace publisher's a last segment.
            # Each flush is bounded (a dead KV primary costs its breaker
            # and the request timeout, then the set fails over)
            if self.metrics_emitter is not None:
                self.metrics_emitter.stop(final_flush=True)
                self.metrics_emitter = None
            if self.trace_publisher is not None:
                self.trace_publisher.stop(final_flush=True)
                self.trace_publisher = None
            if self.stall_inspector is not None:
                self.stall_inspector.stop()
                self.stall_inspector = None
            if self.timeline is not None:
                self.timeline.stop()
                self.timeline = None
            self.trace_recorder = None
            if self.slice_aggregator is not None:
                # after every publisher stopped (their final flushes may
                # still route through it), before the backend goes: the
                # final rollup ships what landed since the last interval,
                # and the stopped receiver frees its port for the next
                # world's aggregator in this process
                self.slice_aggregator.stop(final_rollup=True)
                self.slice_aggregator = None
            self.telemetry_route = None
            self.step_health = None
            self.flight_dumper = None
            self.hbm_sampler = None
            self.kv = None
            self.engine = None
            self.backend.shutdown()


def _apply_log_level():
    """HOROVOD_LOG_LEVEL (the reference's ``core/state.py:527-550``):
    trace/debug/info/warning/error/fatal onto the port's logger."""
    import logging
    level = os.environ.get(env_mod.HOROVOD_LOG_LEVEL)
    if not level:
        return
    mapping = {"trace": logging.DEBUG, "debug": logging.DEBUG,
               "info": logging.INFO, "warning": logging.WARNING,
               "error": logging.ERROR, "fatal": logging.CRITICAL}
    lvl = mapping.get(level.strip().lower())
    if lvl is not None:
        logger = logging.getLogger("horovod_tpu_torch")
        logger.setLevel(lvl)
        # without a handler, DEBUG/INFO would be filtered by Python's
        # lastResort handler (WARNING) and the knob would be a silent no-op
        if not logger.handlers and not logging.getLogger().handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "[%(asctime)s] %(levelname)s %(name)s: %(message)s"))
            logger.addHandler(h)


_state = GlobalState()


def global_state() -> GlobalState:
    return _state


def engine() -> Engine:
    """The initialized engine; raises if ``hvd.init()`` has not run."""
    if _state.engine is None:
        raise ValueError("horovod_tpu_torch has not been initialized; run "
                         "hvd.init() first.")
    return _state.engine
