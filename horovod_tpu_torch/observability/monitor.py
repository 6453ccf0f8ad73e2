"""Step-health monitor: digest assembly, detection, automatic dumps (the
port's copy of ``horovod_tpu/observability/monitor.py``).

:class:`StepHealthMonitor` is the object ``engine.health`` points at
when ``HOROVOD_TPU_STEP_HEALTH=1`` (the default). The engine's
``step_end`` makes exactly one is-None check and one call; everything
else — registry deltas, baseline updates, anomaly classification,
EventLog/counter bumps, the rate-limited flight dump — happens here,
once per step, never per dispatch. When the knob is 0 the attribute
stays ``None`` and the step path pays a single predicted-not-taken
branch (the ``engine.trace`` discipline).

:class:`FlightDumper` wraps the ``flight_dump`` hook (the same method the
stall-inspector watchdog uses) with a minimum-interval rate
limit, so an anomaly storm or a tight elastic-restore loop cannot turn
the trace ring into a disk firehose. Dumps are counted by trigger on
``hvd_tpu_flight_dumps_total``.

:class:`HBMSampler` reads ``torch.cuda.memory_stats(device)`` of the
engine's device on the MetricsEmitter thread — never the step path —
publishing ``hvd_tpu_hbm_bytes{kind=in_use|peak|limit}`` and keeping the
last watermark for the digest. A device without memory stats (the CPU) is
detected at the first sample and sampling quietly stops.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import faults
from ..metrics import registry
from .detector import Anomaly, AnomalyDetector
from .digest import StepDigest

_LOG = logging.getLogger("horovod_tpu_torch")


class FlightDumper:
    """Rate-limited wrapper around the flight-recorder dump hook.

    Callable from any thread (step thread on anomalies, elastic
    run-loop on restore, tests directly); the interval gate is the only
    shared state."""

    _GUARDED_BY = {"_last_dump": "_lock"}

    def __init__(self, dump_fn: Callable[[], Optional[str]],
                 min_interval: float = 60.0):
        self._dump_fn = dump_fn
        self.min_interval = min_interval
        self._lock = threading.Lock()
        self._last_dump: Optional[float] = None
        self._m_dumps = registry().counter("hvd_tpu_flight_dumps_total")

    def __call__(self, trigger: str = "manual") -> Optional[str]:
        with self._lock:
            now = time.monotonic()
            if (self._last_dump is not None
                    and now - self._last_dump < self.min_interval):
                return None
            self._last_dump = now
        try:
            faults.failpoint("observability.dump")
            path = self._dump_fn()
        except Exception:
            _LOG.debug("flight dump (%s) failed", trigger, exc_info=True)
            return None
        if path:
            self._m_dumps.inc(trigger=trigger)
            _LOG.info("flight dump (%s) written to %s", trigger, path)
        return path


class HBMSampler:
    """Off-hot-path device-memory sampler (runs on the emitter thread)."""

    _GUARDED_BY = {"_last": "_lock"}

    def __init__(self, stats_fn: Optional[Callable[[], Optional[dict]]] = None,
                 device=None):
        self._stats_fn = stats_fn
        self._device = device
        self._supported: Optional[bool] = None
        self._lock = threading.Lock()
        self._last: Tuple[Optional[int], Optional[int]] = (None, None)
        self._g_hbm = registry().gauge("hvd_tpu_hbm_bytes")

    def _default_stats(self) -> Optional[dict]:
        """The reference's keys from ``torch.cuda.memory_stats`` of the
        sampler's device: bytes held by live tensors now and at their
        peak, and the device's total memory. None on any other device."""
        import torch
        dev = self._device
        if dev is None or torch.device(dev).type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
        return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak",
                                               0),
                "bytes_limit": torch.cuda.get_device_properties(
                    dev).total_memory}

    def sample(self) -> Optional[dict]:
        if self._supported is False:
            return None
        try:
            stats = (self._stats_fn or self._default_stats)()
        except Exception:
            stats = None
        if not isinstance(stats, dict):
            if self._supported is None:
                self._supported = False
                _LOG.debug("device memory stats unavailable; "
                           "HBM telemetry disabled")
            return None
        self._supported = True
        in_use = stats.get("bytes_in_use")
        peak = stats.get("peak_bytes_in_use")
        limit = stats.get("bytes_limit")
        if in_use is not None:
            self._g_hbm.set(float(in_use), kind="in_use")
        if peak is not None:
            self._g_hbm.set(float(peak), kind="peak")
        if limit is not None:
            self._g_hbm.set(float(limit), kind="limit")
        with self._lock:
            self._last = (in_use, peak)
        return stats

    def last(self) -> Tuple[Optional[int], Optional[int]]:
        """Last (bytes_in_use, peak_bytes_in_use) watermark."""
        with self._lock:
            return self._last


def _labeled_totals(inst, label: str) -> Dict[str, float]:
    """Per-label-value totals from an instrument snapshot. Counters sum
    their value, histograms their observation sum; disabled-mode no-op
    instruments have no snapshot and yield {}."""
    snap = getattr(inst, "_snap", None)
    if snap is None:
        return {}
    out: Dict[str, float] = {}
    for labels, val in snap():
        key = str(labels.get(label, ""))
        if isinstance(val, dict):
            val = val.get("sum", 0.0)
        out[key] = out.get(key, 0.0) + float(val)
    return out


def _delta_map(cur: Dict[str, float],
               prev: Dict[str, float]) -> Dict[str, float]:
    return {k: max(0.0, v - prev.get(k, 0.0)) for k, v in cur.items()
            if v - prev.get(k, 0.0) > 0.0}


class StepHealthMonitor:
    """Assembles a :class:`StepDigest` per step and runs the detector.

    All instrument handles resolve ONCE here: no knob or registry lookup
    ever reaches the step path. The monitor
    itself is single-threaded — only the engine's step thread touches
    it — so it carries no lock; the instruments it reads have their
    own (the same per-instrument locks the emitter snapshot takes).
    """

    def __init__(self, engine, rank: int = 0, window: int = 64,
                 warmup: int = 8, mad_k: float = 3.0, sustain: int = 5,
                 dumper: Optional[FlightDumper] = None,
                 hbm: Optional[HBMSampler] = None, history: int = 512):
        self.engine = engine
        self.rank = rank
        self.dumper = dumper
        self.hbm = hbm
        self.detector = AnomalyDetector(window=window, warmup=warmup,
                                        mad_k=mad_k, sustain=sustain)
        reg = registry()
        self._c_wire = reg.counter("hvd_tpu_wire_bytes_total")
        self._h_latency = reg.histogram("hvd_tpu_op_latency_seconds")
        self._c_replayed = reg.counter("hvd_tpu_replay_replayed_steps_total")
        self._c_fallbacks = reg.counter("hvd_tpu_replay_fallbacks_total")
        self._c_prefetch = reg.counter("hvd_tpu_overlap_prefetch_total")
        self._g_fill = reg.gauge("hvd_tpu_fusion_bucket_fill_pct")
        self._c_saved = reg.counter("hvd_tpu_compression_bytes_saved_total")
        self._h_step = reg.histogram("hvd_tpu_step_seconds")
        self._c_anom = reg.counter("hvd_tpu_step_anomalies_total")
        self._ev = reg.event_log("hvd_tpu_step_health_events")
        # baseline totals for delta computation
        self._prev_dispatches = int(getattr(engine, "dispatch_count", 0))
        self._prev_wire: Dict[str, float] = {}
        self._prev_wait: Dict[str, float] = {}
        self._prev_scalars = self._scalar_totals()
        self._last_end: Optional[float] = None
        self._digests: collections.deque = collections.deque(maxlen=history)
        self.anomaly_count = 0
        self.anomalies: collections.deque = collections.deque(maxlen=history)

    # -- step hook (called by engine.step_end; must never raise) -----------

    def on_step_end(self) -> None:
        try:
            self._on_step_end()
        # errflow: ignore[the digest reads host counters after the step completed: a failure in it (or in an anomaly's flight dump) must never fail the step it describes]
        except Exception:
            _LOG.debug("step-health digest failed", exc_info=True)

    def _on_step_end(self) -> None:
        now = time.monotonic()
        wall = (now - self._last_end) if self._last_end is not None else None
        self._last_end = now
        d = self._assemble(wall)
        self._digests.append(d)
        if wall is not None:
            self._h_step.observe(wall)
        for a in self.detector.observe(d, rank=self.rank):
            self._record_anomaly(a)

    # -- assembly ----------------------------------------------------------

    def _scalar_totals(self) -> Dict[str, float]:
        return {
            "replayed": self._c_replayed.total(),
            "fallbacks": self._c_fallbacks.total(),
            "prefetch": self._c_prefetch.total(),
            "saved": self._c_saved.total(),
        }

    def _assemble(self, wall: Optional[float]) -> StepDigest:
        eng = self.engine
        dispatches = int(getattr(eng, "dispatch_count", 0))
        d_dispatches = dispatches - self._prev_dispatches
        self._prev_dispatches = dispatches

        wire = _labeled_totals(self._c_wire, "link")
        wire_delta = _delta_map(wire, self._prev_wire)
        self._prev_wire = wire

        wait = _labeled_totals(self._h_latency, "kind")
        wait_delta = _delta_map(wait, self._prev_wait)
        self._prev_wait = wait

        scalars = self._scalar_totals()
        deltas = {k: max(0.0, scalars[k] - self._prev_scalars.get(k, 0.0))
                  for k in scalars}
        self._prev_scalars = scalars

        hbm_in_use = hbm_peak = None
        if self.hbm is not None:
            hbm_in_use, hbm_peak = self.hbm.last()

        return StepDigest(
            step=int(getattr(eng, "step_index", 0)),
            wall_s=wall,
            dispatches=d_dispatches,
            wire_bytes=sum(wire_delta.values()),
            wire_by_link=wire_delta,
            collective_wait_s=sum(wait_delta.values()),
            wait_by_kind=wait_delta,
            replay_replayed=int(deltas["replayed"]),
            replay_fallbacks=int(deltas["fallbacks"]),
            replay_armed=deltas["replayed"] > 0,
            prefetch_hits=int(deltas["prefetch"]),
            bucket_fill_pct=float(self._g_fill.value()),
            compression_saved=deltas["saved"],
            hbm_in_use=hbm_in_use,
            hbm_peak=hbm_peak,
        )

    def _record_anomaly(self, a: Anomaly) -> None:
        self.anomaly_count += 1
        self.anomalies.append(a)
        self._c_anom.inc(**{"class": a.cls})
        self._ev.append(a.cls, a.detail)
        _LOG.warning("step-health anomaly [%s]: %s", a.cls, a.detail)
        if self.dumper is not None:
            self.dumper(trigger=a.cls)

    # -- consumers (bench, tests, tools) -----------------------------------

    def recent(self) -> List[StepDigest]:
        return list(self._digests)

    def recent_anomalies(self) -> List[Anomaly]:
        return list(self.anomalies)
