"""Process-wide metrics registry (the port's copy of
``horovod_tpu/metrics.py``).

- **Instruments** — :class:`Counter` (monotonic, labeled), :class:`Gauge`,
  :class:`Histogram` (fixed log2 buckets, no deps) and :class:`EventLog`
  (bounded monotonic event log). The engine, replay, the optimizer,
  Adasum, the stall inspector and the step-health monitor write here.
- **Registry** — thread-safe name -> instrument table. Every metric name
  is declared in :data:`METRIC_SPECS` (``^hvd_tpu_[a-z0-9_]+$`` and a help
  string); an undeclared instrument needs an explicit help string.
- **Exposure** — :func:`snapshot` / ``hvd.metrics_snapshot()`` returns a
  plain nested dict; :func:`render_prometheus` renders one as Prometheus
  text; the :class:`MetricsEmitter` thread appends snapshots to
  ``HOROVOD_TPU_METRICS_FILE`` (JSONL) and samples wire-byte and dispatch
  rates into Chrome-trace counter tracks of the timeline. The KV server
  (``runner/http_server.py``) renders ``GET /metrics`` from the snapshots
  published under ``metrics/<rank>``; the emitter's KV publish comes with
  the launcher (ROADMAP A14).

``HOROVOD_TPU_METRICS=0`` disables the whole subsystem: every factory
returns a shared no-op instrument whose methods take no lock.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

NAME_RE = re.compile(r"^hvd_tpu_[a-z0-9_]+$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# label names already matched against _LABEL_RE (a handful: kind, dtype,
# link, ...), so the hot path skips the regex
_VALID_LABELS: set = set()

# Every metric the port registers: the Prometheus family name -> (type,
# help), the reference's names and help strings. Runtime-created
# instruments not listed here must pass an explicit help string and still
# satisfy NAME_RE.
METRIC_SPECS: Dict[str, Tuple[str, str]] = {
    # core/engine.py
    "hvd_tpu_dispatches_total": (
        "counter", "Engine-issued launches: in the port one a fusion "
                   "bucket's collective (its K1 pack included), one an "
                   "unfused collective call, one a replayed step's "
                   "graph launch (an XLA launch of the reference has no "
                   "one-to-one counterpart)"),
    "hvd_tpu_wire_bytes_total": (
        "counter", "Collective payload bytes submitted by this rank, by op "
                   "kind, dtype, and fabric link (hierarchical buckets "
                   "split into their ici and dcn legs; everything else "
                   "rides link=\"flat\")"),
    "hvd_tpu_collective_algo_total": (
        "counter", "Topology-aware algorithm selections, one per fusion "
                   "bucket, by op kind and algorithm "
                   "(flat/tree/hierarchical)"),
    "hvd_tpu_compression_codec_total": (
        "counter", "Wire-codec selections, one per fusion bucket, by op "
                   "kind and resolved codec (none/bf16/fp8/int8 — "
                   "non-float buckets resolve to none)"),
    "hvd_tpu_compression_bytes_saved_total": (
        "counter", "Wire bytes removed by the gradient codecs, by fabric "
                   "link (the encoded legs' uncompressed-minus-encoded "
                   "delta; hvd_tpu_wire_bytes_total already counts the "
                   "encoded sizes)"),
    "hvd_tpu_compression_residual_invalidations_total": (
        "counter", "Error-feedback residual buffers dropped before reuse "
                   "(join(), elastic world-version bumps, explicit "
                   "resets — the prefetch-leg invalidation contract)"),
    "hvd_tpu_collectives_total": (
        "counter", "Collective operations submitted, by op kind"),
    "hvd_tpu_fusion_buckets_total": (
        "counter", "Fusion buckets formed by grouped/sharded ops"),
    "hvd_tpu_fusion_bucket_bytes_total": (
        "counter", "Payload bytes packed into fusion buckets"),
    "hvd_tpu_fusion_bucket_fill_pct": (
        "gauge", "Last grouped/sharded call's bucket fill efficiency: "
                 "packed bytes / (buckets x fusion threshold) x 100"),
    "hvd_tpu_op_latency_seconds": (
        "histogram", "Collective enqueue-to-complete latency, by op kind"),
    # core/replay.py
    "hvd_tpu_steps_total": (
        "counter", "Eager training steps bracketed by step_begin/step_end"),
    "hvd_tpu_replay_armed_total": (
        "counter", "Step-capture replay streams armed"),
    "hvd_tpu_replay_replayed_steps_total": (
        "counter", "Steps serviced by a single fused replay launch"),
    "hvd_tpu_replay_fallbacks_total": (
        "counter", "Replay fallbacks to the normal dispatch path, by "
                   "digit-normalized reason"),
    "hvd_tpu_replay_invalidations_total": (
        "counter", "Armed replay streams dropped (join(), elastic "
                   "world-version bumps, explicit resets)"),
    # read by the step-health digest; the prefetch leg that counts it
    # comes with replay's overlap modes (ROADMAP A10)
    "hvd_tpu_overlap_prefetch_total": (
        "counter", "ZeRO-1 parameter all-gather prefetch legs launched "
                   "under the step tail"),
    # optimizer.py (ZeRO-1 sharded path)
    "hvd_tpu_sharded_step_seconds": (
        "histogram", "Wall time of one sharded optimizer step's dispatch "
                     "phase (pack + rs->update->ag launch)"),
    # models/transformer.py (the MoE-EP train step)
    "hvd_tpu_moe_expert_tokens_total": (
        "counter", "Tokens routed to each expert by the MoE-EP engine "
                   "train step's capacity router, by expert index "
                   "(pre-capacity counts — dropped-overflow tokens still "
                   "count toward the expert they chose)"),
    "hvd_tpu_moe_dispatch_skew": (
        "gauge", "Last MoE-EP routing decision's expert load imbalance: "
                 "max per-expert token count / mean (1.0 = perfectly "
                 "balanced), by layer — the per-expert face of the "
                 "arrival-skew machinery"),
    # trace.py (cross-rank collective tracing)
    "hvd_tpu_collective_skew_seconds": (
        "histogram", "Cross-rank arrival skew per correlated collective "
                     "(last-arrival minus first-arrival rank), by op kind "
                     "— observed by the trace merger when GET /trace is "
                     "served"),
    "hvd_tpu_straggler_rank": (
        "gauge", "Rank most often last to arrive over the correlated "
                 "collectives in the merged trace window"),
    # observability/ (step health)
    "hvd_tpu_step_seconds": (
        "histogram", "Per-step wall time observed by the step-health "
                     "monitor (step_end-to-step_end cadence) — the "
                     "cluster p50/p99 SLO signal health_report reads"),
    "hvd_tpu_step_anomalies_total": (
        "counter", "Step-health anomalies classified by the rolling "
                   "median+MAD detector, by class (step_time_spike, "
                   "sustained_regression, straggler_drift, "
                   "straggler_wait, dispatch_change, wire_shift)"),
    "hvd_tpu_step_health_events": (
        "events", "Step-health anomaly event log: one entry per "
                  "classified anomaly with its human-readable evidence "
                  "line"),
    "hvd_tpu_hbm_bytes": (
        "gauge", "Device memory sampled off the hot path on the emitter "
                 "thread, by kind (in_use/peak/limit) — the headroom "
                 "signal for admission control and memory-vs-MFU "
                 "tradeoffs"),
    "hvd_tpu_flight_dumps_total": (
        "counter", "Flight-recorder dumps written through the "
                   "rate-limited dumper, by trigger (anomaly class, "
                   "elastic_restore, manual)"),
    # stall_inspector.py
    "hvd_tpu_stall_stalled_tensors": (
        "gauge", "Tensors currently outstanding past the stall warning "
                 "threshold"),
    "hvd_tpu_watchdog_escalations_total": (
        "counter", "Collective-watchdog deadline escalations (hang "
                   "converted to HorovodInternalError for elastic "
                   "recovery)"),
    # common/retry.py
    "hvd_tpu_kv_retries_total": (
        "counter", "Retried control-plane KV operations, by op"),
    "hvd_tpu_kv_gave_up_total": (
        "counter", "Control-plane KV operations that exhausted their "
                   "retry budget, by op"),
    # checkpoint/manager.py
    "hvd_tpu_ckpt_snapshots_total": (
        "counter", "Checkpoint snapshot requests, by outcome (written, "
                   "skipped when a newer request replaced a pending one, "
                   "failed)"),
    "hvd_tpu_ckpt_bytes_total": (
        "counter", "Checkpoint bytes moved, by kind (shard = own shard "
                   "written, replica = peer shard held, manifest, "
                   "restore = shard bytes read back)"),
    "hvd_tpu_ckpt_restore_seconds": (
        "histogram", "Wall time of one durable-generation restore "
                     "(discovery, shard sourcing, checksum, decode)"),
    "hvd_tpu_ckpt_gc_total": (
        "counter", "Checkpoint generations garbage-collected, by kind "
                   "(generation, partial = crashed write, kv = chunked "
                   "shard values dropped from the rendezvous KV)"),
    "hvd_tpu_ckpt_snapshot_stall_seconds": (
        "histogram", "Step-path time spent inside snapshot() stamping "
                     "the async request (the stall budget — near zero "
                     "by construction; bench reports the per-step mean)"),
    "hvd_tpu_ckpt_last_step": (
        "gauge", "Step of the last locally-written checkpoint "
                 "generation"),
    # runner/http_client.py + runner/http_server.py
    "hvd_tpu_kv_failover_total": (
        "counter", "KV requests that succeeded only after failing over "
                   "past a dead/not-primary endpoint of the replica set, "
                   "by op"),
    "hvd_tpu_kv_breaker_open_total": (
        "counter", "KV endpoint circuit-breaker trips (consecutive "
                   "transport failures -> open, jittered half-open "
                   "probe), by endpoint"),
    "hvd_tpu_kv_shed_bytes_total": (
        "counter", "Telemetry publish bytes shed on server backpressure "
                   "(429 per-scope byte budget) instead of blocking the "
                   "step path, by scope — degradation made visible, "
                   "never silent"),
    "hvd_tpu_kv_backpressure_total": (
        "counter", "KV writes refused with 429 + Retry-After (per-scope "
                   "byte budget), by scope — counted on the server"),
    "hvd_tpu_kv_requests_total": (
        "counter", "KV/rendezvous HTTP requests served by this server, by "
                   "verb (get/put/delete) and scope — the O(ranks) vs "
                   "O(slices) control-plane load claim, measured server-"
                   "side"),
    "hvd_tpu_kv_request_bytes_total": (
        "counter", "Request payload bytes received by this KV server "
                   "(PUT bodies), by verb and scope"),
    # faults.py
    "hvd_tpu_fault_injections_total": (
        "counter", "Fired fault-injection actions, by failpoint name and "
                   "action"),
}


def metrics_enabled() -> bool:
    """The HOROVOD_TPU_METRICS master switch (default on). Read here, not
    from Config: the registry is process-wide and outlives any engine."""
    from .common.env import HOROVOD_TPU_METRICS, _get_bool
    return _get_bool(HOROVOD_TPU_METRICS, True)


def _labels_key(labels: dict) -> tuple:
    if len(labels) < 2:
        return tuple(labels.items())
    return tuple(sorted(labels.items()))


def _validate(name: str, help: Optional[str]) -> str:
    if not NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} must match {NAME_RE.pattern}")
    help = help if help is not None else METRIC_SPECS.get(name, (None, None))[1]
    if not help:
        raise ValueError(
            f"metric {name!r} needs a help string: declare it in "
            f"horovod_tpu_torch.metrics.METRIC_SPECS or pass help=")
    return help


class _Instrument:
    """Shared label-table plumbing. Values are kept per label-set keyed by
    the sorted (label, value) tuple; one lock per instrument."""

    kind = "untyped"

    # every instrument is written from arbitrary hot-path threads and
    # snapshotted by the emitter thread
    _GUARDED_BY = {"_values": "_lock"}

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[tuple, object] = {}

    # the writers below check a label set's names when it first appears:
    # a set already in _values passed
    def _check_labels(self, labels: dict):
        for k in labels:
            if k not in _VALID_LABELS:
                if not _LABEL_RE.match(k):
                    raise ValueError(
                        f"invalid label name {k!r} on {self.name}")
                _VALID_LABELS.add(k)


class Counter(_Instrument):
    """Monotonic counter. ``inc`` rejects negative increments (monotonicity
    is the contract Prometheus rate() relies on)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {value})")
        key = _labels_key(labels)
        with self._lock:
            old = self._values.get(key)
            if old is None:
                self._check_labels(labels)
                old = 0.0
            self._values[key] = old + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(_labels_key(labels), 0.0))

    def total(self) -> float:
        """Sum across every label set."""
        with self._lock:
            return float(sum(self._values.values()))

    def _snap(self) -> list:
        with self._lock:
            return [[dict(k), v] for k, v in self._values.items()]


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels):
        key = _labels_key(labels)
        with self._lock:
            if key not in self._values:
                self._check_labels(labels)
            self._values[key] = float(value)

    def inc(self, value: float = 1.0, **labels):
        key = _labels_key(labels)
        with self._lock:
            old = self._values.get(key)
            if old is None:
                self._check_labels(labels)
                old = 0.0
            self._values[key] = old + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(_labels_key(labels), 0.0))

    def _snap(self) -> list:
        with self._lock:
            return [[dict(k), v] for k, v in self._values.items()]


class Histogram(_Instrument):
    """Histogram with fixed log2 bucket boundaries 2^min_exp .. 2^max_exp
    (plus +Inf), no external deps. The defaults cover 1 microsecond to ~2
    minutes — the engine's latency range."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 min_exp: int = -20, max_exp: int = 7):
        super().__init__(name, help)
        if max_exp <= min_exp:
            raise ValueError("max_exp must exceed min_exp")
        self.bounds = [2.0 ** e for e in range(min_exp, max_exp + 1)]

    def observe(self, value: float, **labels):
        self.observe_many((value,), **labels)

    def observe_many(self, values, **labels):
        """:meth:`observe` of each of ``values`` under one label set and one
        lock."""
        key = _labels_key(labels)
        idx = [bisect.bisect_left(self.bounds, v) for v in values]
        with self._lock:
            ent = self._values.get(key)
            if ent is None:
                self._check_labels(labels)
                ent = {"counts": [0] * (len(self.bounds) + 1),
                       "sum": 0.0, "count": 0}
                self._values[key] = ent
            counts = ent["counts"]
            for i, v in zip(idx, values):
                counts[i] += 1
                ent["sum"] += float(v)
            ent["count"] += len(idx)

    def _snap(self) -> list:
        out = []
        with self._lock:
            for k, ent in self._values.items():
                cum, buckets = 0, []
                for bound, c in zip(self.bounds, ent["counts"]):
                    cum += c
                    buckets.append([bound, cum])
                buckets.append(["+Inf", ent["count"]])
                out.append([dict(k), {"sum": ent["sum"],
                                      "count": ent["count"],
                                      "buckets": buckets}])
        return out


class EventLog(_Instrument):
    """Bounded append-only event log with a monotonic sequence number; also
    counts events per kind (the Prometheus-visible face: the full log rides
    the snapshot/JSONL path)."""

    kind = "events"

    _GUARDED_BY = {"_log": "_lock", "_seq": "_lock"}

    def __init__(self, name: str, help: str, maxlen: int = 256):
        super().__init__(name, help)
        self._log = collections.deque(maxlen=maxlen)
        self._seq = 0

    def append(self, kind: str, detail: str = "") -> int:
        with self._lock:
            self._seq += 1
            self._log.append([self._seq, time.time(), kind, detail])
            key = _labels_key({"kind": kind})
            self._values[key] = self._values.get(key, 0.0) + 1.0
            return self._seq

    def _snap(self) -> dict:
        with self._lock:
            return {"counts": [[dict(k), v] for k, v in self._values.items()],
                    "log": [list(e) for e in self._log]}


class _Noop:
    """Disabled-mode stand-in: every instrument method is a lock-free no-op
    (the HOROVOD_TPU_METRICS=0 contract — nothing on the dispatch path)."""

    def inc(self, *a, **kw):
        pass

    def set(self, *a, **kw):
        pass

    def observe(self, *a, **kw):
        pass

    def observe_many(self, *a, **kw):
        pass

    def append(self, *a, **kw):
        return 0

    def value(self, *a, **kw):
        return 0.0

    def total(self):
        return 0.0


_NOOP = _Noop()


class Registry:
    """Thread-safe name -> instrument table. Use the process-wide
    :func:`registry` singleton; direct construction is for tests."""

    _GUARDED_BY = {"_metrics": "_lock"}

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}

    def _get(self, name, help, cls, **kwargs):
        if not self.enabled:
            return _NOOP
        help = _validate(name, help)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: Optional[str] = None) -> Counter:
        return self._get(name, help, Counter)

    def gauge(self, name: str, help: Optional[str] = None) -> Gauge:
        return self._get(name, help, Gauge)

    def histogram(self, name: str, help: Optional[str] = None,
                  min_exp: int = -20, max_exp: int = 7) -> Histogram:
        return self._get(name, help, Histogram,
                         min_exp=min_exp, max_exp=max_exp)

    def event_log(self, name: str, help: Optional[str] = None,
                  maxlen: int = 256) -> EventLog:
        return self._get(name, help, EventLog, maxlen=maxlen)

    def snapshot(self) -> dict:
        """Deep-copied plain nested dict of every instrument's state —
        mutating the result never touches the live registry."""
        if not self.enabled:
            return {"enabled": False, "counters": {}, "gauges": {},
                    "histograms": {}, "events": {}}
        out = {"enabled": True, "counters": {}, "gauges": {},
               "histograms": {}, "events": {}}
        with self._lock:
            metrics = list(self._metrics.values())
        section = {"counter": "counters", "gauge": "gauges",
                   "histogram": "histograms", "events": "events"}
        for m in metrics:
            out[section[m.kind]][m.name] = {"help": m.help,
                                            "values": m._snap()}
        return out


_registry_lock = threading.Lock()
_registry: Optional[Registry] = None


def registry() -> Registry:
    """The process-wide registry. Enablement (HOROVOD_TPU_METRICS) is read
    once, at first use."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = Registry(enabled=metrics_enabled())
        return _registry


def _reset_registry_for_tests():
    """Drop the singleton so the next registry() re-reads the environment.
    Tests only — live instruments fetched from the old registry keep
    writing into it, invisible to the new one."""
    global _registry
    with _registry_lock:
        _registry = None


def snapshot() -> dict:
    """Module-level convenience: ``registry().snapshot()`` (the
    ``hvd.metrics_snapshot()`` implementation)."""
    return registry().snapshot()


# ---------------------------------------------------------------------------
# Prometheus text rendering (exposition format 0.0.4, hand-rolled — no deps)
# ---------------------------------------------------------------------------

def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _labels_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_num(v) -> str:
    if v == "+Inf":
        return "+Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.10g}"


def _render_family(lines: List[str], name: str, kind: str, help: str,
                   series: List[tuple]):
    """series: list of (suffix, labels, value)."""
    lines.append(f"# HELP {name} {_esc(help)}")
    lines.append(f"# TYPE {name} {kind}")
    for suffix, labels, value in series:
        lines.append(f"{name}{suffix}{_labels_str(labels)} {_fmt_num(value)}")


def _snapshot_series(snap: dict, extra_labels: Optional[dict] = None):
    """Flatten one snapshot dict into {name: (kind, help, [series...])}
    with ``extra_labels`` merged into every label set."""
    extra = extra_labels or {}
    fams: Dict[str, list] = {}

    def fam(name, kind, help):
        return fams.setdefault(name, [kind, help, []])[2]

    for name, ent in snap.get("counters", {}).items():
        s = fam(name, "counter", ent["help"])
        for labels, v in ent["values"]:
            s.append(("", {**labels, **extra}, v))
    for name, ent in snap.get("gauges", {}).items():
        s = fam(name, "gauge", ent["help"])
        for labels, v in ent["values"]:
            s.append(("", {**labels, **extra}, v))
    for name, ent in snap.get("histograms", {}).items():
        s = fam(name, "histogram", ent["help"])
        for labels, h in ent["values"]:
            merged = {**labels, **extra}
            for le, cum in h["buckets"]:
                le_s = "+Inf" if le == "+Inf" else _fmt_num(le)
                s.append(("_bucket", {**merged, "le": le_s}, cum))
            s.append(("_sum", merged, h["sum"]))
            s.append(("_count", merged, h["count"]))
    for name, ent in snap.get("events", {}).items():
        s = fam(f"{name}_total", "counter", ent["help"])
        vals = ent["values"] if isinstance(ent.get("values"), dict) \
            else {"counts": []}
        for labels, v in vals.get("counts", []):
            s.append(("", {**labels, **extra}, v))
    return fams


def render_prometheus(snap: dict, extra_labels: Optional[dict] = None) -> str:
    """Render one snapshot dict as Prometheus text."""
    lines: List[str] = []
    for name, (kind, help, series) in sorted(
            _snapshot_series(snap, extra_labels).items()):
        _render_family(lines, name, kind, help, series)
    return "\n".join(lines) + "\n"


def render_prometheus_cluster(snaps: Dict[str, dict]) -> str:
    """Merge per-rank snapshot dicts ({rank_key: snapshot}) into one
    exposition with a ``rank`` label on every series and exactly one
    HELP/TYPE block per family (the body of the reference's
    cluster-aggregated ``GET /metrics``)."""
    merged: Dict[str, list] = {}
    for rank_key in sorted(snaps, key=lambda r: (len(str(r)), str(r))):
        fams = _snapshot_series(snaps[rank_key],
                                extra_labels={"rank": str(rank_key)})
        for name, (kind, help, series) in fams.items():
            ent = merged.setdefault(name, [kind, help, []])
            ent[2].extend(series)
    lines: List[str] = [
        "# horovod_tpu cluster metrics: one series per rank "
        f"({len(snaps)} rank(s) published)"]
    for name, (kind, help, series) in sorted(merged.items()):
        _render_family(lines, name, kind, help, series)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Publication: JSONL + Chrome-trace counter tracks
# ---------------------------------------------------------------------------

def counter_total(snap: dict, name: str) -> float:
    """Sum a snapshot counter across every label set (the helper bench.py
    and the emitter's rate sampling share)."""
    ent = snap.get("counters", {}).get(name)
    if not ent:
        return 0.0
    return float(sum(v for _, v in ent["values"]))


class MetricsEmitter(threading.Thread):
    """One background thread, up to two sinks per tick (the reference's
    third, the rendezvous-KV publish, comes with the launcher):

    - JSONL: append ``{"ts", "rank", "metrics": <snapshot>}`` to
      ``HOROVOD_TPU_METRICS_FILE``;
    - timeline: Chrome-trace ``ph:"C"`` counter samples of the wire-byte
      and dispatch rates (``Timeline.record_counter``), so throughput rides
      the same trace as the spans.

    Sink failures are swallowed at debug level — telemetry must never take
    the job down."""

    def __init__(self, reg: Registry, interval: float = 10.0,
                 jsonl_path: Optional[str] = None, rank: int = 0,
                 timeline=None, hbm_sampler=None):
        super().__init__(name="hvd-metrics", daemon=True)
        self.reg = reg
        self.interval = max(float(interval), 0.05)
        self.jsonl_path = jsonl_path
        self.rank = rank
        self.timeline = timeline
        # the device-memory gauges are sampled HERE, on the emitter
        # thread, before the snapshot: torch.cuda.memory_stats() never
        # runs on the step path
        self.hbm_sampler = hbm_sampler
        # NOT named _stop: Thread.join() calls an internal _stop()
        self._stop_evt = threading.Event()
        self._prev: Optional[Tuple[float, float, float]] = None

    def run(self):
        while not self._stop_evt.wait(self.interval):
            self.tick()

    def stop(self, final_flush: bool = True):
        self._stop_evt.set()
        if self.is_alive():
            # drain a possibly in-flight tick before flushing from this
            # thread — two concurrent tick()s would interleave JSONL
            # records and race on _prev (wrong rate samples)
            self.join(timeout=10)
        if final_flush:
            self.tick()

    def tick(self):
        import logging
        log = logging.getLogger("horovod_tpu_torch.metrics")
        if self.hbm_sampler is not None:
            try:
                self.hbm_sampler.sample()
            except Exception as e:
                log.debug("HBM sample failed: %s", e)
        snap = self.reg.snapshot()
        now = time.time()
        if self.jsonl_path:
            try:
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps({"ts": now, "rank": self.rank,
                                        "metrics": snap}) + "\n")
            except Exception as e:
                log.debug("metrics JSONL write failed: %s", e)
        if self.timeline is not None:
            try:
                wire = counter_total(snap, "hvd_tpu_wire_bytes_total")
                disp = counter_total(snap, "hvd_tpu_dispatches_total")
                if self._prev is not None:
                    t0, w0, d0 = self._prev
                    dt = max(now - t0, 1e-9)
                    self.timeline.record_counter(
                        "hvd_tpu_wire_bytes_per_sec",
                        {"bytes_per_sec": (wire - w0) / dt})
                    self.timeline.record_counter(
                        "hvd_tpu_dispatches_per_sec",
                        {"dispatches_per_sec": (disp - d0) / dt})
                self._prev = (now, wire, disp)
            except Exception as e:
                log.debug("metrics timeline counters failed: %s", e)
