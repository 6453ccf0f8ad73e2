"""Cross-rank collective tracing (the port's copy of
``horovod_tpu/trace.py``): correlated spans and a merged cluster timeline.

- **Correlation ids** — the engine stamps every collective at enqueue with
  a deterministic id ``name#world_version#seq`` (per-name submission
  sequence). Every rank submits the same named collectives in the same
  order, so the same logical collective carries the same id on every rank
  and the per-phase events (enqueue / dispatch / complete) join across
  ranks.
- **Ring** — a bounded in-memory ring (:class:`TraceRecorder`) of those
  events and the step markers; :meth:`TraceRecorder.segment` snapshots it
  as a size-capped segment.
- **Merger** — :func:`merge_segments` remaps ``pid`` to rank, aligns clocks
  through each segment's beacons (``(local monotonic, server wall, rtt)``
  triples), closes truncated spans and emits one valid Chrome/Perfetto
  trace; :func:`collective_skew`, :func:`modal_straggler` and
  :func:`observe_skew` read per-collective arrival skew from it.
- **Flight recorder** — :meth:`TraceRecorder.dump` writes the last-N spans
  to disk; the collective watchdog calls it before it poisons the engine,
  so a hang post-mortem has the spans that led into it.

Publishing segments and clock beacons to the rendezvous KV (the reference's
``TracePublisher`` and ``publish_segment``) comes with ROADMAP A14b;
the KV server (``runner/http_server.py``) already renders
``GET /trace`` from what is published under ``trace/<rank>``.

``HOROVOD_TPU_TRACE=0`` leaves the engine's ``trace`` hook ``None``: the
dispatch path pays one ``is None`` check per site.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
from typing import Dict, List, Optional, Tuple

import time

logger = logging.getLogger("horovod_tpu_torch.trace")

SCHEMA_VERSION = 1

# the three phases the engine records per collective: each correlation id
# appears once per phase per rank
PHASES = ("enq", "dis", "done")

CORR_SEP = "#"

DEFAULT_RING_CAPACITY = 4096
DEFAULT_SEGMENT_MAX_BYTES = 256 * 1024
MAX_BEACONS = 64
# bound on the per-name sequence map; far above the ring capacity, so by
# the time it fills, events carrying the evicted sequences are long gone
_MAX_SEQ_NAMES = 65536


def make_corr(name: str, world_version: int, seq: int) -> str:
    return f"{name}{CORR_SEP}{world_version}{CORR_SEP}{seq}"


def parse_corr(corr: str) -> Tuple[str, int, int]:
    """``name#world_version#seq`` -> parts; raises ValueError on malformed
    ids (the ``--check`` schema lint surfaces these loudly)."""
    name, wv, seq = corr.rsplit(CORR_SEP, 2)
    return name, int(wv), int(seq)


class TraceRecorder:
    """Per-rank bounded trace ring with correlation-id stamping.

    Thread-safe; one lock, held only for a deque append plus two dict
    operations per event. The engine calls :meth:`record_enqueue` /
    :meth:`record_dispatch` / :meth:`record_done` only when tracing is
    enabled (``engine.trace is not None``), so the disabled hot path takes
    no lock at all."""

    # the engine's threads record events while a dumper or publisher
    # snapshots segments: every ring/map attribute rides the one lock
    _GUARDED_BY = {
        "_events": "_lock",
        "_total": "_lock",
        "_seq": "_lock",
        "_live": "_lock",
        "_beacons": "_lock",
        "_step": "_lock",
        "_world_version": "_lock",
    }

    def __init__(self, rank: int = 0, capacity: int = DEFAULT_RING_CAPACITY):
        self.rank = rank
        self.capacity = max(int(capacity), 16)
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._total = 0            # appended ever (dropped = total - held)
        self._seq: Dict[str, int] = {}
        self._live: Dict[str, str] = {}   # outstanding name -> corr
        self._beacons: collections.deque = collections.deque(
            maxlen=MAX_BEACONS)
        self._step = 0
        self._world_version = 0

    # -- event recording (engine hooks) ------------------------------------

    # requires: _lock
    def _append(self, ev: dict):
        self._events.append(ev)
        self._total += 1

    def record_enqueue(self, name: str, kind: str, nbytes: int,
                       world_version: int,
                       link_bytes: Optional[dict] = None) -> str:
        """Stamp one collective submission: bump the per-name sequence,
        mint the deterministic correlation id, and record the arrival
        (enqueue-phase) event. Returns the correlation id.

        ``link_bytes`` is the payload's per-fabric split
        ({"ici"/"dcn"/"flat": bytes}) from the topology-aware algorithm
        selection; it rides the event so the merged trace can break wire
        bytes down by link."""
        with self._lock:
            return self._enqueue(name, kind, nbytes, world_version,
                                 link_bytes)

    def record_enqueue_many(self, names, kind: str, nbytes,
                            world_version: int, link_bytes=None) -> list:
        """:meth:`record_enqueue` for each of ``names`` (with its
        ``nbytes`` and ``link_bytes`` entry), under one lock: a grouped
        call's submissions. Returns the correlation ids."""
        links = link_bytes or (None,) * len(names)
        with self._lock:
            return [self._enqueue(n, kind, b, world_version, lb)
                    for n, b, lb in zip(names, nbytes, links)]

    # requires: _lock
    def _enqueue(self, name, kind, nbytes, world_version, link_bytes):
        if name not in self._seq and len(self._seq) >= _MAX_SEQ_NAMES:
            # bounded map: restart sequences. Events carrying the old
            # sequences were evicted from the (much smaller) ring long
            # before the map could fill, so ids stay unique in-window.
            self._seq.clear()
        seq = self._seq.get(name, 0) + 1
        self._seq[name] = seq
        corr = make_corr(name, world_version, seq)
        self._live[name] = corr
        self._world_version = world_version
        ev = {"p": "enq", "t": time.monotonic(), "c": corr,
              "k": kind, "n": name, "b": int(nbytes)}
        if link_bytes:
            ev["lb"] = {str(k): int(v) for k, v in link_bytes.items()}
        self._append(ev)
        return corr

    def live_corr(self, name: str) -> Optional[str]:
        """The correlation id of a currently-outstanding op (what the
        timeline hook tags its span args with)."""
        # under the lock like every other _live access: a handle retired
        # on another thread (record_done pops) may race the timeline hook
        # reading here, and a bare dict .get during a pop is an
        # implementation detail, not a contract
        with self._lock:
            return self._live.get(name)

    def record_dispatch(self, names, activity: str, dur_s: float):
        """One dispatch-phase event per involved tensor (a grouped launch
        carries several). ``dur_s`` is the host-side dispatch wall time;
        the event timestamp marks the dispatch *end* (record time)."""
        if isinstance(names, str):
            names = [names]
        now = time.monotonic()
        with self._lock:
            for n in names:
                self._append({"p": "dis", "t": now, "c": self._live.get(n),
                              "n": n, "a": activity, "d": float(dur_s)})

    def record_done(self, name: str):
        self.record_done_many((name,))

    def record_done_many(self, names):
        """The completion event of each of ``names`` (one launch's
        handles), under one lock."""
        with self._lock:
            for name in names:
                corr = self._live.pop(name, None)
                if corr is None:
                    # completion for a name this ring never saw enqueued
                    # (ring started mid-op, or a stray done): drop it —
                    # merged traces must never contain dangling ends
                    logger.debug("trace: done for unknown name %r dropped",
                                 name)
                    continue
                self._append({"p": "done", "t": time.monotonic(),
                              "c": corr, "n": name})

    def record_step(self, begin: bool):
        """Step boundary markers (engine.step_begin/step_end): a wire-vs-gap
        breakdown slices per step."""
        with self._lock:
            if begin:
                self._step += 1
            self._append({"p": "step" if begin else "step_end",
                          "t": time.monotonic(), "i": self._step})

    # -- clock beacons ------------------------------------------------------

    def add_beacon(self, local_mono: float, server_ts: float, rtt: float):
        """One ``(local monotonic, server wall, rtt)`` alignment pair (the
        reference's publisher fetches them from the rendezvous server)."""
        with self._lock:
            self._beacons.append((float(local_mono), float(server_ts),
                                  float(rtt)))

    # -- export --------------------------------------------------------------

    def segment(self, max_bytes: int = DEFAULT_SEGMENT_MAX_BYTES) -> dict:
        """Snapshot the ring as a compact, size-capped publishable segment.
        When the JSON encoding exceeds ``max_bytes``, the oldest half of
        the events is dropped (and counted) until it fits."""
        return self._segment(max_bytes)[0]

    def _segment(self, max_bytes: int) -> Tuple[dict, str]:
        with self._lock:
            events = list(self._events)
            beacons = [list(b) for b in self._beacons]
            dropped = max(0, self._total - len(self._events))
            wv = self._world_version
        while True:
            seg = {"schema": SCHEMA_VERSION, "rank": self.rank,
                   "world_version": wv, "dropped": dropped,
                   "beacons": beacons, "events": events}
            data = json.dumps(seg)
            if len(data) <= max_bytes or not events:
                return seg, data
            cut = max(len(events) // 2, 1)
            dropped += cut
            events = events[cut:]

    def dump(self, path: str) -> str:
        """Flight recorder: write this rank's ring to ``path`` as a valid
        single-process Chrome trace (raw monotonic microseconds — no
        cross-rank alignment needed for a local post-mortem). Returns the
        path. Called by the collective watchdog before it poisons the
        engine, so the spans leading into a hang survive it."""
        import os
        seg = self.segment(max_bytes=1 << 30)
        events = merge_segments({self.rank: seg})
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "otherData": {"flight_recorder": True,
                                     "rank": self.rank,
                                     "dropped": seg["dropped"]}}, f)
        return path


# ---------------------------------------------------------------------------
# Merger: per-rank segments -> one aligned Chrome trace
# ---------------------------------------------------------------------------

def clock_offset(beacons) -> Optional[float]:
    """Monotonic->server-wall offset from the minimum-rtt beacon. The
    beacon's local timestamp is already the request *midpoint*
    (the beacon fetch records ``(t0+t1)/2``) and the server stamped
    its wall clock roughly mid-flight, so ``offset = server_ts - mono``
    with error bounded by rtt/2; the rtt only picks the tightest beacon.
    None without beacons."""
    if not beacons:
        return None
    mono, server_ts, _rtt = min(beacons, key=lambda b: b[2])
    return server_ts - mono


def _tid_for(tids: Dict[str, int], name: str) -> int:
    tid = tids.get(name)
    if tid is None:
        tid = len(tids) + 1
        tids[name] = tid
    return tid


def merge_segments(segments: Dict[int, dict]) -> List[dict]:
    """Merge per-rank trace segments into one valid Chrome-trace event
    list: ``pid`` = rank, clocks aligned through each rank's beacons,
    B/E spans balanced even when a rank's ring was truncated mid-op
    (unmatched begins are sealed at the rank's last timestamp, dangling
    ends are dropped). Ranks without beacons fall back to raw monotonic
    time and are labeled ``(unaligned)`` — a degraded but still valid
    trace, never a failure."""
    out: List[dict] = []
    # compute per-rank offsets first so the global time origin is shared
    offsets: Dict[int, float] = {}
    aligned: Dict[int, bool] = {}
    for rank, seg in segments.items():
        off = clock_offset(seg.get("beacons"))
        aligned[rank] = off is not None
        offsets[rank] = off if off is not None else 0.0
    t0 = None
    for rank, seg in segments.items():
        for ev in seg.get("events", ()):
            t = ev.get("t")
            if isinstance(t, (int, float)):
                w = t + offsets[rank]
                if t0 is None or w < t0:
                    t0 = w
    if t0 is None:
        t0 = 0.0

    for rank in sorted(segments):
        seg = segments[rank]
        label = f"rank {rank}" + ("" if aligned[rank] else " (unaligned)")
        out.append({"ph": "M", "name": "process_name", "pid": rank, "tid": 0,
                    "args": {"name": label}})
        out.append({"ph": "M", "name": "process_sort_index", "pid": rank,
                    "tid": 0, "args": {"sort_index": rank}})
        tids: Dict[str, int] = {}
        open_spans: Dict[int, list] = {}   # tid -> stack of corr
        last_ts = 0.0
        step_open: Optional[Tuple[int, float]] = None

        def us(t: float) -> float:
            return (t + offsets[rank] - t0) * 1e6

        for ev in seg.get("events", ()):
            p = ev.get("p")
            t = ev.get("t")
            if p not in ("enq", "dis", "done", "step", "step_end") or \
                    not isinstance(t, (int, float)):
                continue
            ts = us(t)
            last_ts = max(last_ts, ts)
            if p == "enq":
                tid = _tid_for(tids, ev.get("n", ""))
                open_spans.setdefault(tid, []).append(ev.get("c"))
                args = {"corr": ev.get("c"), "tensor": ev.get("n"),
                        "bytes": ev.get("b", 0)}
                if isinstance(ev.get("lb"), dict):
                    args["link_bytes"] = ev["lb"]
                out.append({"ph": "B", "ts": ts, "pid": rank, "tid": tid,
                            "name": str(ev.get("k", "")).upper(),
                            "cat": "collective", "args": args})
            elif p == "done":
                tid = _tid_for(tids, ev.get("n", ""))
                stack = open_spans.get(tid)
                if not stack:
                    # dangling end (ring started mid-op): drop, the merged
                    # trace must stay balanced
                    continue
                stack.pop()
                out.append({"ph": "E", "ts": ts, "pid": rank, "tid": tid,
                            "args": {"corr": ev.get("c")}})
            elif p == "dis":
                tid = _tid_for(tids, ev.get("n", ""))
                dur = max(float(ev.get("d", 0.0)), 0.0) * 1e6
                out.append({"ph": "X", "ts": ts - dur, "dur": dur,
                            "pid": rank, "tid": tid,
                            "name": str(ev.get("a", "XLA_DISPATCH")),
                            "cat": "dispatch",
                            "args": {"corr": ev.get("c")}})
            elif p == "step":
                if step_open is not None:
                    idx, t_open = step_open
                    out.append({"ph": "X", "ts": t_open,
                                "dur": max(ts - t_open, 0.0), "pid": rank,
                                "tid": 0, "name": "STEP", "cat": "step",
                                "args": {"step": idx}})
                step_open = (int(ev.get("i", 0)), ts)
            elif p == "step_end":
                if step_open is not None:
                    idx, t_open = step_open
                    out.append({"ph": "X", "ts": t_open,
                                "dur": max(ts - t_open, 0.0), "pid": rank,
                                "tid": 0, "name": "STEP", "cat": "step",
                                "args": {"step": idx}})
                    step_open = None
        # seal what the ring truncated: unmatched B spans close at the
        # rank's last seen timestamp, flagged so the report can tell
        if step_open is not None:
            idx, t_open = step_open
            out.append({"ph": "X", "ts": t_open,
                        "dur": max(last_ts - t_open, 0.0), "pid": rank,
                        "tid": 0, "name": "STEP", "cat": "step",
                        "args": {"step": idx, "truncated": True}})
        for tid, stack in open_spans.items():
            for corr in reversed(stack):
                out.append({"ph": "E", "ts": last_ts, "pid": rank,
                            "tid": tid,
                            "args": {"corr": corr, "truncated": True}})
    return out


def collective_skew(segments: Dict[int, dict]) -> Dict[str, dict]:
    """Per-collective arrival skew from the *enqueue* (arrival) events:
    ``corr -> {kind, arrivals: {rank: wall_ts}, first_rank, last_rank,
    skew}``. Only collectives seen on >= 2 ranks participate — a rank
    whose segment is missing (dropped publish) simply thins the sample
    instead of failing the merge. A rank WITHOUT beacons is skipped
    entirely: its timestamps live in a private monotonic clock domain,
    and comparing them against beacon-aligned server-wall times would
    produce epoch-scale garbage skew (merge_segments still renders such
    ranks, labeled ``(unaligned)``)."""
    arrivals: Dict[str, dict] = {}
    for rank, seg in segments.items():
        off = clock_offset(seg.get("beacons"))
        if off is None:
            continue
        for ev in seg.get("events", ()):
            if ev.get("p") != "enq" or not ev.get("c"):
                continue
            ent = arrivals.setdefault(
                ev["c"], {"kind": ev.get("k", ""), "arrivals": {}})
            # first arrival wins if a corr repeats within one ring window
            ent["arrivals"].setdefault(rank, ev["t"] + off)
    out: Dict[str, dict] = {}
    for corr, ent in arrivals.items():
        ranks = ent["arrivals"]
        if len(ranks) < 2:
            continue
        first = min(ranks, key=ranks.get)
        last = max(ranks, key=ranks.get)
        out[corr] = {"kind": ent["kind"], "arrivals": ranks,
                     "first_rank": first, "last_rank": last,
                     "skew": ranks[last] - ranks[first]}
    return out


def modal_straggler(skews: Dict[str, dict]) -> Optional[int]:
    """The rank most often last to arrive (ties -> lowest rank); None
    without cross-rank data."""
    if not skews:
        return None
    last_counts: Dict[int, int] = {}
    for ent in skews.values():
        last_counts[ent["last_rank"]] = \
            last_counts.get(ent["last_rank"], 0) + 1
    return max(sorted(last_counts), key=lambda r: last_counts[r])


def observe_skew(skews: Dict[str, dict], reg,
                 watermark: Optional[Dict[str, Tuple[int, int]]] = None
                 ) -> Optional[int]:
    """Feed the merger's skew computation into the metrics registry
    (`hvd_tpu_collective_skew_seconds` by kind + the modal straggler into
    `hvd_tpu_straggler_rank`), so arrival skew rides the Prometheus
    scrape. ``watermark`` (per-name highest observed ``(world_version,
    seq)``, mutated in place) deduplicates across scrapes: segments are
    ring snapshots, so without it every ``GET /trace`` would re-observe
    the same still-in-ring collectives and the histogram count would
    scale with scrape frequency instead of collectives. Returns the
    straggler rank over ALL given skews (None when no cross-rank data)."""
    if not skews:
        return None
    hist = reg.histogram("hvd_tpu_collective_skew_seconds")
    for corr, ent in skews.items():
        if watermark is not None:
            try:
                name, wv, seq = parse_corr(corr)
            except ValueError:
                continue
            if (wv, seq) <= watermark.get(name, (-1, -1)):
                continue               # already observed by a prior scrape
            watermark[name] = (wv, seq)
        hist.observe(max(ent["skew"], 0.0), kind=str(ent["kind"]))
    straggler = modal_straggler(skews)
    reg.gauge("hvd_tpu_straggler_rank").set(float(straggler))
    return straggler


def render_cluster_trace(payloads: Dict[str, object], reg=None,
                         watermark: Optional[Dict[str, Tuple[int, int]]]
                         = None) -> bytes:
    """The merged cluster trace (the body of the reference's ``GET
    /trace``): parse every rank's segment payload (unparseable or missing
    ranks are skipped: a lost segment degrades the trace, never fails it),
    merge, and observe skew into
    ``reg`` when given (``watermark`` dedupes repeat scrapes, see
    :func:`observe_skew`). Returns Chrome-trace JSON bytes (object form
    with ``traceEvents`` + an ``otherData`` summary)."""
    segments: Dict[int, dict] = {}
    for key, raw in payloads.items():
        try:
            seg = raw
            if isinstance(seg, (bytes, bytearray, str)):
                seg = json.loads(seg)
            if not isinstance(seg, dict) or "events" not in seg:
                raise ValueError("not a trace segment")
            segments[int(seg.get("rank", key))] = seg
        except Exception as e:
            logger.debug("unusable trace payload from %r: %s", key, e)
    events = merge_segments(segments)
    skews = collective_skew(segments)
    # the headline straggler verdict never depends on the metrics
    # registry being enabled — skew is already in hand
    straggler = modal_straggler(skews)
    if reg is not None and getattr(reg, "enabled", False):
        try:
            observe_skew(skews, reg, watermark=watermark)
        except Exception as e:
            logger.debug("skew observation failed: %s", e)
    summary = {"schema": SCHEMA_VERSION,
               "ranks": sorted(segments),
               "collectives_correlated": len(skews),
               "straggler_rank": straggler}
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": summary}).encode()


# ---------------------------------------------------------------------------
# Tolerant loaders (crash-truncated timelines, NDJSON, object/array forms)
# ---------------------------------------------------------------------------

def load_trace_events(text: str) -> List[dict]:
    """Parse Chrome-trace JSON *tolerantly*: accepts the object form
    (``{"traceEvents": [...]}``), a bare array, a crash-truncated array
    (a rank that died mid-write leaves a valid prefix — every complete
    event is recovered), and newline-delimited events."""
    try:
        data = json.loads(text)
        if isinstance(data, dict):
            return [e for e in data.get("traceEvents", [])
                    if isinstance(e, dict)]
        if isinstance(data, list):
            return [e for e in data if isinstance(e, dict)]
        return []
    except ValueError:
        pass
    events: List[dict] = []
    dec = json.JSONDecoder()
    i, n = 0, len(text)
    while i < n and text[i] in " \t\r\n":
        i += 1
    if i < n and text[i] == "[":
        i += 1
    while i < n:
        while i < n and text[i] in " \t\r\n,]":
            i += 1
        if i >= n:
            break
        try:
            obj, end = dec.raw_decode(text, i)
        except ValueError:
            break                      # truncated tail: keep what parsed
        if isinstance(obj, dict):
            events.append(obj)
        i = end
    return events


def load_trace_file(path: str) -> List[dict]:
    with open(path, "r", errors="replace") as f:
        return load_trace_events(f.read())
