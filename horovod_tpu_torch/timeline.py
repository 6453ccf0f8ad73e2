"""Chrome-tracing timeline writer (the port's copy of
``horovod_tpu/timeline.py``; parity: horovod/common/timeline.{h,cc}).

Writes catapult-format JSON. Events go to the native C++ writer thread
(``native/src/timeline.cc``, loaded via ctypes) when the library builds,
else onto a queue drained by a Python writer thread. Per tensor: the
enqueue opens a span named after the op kind (``ALLREDUCE``,
``GROUPED_ALLREDUCE``, ...), the dispatch is an ``X`` activity inside it
(the reference's names, ``XLA_DISPATCH`` and ``XLA_REPLAY_DISPATCH``, which
``tools/trace_report.py`` reads), and completion closes the span. Every
event carries ``pid`` = the rank. Set ``HOROVOD_TIMELINE_NATIVE=0`` to
force the Python writer.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import threading
import time
from typing import Optional

logger = logging.getLogger("horovod_tpu_torch")

_AUTO_NAME_RE = re.compile(r"\.noname\.\d+$")
_MAX_TIDS = 4096
# Past _MAX_TIDS distinct names, new names hash onto this reserved tid pool
# (tids _MAX_TIDS+1 .. _MAX_TIDS+_OVERFLOW_TIDS). Deterministic per name, so
# a tensor's B/E events stay balanced on one track — where the old collapse
# onto tid 0 interleaved every overflow tensor's spans on a single row.
_OVERFLOW_TIDS = 64


def _native_enabled() -> bool:
    return os.environ.get("HOROVOD_TIMELINE_NATIVE", "1").strip().lower() \
        not in ("0", "false", "no", "off")


class Timeline:
    def __init__(self, path: str, mark_cycles: bool = False, pid: int = 0):
        self.path = path
        self.mark_cycles = mark_cycles
        # Chrome-trace pid of every event, from either writer: the rank, so
        # two ranks' timelines can be overlaid
        self.pid = pid
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._start = time.monotonic()
        # outstanding tensor names (enqueue seen, done not yet): the guard
        # that keeps a stray record_done from emitting an unbalanced "E"
        self._pending = {}
        self._tids = {}
        self._next_tid = 1
        self._native = None  # ctypes lib when the C++ writer owns the file

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._running:
            return
        if _native_enabled():
            from . import native
            lib = native.load()
            # The native writer is a process-wide singleton (one open file);
            # a second concurrent Timeline falls back to the Python writer.
            if lib is not None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                if lib.hvd_timeline_open(self.path.encode(), int(self.pid)) == 0:
                    self._native = lib
        self._running = True
        if self._native is None:
            self._thread = threading.Thread(target=self._writer,
                                            name="hvd-timeline", daemon=True)
            self._thread.start()

    def stop(self):
        if not self._running:
            return
        self._running = False
        if self._native is not None:
            self._native.hvd_timeline_close()
            self._native = None
            return
        self._q.put(None)
        self._thread.join(timeout=5)
        self._thread = None

    @property
    def native_active(self) -> bool:
        return self._native is not None

    # -- event recording (any thread) -------------------------------------

    def _ts_us(self) -> float:
        return (time.monotonic() - self._start) * 1e6

    def _tid(self, name: str) -> int:
        # Collapse auto-generated names ("allreduce.noname.N") onto one trace
        # row per op kind and cap the map, so long unnamed-op runs don't grow
        # host memory or tid count without bound (the reference reuses
        # per-tensor-name rows, timeline.h:77).
        key = _AUTO_NAME_RE.sub(".noname", name)
        tid = self._tids.get(key)
        if tid is None:
            if len(self._tids) >= _MAX_TIDS:
                # map is full: stable hash onto the reserved overflow pool
                # (not cached — the map must stop growing). Collisions share
                # a track, but one name's B/E pairs never split across tids.
                import zlib
                return _MAX_TIDS + 1 + (zlib.crc32(key.encode())
                                        % _OVERFLOW_TIDS)
            tid = self._next_tid
            self._next_tid += 1
            self._tids[key] = tid
        return tid

    def record_enqueue(self, name: str, kind: str, nbytes: int,
                       corr: Optional[str] = None):
        """Open the tensor's span. ``corr`` is the cross-rank correlation
        id stamped by the engine (``trace.py``), tagged into the span args
        so a local timeline joins against a merged trace."""
        self._pending[name] = corr
        args = {"tensor": name, "bytes": nbytes}
        if corr is not None:
            args["corr"] = corr
        if self._native is not None:
            self._native.hvd_timeline_event(
                b"B", kind.upper().encode(), int(self._ts_us()), 0,
                self._tid(name), json.dumps(args).encode())
            return
        self._q.put({"name": kind.upper(), "ph": "B", "ts": self._ts_us(),
                     "pid": self.pid, "tid": self._tid(name), "args": args})

    def record_done(self, name: str):
        if name not in self._pending:
            # a done for a name that was never enqueued (e.g. a handle
            # completed after an elastic reset rebuilt the timeline) would
            # emit an unbalanced "E" and corrupt the trace: drop it.
            logger.debug("timeline: done for un-enqueued name %r dropped",
                         name)
            return
        corr = self._pending.pop(name, None)
        if self._native is not None:
            args = (json.dumps({"corr": corr}).encode()
                    if corr is not None else None)
            self._native.hvd_timeline_event(
                b"E", b"", int(self._ts_us()), 0, self._tid(name), args)
            return
        ev = {"name": "", "ph": "E", "ts": self._ts_us(),
              "pid": self.pid, "tid": self._tid(name)}
        if corr is not None:
            ev["args"] = {"corr": corr}
        self._q.put(ev)

    def record_activity(self, name: str, activity: str, dur_us: float):
        if self._native is not None:
            self._native.hvd_timeline_event(
                b"X", activity.encode(), int(self._ts_us() - dur_us),
                int(dur_us), self._tid(name), None)
            return
        self._q.put({"name": activity, "ph": "X", "ts": self._ts_us() - dur_us,
                     "dur": dur_us, "pid": self.pid, "tid": self._tid(name)})

    def record_replay(self, event: str, detail: str = ""):
        """Step-capture replay lifecycle instants (core/replay.py):
        REPLAY_CAPTURE when a stream arms, REPLAY_REPLAY per replayed step,
        REPLAY_FALLBACK / REPLAY_INVALIDATE with the reason."""
        name = f"REPLAY_{event.upper()}"
        if self._native is not None:
            args = json.dumps({"detail": detail}).encode() if detail else None
            self._native.hvd_timeline_event(
                b"i", name.encode(), int(self._ts_us()), 0, 0, args)
            return
        ev = {"name": name, "ph": "i", "ts": self._ts_us(), "pid": self.pid,
              "tid": 0, "s": "p"}
        if detail:
            ev["args"] = {"detail": detail}
        self._q.put(ev)

    def record_counter(self, name: str, values: dict):
        """Chrome-trace counter track (``ph:"C"``): ``values`` maps series
        name -> number and renders as a stacked counter row riding the same
        trace as the spans. The MetricsEmitter samples wire-byte and
        dispatch rates from the metrics registry through this."""
        if self._native is not None:
            self._native.hvd_timeline_event(
                b"C", name.encode(), int(self._ts_us()), 0, 0,
                json.dumps(values).encode())
            return
        self._q.put({"name": name, "ph": "C", "ts": self._ts_us(),
                     "pid": self.pid, "tid": 0, "args": dict(values)})

    def mark_cycle(self):
        if not self.mark_cycles:
            return
        if self._native is not None:
            self._native.hvd_timeline_event(
                b"i", b"CYCLE", int(self._ts_us()), 0, 0, None)
            return
        self._q.put({"name": "CYCLE", "ph": "i", "ts": self._ts_us(),
                     "pid": self.pid, "tid": 0, "s": "g"})

    # -- writer thread -----------------------------------------------------

    def _writer(self):
        # Write-then-seal (crash tolerance): after EVERY event the closing
        # "]" is re-written and flushed, then overwritten in place by the
        # next event. A rank killed mid-stream leaves a file whose last
        # flushed state is complete, valid Chrome-trace JSON — where the
        # old close-on-clean-stop form left an unparseable fragment. (A
        # kill between flushes can still leave partial buffered bytes
        # after the last seal; trace.load_trace_events recovers the valid
        # prefix of such files.) Each event is one seek + two small writes
        # — negligible next to the json.dump it already paid.
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "w") as f:
            f.write("[")
            seal_pos = f.tell()
            f.write("\n]\n")
            f.flush()
            first = True
            while True:
                try:
                    ev = self._q.get(timeout=0.5)
                except queue.Empty:
                    # lockcheck: ignore[single-writer shutdown flag: stop() also enqueues a None sentinel, a stale read costs one 0.5s poll]
                    if not self._running:
                        break
                    continue
                if ev is None:
                    break
                f.seek(seal_pos)
                f.write("\n" if first else ",\n")
                json.dump(ev, f)
                seal_pos = f.tell()
                f.write("\n]\n")
                f.flush()
                first = False
