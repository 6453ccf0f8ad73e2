"""Threaded HTTP KV store (the port's copy of
``horovod_tpu/runner/http_server.py``'s ``KVStoreServer``; parity:
Horovod's ``horovod/runner/http/http_server.py``, ``KVStoreHandler`` GET/PUT
:35-110 and the standalone ``KVStoreServer``). Plain Python: no torch.

Role in the port: the rendezvous KV that checkpoint shards, manifests and
headers go through (``checkpoint/manager.py``), and the scrape endpoints
``GET /metrics``, ``GET /trace`` and ``GET /clock`` over what ranks publish
under ``metrics/<rank>`` and ``trace/<rank>``. The launcher's
``RendezvousServer`` (slot plans, the coordinator address), the ranks'
telemetry publishers and the replication tier come with the launcher
(ROADMAP A14): :meth:`KVStoreServer.enable_replication` raises until then.
Per-scope byte budgets answer over-budget writes with ``429 + Retry-After``
so publishers shed instead of piling onto a struggling control plane.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from ..faults import DROP, failpoint

_LOG = logging.getLogger("horovod_tpu_torch.runner")

OK = 200
NOT_FOUND = 404
BAD_REQUEST = 400
TOO_MANY_REQUESTS = 429

# Prometheus exposition content type (text format 0.0.4)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# KV scope workers publish snapshots under (== metrics.METRICS_KV_SCOPE;
# kept literal so the server module stays importable standalone)
METRICS_SCOPE = "metrics"
# KV scope workers publish trace segments under (== trace.TRACE_KV_SCOPE);
# GET /trace (empty key) serves the merged cluster Chrome trace
TRACE_SCOPE = "trace"
# GET /clock serves the server's wall clock — the clock-alignment beacon
# every rank pairs with its local monotonic clock (trace.py)
CLOCK_SCOPE = "clock"
# reserved replication-control scope (runner/replication.py): PUT apply/
# snapshot between replicas, GET status/journal for operators and tests
REPL_SCOPE = "_repl"
# KV scope carrying slice-aggregator registrations ("<slice>") and
# telemetry rollups ("<stream>/<slice>") — == runner/aggregator.py
# AGG_KV_SCOPE, kept literal for the same standalone-import reason.
# GET /agg (empty key) serves a JSON summary of the aggregation tier
# (tools/health_report.py's freshness source).
AGG_SCOPE = "agg"


def _normalize(result) -> Tuple[int, dict, bytes]:
    """Handler callbacks may return a bare status code or a
    ``(code, headers, body)`` tuple (backpressure and replication answers
    carry headers/bodies); normalize for the HTTP layer."""
    if isinstance(result, tuple):
        code, headers, body = result
        return int(code), dict(headers or {}), bytes(body or b"")
    return int(result), {}, b""


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # quiet the default stderr chatter
    def log_message(self, fmt, *args):
        _LOG.debug("http: " + fmt, *args)

    def _split(self):
        parts = self.path.lstrip("/").split("/", 1)
        scope = parts[0] if parts else ""
        key = parts[1] if len(parts) > 1 else ""
        return scope, key

    def _reply(self, result):
        code, headers, body = _normalize(result)
        self.send_response(code)
        for h, v in headers.items():
            self.send_header(h, str(v))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        scope, key = self._split()
        self.server._count_request("get", scope, 0)
        value = self.server.handle_get(scope, key, self)
        if value is None:
            self.send_response(NOT_FOUND)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(OK)
        if scope == METRICS_SCOPE and not key:
            self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
        elif (scope in (TRACE_SCOPE, CLOCK_SCOPE, REPL_SCOPE, AGG_SCOPE)) and \
                (not key or scope == REPL_SCOPE):
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_PUT(self):  # noqa: N802
        scope, key = self._split()
        length = int(self.headers.get("Content-Length", "0"))
        value = self.rfile.read(length)
        self.server._count_request("put", scope, length)
        self._reply(self.server.handle_put(scope, key, value, self))

    def do_DELETE(self):  # noqa: N802
        # idempotent key removal (checkpoint GC drops stale chunked shard
        # values; see http_client.delete_data_from_kvstore)
        scope, key = self._split()
        self.server._count_request("delete", scope, 0)
        self._reply(self.server.handle_delete(scope, key, self))


class KVStoreServer(ThreadingHTTPServer):
    """Plain scoped KV store over HTTP (reference http_server.py:175-242).

    Additionally answers ``GET /metrics`` (scope ``metrics``, empty key)
    with a Prometheus-text cluster aggregation of every worker snapshot
    published under ``metrics/<rank>`` — the scrape endpoint of
    ``horovod_tpu.metrics`` (each series carries a ``rank`` label)."""

    daemon_threads = True

    # lock discipline (tools/check.py lockcheck): the store, its per-scope
    # byte totals, and the per-record (seq, epoch) replication metadata
    # move together under the one store lock.
    _GUARDED_BY = {
        "_store": "_lock",
        "_scope_bytes": "_lock",
        "_record_meta": "_lock",
        "_slots_by_key": "_lock",
        "_request_stats": "_lock",
        "_skew_watermark": "_trace_render_lock",
    }

    def handle_error(self, request, client_address):
        # A client that timed out and reconnected (capped per-request
        # timeout, fault-injected hangs) leaves this thread writing into a
        # closed socket — debug noise, not an error worth a traceback.
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            _LOG.debug("client %s disconnected mid-response: %s",
                       client_address, exc)
            return
        super().handle_error(request, client_address)

    def __init__(self, addr=("0.0.0.0", 0)):
        super().__init__(addr, _KVHandler)
        from ..common.env import HOROVOD_KV_SCOPE_BUDGET_BYTES, _get_int
        self._lock = threading.Lock()
        self._store: Dict[str, Dict[str, bytes]] = collections.defaultdict(dict)
        self._thread: Optional[threading.Thread] = None
        # per-scope running byte totals + the default/override budgets
        # (backpressure): a PUT that would grow a scope past its
        # budget is answered 429 + Retry-After instead of stored. 0 = no
        # budget. Budgets resolve once here (knob) or via
        # set_scope_budget — never re-read per request.
        self._scope_bytes: Dict[str, int] = {}
        self._scope_budget_default = _get_int(
            HOROVOD_KV_SCOPE_BUDGET_BYTES, 0)
        self._scope_budgets: Dict[str, int] = {}
        # per-record (seq, epoch) stamped by replicated mutations — the
        # fenced-epoch trail of every replicated record
        self._record_meta: Dict[str, Dict[str, tuple]] = \
            collections.defaultdict(dict)
        # replication coordinator (runner/replication.py); None = the
        # classic standalone server, zero new work on any path
        self._repl = None
        # per-name highest observed (world_version, seq) by the /trace
        # skew observation: repeat scrapes over the same ring snapshot
        # must not re-observe the same collectives into the histogram.
        # Guarded by its own lock (renders can be slow — don't block PUTs
        # on self._lock, but two racing GET /trace must not both observe
        # the same collectives)
        self._skew_watermark: Dict[str, tuple] = {}
        self._trace_render_lock = threading.Lock()
        # server-side request accounting: root load is measured,
        # not inferred. The registry counters are process-wide (the scrape
        # face); the per-instance table lets an in-process test or bench
        # attribute load to ONE server when several share the process
        # (root vs embedded slice-aggregator receivers).
        self._request_stats: Dict[Tuple[str, str], list] = {}
        from ..metrics import registry as _metrics_registry
        _reg = _metrics_registry()
        self._m_requests = _reg.counter("hvd_tpu_kv_requests_total")
        self._m_request_bytes = _reg.counter("hvd_tpu_kv_request_bytes_total")

    # -- public state accessors ---------------------------------------------

    def snapshot(self, scope: Optional[str] = None
                 ) -> Dict[str, Dict[str, bytes]]:
        """Consistent copy of the store under the lock — the public
        surface tests and the replication snapshot push use instead of
        reaching into ``_lock``/``_store`` privates. With
        ``scope``, only that scope is copied (the scrape/trace renders —
        copying every checkpoint chunk key per scrape would stretch the
        lock hold for no reason)."""
        with self._lock:
            if scope is not None:
                kv = self._store.get(scope)
                return {scope: dict(kv)} if kv else {}
            return {scope: dict(kv) for scope, kv in self._store.items()}

    def clear_all(self):
        """Drop every scope (test isolation helper)."""
        with self._lock:
            self._store.clear()
            self._scope_bytes.clear()
            self._record_meta.clear()

    def scope_bytes(self, scope: str) -> int:
        with self._lock:
            return self._scope_bytes.get(scope, 0)

    def _count_request(self, verb: str, scope: str, nbytes: int):
        """One HTTP request landed on this server: count it per
        (verb, scope) into the instance table and the process registry
        (``hvd_tpu_kv_requests_total`` / ``hvd_tpu_kv_request_bytes_total``
        — the O(ranks) vs O(slices) root-load claim, measured)."""
        with self._lock:
            ent = self._request_stats.setdefault((verb, scope), [0, 0])
            ent[0] += 1
            ent[1] += int(nbytes)
        self._m_requests.inc(verb=verb, scope=scope)
        if nbytes:
            self._m_request_bytes.inc(int(nbytes), verb=verb, scope=scope)

    def request_stats(self) -> Dict[Tuple[str, str], Tuple[int, int]]:
        """Copy of the per-instance request table:
        ``(verb, scope) -> (requests, bytes)``."""
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._request_stats.items()}

    def set_scope_budget(self, scope: str, budget_bytes: int):
        """Per-scope byte-budget override (0 disables); the knob
        ``HOROVOD_KV_SCOPE_BUDGET_BYTES`` sets the default for every
        scope."""
        with self._lock:
            self._scope_budgets[scope] = int(budget_bytes)

    def enable_replication(self, self_addr: str, replicas, role="standby",
                           config=None):
        """Attach a replication coordinator: this server becomes one
        replica of the ordered ``replicas`` endpoint set (``host:port``
        strings; ``self_addr`` must be one of them). The coordinator
        (``runner/replication.py``) comes with the launcher: until then
        this raises, and the server stays the standalone store."""
        raise NotImplementedError(
            "KV replication (runner/replication.py's ReplicaCoordinator) "
            "is not ported yet (ROADMAP A14); the port's KVStoreServer "
            "runs standalone")

    @property
    def replication(self):
        return self._repl

    # -- store mutation core (shared by direct and replicated paths) --------

    def _store_apply(self, op: str, scope: str, key: str,
                     value: Optional[bytes], seq: int = 0,
                     epoch: int = 0) -> bool:
        """Apply one mutation under the lock, maintaining byte totals and
        the per-record (seq, epoch) metadata. Returns False only for a
        delete of an absent key."""
        with self._lock:
            return self._store_apply_locked(op, scope, key, value,
                                            seq=seq, epoch=epoch)

    # requires: _lock
    def _store_apply_locked(self, op: str, scope: str, key: str,
                            value: Optional[bytes], seq: int = 0,
                            epoch: int = 0) -> bool:
        """The mutation core for callers already holding the lock (the
        launcher's RendezvousServer.init, ROADMAP A14, swaps the slot plan
        and the coordinator key under ONE lock hold — byte totals must
        move with the store either way)."""
        if op == "put":
            old = self._store[scope].get(key)
            self._scope_bytes[scope] = (
                self._scope_bytes.get(scope, 0)
                - (len(old) if old is not None else 0)
                + len(value or b""))
            self._store[scope][key] = value or b""
            if seq:
                self._record_meta[scope][key] = (seq, epoch)
            return True
        if op == "delete":
            old = self._store.get(scope, {}).pop(key, None)
            if old is not None:
                self._scope_bytes[scope] = \
                    self._scope_bytes.get(scope, 0) - len(old)
            self._record_meta.get(scope, {}).pop(key, None)
            return old is not None
        if op == "clear":
            self._store.pop(scope, None)
            self._scope_bytes.pop(scope, None)
            self._record_meta.pop(scope, None)
            return True
        raise ValueError(f"unknown store op {op!r}")

    def _store_replace(self, store: Dict[str, Dict[str, bytes]],
                       seq: int = 0, epoch: int = 0):
        """Wholesale store replacement (replication snapshot install)."""
        with self._lock:
            self._store.clear()
            self._scope_bytes.clear()
            self._record_meta.clear()
            for scope, kv in store.items():
                self._store[scope] = dict(kv)
                self._scope_bytes[scope] = sum(
                    len(v) for v in kv.values())
                if seq:
                    for k in kv:
                        self._record_meta[scope][k] = (seq, epoch)

    def _check_budget(self, scope: str, key: str, value: bytes):
        """429 + Retry-After when this PUT would grow ``scope`` past its
        byte budget. Overwrites that shrink (or keep) the scope always
        pass — a last-writer-wins publisher can never livelock itself
        out of its own key."""
        with self._lock:
            budget = self._scope_budgets.get(scope,
                                             self._scope_budget_default)
            if budget <= 0:
                return None
            old = self._store.get(scope, {}).get(key)
            delta = len(value) - (len(old) if old is not None else 0)
            if delta <= 0 or \
                    self._scope_bytes.get(scope, 0) + delta <= budget:
                return None
            total = self._scope_bytes.get(scope, 0)
        from ..metrics import registry as metrics_registry
        metrics_registry().counter("hvd_tpu_kv_backpressure_total").inc(
            scope=scope)
        body = json.dumps({"error": "scope_over_budget", "scope": scope,
                           "budget": budget, "bytes": total,
                           "put": len(value)}).encode()
        return (TOO_MANY_REQUESTS,
                {"Retry-After": "1", "Content-Type": "application/json"},
                body)

    # -- handler callbacks --------------------------------------------------

    def handle_get(self, scope: str, key: str, handler) -> Optional[bytes]:
        # hang() here models a server that accepted the connection and
        # wedged (the capped per-request client timeout's regression seam);
        # drop() serves a 404 for a key that exists
        if failpoint("kv.server.get") is DROP:
            return None
        if scope == METRICS_SCOPE and not key:
            return self._render_metrics()
        if scope == TRACE_SCOPE and not key:
            return self._render_trace()
        if scope == CLOCK_SCOPE and not key:
            # server-stamped wall clock: the clock-alignment beacon source
            # (trace.py). Stamped as late as possible so the client's
            # rtt/2 midpoint estimate stays tight.
            import time
            return json.dumps({"ts": time.time()}).encode()
        if scope == AGG_SCOPE and not key:
            return self._render_agg_summary()
        if scope == REPL_SCOPE:
            if self._repl is None:
                return None
            if key == "status":
                return json.dumps(self._repl.status()).encode()
            if key == "journal":
                return json.dumps(self._repl.audit_journal()).encode()
            if key.startswith("tail/"):
                # journal tail past a seq — a promoting peer's election-
                # restriction catch-up source (replication.py)
                try:
                    from_seq = int(key.split("/", 1)[1])
                except ValueError:
                    return None
                return json.dumps(
                    self._repl.journal_tail(from_seq)).encode()
            return None
        with self._lock:
            return self._store.get(scope, {}).get(key)

    def _agg_rollups(self, stream: str) -> Dict[str, dict]:
        """Parsed ``agg/<stream>/<slice>`` rollup payloads, keyed by slice
        string (unparseable rollups are skipped)."""
        out: Dict[str, dict] = {}
        prefix = stream + "/"
        for key, raw in self.snapshot(AGG_SCOPE).get(AGG_SCOPE, {}).items():
            if not key.startswith(prefix):
                continue
            try:
                out[key[len(prefix):]] = json.loads(raw)
            except Exception:
                _LOG.debug("unparseable %s rollup under agg/%s", stream, key)
        return out

    def _render_metrics(self) -> bytes:
        from ..metrics import registry, render_prometheus_cluster
        snaps = {}
        # aggregator rollups first: each carries its slice's
        # per-rank snapshots (cardinality=rank) or one summed per-slice
        # snapshot (cardinality=slice) — the root never needed N keys
        for slice_key, roll in self._agg_rollups(METRICS_SCOPE).items():
            rolled = roll.get("snaps")
            if isinstance(rolled, dict):
                snaps.update(rolled)
        # direct rank keys overlay the rollups: a direct key only exists on
        # flat topologies (no rollups at all) or for a rank that FELL BACK
        # past its aggregator — whose rollup copy is by definition frozen
        payloads = self.snapshot(METRICS_SCOPE).get(METRICS_SCOPE, {})
        for rank, raw in payloads.items():
            try:
                snaps[rank] = json.loads(raw)
            except Exception:
                _LOG.debug("unparseable metrics payload from rank %s", rank)
        # The server runs in the launcher/driver process, whose own registry
        # (elastic world version + membership event log) has no KV publish
        # path — merge it into the scrape under rank="driver" so elastic
        # telemetry is visible without a worker-side hop.
        local = registry().snapshot()
        if local.get("enabled") and any(
                local.get(s) for s in ("counters", "gauges", "histograms",
                                       "events")):
            snaps.setdefault("driver", local)
        return render_prometheus_cluster(snaps).encode()

    def _render_trace(self) -> bytes:
        """The merged cluster Chrome trace: every worker's published
        ``trace/<rank>`` segment, pid-remapped to rank and clock-aligned
        (horovod_tpu/trace.py). Missing or unparseable rank segments thin
        the trace instead of failing the endpoint; per-collective arrival
        skew is observed into the server-local registry on the way so it
        rides the ``GET /metrics`` scrape (rank="driver")."""
        from ..metrics import registry
        from ..trace import render_cluster_trace
        # aggregator trace rollups first (segments already edge-aligned to
        # this server's wall clock, pid pinned to rank), then direct
        # ``trace/<rank>`` keys overlay them (flat topologies + fallback
        # ranks — the fresher copy for any rank publishing direct)
        payloads: Dict[str, object] = {}
        for slice_key, roll in self._agg_rollups(TRACE_SCOPE).items():
            segs = roll.get("segments")
            if isinstance(segs, dict):
                payloads.update(segs)
        payloads.update(self.snapshot(TRACE_SCOPE).get(TRACE_SCOPE, {}))
        with self._trace_render_lock:
            return render_cluster_trace(payloads, reg=registry(),
                                        watermark=self._skew_watermark)

    def _render_agg_summary(self) -> bytes:
        """The ``GET /agg`` body: aggregation-tier state as JSON —
        per-slice registrations, per-stream rollup freshness/size, and
        this server's request accounting (tools/health_report.py's
        per-slice publish-freshness and control-plane-load source)."""
        import time
        slices: Dict[str, dict] = {}
        rollups: Dict[str, dict] = {}
        for key, raw in self.snapshot(AGG_SCOPE).get(AGG_SCOPE, {}).items():
            try:
                payload = json.loads(raw)
            except Exception:
                continue
            if "/" in key:
                stream, _, slice_key = key.partition("/")
                rollups.setdefault(stream, {})[slice_key] = {
                    "ts": payload.get("ts"), "bytes": len(raw),
                    "ranks": sorted(payload.get("snaps")
                                    or payload.get("segments")
                                    or payload.get("reports") or ())}
            else:
                slices[key] = payload
        stats = {f"{verb} {scope}": {"requests": n, "bytes": b}
                 for (verb, scope), (n, b) in self.request_stats().items()}
        return json.dumps({"ts": time.time(), "slices": slices,
                           "rollups": rollups,
                           "request_stats": stats}).encode()

    def clear_scope(self, scope: str):
        """Drop every key under one scope (the elastic driver clears stale
        ``trace/<rank>`` segments when a new world activates, so a merged
        trace never mixes ranks from two worlds). On a replicated primary
        the clear is journaled like any client mutation so standbys
        converge."""
        if self._repl is not None:
            code = _normalize(self._repl.client_write("clear", scope, "",
                                                      None))[0]
            if code != OK:
                # a demoted/quorum-less replica cannot clear: surface it —
                # stale segments would silently mix two worlds' ranks in
                # the merged trace otherwise
                _LOG.warning(
                    "clear_scope(%r) refused by the replication tier "
                    "(HTTP %d, role %s): stale keys may persist until the "
                    "current primary clears the scope", scope, code,
                    self._repl.status().get("role"))
            return
        self._store_apply("clear", scope, "", None)

    def handle_put(self, scope: str, key: str, value: bytes, handler):
        # drop() acks 200 without storing — the silent-loss fault the
        # retry/verify paths must survive
        if failpoint("kv.server.put") is DROP:
            return OK
        if scope == REPL_SCOPE:
            if self._repl is None:
                return NOT_FOUND
            return self._repl.handle_control(key, value)
        if self._repl is not None:
            # the budget is enforced by the PRIMARY only: a standby's
            # local/stale budget view answering 429 would be terminal for
            # the client (KVBackpressure is deliberately not retried) —
            # redirect first, let the authority decide
            if self._repl.is_primary():
                bp = self._check_budget(scope, key, value)
                if bp is not None:
                    return bp
            return self._repl.client_write("put", scope, key, value)
        bp = self._check_budget(scope, key, value)
        if bp is not None:
            return bp
        self._store_apply("put", scope, key, value)
        return OK

    def handle_delete(self, scope: str, key: str, handler):
        if self._repl is not None:
            return self._repl.client_write("delete", scope, key, None)
        existed = self._store_apply("delete", scope, key, None)
        return OK if existed else NOT_FOUND

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="kvstore-http", daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._repl is not None:
            self._repl.stop()
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
