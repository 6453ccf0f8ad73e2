"""HTTP KV client of the rendezvous KV (the port's copy of
``horovod_tpu/runner/http_client.py``; parity: Horovod's
``horovod/runner/http/http_client.py:45``, read_data_from_kvstore /
put_data_into_kvstore). Plain Python: no torch.

Hardening: both verbs carry ``failpoint()`` markers (``kv.read``/``kv.put``)
so transient-fabric failures are injectable, the long-poll read caps its
*per-request* socket timeout (one hung server connection cannot eat the
whole deadline), and the write path retries through
:func:`..common.retry.retrying` within its deadline.

Replicated control plane: every entry point accepts an endpoint *set*
instead of one ``(addr, port)`` — pass an :class:`Endpoints`, a list of
``(host, port)`` pairs, or a spec string ``"h1:p1,h2:p2"`` as ``addr``
(``port`` is then ignored / may be ``None``). Requests fail over across the
set mid-deadline: per-endpoint health rides a consecutive-failure circuit
breaker (trip -> open with jittered exponential reopen via the shared
``backoff_delays`` schedule -> half-open probe), a standby's
``409 not-primary`` answer redirects to its primary hint (epoch-aware, so
a zombie ex-primary's stale hint never wins over a newer promotion), and a
``429 + Retry-After`` backpressure answer surfaces as
:class:`KVBackpressure` — deliberately NOT an ``OSError``, so the retry
machinery never hammers a server that asked for load shedding; publishers
catch it and shed (``hvd_tpu_kv_shed_bytes_total``).

Endpoint sets are resolved ONCE per distinct pair tuple (module registry),
so breaker state survives callers that pass raw ``(addr, port)`` tuples on
every call; the set itself is frozen at construction — failover reorders
*within* it, never grows it.

The chunked large-value transfer (:func:`put_large_value`,
:func:`read_large_value`, :func:`delete_large_value`) carries checkpoint
shards (``checkpoint/manager.py``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional, Tuple

from ..common.retry import backoff_delays, retrying
from ..faults import DROP, failpoint

# Cap on the socket timeout of any single long-poll GET request: a server
# that accepted the connection and then wedged costs one capped request,
# not the caller's whole deadline (the retry loop reconnects).
DEFAULT_PER_REQUEST_TIMEOUT = 5.0

# HTTP status a standby answers writes with (body carries the primary hint
# and epoch); mirrored by the server tier (runner/replication.py).
NOT_PRIMARY_STATUS = 409
BACKPRESSURE_STATUS = 429


class KVBackpressure(Exception):
    """A KV server refused a write with ``429 + Retry-After`` (per-scope
    byte budget). Deliberately NOT an ``OSError``:
    the shared retry machinery must not re-submit into an overloaded
    server — telemetry publishers catch this and shed instead."""

    def __init__(self, scope: str, retry_after: float = 1.0):
        super().__init__(
            f"KV scope {scope!r} over its byte budget "
            f"(Retry-After {retry_after:g}s)")
        self.scope = scope
        self.retry_after = retry_after


def count_shed_bytes(scope: str, nbytes: int):
    """The one accounting point for publisher load-shedding: every
    ``except KVBackpressure`` handler that drops a payload counts it
    here (``hvd_tpu_kv_shed_bytes_total{scope=...}``) so degradation is
    visible in the scrape, never silent."""
    from ..metrics import registry as metrics_registry
    metrics_registry().counter("hvd_tpu_kv_shed_bytes_total").inc(
        nbytes, scope=scope)


class _KeyMissing(Exception):
    """Internal: a live endpoint answered 404 (key absent — long-poll)."""

    def __init__(self, err):
        super().__init__(str(err))
        self.err = err


class _SweepFailed(OSError):
    """Internal: every endpoint of a sweep failed transport-wise (or kept
    answering not-primary/503). An OSError so the shared retry/backoff
    machinery treats it exactly like the legacy single-endpoint
    connection failure."""


class _EndpointState:
    """Per-endpoint circuit-breaker record (guarded by Endpoints._lock)."""

    __slots__ = ("failures", "open_until", "trips")

    def __init__(self):
        self.failures = 0       # consecutive transport failures
        self.open_until = 0.0   # monotonic instant the breaker half-opens
        self.trips = 0          # lifetime trips (grows the reopen delay)


class Endpoints:
    """A frozen, ordered set of control-plane endpoints with per-endpoint
    health tracking. The set is resolved once at construction (off the
    step path — divcheck's endpoint-resolution discipline); requests
    iterate :meth:`candidates` and report outcomes back.

    Breaker policy: ``HOROVOD_KV_BREAKER_FAILURES`` consecutive transport
    failures trip an endpoint open; it half-opens (one probe admitted by
    ``candidates()`` ordering) after a jittered, per-trip-doubling delay
    seeded by ``HOROVOD_KV_BREAKER_RESET``. With every breaker open the
    candidates are served anyway, soonest-reopen first — an all-dead set
    has nothing better to try.
    """

    # lock discipline (tools/check.py lockcheck): the breaker records,
    # preferred-primary index, and fencing epoch are touched by every
    # requesting thread.
    _GUARDED_BY = {
        "_state": "_lock",
        "_preferred": "_lock",
        "_epoch": "_lock",
    }

    def __init__(self, pairs, trip_failures: Optional[int] = None,
                 reset_delay: Optional[float] = None):
        from ..common.env import (HOROVOD_KV_BREAKER_FAILURES,
                                  HOROVOD_KV_BREAKER_RESET, _get_float,
                                  _get_int)
        self.pairs: Tuple[Tuple[str, int], ...] = tuple(
            (str(h), int(p)) for h, p in pairs)
        if not self.pairs:
            raise ValueError("empty endpoint set")
        self._lock = threading.Lock()
        self._state = [_EndpointState() for _ in self.pairs]
        self._preferred = 0
        self._epoch = 0
        self._trip = trip_failures if trip_failures is not None else \
            max(_get_int(HOROVOD_KV_BREAKER_FAILURES, 3), 1)
        self._reset = reset_delay if reset_delay is not None else \
            max(_get_float(HOROVOD_KV_BREAKER_RESET, 0.5), 0.01)

    @property
    def spec(self) -> str:
        return ",".join(f"{h}:{p}" for h, p in self.pairs)

    def __repr__(self):
        return self.spec

    def __len__(self):
        return len(self.pairs)

    def candidates(self) -> List[int]:
        """Indices to try, in order: the last-known primary first, then
        declaration order; tripped-open endpoints sort last (soonest
        reopen first) rather than being skipped — a breaker past its
        reopen instant admits its half-open probe naturally by sorting
        with the closed ones."""
        now = time.monotonic()
        with self._lock:
            order = [self._preferred] + [
                i for i in range(len(self.pairs)) if i != self._preferred]
            closed = [i for i in order if self._state[i].open_until <= now]
            opened = [i for _, i in sorted(
                (self._state[i].open_until, i) for i in order
                if self._state[i].open_until > now)]
        return closed + opened

    def tripped(self, i: int = 0) -> bool:
        """Whether endpoint ``i``'s breaker is currently open (its reopen
        instant not yet reached). Single-endpoint callers — the telemetry
        route's slice-aggregator leg — use this to skip the attempt
        entirely while the breaker is open instead of paying a connect
        timeout per publish; once the reopen instant passes this returns
        False and the next publish is the half-open probe."""
        with self._lock:
            return self._state[i].open_until > time.monotonic()

    def record_success(self, i: int, prefer: bool = True):
        """A request completed against endpoint ``i``: close its breaker.
        ``prefer`` pins it as the sticky first candidate (writes — the
        answering endpoint is the live primary); reads pass False so a
        standby serving GETs never steals the write preference."""
        with self._lock:
            st = self._state[i]
            st.failures = 0
            st.open_until = 0.0
            st.trips = 0
            if prefer:
                self._preferred = i

    def record_failure(self, i: int, op: str = "kv"):
        """A transport failure against endpoint ``i``; trips the breaker
        open past the consecutive-failure threshold."""
        tripped = False
        with self._lock:
            st = self._state[i]
            st.failures += 1
            now = time.monotonic()
            if st.failures >= self._trip and st.open_until <= now:
                st.trips += 1
                base = self._reset * (2.0 ** min(st.trips - 1, 6))
                delay = next(iter(backoff_delays(2, base, 30.0, 0.5)), base)
                st.open_until = now + delay
                tripped = True
        if tripped:
            from ..metrics import registry as metrics_registry
            h, p = self.pairs[i]
            metrics_registry().counter("hvd_tpu_kv_breaker_open_total").inc(
                endpoint=f"{h}:{p}")

    def record_redirect(self, hint: str, epoch: int) -> Optional[int]:
        """A standby answered not-primary with ``hint`` (``host:port``) at
        ``epoch``. Epoch-aware: hints older than the newest epoch seen are
        stale (a zombie ex-primary must not steal the preference back).
        Returns the hint's index in the set, or None when the hint is
        unknown/stale — the set never grows at runtime."""
        try:
            host, _, port_s = str(hint).rpartition(":")
            pair = (host, int(port_s))
        except (ValueError, TypeError):
            return None
        with self._lock:
            if epoch < self._epoch:
                return None
            self._epoch = max(self._epoch, int(epoch))
            try:
                i = self.pairs.index(pair)
            except ValueError:
                return None
            self._preferred = i
        return i


# One shared Endpoints per distinct pair tuple, so breaker state persists
# across stateless call sites that pass raw (addr, port) every time.
_ENDPOINT_CACHE: dict = {}
_ENDPOINT_CACHE_LOCK = threading.Lock()


def parse_endpoint_spec(spec: str,
                        default_port: Optional[int] = None
                        ) -> Tuple[Tuple[str, int], ...]:
    """Parse ``"h1:p1,h2:p2"`` (or a bare ``"host"`` with
    ``default_port``) into a pair tuple."""
    pairs = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, _, port_s = part.rpartition(":")
            pairs.append((host, int(port_s)))
        elif default_port is not None:
            pairs.append((part, int(default_port)))
        else:
            raise ValueError(f"endpoint {part!r} has no port (spec {spec!r})")
    if not pairs:
        raise ValueError(f"empty endpoint spec {spec!r}")
    return tuple(pairs)


def resolve_endpoints(addr, port=None) -> Endpoints:
    """Normalize any accepted address form — :class:`Endpoints`, a list of
    pairs, a spec string, or the legacy ``(addr, port)`` — onto one shared
    stateful :class:`Endpoints` per distinct pair tuple."""
    if isinstance(addr, Endpoints):
        return addr
    if isinstance(addr, (list, tuple)):
        if len(addr) == 2 and isinstance(addr[0], str) and \
                not isinstance(addr[1], (list, tuple)):
            # a single legacy ("host", port) tuple, not a list of pairs
            return resolve_endpoints(addr[0], addr[1])
        pairs = tuple((str(h), int(p)) for h, p in addr)
    else:
        s = str(addr)
        if "," in s or ":" in s:
            pairs = parse_endpoint_spec(s, default_port=port)
        else:
            if port is None:
                raise ValueError(f"address {s!r} needs a port")
            pairs = ((s, int(port)),)
    with _ENDPOINT_CACHE_LOCK:
        eps = _ENDPOINT_CACHE.get(pairs)
        if eps is None:
            if len(_ENDPOINT_CACHE) > 512:   # test churn bound, not LRU
                _ENDPOINT_CACHE.clear()
            eps = _ENDPOINT_CACHE[pairs] = Endpoints(pairs)
    return eps


def _url(host: str, port: int, scope: str, key: str) -> str:
    return f"http://{host}:{port}/{scope}/{key}"


def _sweep(eps: Endpoints, method: str, scope: str, key: str,
           data: Optional[bytes] = None,
           per_request_timeout: float = DEFAULT_PER_REQUEST_TIMEOUT,
           deadline: Optional[float] = None, op: str = "kv",
           prior_failure: bool = False) -> bytes:
    """One failover pass over the endpoint set.

    - 2xx: returns the body; counts ``hvd_tpu_kv_failover_total`` when an
      earlier endpoint failed or redirected this sweep.
    - 404: raises :class:`_KeyMissing` (the key is absent on a LIVE
      endpoint — callers long-poll, never fail over on it).
    - 429: raises :class:`KVBackpressure`.
    - 409 + X-KV-Not-Primary: follows the standby's primary hint (epoch-
      aware) within the same sweep.
    - 503 (mid-promotion / no quorum): retryable — moves on.
    - other HTTP errors: propagate (the server processed and refused).
    - transport errors: breaker-recorded, move to the next endpoint.

    Raises :class:`_SweepFailed` (an OSError) when every endpoint failed.
    """
    last_err: Optional[BaseException] = None
    failed_over = False
    followed = set()
    order = eps.candidates()
    k = 0
    while k < len(order):
        i = order[k]
        k += 1
        host, port = eps.pairs[i]
        timeout = per_request_timeout
        if deadline is not None:
            timeout = max(min(per_request_timeout,
                              deadline - time.monotonic()), 0.1)
        req = urllib.request.Request(_url(host, port, scope, key),
                                     data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                eps.record_success(i, prefer=False)
                raise _KeyMissing(e)
            if e.code == BACKPRESSURE_STATUS:
                try:
                    retry_after = float(e.headers.get("Retry-After") or 1.0)
                except ValueError:
                    retry_after = 1.0
                raise KVBackpressure(scope, retry_after)
            if e.code == NOT_PRIMARY_STATUS and \
                    e.headers.get("X-KV-Not-Primary"):
                failed_over = True
                last_err = e
                try:
                    info = json.loads(e.read() or b"{}")
                except Exception:
                    info = {}
                j = eps.record_redirect(info.get("primary", ""),
                                        int(info.get("epoch", 0) or 0))
                if j is not None and j not in followed:
                    followed.add(j)
                    if j in order[k:]:
                        order.remove(j)     # pull the pending hint forward
                    if j not in order[:k]:
                        order.insert(k, j)  # try the hinted primary next
                continue
            if e.code == 503:
                failed_over = True
                last_err = e
                continue
            raise
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            failed_over = True
            last_err = e
            eps.record_failure(i, op=op)
            continue
        eps.record_success(i, prefer=(method != "GET"))
        if (failed_over or prior_failure) and len(eps) > 1:
            # counted when the operation succeeded only after an endpoint
            # failure/redirect — within this sweep or (prior_failure) on
            # an earlier sweep of the same logical operation
            from ..metrics import registry as metrics_registry
            metrics_registry().counter("hvd_tpu_kv_failover_total").inc(op=op)
        return body
    raise _SweepFailed(
        f"every endpoint of {eps.spec} failed for {method} {scope}/{key}: "
        f"{last_err}")


def read_data_from_kvstore(addr, port, scope: str, key: str,
                           timeout: float = 60.0,
                           poll_interval: float = 0.2,
                           per_request_timeout: float =
                           DEFAULT_PER_REQUEST_TIMEOUT) -> bytes:
    """GET with long-poll semantics: retries on 404 until ``timeout``
    (the reference's workers block until the launcher publishes the key).
    Each request's socket timeout is ``min(per_request_timeout,
    remaining)`` so a hung connection is abandoned and retried instead of
    consuming the entire deadline; with an endpoint set, each poll sweeps
    the replicas (standbys serve reads), so a dead primary costs one
    transport error, not the deadline."""
    eps = resolve_endpoints(addr, port)
    deadline = time.monotonic() + timeout
    last_err: Optional[BaseException] = None
    had_failure = False
    while time.monotonic() < deadline:
        try:
            failpoint("kv.read")
            return _sweep(eps, "GET", scope, key,
                          per_request_timeout=per_request_timeout,
                          deadline=deadline, op="read",
                          prior_failure=had_failure)
        except _KeyMissing as e:
            last_err = e.err
        except _SweepFailed as e:
            had_failure = True
            last_err = e
        except urllib.error.HTTPError:
            raise
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            had_failure = True
            last_err = e
        time.sleep(poll_interval)
    raise TimeoutError(
        f"KV store read {scope}/{key} from {eps.spec} timed out "
        f"after {timeout}s: {last_err}")


def fetch_server_clock(addr, port=None, timeout: float = 5.0) -> tuple:
    """One clock-alignment beacon against the KV server's ``GET /clock``:
    returns ``(local_monotonic_midpoint, server_wall_ts, rtt)``. The
    server stamps its wall clock while the request is in flight, so
    pairing it with the local monotonic midpoint bounds the offset error
    by rtt/2 — the same server-stamped-clock discipline the stall
    inspector's skew-safe heartbeat staleness uses. The trace merger picks
    each rank's minimum-rtt beacon (trace.clock_offset).

    With an endpoint set the beacon comes from the first live replica —
    replicas run on different hosts with different wall clocks, so the
    merger's min-rtt selection naturally favors the stable one
    (docs/control_plane.md)."""
    eps = resolve_endpoints(addr, port)
    last_err: Optional[BaseException] = None
    for i in eps.candidates():
        host, p = eps.pairs[i]
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(f"http://{host}:{p}/clock",
                                        timeout=timeout) as resp:
                payload = json.loads(resp.read())
        except Exception as e:
            last_err = e
            eps.record_failure(i, op="clock")
            continue
        t1 = time.monotonic()
        eps.record_success(i, prefer=False)
        return ((t0 + t1) / 2.0, float(payload["ts"]), t1 - t0)
    raise _SweepFailed(f"no endpoint of {eps.spec} served a clock beacon: "
                       f"{last_err}")


def delete_data_from_kvstore(addr, port, scope: str, key: str,
                             timeout: float = 10.0) -> None:
    """Idempotent DELETE of one key (checkpoint GC drops stale shard
    chunks from the KV). A 404 — already gone — is success."""
    eps = resolve_endpoints(addr, port)
    deadline = time.monotonic() + timeout
    try:
        _sweep(eps, "DELETE", scope, key, deadline=deadline,
               per_request_timeout=min(DEFAULT_PER_REQUEST_TIMEOUT, timeout),
               op="delete")
    except _KeyMissing:
        pass


# ---------------------------------------------------------------------------
# Chunked large-value transfer: checkpoint shards are orders of
# magnitude bigger than any control-plane value — one multi-hundred-MB PUT
# would ride a single socket write against the capped per-request timeout.
# Values are split into fixed-size chunk keys (``<key>.c<i>``) with a meta
# record under the bare key written LAST, so a reader that sees the meta
# can fetch every chunk; the sha256 in the meta catches torn interleavings
# of two racing writers (the reader retries until a consistent set lands).
# ---------------------------------------------------------------------------

DEFAULT_KV_CHUNK_BYTES = 4 * 1024 * 1024


def put_large_value(addr, port, scope: str, key: str,
                    value: bytes, chunk_bytes: int = DEFAULT_KV_CHUNK_BYTES,
                    timeout: float = 60.0) -> int:
    """Chunked PUT: writes ``ceil(len/chunk_bytes)`` chunk keys then the
    meta record. Returns the number of chunks written."""
    import hashlib
    chunk_bytes = max(int(chunk_bytes), 1)
    n = max(1, -(-len(value) // chunk_bytes))
    for i in range(n):
        put_data_into_kvstore(addr, port, scope, f"{key}.c{i}",
                              value[i * chunk_bytes:(i + 1) * chunk_bytes],
                              timeout=timeout)
    meta = {"chunks": n, "bytes": len(value),
            "sha256": hashlib.sha256(value).hexdigest(),
            "chunk_bytes": chunk_bytes}
    put_data_into_kvstore(addr, port, scope, key,
                          json.dumps(meta).encode(), timeout=timeout)
    return n


def read_large_value(addr, port, scope: str, key: str,
                     timeout: float = 60.0) -> bytes:
    """Chunked GET: long-polls the meta record (the writer publishes it
    last), fetches every chunk, and verifies the meta's sha256 —
    retrying inside the deadline on a torn read (a concurrent re-write
    of the same key)."""
    import hashlib
    deadline = time.monotonic() + timeout
    last_err: Optional[Exception] = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            eps = resolve_endpoints(addr, port)
            raise TimeoutError(
                f"chunked KV read {scope}/{key} from {eps.spec} timed "
                f"out after {timeout}s: {last_err}")
        try:
            meta = json.loads(read_data_from_kvstore(
                addr, port, scope, key, timeout=remaining))
            parts = [read_data_from_kvstore(
                addr, port, scope, f"{key}.c{i}",
                timeout=max(deadline - time.monotonic(), 0.1))
                for i in range(int(meta["chunks"]))]
            value = b"".join(parts)
            if len(value) == int(meta["bytes"]) and \
                    hashlib.sha256(value).hexdigest() == meta["sha256"]:
                return value
            last_err = ValueError(
                f"chunk set inconsistent with meta ({len(value)} bytes)")
        except TimeoutError:
            raise
        except Exception as e:
            last_err = e
        time.sleep(0.1)


def delete_large_value(addr, port, scope: str, key: str,
                       timeout: float = 10.0) -> None:
    """Chunked DELETE: remove the meta first (hides the value from
    readers), then the chunks. Best-effort on an absent/garbled meta —
    GC must be idempotent."""
    chunks = 0
    try:
        meta = json.loads(read_data_from_kvstore(addr, port, scope, key,
                                                 timeout=1.0,
                                                 poll_interval=0.05))
        chunks = int(meta.get("chunks", 0))
    except Exception:
        pass
    delete_data_from_kvstore(addr, port, scope, key, timeout=timeout)
    for i in range(chunks):
        delete_data_from_kvstore(addr, port, scope, f"{key}.c{i}",
                                 timeout=timeout)


def put_data_into_kvstore(addr, port, scope: str, key: str,
                          value: bytes, timeout: float = 60.0,
                          retries: int = 3,
                          per_request_timeout: float =
                          DEFAULT_PER_REQUEST_TIMEOUT) -> None:
    """PUT with bounded retries (exponential backoff + jitter) inside the
    ``timeout`` deadline. KV writes are idempotent (last-writer-wins per
    key), so re-submission is always safe. Each attempt's socket timeout
    is capped like the read path — a hung server connection costs one
    capped attempt, not the whole deadline. ``retries`` is the number of
    re-attempts after the first try; 0 is a true one-shot (no retry
    machinery, no give-up counter — callers that layer their own
    ``retrying()`` on top use this to keep the abandoned-operation
    counters honest). Retry/give-up counters are labeled with the scope.

    With a multi-endpoint set, each attempt is a full failover sweep
    (standbys redirect to their primary hint), and the attempt budget is
    widened to pace the deadline — a promotion takes a lease timeout, and
    an acked write must be able to wait it out mid-deadline rather than
    exhausting three quick attempts before the standby takes over.

    Raises :class:`KVBackpressure` — without retrying — when the server
    answers ``429`` (per-scope byte budget): the caller decides whether
    to shed (telemetry publishers) or surface (everything else)."""
    if isinstance(value, str):
        value = value.encode()
    eps = resolve_endpoints(addr, port)
    t_end = time.monotonic() + timeout
    state = {"had_failure": False}

    def _attempt():
        if failpoint("kv.put") is DROP:
            return
        try:
            _sweep(eps, "PUT", scope, key, data=value,
                   per_request_timeout=per_request_timeout, deadline=t_end,
                   op=f"put:{scope}",
                   prior_failure=state["had_failure"])
        except _SweepFailed:
            state["had_failure"] = True
            raise

    if retries <= 0:
        _attempt()
        return
    attempts = retries + 1
    if len(eps) > 1:
        # failover patience: enough deadline-paced attempts to ride out a
        # standby promotion (retrying() stops at the deadline regardless)
        attempts = max(attempts, min(int(timeout / 0.5) + 1, 32))
    retrying(_attempt, attempts=attempts, deadline=timeout,
             op=f"put:{scope}")
