"""Shared bounded-retry helper for the control-plane transports (the
port's copy of ``horovod_tpu/common/retry.py``; its caller is the
rendezvous KV client's PUT, ``runner/http_client.py``).

:func:`retrying` is the one policy every control-plane write shares: bounded attempts, exponential backoff with jitter, deadline-aware,
and registry-counted (``hvd_tpu_kv_retries_total`` per retried attempt,
``hvd_tpu_kv_gave_up_total`` on final failure, both labeled ``op``).

Data-plane code (engine dispatch) must NOT use this: a collective that
failed has desynchronized the world and is only recoverable through the
elastic reset path, never by re-submission.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger("horovod_tpu_torch")

# urllib surfaces everything transport-shaped as an OSError subclass
# (URLError, HTTPError, ConnectionError, socket.timeout); TimeoutError is
# an OSError too since 3.10 but listed for older trees.
DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (OSError, TimeoutError)


def backoff_delays(attempts: int, base_delay: float, max_delay: float,
                   jitter: float, seed: Optional[random.Random] = None):
    """The delay schedule between attempts: ``base * 2^i`` capped at
    ``max_delay``, each multiplied by ``1 ± jitter`` (decorrelates a
    thundering herd of workers retrying the same dead server)."""
    rng = seed or random
    for i in range(max(attempts - 1, 0)):
        d = min(base_delay * (2.0 ** i), max_delay)
        yield d * (1.0 + jitter * (2.0 * rng.random() - 1.0))


def retrying(fn: Callable, *, attempts: int = 4, base_delay: float = 0.05,
             max_delay: float = 2.0, deadline: Optional[float] = None,
             jitter: float = 0.5,
             retry_on: Tuple[Type[BaseException], ...] = DEFAULT_RETRY_ON,
             op: str = "kv", log_level: int = logging.DEBUG):
    """Call ``fn()`` with bounded retries.

    - ``attempts``: total tries (first call included).
    - ``base_delay``/``max_delay``/``jitter``: exponential backoff schedule.
    - ``deadline``: overall wall-clock budget in seconds; no retry starts
      past it (the attempt in flight is not interrupted).
    - ``retry_on``: exception classes worth retrying; anything else
      propagates immediately.
    - ``op``: label for the retry/give-up counters (use the KV scope or a
      short operation name — ``"stall"``, ``"reregister"``...).

    Returns ``fn()``'s value. On final failure re-raises the last error
    after incrementing ``hvd_tpu_kv_gave_up_total{op=...}``.
    """
    from ..metrics import registry as metrics_registry
    reg = metrics_registry()
    t_end = None if deadline is None else time.monotonic() + deadline
    delays = backoff_delays(attempts, base_delay, max_delay, jitter)
    last_err: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            last_err = e
            delay = next(delays, None)
            out_of_time = (t_end is not None and
                           time.monotonic() + (delay or 0) >= t_end)
            if delay is None or out_of_time:
                break
            reg.counter("hvd_tpu_kv_retries_total").inc(op=op)
            logger.log(log_level,
                       "%s failed (attempt %d/%d): %s; retrying in %.2fs",
                       op, attempt + 1, attempts, e, delay)
            time.sleep(delay)
    reg.counter("hvd_tpu_kv_gave_up_total").inc(op=op)
    assert last_err is not None
    raise last_err
