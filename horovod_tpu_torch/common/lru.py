"""LRU helpers over plain (insertion-ordered) dicts.

A copy of ``horovod_tpu/common/lru.py``: the port's bounded caches (step
replay's per-signature table) use it as the reference's do, the role of
the reference's LRU response cache bookkeeping
(common/response_cache.h:45-102). Plain-dict + pop/reinsert keeps each
operation a single atomic-under-the-GIL dict call, so a cache shared
between threads degrades to a miss/no-op under concurrent invalidation,
never a KeyError.
"""

from __future__ import annotations

_MISSING = object()


def lru_get(cache: dict, key, default=None):
    """Fetch + MRU-touch; ``default`` on miss."""
    val = cache.pop(key, _MISSING)
    if val is _MISSING:
        return default
    cache[key] = val
    return val


def lru_put(cache: dict, key, val, cap: int):
    """Insert as MRU, evicting the LRU entry when growing past ``cap``.
    Overwriting an existing key never evicts an unrelated entry."""
    if key not in cache and len(cache) >= max(cap, 1):
        # len+iter+pop is NOT one atomic dict op: a concurrent invalidation
        # (the engine cycle thread pops meta-cache entries) can land
        # between iter() and next() (RuntimeError) or empty the dict first
        # (StopIteration). Degrade to skipping the eviction — one entry
        # over cap beats crashing the training step.
        try:
            cache.pop(next(iter(cache)), None)
        except (StopIteration, RuntimeError):
            pass
    cache.pop(key, None)
    cache[key] = val
    return val


def lru_touch(cache: dict, key, val):
    """Re-insert ``key`` as MRU (no capacity check). Tolerates the entry
    having been concurrently removed."""
    cache.pop(key, None)
    cache[key] = val
