"""Host discovery for elastic training.

The port's copy of ``horovod_tpu/elastic/discovery.py``, line for line:
plain Python, no torch.

Parity: reference ``horovod/runner/elastic/discovery.py`` —
``HostDiscoveryScript`` (user script → host:slots map, discovery.py:130-152),
``FixedHosts`` (discovery.py:155), and ``HostManager`` with blacklisting and
stable host ordering (discovery.py:79-121).

Discovery is pure control-plane Python; nothing here touches the
device. The driver polls ``HostManager.update_available_hosts()`` and rebuilds
the mesh/world only when membership actually changes.
"""

from __future__ import annotations

import logging
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

from ..common.retry import retrying
from ..faults import DROP, failpoint
from ..metrics import registry as metrics_registry
from ..runner.hosts import HostInfo

_LOG = logging.getLogger("horovod_tpu_torch.elastic")

# Discovery-probe retry schedule: a flaky discovery
# script gets a few bounded-backoff attempts before the manager falls
# back to its last-known-good snapshot.
DISCOVERY_RETRY_ATTEMPTS = 3
DISCOVERY_RETRY_BASE_DELAY = 0.1
DISCOVERY_RETRY_MAX_DELAY = 1.0


class HostUpdateResult:
    """Bitmask describing what changed in a membership update
    (reference discovery.py HostUpdateResult)."""
    NO_UPDATE = 0
    ADDED = 1
    REMOVED = 2
    MIXED = ADDED | REMOVED


class HostDiscovery:
    """Abstract source of current cluster membership."""

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """Return {hostname: slots} for every currently-usable host."""
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Runs a user script that prints one ``host:slots`` (or bare ``host``)
    per line (reference discovery.py:130-152). A default slot count is used
    for bare hostnames."""

    def __init__(self, discovery_script: str, default_slots: int = 1):
        self._script = discovery_script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.check_output(self._script, shell=True,
                                      stderr=subprocess.DEVNULL)
        hosts: Dict[str, int] = {}
        for line in out.decode().splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                host, _, slots = line.rpartition(":")
                hosts[host] = int(slots)
            else:
                hosts[line] = self._default_slots
        return hosts


class FixedHosts(HostDiscovery):
    """A settable, static membership — the unit-test seam
    (reference discovery.py:155-164)."""

    def __init__(self, available_hosts: Optional[Dict[str, int]] = None):
        self._hosts = dict(available_hosts or {})

    def set(self, available_hosts: Dict[str, int]):
        self._hosts = dict(available_hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class HostManager:
    """Tracks current membership, preserves host seniority order, and
    maintains the blacklist (reference discovery.py:79-121).

    Ordering contract: hosts are ordered by the round in which they first
    appeared (oldest first), so rank assignment is stable across updates and
    rank 0 lives on the longest-surviving host — the host whose state is used
    for recovery sync (reference common/elastic.py:137-144).
    """

    def __init__(self, discovery: HostDiscovery):
        self._discovery = discovery
        self._lock = threading.Lock()
        self._current: Dict[str, int] = {}
        self._order: List[str] = []          # seniority order
        self._blacklist: set = set()

    # -- membership ---------------------------------------------------------

    def update_available_hosts(self) -> int:
        """Poll discovery; returns a HostUpdateResult bitmask.

        Discovery hardening: a failing discovery
        script/callable used to propagate — killing the driver's resume
        path (``wait_for_available_slots`` calls this uncaught). Now the
        probe gets bounded-backoff retries; on final failure the manager
        serves its last-known-good snapshot (``NO_UPDATE``) with a
        WARNING and ``hvd_tpu_discovery_failures_total``, and the driver
        keeps running on stale-but-sane membership."""
        def _probe():
            if failpoint("driver.discovery") is DROP:
                raise RuntimeError("injected: driver.discovery drop")
            return self._discovery.find_available_hosts_and_slots()

        try:
            found = retrying(_probe, attempts=DISCOVERY_RETRY_ATTEMPTS,
                             base_delay=DISCOVERY_RETRY_BASE_DELAY,
                             max_delay=DISCOVERY_RETRY_MAX_DELAY,
                             retry_on=(Exception,), op="discovery")
        except Exception as e:
            with self._lock:
                stale = len(self._current)
            metrics_registry().counter(
                "hvd_tpu_discovery_failures_total").inc()
            _LOG.warning(
                "host discovery failed after %d attempts (%s); serving "
                "the last-known-good membership snapshot (%d host(s)) — "
                "STALE until discovery recovers",
                DISCOVERY_RETRY_ATTEMPTS, e, stale)
            return HostUpdateResult.NO_UPDATE
        with self._lock:
            usable = {h: s for h, s in found.items()
                      if h not in self._blacklist}
            prev = set(self._current)
            cur = set(usable)
            res = HostUpdateResult.NO_UPDATE
            if cur - prev:
                res |= HostUpdateResult.ADDED
            if prev - cur:
                res |= HostUpdateResult.REMOVED
            # slot-count changes on an existing host count as MIXED
            for h in cur & prev:
                if usable[h] != self._current[h]:
                    res |= HostUpdateResult.MIXED
            self._current = usable
            for h in usable:
                if h not in self._order:
                    self._order.append(h)
            self._order = [h for h in self._order if h in usable]
            return res

    def current_hosts(self) -> List[HostInfo]:
        """Membership as ordered HostInfo list (seniority order)."""
        with self._lock:
            return [HostInfo(h, self._current[h]) for h in self._order]

    def available_slots(self) -> int:
        with self._lock:
            return sum(self._current.values())

    def state(self) -> Tuple[Dict[str, int], List[str], set]:
        """Consistent (current, order, blacklist) copy — the driver
        journal's host-delta payload."""
        with self._lock:
            return dict(self._current), list(self._order), \
                set(self._blacklist)

    def restore_state(self, current: Dict[str, int], order: List[str],
                      blacklist):
        """Install journaled host state (promotion path): the
        promoted driver re-runs discovery against the dead driver's
        membership view — seniority order and blacklist included, so
        rank 0 stays on the longest-surviving host."""
        with self._lock:
            self._blacklist = set(blacklist)
            self._current = {h: int(s) for h, s in current.items()
                             if h not in self._blacklist}
            self._order = [h for h in order if h in self._current]

    # -- blacklist ----------------------------------------------------------

    def blacklist(self, host: str):
        """Permanently exclude a failing host (reference
        discovery.py:25-46,102-108; driver.py:136-139)."""
        with self._lock:
            if host not in self._blacklist:
                _LOG.warning("blacklisting host %s", host)
            self._blacklist.add(host)
            self._current.pop(host, None)
            self._order = [h for h in self._order if h != host]

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            return host in self._blacklist

    @property
    def blacklisted_hosts(self) -> set:
        with self._lock:
            return set(self._blacklist)
