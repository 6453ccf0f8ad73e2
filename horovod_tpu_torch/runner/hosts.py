"""Host/slot parsing and rank assignment.

The port's copy of ``horovod_tpu/runner/hosts.py``, line for line: plain
Python, no torch.

Parity: reference ``horovod/runner/common/util/hosts.py`` (parse_hosts at
hosts.py:~30, get_host_assignments → SlotInfo{rank, local_rank, cross_rank,
sizes} at hosts.py:106-155). The semantics we preserve:

- hosts are given as ``"host1:4,host2:4"`` (slots optional, default 1);
- ranks are assigned host-major in the given host order, so local ranks are
  contiguous per host;
- ``cross_rank`` is the index of the host among hosts that have a slot at the
  same ``local_rank`` — the topology the hierarchical collectives key off
  (reference controller.h:119-127).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(spec: str) -> "HostInfo":
        spec = spec.strip()
        if ":" in spec:
            host, slots = spec.rsplit(":", 1)
            return HostInfo(host, int(slots))
        return HostInfo(spec, 1)


@dataclass
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_response_string(self) -> str:
        return ":".join(str(v) for v in
                        (self.hostname, self.rank, self.local_rank,
                         self.cross_rank, self.size, self.local_size,
                         self.cross_size))

    @staticmethod
    def from_response_string(s: str) -> "SlotInfo":
        hostname, rank, local_rank, cross_rank, size, local_size, cross_size = \
            s.rsplit(":", 6)
        return SlotInfo(hostname, int(rank), int(local_rank), int(cross_rank),
                        int(size), int(local_size), int(cross_size))


INVALID_SLOT_INFO = SlotInfo("", -1, -1, -1, -1, -1, -1)


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """``"a:2,b:2"`` → [HostInfo(a,2), HostInfo(b,2)]."""
    return [HostInfo.from_string(s)
            for s in hosts_string.split(",") if s.strip()]


def parse_host_files(filename: str) -> List[HostInfo]:
    """One ``host slots=N`` or ``host:N`` per line (mpirun hostfile style)."""
    infos = []
    with open(filename) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "slots=" in line:
                host, _, rest = line.partition("slots=")
                infos.append(HostInfo(host.strip(), int(rest.split()[0])))
            else:
                infos.append(HostInfo.from_string(line))
    return infos


def get_host_assignments(hosts: List[HostInfo], min_np: int,
                         max_np: Optional[int] = None) -> List[SlotInfo]:
    """Assign ranks host-major over the available slots.

    Raises if fewer than ``min_np`` slots exist; caps at ``max_np`` when given
    (elastic mode). Mirrors reference hosts.py:106-155.
    """
    total = sum(h.slots for h in hosts)
    if total < min_np:
        raise ValueError(
            f"Requested {min_np} processes but only {total} slots available "
            f"on hosts {[h.hostname for h in hosts]}")
    np_ = total if max_np is None else min(total, max_np)
    np_ = max(np_, min_np)

    # rank assignment: host-major
    assignments: List[SlotInfo] = []
    rank = 0
    local_sizes: Dict[str, int] = {}
    for h in hosts:
        take = min(h.slots, np_ - rank)
        if take <= 0:
            break
        local_sizes[h.hostname] = take
        for local_rank in range(take):
            assignments.append(SlotInfo(h.hostname, rank, local_rank,
                                        cross_rank=-1, size=np_,
                                        local_size=take, cross_size=-1))
            rank += 1
    # cross topology: for each local_rank, the set of hosts owning that slot
    by_local: Dict[int, List[SlotInfo]] = {}
    for s in assignments:
        by_local.setdefault(s.local_rank, []).append(s)
    host_order = [h.hostname for h in hosts if h.hostname in local_sizes]
    for local_rank, slots in by_local.items():
        slots.sort(key=lambda s: host_order.index(s.hostname))
        for i, s in enumerate(slots):
            s.cross_rank = i
            s.cross_size = len(slots)
    return assignments
