"""Training meshes over the world's ranks, and the world's topology.

The port's counterpart of ``horovod_tpu/parallel/mesh.py``:

- :func:`training_mesh` (the reference's :381), for the eager, per-process
  form of the port: a mesh is the world's ranks laid out on named axes,
  row-major in the order of the dict (the reference's device order), with
  one ``torch.distributed`` process group for each line of ranks along an
  axis of size > 1. A rank's group on an axis is what the reference names
  by the axis inside ``shard_map``.
- :class:`Topology` and :func:`detect_topology` (the reference's :53-195,
  :288-351): how many ranks share one fast-fabric island (the ranks of an
  NVLink box on the card; the reference's ICI slice), resolved once a world
  and read by the collective algorithm selection (``ops/collectives.py``
  ``choose_algorithm``). The reference's ``MeasuredTopology`` and its
  calibration probe wait for ROADMAP A15.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..common import env as env_mod

DATA_AXIS = "data"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"

logger = logging.getLogger("horovod_tpu_torch")

# Nominal per-participant link rates in GB/s, (fast fabric, slow fabric),
# by platform: the reference's order-of-magnitude figures for the selection
# layer and the roofline (its ``gpu`` and ``cpu`` rows; not measured
# here). The card is ``gpu``, gloo worlds are ``cpu``.
_NOMINAL_LINK_GBPS = {
    "gpu": (50.0, 12.5),   # NVLink-class against a host NIC
    "cpu": (8.0, 1.0),     # test worlds: the 1:8 shape
}


@dataclasses.dataclass(frozen=True)
class Topology:
    """The world's fabric, resolved once an engine (the reference's
    ``Topology``): ``local_size`` ranks share one fast-fabric island (the
    reference's ICI slice; an NVLink box here) and ``size / local_size``
    islands talk over the slow fabric (the reference's DCN). Ranks are
    laid out island by island: island c holds ranks ``[c·local_size,
    (c+1)·local_size)`` (``ops/collectives.py`` ``slice_groups``)."""

    size: int
    local_size: int = 1
    platform: str = "cpu"
    source: str = "flat"       # "override" | "process" | "hosts" | "flat"
    ici_gbps: float = _NOMINAL_LINK_GBPS["cpu"][0]
    dcn_gbps: float = _NOMINAL_LINK_GBPS["cpu"][1]

    @property
    def num_slices(self) -> int:
        return max(1, self.size // max(self.local_size, 1))

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1 and self.local_size > 1

    @property
    def hierarchical_ok(self) -> bool:
        """Whether the (cross, local) decomposition is non-trivial and
        exact: more than one rank an island, more than one island, a
        divisible world."""
        return (1 < self.local_size < self.size
                and self.size % self.local_size == 0)

    def local_groups(self) -> List[List[int]]:
        """The ranks of each island (``slice_groups``' rule: the layout
        every two-level collective shares)."""
        from ..ops.collectives import slice_groups
        return slice_groups(self.size, self.local_size)[0]

    def cross_groups(self) -> List[List[int]]:
        """The ranks at one local index across the islands."""
        from ..ops.collectives import slice_groups
        return slice_groups(self.size, self.local_size)[1]

    def roofline_busbw_gbps(self, kind: str = "allreduce",
                            algo: str = "flat") -> float:
        """Nominal bus-bandwidth ceiling in GB/s of one collective under
        ``algo`` (the reference's :117-161): the flat ring is paced by the
        slow fabric when the world spans islands; the hierarchical
        allreduce's cross leg carries 1/local_size of the payload; the
        hierarchical allgather moves every byte across; the hierarchical
        alltoall's cross leg moves (C-1)/C of it; each tree round moves the
        whole payload (divided by log2 n)."""
        n = max(self.size, 1)
        if n <= 1:
            return float("inf")
        if kind == "alltoall":
            if algo == "hierarchical" and self.hierarchical_ok:
                c = self.num_slices
                if c <= 1:
                    return self.ici_gbps
                factor = ((n - 1) / n) / ((c - 1) / c)
                return min(self.ici_gbps, self.dcn_gbps * factor)
            return self.dcn_gbps if self.is_multislice else self.ici_gbps
        if algo == "hierarchical" and self.hierarchical_ok:
            if kind == "allgather":
                return min(self.ici_gbps, self.dcn_gbps)
            return min(self.ici_gbps, self.dcn_gbps * self.local_size)
        base = self.dcn_gbps if self.is_multislice else self.ici_gbps
        if algo == "tree":
            return base / max(math.log2(n), 1.0)
        return base

    def describe(self) -> dict:
        return {"size": self.size, "local_size": self.local_size,
                "num_slices": self.num_slices, "platform": self.platform,
                "source": self.source, "ici_gbps": self.ici_gbps,
                "dcn_gbps": self.dcn_gbps,
                "hierarchical_ok": self.hierarchical_ok}

    def digest(self) -> str:
        """Identity of the fabric's shape (size, local size, islands,
        platform), not of its rates or of how it was found."""
        text = f"{self.size}|{self.local_size}|{self.num_slices}|" \
               f"{self.platform}"
        return hashlib.sha256(text.encode()).hexdigest()

    @property
    def calibrated(self) -> bool:
        """False: the link table is nominal (``MeasuredTopology``, the
        calibrated one, waits for ROADMAP A15)."""
        return False


def _host_local_size(hosts: Sequence) -> Tuple[int, str]:
    """Ranks an island from each rank's host identity (the counterpart of
    the reference's ``process_index`` probe, :262-285): the ranks of one
    host when every host holds as many and each host's ranks are
    contiguous (``slice_groups``' layout); one island otherwise."""
    n = len(hosts)
    counts: Dict = {}
    for h in hosts:
        counts[h] = counts.get(h, 0) + 1
    sizes = set(counts.values())
    if len(counts) <= 1 or len(sizes) != 1:
        return 1, "flat"
    local = sizes.pop()
    if any(hosts[r] != hosts[(r // local) * local] for r in range(n)):
        return 1, "flat"
    return local, "hosts"


def detect_topology(size: int, local_size: Optional[int] = None,
                    hosts: Optional[Sequence] = None,
                    platform: str = "cpu") -> Topology:
    """The world's :class:`Topology` (the reference's :288-351).

    Precedence for ``local_size`` (ranks an island):

    1. ``HOROVOD_TPU_LOCAL_SIZE``, the override;
    2. the ``local_size`` argument when above 1 (the engine passes the
       launcher's ``HOROVOD_LOCAL_SIZE``);
    3. ``hosts``, each rank's host identity (gathered once at init):
       uniform, contiguous groups of ranks on one host;
    4. flat (one island).

    A ``local_size`` that does not divide the world falls back to the
    largest divisor below it, with a warning; ``hierarchical_ok`` says
    whether the result has a two-level form. On one box every rank shares
    a host, so a single-node world stays one island unless the override
    says otherwise."""
    override = os.environ.get(env_mod.HOROVOD_TPU_LOCAL_SIZE)
    source = "flat"
    parsed = None
    if override:
        try:
            parsed = int(override)
        except ValueError:
            logger.warning("HOROVOD_TPU_LOCAL_SIZE=%r is not an int; "
                           "ignoring the override", override)
    if parsed is not None:
        local_size, source = parsed, "override"
    elif local_size is not None and local_size > 1:
        source = "process"
    elif hosts is not None:
        local_size, source = _host_local_size(hosts)
    else:
        local_size = 1
    local_size = max(1, min(int(local_size), int(size)))
    if size % local_size != 0:
        fallback = max(d for d in range(1, local_size + 1)
                       if size % d == 0)
        logger.warning(
            "topology: local_size %d does not divide world size %d; "
            "falling back to local_size=%d (hierarchical collectives "
            "demote to flat when no non-trivial divisor exists)",
            local_size, size, fallback)
        local_size = fallback
    ici, dcn = _NOMINAL_LINK_GBPS.get(platform, _NOMINAL_LINK_GBPS["cpu"])
    return Topology(size=int(size), local_size=int(local_size),
                    platform=platform, source=source,
                    ici_gbps=ici, dcn_gbps=dcn)


@dataclasses.dataclass(frozen=True)
class TrainingMesh:
    """This rank's view of a mesh: the axes in major order, their sizes,
    this rank's index on each, and its process group on each axis of size
    > 1 (None on an axis of size 1)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    index: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups.get(axis)


def training_mesh(axis_sizes: dict) -> TrainingMesh:
    """N-D training mesh over every rank, e.g. ``{"data": 2, "seq": 2}``.

    One axis may be -1 and takes the ranks that are left. Every rank must
    call this with the same argument: it creates every axis group, in the
    same order on every rank (``dist.new_group`` is collective). The
    tensor axis is not ported: ``tensor > 1`` raises."""
    if not dist.is_initialized():
        raise RuntimeError("training_mesh needs an initialized world: call "
                           "hvd.init() first")
    n = dist.get_world_size()
    names = tuple(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("only one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    shape = dict(zip(names, sizes))
    if shape.get(TENSOR_AXIS, 1) > 1:
        raise NotImplementedError(
            "tensor parallelism is not ported to horovod_tpu_torch yet "
            "(ROADMAP A16): use a tensor axis of size 1")
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {shape} needs {math.prod(sizes)} ranks, "
                         f"have {n}")
    grid = np.arange(n).reshape(sizes)
    me = dist.get_rank()
    coords = dict(zip(names, (int(c) for c in np.argwhere(grid == me)[0])))
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for axis, name in enumerate(names):
        groups[name] = None
        if sizes[axis] == 1:
            continue
        # every line of ranks along this axis, in one order on every rank
        lines = np.moveaxis(grid, axis, -1).reshape(-1, sizes[axis])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = group
    return TrainingMesh(names, shape, coords, groups)
