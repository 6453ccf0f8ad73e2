"""Training meshes over the world's ranks, and the world's topology.

The port's counterpart of ``horovod_tpu/parallel/mesh.py``:

- :func:`training_mesh` (the reference's :381), for the eager, per-process
  form of the port: a mesh is the world's ranks laid out on named axes,
  row-major in the order of the dict (the reference's device order), with
  one ``torch.distributed`` process group for each line of ranks along an
  axis of size > 1, and one for each line of every combination of such
  axes (``mesh.group(("data", "seq"))``, what a ``psum`` over a tuple of
  axes names inside the reference's ``shard_map``). A rank's group on an
  axis is what the reference names by the axis inside ``shard_map``.
- the mesh helpers (the reference's :354-464): :func:`world_mesh` (one
  ``world`` axis on the default group), :func:`hierarchical_mesh`
  (``(cross, local)``), :func:`multislice_mesh` (the slow-fabric axes
  major, the fast-fabric ones inside an island) and :func:`pp_dp_sp_mesh`.
- :func:`pipeline_boundary_edges` (the reference's :467): which stage
  boundaries of a pipeline cross islands, for the boundary codec; and a
  rank's neighbours on an axis (:meth:`TrainingMesh.neighbours`), the
  pipeline's previous and next stage on the ``pipe`` axis.
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
import itertools
import logging
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..common import env as env_mod

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"
WORLD_AXIS = "world"
CROSS_AXIS = "cross"   # between islands: the slow fabric
LOCAL_AXIS = "local"   # inside an island: NVLink on the card

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

    # -- mesh integration (the reference's :180-193) ------------------------

    def hierarchical_mesh(self) -> "TrainingMesh":
        """The ``(cross, local)`` mesh of this topology's islands."""
        return hierarchical_mesh(self.local_size)

    def multislice_mesh(self, dcn_axes: dict,
                        ici_axes: dict) -> "TrainingMesh":
        """:func:`multislice_mesh` checked against this topology's
        islands."""
        return multislice_mesh(dcn_axes, ici_axes, local_size=self.local_size)


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
    > 1 (None on an axis of size 1) and on each combination of them, keyed
    by the tuple of their names in the mesh's order."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    index: Dict[str, int]
    groups: Dict[object, Optional[dist.ProcessGroup]]

    def _axes(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for name in names:
            if name not in self.shape:
                raise ValueError(f"mesh {self.shape} has no axis {name!r}")
        return tuple(a for a in self.axis_names if a in names)

    def size(self, axes) -> int:
        """The axis's size (the product over a tuple of axes); 1 for an
        axis the mesh does not have."""
        if isinstance(axes, str):
            return self.shape.get(axes, 1)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def rank_in(self, axes) -> int:
        """This rank's index in its group on ``axes`` (row-major over a
        tuple of axes, in the mesh's order)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.index[a]
        return idx

    def global_rank(self, index: Dict[str, int]) -> int:
        """The world rank at ``index`` (an index on every axis; the mesh
        is the world's ranks row-major in the axes' order)."""
        rank = 0
        for a in self.axis_names:
            rank = rank * self.shape[a] + index[a] % self.shape[a]
        return rank

    def neighbours(self, axis: str) -> Tuple[int, int]:
        """The world ranks of this rank's previous and next rank on its
        line of ``axis``, cyclically (itself on an axis of size 1): a
        pipeline stage's neighbours on the ``pipe`` axis."""
        self._axes(axis)
        prv, nxt = dict(self.index), dict(self.index)
        prv[axis] -= 1
        nxt[axis] += 1
        return self.global_rank(prv), self.global_rank(nxt)

    def group(self, axes) -> Optional[dist.ProcessGroup]:
        """This rank's process group on ``axes`` (an axis name or a tuple
        of them): None where their sizes multiply to 1."""
        if isinstance(axes, str):
            return self.groups.get(axes)
        live = tuple(a for a in self._axes(axes) if self.shape[a] > 1)
        if not live:
            return None
        if len(live) == 1:
            return self.groups.get(live[0])
        return self.groups[live]


def _mesh(names, sizes, world_group: bool = False) -> TrainingMesh:
    """The :class:`TrainingMesh` of ``sizes`` over every rank, creating its
    groups (collective: every rank, one order). With ``world_group`` a
    single axis over the whole world takes the default group and nothing is
    created."""
    n = dist.get_world_size()
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} ranks, have {n}")
    grid = np.arange(n).reshape(sizes)
    me = dist.get_rank()
    coords = dict(zip(names, (int(c) for c in np.argwhere(grid == me)[0])))
    groups: Dict[object, Optional[dist.ProcessGroup]] = {
        name: None for name in names}
    if world_group and len(names) == 1:
        if n > 1:
            groups[names[0]] = dist.group.WORLD
        return TrainingMesh(tuple(names), dict(zip(names, sizes)), coords,
                            groups)
    live = [axis for axis, size in enumerate(sizes) if size > 1]
    # every axis of size > 1, then every combination of two or more of
    # them, each as all its lines of ranks, in one order on every rank
    combos = [(a,) for a in live] + [
        c for k in range(2, len(live) + 1)
        for c in itertools.combinations(live, k)]
    for combo in combos:
        rest = [a for a in range(len(sizes)) if a not in combo]
        span = math.prod(sizes[a] for a in combo)
        lines = np.transpose(grid, rest + list(combo)).reshape(-1, span)
        key = names[combo[0]] if len(combo) == 1 else tuple(
            names[a] for a in combo)
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if me in line:
                groups[key] = group
    return TrainingMesh(tuple(names), dict(zip(names, sizes)), coords,
                        groups)


def _require_world(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialized world: call "
                           "hvd.init() first")
    return dist.get_world_size()


def training_mesh(axis_sizes: dict) -> TrainingMesh:
    """N-D training mesh over every rank, e.g. ``{"data": 2, "seq": 2,
    "tensor": 2}``.

    One axis may be -1 and takes the ranks that are left. The dict's order
    is the mesh's major order: put the axis that should ride the slow
    fabric first and the most bandwidth-hungry one (tensor) last, so its
    lines are neighbouring ranks of one island. Every rank must call this
    with the same argument: it creates every group, in the same order on
    every rank (``dist.new_group`` is collective)."""
    n = _require_world("training_mesh")
    names = tuple(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("only one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    return _mesh(names, sizes)


def world_mesh() -> TrainingMesh:
    """1-D mesh over every rank, the global communicator: its one axis,
    ``world``, is the default process group, so no group is created and
    any rank may call it alone (``hvd.mesh()``)."""
    n = _require_world("world_mesh")
    return _mesh((WORLD_AXIS,), [n], world_group=True)


def _default_local_size() -> int:
    """Ranks an island of the running world: the engine's agreed topology
    when one is up, else the launcher's ``HOROVOD_LOCAL_SIZE``, else 1."""
    from ..core import state
    if state.global_state().engine is not None:
        return state.global_state().engine.topology.local_size
    try:
        return max(1, int(os.environ.get("HOROVOD_LOCAL_SIZE", "1")))
    except ValueError:
        return 1


def hierarchical_mesh(local_size: Optional[int] = None) -> TrainingMesh:
    """2-D ``(cross, local)`` mesh for hierarchical collectives: ``local``
    the ranks of one island (default: the running world's topology), in
    rank order, ``cross`` the islands. A ``local_size`` that does not divide
    the world falls back to the largest divisor below it (the reference's
    :373-377)."""
    n = _require_world("hierarchical_mesh")
    if local_size is None:
        local_size = _default_local_size()
    local_size = max(1, min(int(local_size), n))
    if n % local_size:
        local_size = max(d for d in range(1, local_size + 1) if n % d == 0)
    return _mesh((CROSS_AXIS, LOCAL_AXIS), [n // local_size, local_size])


def multislice_mesh(dcn_axes: dict, ici_axes: dict,
                    local_size: Optional[int] = None) -> TrainingMesh:
    """Fabric-aware mesh (the reference's :408): ``dcn_axes`` partition
    across islands (data or pipeline parallelism: the slow fabric between
    NVLink boxes), ``ici_axes`` within one (tensor, sequence, expert: the
    fast one). The slow axes are the major ones, so with ranks numbered
    island by island the fast axes' lines lie inside one island of
    ``local_size`` ranks (default: the running world's topology) whenever
    their product divides it; otherwise a warning says which axes cross
    islands. The axes keep the reference's order: the slow ones, then the
    fast ones."""
    names = tuple(dcn_axes) + tuple(ici_axes)
    if len(set(names)) != len(names):
        raise ValueError(f"an axis is named twice in {dcn_axes} and "
                         f"{ici_axes}")
    sizes = [int(v) for v in dcn_axes.values()] + [int(v) for v in
                                                  ici_axes.values()]
    n = _require_world("multislice_mesh")
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} ranks, have {n}")
    local = _default_local_size() if local_size is None else int(local_size)
    inner = math.prod(int(v) for v in ici_axes.values())
    if local > 1 and local % inner:
        logger.warning(
            "multislice_mesh: the fast-fabric axes %s span %d ranks, which "
            "do not divide an island of %d: their lines cross islands",
            dict(ici_axes), inner, local)
    return _mesh(names, sizes)


def pp_dp_sp_mesh(n_stages: int, data: int = -1,
                  seq: int = 1) -> TrainingMesh:
    """The pipeline x data x sequence composition mesh (the reference's
    :449): ``pipe`` outermost (stage boundaries are the fewest and most
    latency-tolerant transfers, one hop a tick, so the pipeline absorbs the
    slow fabric), ``data`` in the middle (-1 takes the ranks that are
    left), ``seq`` innermost, on the fastest links."""
    return training_mesh({"pipe": n_stages, "data": data, "seq": seq})


def pipeline_boundary_edges(topology: Topology, n_stages: int,
                            stage_size: Optional[int] = None
                            ) -> Tuple[bool, ...]:
    """Which boundaries of a pipeline's ring cross islands (the reference's
    :467): entry i is the boundary between stage i and stage (i+1) %
    n_stages. A stage owns ``stage_size`` consecutive ranks of the
    island-major layout (default size // n_stages: the
    :func:`pp_dp_sp_mesh` layout, each stage's data x seq block
    contiguous), and a boundary crosses when the two stages' blocks start
    on different islands. The ``coded_edges`` of the boundary codec
    (``parallel/pipeline.py``): only those hops are encoded."""
    p = n_stages
    g = stage_size if stage_size else max(1, topology.size // max(1, p))
    ls = max(1, topology.local_size)
    if ls <= 1 or ls >= topology.size:
        return tuple([False] * p)

    def island(s: int) -> int:
        return ((s % p) * g) // ls

    return tuple(island(i) != island(i + 1) for i in range(p))
