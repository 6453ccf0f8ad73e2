"""Training meshes over the world's ranks.

The port's counterpart of ``horovod_tpu/parallel/mesh.py:training_mesh``
(:381), for the eager, per-process form of the port: a mesh is the world's
ranks laid out on named axes, row-major in the order of the dict (the
reference's device order), with one ``torch.distributed`` process group
for each line of ranks along an axis of size > 1. A rank's group on an axis
is what the reference names by the axis inside ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"


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
