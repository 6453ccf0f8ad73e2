"""Parallelism beyond data parallelism, on ``torch.distributed`` groups.

- :mod:`.mesh` — training meshes: named axes over the world's ranks, one
  process group per line of an axis.
- :mod:`.flash_attention` — single-shard attention on kernel K6.
- :mod:`.ring_attention` — sequence parallelism by K/V rotation on kernel
  K7, contiguous or zig-zag layout.
- :mod:`.ulysses` — sequence parallelism by head/sequence all-to-all.
"""

from .mesh import TrainingMesh, training_mesh
from .flash_attention import flash_attention_local
from .ring_attention import (local_attention, ring_attention_p,
                             zigzag_indices, zigzag_pair_kinds)
from .ulysses import ulysses_attention_p

__all__ = [
    "TrainingMesh", "training_mesh", "flash_attention_local",
    "local_attention", "ring_attention_p", "zigzag_indices",
    "zigzag_pair_kinds", "ulysses_attention_p",
]
