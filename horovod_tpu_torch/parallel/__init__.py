"""Parallelism beyond data parallelism, on ``torch.distributed`` groups.

- :mod:`.mesh` — training meshes: named axes over the world's ranks, one
  process group per line of an axis (and of each combination of axes);
  the world, hierarchical, multislice and pipeline x data x sequence
  meshes.
- :mod:`.flash_attention` — single-shard attention on kernel K6.
- :mod:`.ring_attention` — sequence parallelism by K/V rotation on kernel
  K7, contiguous or zig-zag layout.
- :mod:`.ulysses` — sequence parallelism by head/sequence all-to-all.
- :mod:`.tensor_parallel` — the tensor axis's autograd operators.
- :mod:`.moe` — expert parallelism (Switch top-1, all-to-all dispatch).
- :mod:`.pipeline` — pipeline parallelism over the pipe group: 1F1B, the
  interleaved and zero-bubble schedules from static tables, the boundary
  codec.
"""

from .mesh import (WORLD_AXIS, TrainingMesh, hierarchical_mesh,
                   multislice_mesh, pipeline_boundary_edges, pp_dp_sp_mesh,
                   training_mesh, world_mesh)
from .flash_attention import flash_attention_local
from .ring_attention import (local_attention, ring_attention_p,
                             zigzag_indices, zigzag_pair_kinds)
from .ulysses import ulysses_attention_p
from .moe import MoEParams, init_moe, moe_layer_p
from .pipeline import (build_schedule_tables, merge_microbatches,
                       pipeline_apply_p, pipeline_bubble_fraction,
                       pipeline_chunk_placement, pipeline_train_1f1b,
                       pipeline_train_step, predict_schedule_bubble,
                       resolve_pipeline_schedule, split_microbatches)

__all__ = [
    "WORLD_AXIS", "TrainingMesh", "training_mesh", "world_mesh",
    "hierarchical_mesh", "multislice_mesh", "pp_dp_sp_mesh",
    "flash_attention_local", "local_attention", "ring_attention_p",
    "zigzag_indices", "zigzag_pair_kinds", "ulysses_attention_p",
    "MoEParams", "init_moe", "moe_layer_p", "pipeline_boundary_edges",
    "pipeline_apply_p", "pipeline_train_1f1b", "pipeline_train_step",
    "resolve_pipeline_schedule", "pipeline_chunk_placement",
    "build_schedule_tables", "pipeline_bubble_fraction",
    "predict_schedule_bubble", "split_microbatches", "merge_microbatches",
]
