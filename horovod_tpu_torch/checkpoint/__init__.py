"""Async sharded checkpointing with peer-redundant fast restore (the port
of ``horovod_tpu/checkpoint/``).

The subsystem has four layers:

1. **Async snapshot** — :class:`CheckpointManager` captures the state's
   values on the step path (a device-side copy of each CUDA tensor, no
   host wait) and copies them to host on a background thread
   (double-buffered: step N+1 never blocks on step N's write), then
   serializes them into a flat byte stream sharded over ranks with the
   same ``shard_spec`` padding the ZeRO-1 optimizer uses — each rank
   writes 1/world_size of the bytes, off the step path.
2. **Manifests in the rendezvous KV** — every rank publishes a per-rank
   shard manifest under ``ckpt/<rank>``; a generation is valid only when
   all ranks' manifests agree on ``(step, world_version)`` (the commit
   barrier). Partial generations are garbage-collected.
3. **Peer-redundant placement** — rank r also holds rank (r+1)%N's shard
   (degree = ``HOROVOD_TPU_CHECKPOINT_REDUNDANCY``), so a lost host's
   shard restores from its neighbor over the wire (KV-mediated chunked
   fetch) instead of requiring shared blob storage.
4. **Elastic-world-resize restore** — a checkpoint written at ``np=N``
   restores at ``np=M``: restore re-slices the flat shard byte ranges
   against the new world's ``shard_spec`` padding.

A generation's bytes are the JAX package's byte for byte (the header, the
padding, the manifests, leaves in ``jax.tree_util`` order:
:mod:`.flatten`), so each package restores what the other writes.
"""

from .flatten import flatten  # noqa: F401
from .manager import (CheckpointManager, CheckpointRestoreError,  # noqa: F401
                      RestoreResult, load_training_state, training_state,
                      training_template)
from .manifest import (build_manifest, checksum,  # noqa: F401
                       generation_complete, validate_manifest)
from .shard_io import (decode_leaves, encode_leaves,  # noqa: F401
                       make_header, reshard_ranges, shard_of,
                       zero1_header, zero1_payload, zero1_reshard)
