"""Environment-variable knobs of the PyTorch port.

A trimmed copy of ``horovod_tpu/common/env.py``: the same ``HOROVOD_*`` names,
so a launch environment written for the JAX package carries over unchanged,
and only the :class:`Config` fields the port reads so far.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# --- knob names (the JAX package's names) ---
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_TPU_COORDINATOR = "HOROVOD_TPU_COORDINATOR"      # host:port of rank 0
HOROVOD_TPU_NUM_PROCESSES = "HOROVOD_TPU_NUM_PROCESSES"
HOROVOD_TPU_PROCESS_ID = "HOROVOD_TPU_PROCESS_ID"
HOROVOD_TPU_SHUTDOWN_TIMEOUT = "HOROVOD_TPU_SHUTDOWN_TIMEOUT"
HOROVOD_PALLAS_PACK = "HOROVOD_PALLAS_PACK"
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024


def _get_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return int(v)
    except ValueError:
        return default


@dataclass
class Config:
    """The knobs the port reads, parsed once at ``init``."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    # HOROVOD_PALLAS_PACK keeps the JAX package's name so launch scripts run
    # unchanged; in the port it selects the hand-written CUDA pack kernel
    pack_kernel: bool = False
    # HOROVOD_HIERARCHICAL_ALLREDUCE: the two-level (local, cross) form where
    # the agreed topology has one. So far it selects hierarchical Adasum
    # only; hierarchical Sum/Average is not ported (ROADMAP A11)
    hierarchical_allreduce: bool = False

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            fusion_threshold_bytes=_get_int(HOROVOD_FUSION_THRESHOLD,
                                            DEFAULT_FUSION_THRESHOLD_BYTES),
            pack_kernel=_get_bool(HOROVOD_PALLAS_PACK),
            hierarchical_allreduce=_get_bool(HOROVOD_HIERARCHICAL_ALLREDUCE),
        )
