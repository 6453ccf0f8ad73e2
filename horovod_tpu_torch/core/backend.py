"""Process/world state on ``torch.distributed``.

The port's counterpart of ``horovod_tpu/core/backend.py``. It reads the same
launch contract:

- ``HOROVOD_TPU_COORDINATOR`` (``host:port`` of rank 0's store),
  ``HOROVOD_TPU_NUM_PROCESSES`` and ``HOROVOD_TPU_PROCESS_ID`` (or
  ``HOROVOD_RANK``) join a multi-process world;
- ``HOROVOD_LOCAL_RANK``/``HOROVOD_LOCAL_SIZE`` and
  ``HOROVOD_CROSS_RANK``/``HOROVOD_CROSS_SIZE`` place the process on its host.

Without a coordinator the world has size 1 (an in-process store, no socket).
The process group is NCCL on ``cuda`` and gloo on ``cpu``. The device is
``cuda`` unless the caller asks for the CPU (``init(device="cpu")``); a
missing GPU is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..common import env as env_mod
from ..common.exceptions import HorovodInternalError


def resolve_device(device=None) -> torch.device:
    """The device a world runs on: the argument, else ``cuda``. ``cuda``
    picks the card of the process's local rank."""
    name = device if device is not None else "cuda"
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise HorovodInternalError(
                "no CUDA device is visible; pass device='cpu' to run on the "
                "CPU")
        if dev.index is None:
            local = int(os.environ.get(env_mod.HOROVOD_LOCAL_RANK, "0"))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    return dev


class Backend:
    """World/topology state and the process group of the eager collectives."""

    def __init__(self):
        self._initialized = False
        self._rank = 0
        self._size = 1
        self._local_rank = 0
        self._local_size = 1
        self._cross_rank = 0
        self._cross_size = 1
        self.device: Optional[torch.device] = None

    def init(self, device=None):
        if self._initialized:
            return
        self.device = resolve_device(device)
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        coord = os.environ.get(env_mod.HOROVOD_TPU_COORDINATOR)
        nprocs = int(os.environ.get(env_mod.HOROVOD_TPU_NUM_PROCESSES) or 1)
        timeout = datetime.timedelta(seconds=int(os.environ.get(
            env_mod.HOROVOD_TPU_SHUTDOWN_TIMEOUT, "300")))
        if dist.is_initialized():
            raise HorovodInternalError(
                "torch.distributed already has a default process group; "
                "call hvd.shutdown() (or destroy it) before hvd.init()")
        if coord and nprocs > 1:
            rank = int(os.environ.get(env_mod.HOROVOD_TPU_PROCESS_ID,
                                      os.environ.get(env_mod.HOROVOD_RANK,
                                                     "0")))
            dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                    world_size=nprocs, rank=rank,
                                    timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, timeout=timeout)
        self._rank = dist.get_rank()
        self._size = dist.get_world_size()
        env = os.environ
        self._local_rank = int(env.get(env_mod.HOROVOD_LOCAL_RANK, "0"))
        self._local_size = int(env.get(env_mod.HOROVOD_LOCAL_SIZE, "1"))
        per_host = max(self._local_size, 1)
        self._cross_rank = int(env.get(env_mod.HOROVOD_CROSS_RANK,
                                       str(self._rank // per_host)))
        self._cross_size = int(env.get(env_mod.HOROVOD_CROSS_SIZE,
                                       str(max(1, self._size // per_host))))
        self._initialized = True

    def shutdown(self):
        if dist.is_initialized():
            dist.destroy_process_group()
        self._initialized = False

    @property
    def initialized(self) -> bool:
        return self._initialized

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._size

    def local_rank(self) -> int:
        return self._local_rank

    def local_size(self) -> int:
        return self._local_size

    def cross_rank(self) -> int:
        return self._cross_rank

    def cross_size(self) -> int:
        return self._cross_size

    def is_homogeneous(self) -> bool:
        return self._size % max(self._local_size, 1) == 0
