"""Process-wide runtime state (the port's ``GlobalState``: backend and engine
only; no stall inspector, timeline, checkpoint, aggregator or monitor yet)."""

from __future__ import annotations

import threading
from typing import Optional

from ..common import env as env_mod
from .backend import Backend
from .engine import Engine


class GlobalState:
    def __init__(self):
        self._lock = threading.Lock()
        self.backend = Backend()
        self.config: Optional[env_mod.Config] = None
        self.engine: Optional[Engine] = None

    @property
    def initialized(self) -> bool:
        return self.engine is not None

    def init(self, device=None):
        with self._lock:
            if self.engine is not None:
                return
            self.config = env_mod.Config.from_env()
            self.backend.init(device)
            self.engine = Engine(self.backend, self.config)

    def shutdown(self):
        with self._lock:
            if self.engine is not None:
                # armed replay graphs hold NCCL work of the process group:
                # they go first (handles may keep the engine alive)
                self.engine.replay.invalidate_all("shutdown")
            self.engine = None
            self.backend.shutdown()


_state = GlobalState()


def global_state() -> GlobalState:
    return _state


def engine() -> Engine:
    """The initialized engine; raises if ``hvd.init()`` has not run."""
    if _state.engine is None:
        raise ValueError("horovod_tpu_torch has not been initialized; run "
                         "hvd.init() first.")
    return _state.engine
