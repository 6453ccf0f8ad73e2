"""Worker-side entry for the programmatic ``horovod_tpu_torch.runner.run()``
API.

The port's copy of ``horovod_tpu/runner/run_task.py``. Parity: the
reference's ``horovod.runner.run()`` serializes the user function and has
each worker execute it, collecting per-rank return values
(runner/__init__.py:89, task_fn wrapping). Here: workers unpickle
``(fn, args, kwargs)`` from the payload file, ``hvd.init()`` (on the card,
or on the CPU under ``HOROVOD_TPU_PLATFORM=cpu``), call the fn, and write
``result_<rank>.pkl`` into the output dir. ``cloudpickle`` is used where it
is installed.
"""

from __future__ import annotations

import os
import pickle
import sys


def _loads(data: bytes):
    try:
        import cloudpickle
        return cloudpickle.loads(data)
    except ImportError:
        return pickle.loads(data)


def main(payload_path: str, out_dir: str) -> int:
    with open(payload_path, "rb") as f:
        fn, args, kwargs = _loads(f.read())
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        result = fn(*args, **kwargs)
        from horovod_tpu_torch.core.state import global_state
        backend = global_state().backend
        if backend is not None and getattr(backend, "removed", False):
            # elastically scaled out: this worker's inert backend reports
            # rank 0 — writing result_0 would collide with the real rank 0
            return 0
        rank = hvd.rank()
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
