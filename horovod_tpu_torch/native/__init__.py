"""Native (C++) host layer, loaded via ctypes: the port's copy of
``horovod_tpu/native``.

- ``src/timeline.cc`` — the Chrome-trace writer thread: Python pushes
  events through a C API and a dedicated C++ thread owns the file, so the
  engine's enqueue path never blocks on I/O.

The library is built with ``g++`` at first use (nothing is built at
import) into ``build/horovod_tpu_torch/native-<hash>/`` beside the
package, keyed by a hash of the sources, the flags and the compiler, as
``ops/build.py`` keys the CUDA kernels: an edit rebuilds, an unchanged tree
loads what is there. Loading is best effort: :func:`load` returns None where
there is no compiler or the build fails, and the timeline then uses its
Python writer.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_LOG = logging.getLogger("horovod_tpu_torch.native")

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / \
    "horovod_tpu_torch"
LIB_NAME = "libhvd_torch_native.so"
SOURCES = ("timeline.cc",)
CFLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def sources():
    return [SRC_DIR / s for s in SOURCES]


def _compiler() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return gxx


def lib_path(gxx: Optional[str] = None) -> Path:
    """Where the library of this tree's sources lives."""
    gxx = gxx or _compiler()
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join([gxx] + CFLAGS).encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the library if the keyed one is missing; return its path.
    Raises with the compiler's output when the compile fails."""
    gxx = _compiler()
    out = lib_path(gxx)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile into a temporary file and rename: concurrent ranks building
    # the same key each publish atomically
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [gxx, *CFLAGS, "-o", str(tmp_lib)] + [str(s) for s in sources()]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"native build failed ({' '.join(cmd)}):\n{res.stderr}")
        # divcheck: ignore[the call graph aliases this build() to ops/build.py's by name; the native timeline library is built by Timeline.start() at init, never on the step path]
        os.replace(tmp_lib, out)
    _LOG.info("built %s", out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.hvd_timeline_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.hvd_timeline_open.restype = ctypes.c_int
    lib.hvd_timeline_event.argtypes = [
        ctypes.c_char, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p]
    lib.hvd_timeline_event.restype = None
    lib.hvd_timeline_close.argtypes = []
    lib.hvd_timeline_close.restype = None
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded native library (built on first call); None when it cannot
    be built or loaded."""
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError) as e:
            _LOG.debug("native layer unavailable, using Python fallbacks: "
                       "%r", e)
            _lib = None
        return _lib


def built() -> bool:
    """Whether the native layer is available (builds it if need be)."""
    return load() is not None
