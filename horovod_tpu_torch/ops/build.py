"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc -c``
per source, all started together, then one link) into a shared library
with a plain C interface, and loaded with ``ctypes``. No PyTorch header is
included, so a build takes seconds. The library goes under ``build/`` beside
the package, in a directory keyed by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree loads what is there. Nothing is built
at import: the first CUDA launch builds. Beside the library, each source's
``ptxas`` report (registers and spills of every kernel) is kept as
``<stem>.ptxas.txt``; :func:`ptxas_report` reads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "horovod_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _LLP = ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)
# C entry points and their argument types: every pointer and the stream are
# c_void_p (ctypes would otherwise pass a Python int as a 32-bit int)
SIGNATURES = {
    "hvd_pack": [_I, _P, _I, _LL, _P, _P],
    "hvd_pack_tile_bytes": [],
    # (device, dtype, tensors..., M, C, ctas, cluster, rows_per_cta, work,
    # tickets, epilogue, epilogue's inputs..., out, stream)
    "hvd_bn_stats": [_I, _I, _P, _LL, _I, _I, _I, _LL, _P, _P, _I, _P, _P,
                     _F, _P, _P, _F, _F, _P, _P],
    "hvd_bn_bwd_stats": [_I, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _LL, _P,
                         _P, _I, _P, _P, _P],
    "hvd_bn_max_clusters": [_I, _I, _I, _I],
    # (device, dtype, tensors..., strides, B, H, Tq, [Tk,] D, [causal,
    # scale,] stream): D the views' head dim
    "hvd_flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _I,
                      _I, _F, _P],
    "hvd_flash_bwd_pre": [_I, _I, _P, _P, _P, _LLP, _I, _I, _I, _I, _P],
    "hvd_flash_bwd_dkdv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _LLP, _I,
                           _I, _I, _I, _I, _I, _F, _P],
    "hvd_flash_bwd_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _LLP, _I, _I,
                         _I, _I, _I, _I, _F, _P],
}
# K7 takes K6's arguments, with fp32 outputs and the statistics' strides
# appended to `strides`
SIGNATURES.update({
    "hvd_flash_seg_fwd": SIGNATURES["hvd_flash_fwd"],
    "hvd_flash_seg_bwd_dkdv": SIGNATURES["hvd_flash_bwd_dkdv"],
    "hvd_flash_seg_bwd_dq": SIGNATURES["hvd_flash_bwd_dq"],
})
# K4/K5: (device, [triple,] a, b, [out,] dtype, n, aligned, blocks,
# [partial, triple,] stream)
SIGNATURES.update({
    "hvd_adasum_triple": [_I, _P, _P, _I, _LL, _I, _I, _P, _P, _P],
    "hvd_adasum_scale": [_I, _P, _P, _P, _P, _I, _LL, _I, _I, _P],
})
RESTYPES = {"hvd_pack_tile_bytes": ctypes.c_longlong}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda): the port's CUDA kernels are built at first use "
        "and need the CUDA toolkit")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _key(nvcc: str) -> str:
    h = hashlib.sha256()
    for p in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join([nvcc] + ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if the keyed library is missing; return its
    path. Raises with the compiler's output when a compile fails."""
    nvcc = _nvcc()
    out_dir = BUILD_ROOT / _key(nvcc)
    lib_path = out_dir / "libhvd_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs, errors, reports = [], [], []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"$ {' '.join(cmd)}\n{out}")
            objs.append(str(obj))
            report = Path(tmp) / (obj.stem + ".ptxas.txt")
            report.write_text(out)
            reports.append(report)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(tmp_lib)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                               f"{res.stdout}")
        # atomic publish: concurrent ranks may build the same key
        for report in reports:
            os.replace(report, out_dir / report.name)
        os.replace(tmp_lib, lib_path)
    return lib_path


def parse_ptxas(text: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    (spills in bytes) from the output of ``nvcc -Xptxas -v``."""
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            kernels[name].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels[name]["registers"] = int(m.group(1))
    return kernels


def ptxas_report(stem: str) -> dict:
    """:func:`parse_ptxas` of the report that the build of ``csrc/<stem>.cu``
    left beside the library (building it if need be)."""
    return parse_ptxas((build().parent / f"{stem}.ptxas.txt").read_text())


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib
