"""Build and load the port's CUDA kernels (nvcc into a plain C shared
library, bound with ctypes).

The library is compiled on first use, for sm_90a, into
``build/finito_tpu_torch/<hash>/`` at the root of the checkout, keyed by
a hash of the sources, their header and the flags, so an edited source
rebuilds and an unchanged one loads the cached library. A missing nvcc or a failed
build raises: there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = [_PKG / "csrc" / "minimizer_front.cu", _PKG / "csrc" / "chain_opt.cu",
            _PKG / "csrc" / "segment_repair.cu"]
_HEADERS = [_PKG / "csrc" / "rank24.cuh"]
BUILD_ROOT = _PKG.parent / "build" / "finito_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build of this process reported: seconds, nvcc's output
# (ptxas register/shared-memory lines) and the library path
build_info: dict = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES + _HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _SOURCES)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_info.update(seconds=time.perf_counter() - t0, log=r.stdout + r.stderr)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = BUILD_ROOT / _digest() / "libfinito_torch_kernels.so"
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.fin_minimizer_windows.argtypes = [vp, ll, ll, ci, ci, vp, vp, vp, vp, vp]
        lib.fin_minimizer_windows.restype = ci
        lib.fin_chain_opt.argtypes = [vp, ll, ll, ci, vp, ci, ll, vp, vp, ll, ci, vp, vp, vp, vp]
        lib.fin_chain_opt.restype = ci
        lib.fin_segment_repair.argtypes = [vp, ll, vp, vp, vp, ll, ll, ci, ci, vp, ci, ll, vp, vp,
                                           vp, vp, vp, ll, ci, vp, vp, vp]
        lib.fin_segment_repair.restype = ci
        build_info["path"] = str(path)
        _lib = lib
        return lib
