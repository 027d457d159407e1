"""Build and load the CUDA kernels of the port.

``nvcc`` compiles ``csrc/fused_solve.cu`` (the whole-solve and the
per-round kernels) at first use into a shared library
with a plain C interface under ``build/`` at the repository root (named by
the hash of the source, so an edited source is rebuilt), and ``ctypes``
loads it.  Target: ``sm_90a`` (Hopper).  No ``--use_fast_math``, and no
contraction of separate multiplies and adds into FMAs (``-fmad=false``): the
elementwise arithmetic rounds as the plain PyTorch version's does; the
basis products use explicit ``fmaf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_solve.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None
# What the last build did: seconds, and nvcc's output (ptxas register and
# shared-memory report); None while nothing was built in this process.
build_info = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"fused_solve_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library if it is not built yet; return its path."""
    global build_info
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_info = {"seconds": time.perf_counter() - t0,
                  "log": (proc.stdout + proc.stderr).strip()}
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.fused_solve_launch.restype = ctypes.c_int
            from .fused_solve import _Params

            # (params, lanes per block[, n_r]), then a c_void_p for every
            # pointer and for the stream.
            lib.fused_solve_launch.argtypes = (
                [_Params, ctypes.c_int] + [ctypes.c_void_p] * 17
            )
            lib.fused_round_launch.restype = ctypes.c_int
            lib.fused_round_launch.argtypes = (
                [_Params, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 18
            )
            lib.fused_solve_error_string.restype = ctypes.c_char_p
            lib.fused_solve_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib
