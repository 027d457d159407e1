"""Build and load the CUDA kernels of the port.

``nvcc`` compiles every ``csrc/*.cu`` (``fused_solve.cu``: the whole-solve
and the per-round kernels, from ``warp_body.cuh``; ``step_kernels.cu``: the
per-step kernels, from ``lane_body.cuh``), one
process per source, all started together, and links the objects into one
shared library with a plain C interface under ``build/`` at the repository
root.  The library is named by the hash of every source and header
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt; ``ctypes``
loads it at first use.  Target: ``sm_90a`` (Hopper).  No
``--use_fast_math``, and no contraction of separate multiplies and adds into
FMAs (``-fmad=false``): the elementwise arithmetic rounds as the plain
PyTorch version's does; the basis products use explicit ``fmaf``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + [
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler",
    "-fPIC",
]

_lock = threading.Lock()
_lib = None
# What the last build did: seconds, and nvcc's output (ptxas register and
# shared-memory report); None while nothing was built in this process.
build_info = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"kernels_{digest.hexdigest()[:16]}.so")


def _check(proc, what: str) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n"
                           f"{out}\n{err}")
    return (out + err).strip()


def build() -> str:
    """Compile the kernel library if it is not built yet; return its path."""
    global build_info
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = [_check(proc, os.path.basename(src)) for src, proc in procs]
        lib = os.path.join(tmp, "kernels.so")
        link = subprocess.Popen([nvcc, *ARCH, "-shared", "-o", lib, *objs],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        logs.append(_check(link, "the link"))
        os.replace(lib, out)
    build_info = {"seconds": time.perf_counter() - t0,
                  "log": "\n".join(x for x in logs if x)}
    return out


def bind(lib: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Give ``lib``'s entry points (all, or those in ``names``) their C
    signatures: the parameter block and the lanes per block (K3-K6) or per
    CTA (K1/K2)[, K1/K2's program and the CTAs of their grid][, n_r][, K3's
    ladder tier], then a c_void_p for every tensor pointer; callers pass the
    stream last, as a c_void_p."""
    from .fused_solve import _Params

    for name, n_int, n_ptr in (
        ("fused_solve_launch", 2, 16),
        ("fused_round_launch", 3, 17),
        ("bls_step_launch", 1, 19),
        ("gd_step_launch", 0, 19),
        ("cost_grad_eval_launch", 0, 17),
        ("forward_eval_launch", 0, 6),
    ):
        if names is None or name in names:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([_Params, ctypes.c_int] + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p] * n_ptr)
    lib.fused_launch_shape.restype = ctypes.c_int
    lib.fused_launch_shape.argtypes = [_Params, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.fused_params_layout.restype = ctypes.c_int
    lib.fused_params_layout.argtypes = [ctypes.c_void_p]
    lib.fused_solve_error_string.restype = ctypes.c_char_p
    lib.fused_solve_error_string.argtypes = [ctypes.c_int]
    return lib


def params_layout() -> tuple:
    """(size, offset of the last field) of the ctypes mirror _Params, as
    the C side's fused_params_layout reports them for struct FsParams."""
    from .fused_solve import _Params

    last = _Params._fields_[-1][0]
    return ctypes.sizeof(_Params), getattr(_Params, last).offset


def check_layout(lib: ctypes.CDLL) -> None:
    """Refuse a library whose struct FsParams is laid out otherwise than
    the ctypes mirror: a field added on one side only, or elsewhere, would
    shift every later field without any other error."""
    out = (ctypes.c_int * 2)()
    lib.fused_params_layout(out)
    if tuple(out) != params_layout():
        raise RuntimeError(
            f"struct FsParams (size, last-field offset) {tuple(out)} differs "
            f"from its ctypes mirror _Params {params_layout()}: the kernels "
            f"would read shifted parameters"
        )


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures
    (``bind``) and its parameter layout checked (``check_layout``)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = bind(ctypes.CDLL(build()))
            check_layout(lib)
            _lib = lib
    return _lib


def launch(name: str, params, block_b: int, args, device) -> None:
    """Call ``<name>_launch`` of the library with the parameter block, the
    lanes per block or CTA and ``args`` (ctypes ints as they are, tensors as their
    data pointers) on the current stream of ``device``.  Raises when the
    launch is refused."""
    lib = load_library()
    ptrs = [a if isinstance(a, ctypes.c_int) else ctypes.c_void_p(a.data_ptr())
            for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, f"{name}_launch")(
            params, ctypes.c_int(block_b), *ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.fused_solve_error_string(err).decode()})"
        )
