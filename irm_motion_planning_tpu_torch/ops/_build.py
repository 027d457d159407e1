"""Build and load the CUDA kernels of the port.

``nvcc`` compiles every ``csrc/*.cu`` (``fused_solve.cu``: the whole-solve
and the per-round kernels, from ``warp_body.cuh``; ``fused_tiers.cu``: their
kernel tiers; ``step_kernels.cu``: the per-step kernels, K3, K4 and K5
from ``warp_body.cuh``, K6 a tiled product), one
process per source, all started together, and links the objects into one
shared library with a plain C interface under ``build/`` at the repository
root.  One library per joint count J: the kernels take J from ``-DNJ=<J>``
(every layout and register block follows it; 1 <= J <=
fused_solve.MAX_JOINTS), the library of a J is built at the first launch
at that J, and the loaded libraries are kept by J.  J = 3, the reference
arm, also instantiates the kernels specialised to the bench's T and
obstacle slots; other J build only the generic instantiations.  A library
is named by the hash of J, every source and header (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt; ``ctypes`` loads it at first
use.  Target: ``sm_90a`` (Hopper).  No ``--use_fast_math``, and no
contraction of separate multiplies and adds into FMAs (``-fmad=false``):
the elementwise arithmetic rounds as the plain PyTorch version's does; the
basis products use explicit ``fmaf``.

Variant builds (:func:`build_variant`, :func:`variant`): ``fused_solve.cu``
alone, compiled with extra ``-D`` flags (the phase-ablated builds of
csrc/warp_body.cuh, ``WB_ABLATE_*``, which hold K1 and K2 of the resident
linearized program only) into ``build/variants/``, and loaded in place of
the default library of its J for the duration of a ``with`` block.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
VARIANT_DIR = os.path.join(BUILD_DIR, "variants")
# What a variant build compiles: K1 and K2 (and, by default, K7 alone).
VARIANT_SOURCES = ("fused_solve.cu",)
VARIANT_ENTRIES = ("fused_solve_launch", "fused_round_launch")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + [
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler",
    "-fPIC",
]

_lock = threading.Lock()
# The loaded libraries, by J.
_libs: dict = {}
# What each build in this process did, by J (a variant build by J and its
# -D flags): seconds, and nvcc's output (ptxas register and shared-memory
# report); no entry for a library that was built before.
builds: dict = {}


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


def _check_joints(J: int) -> int:
    from .fused_solve import MAX_JOINTS

    J = int(J)
    if not 1 <= J <= MAX_JOINTS:
        raise NotImplementedError(
            f"the CUDA kernels take 1 <= J <= {MAX_JOINTS} joints, not {J}")
    return J


def flags(J: int = 3) -> list:
    """nvcc's flags for the library of J joints."""
    return NVCC_FLAGS + [f"-DNJ={_check_joints(J)}"]


def _digest(J: int, extra: tuple, srcs: list) -> str:
    digest = hashlib.sha256(" ".join(flags(J) + list(extra)).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return digest.hexdigest()[:16]


def library_path(J: int = 3) -> str:
    return os.path.join(BUILD_DIR,
                        f"kernels_J{J}_{_digest(J, (), sources())}.so")


def _variant_sources() -> list:
    return [os.path.join(CSRC, f) for f in VARIANT_SOURCES]


def _defines(defines) -> tuple:
    """``-D`` flags from macro definitions (``NAME`` or ``NAME=value``)."""
    return tuple(f"-D{d}" for d in defines)


def variant_path(J: int, defines) -> str:
    """Where the variant build of J with the macro ``defines`` goes."""
    digest = _digest(J, _defines(defines), _variant_sources())
    return os.path.join(VARIANT_DIR, f"kernels_J{J}_{digest}.so")


def _check(proc, what: str) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n"
                           f"{out}\n{err}")
    return (out + err).strip()


def _compile(out: str, J: int, srcs: list, extra: tuple, key) -> str:
    """Compile ``srcs`` (one nvcc each, all started together) with J's
    flags and ``extra`` and link them into ``out``, unless it exists;
    record the build in ``builds[key]``."""
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *flags(J), *extra, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = [_check(proc, os.path.basename(src)) for src, proc in procs]
        lib = os.path.join(tmp, "kernels.so")
        link = subprocess.Popen([nvcc, *ARCH, "-shared", "-o", lib, *objs],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        logs.append(_check(link, "the link"))
        os.replace(lib, out)
    info = {"seconds": time.perf_counter() - t0,
            "log": "\n".join(x for x in logs if x)}
    builds[key] = info
    print(f"[kernels] built {os.path.basename(out)} {' '.join(extra)} in "
          f"{info['seconds']:.1f}s", file=sys.stderr, flush=True)
    return out


def build(J: int = 3) -> str:
    """Compile the kernel library of J joints if it is not built yet;
    return its path.  Prints the build's seconds (stderr); raises
    RuntimeError when nvcc fails."""
    return _compile(library_path(J), J, sources(), (), J)


def build_variant(J: int, defines) -> str:
    """Compile the variant of J joints with the macro ``defines`` (e.g.
    ``("WB_ABLATE_FK",)``) if it is not built yet: VARIANT_SOURCES, the
    flags of J's library plus one ``-D`` per define.  Returns its path;
    its build is ``builds[(J, tuple(defines))]``."""
    J = _check_joints(J)
    defines = tuple(defines)
    return _compile(variant_path(J, defines), J, _variant_sources(),
                    _defines(defines), (J, defines))


@contextlib.contextmanager
def variant(J: int, defines):
    """Within the block, every launch at J goes to the variant build of J
    with ``defines`` (:func:`build_variant`; its entry points
    VARIANT_ENTRIES, its layout checked), in every thread of the process;
    the default library (or none) is restored on exit."""
    J = _check_joints(J)
    lib = bind(ctypes.CDLL(build_variant(J, defines)), VARIANT_ENTRIES, J)
    check_layout(lib, J)
    with _lock:
        saved = _libs.get(J)
        _libs[J] = lib
    try:
        yield lib
    finally:
        with _lock:
            if saved is None:
                _libs.pop(J, None)
            else:
                _libs[J] = saved


def bind(lib: ctypes.CDLL, names=None, J: int = 3) -> ctypes.CDLL:
    """Give ``lib``'s entry points (all, or those in ``names``) their C
    signatures: the parameter block and the lanes per CTA (K1-K5, K7) or
    the threads per block (K6)[, K1/K2's program, body (resident 0,
    streamed 1) and the CTAs of their grid][, n_r][, K3-K5's body][, K3's
    ladder tier][, K6's 16-byte copies and its basis' padded rows], then a
    c_void_p for every tensor pointer; callers pass the stream last, as a
    c_void_p.  ``J``: the library's joint count (its parameter block)."""
    from .fused_solve import params_type

    _Params = params_type(J)

    for name, n_int, n_ptr in (
        ("fused_solve_launch", 3, 16),
        ("fused_round_launch", 4, 17),
        ("bls_step_launch", 2, 18),
        ("gd_step_launch", 1, 18),
        ("cost_grad_eval_launch", 1, 16),
        ("forward_eval_launch", 2, 6),
        ("k7_forward_launch", 0, 6),
    ):
        if names is None or name in names:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([_Params, ctypes.c_int] + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p] * n_ptr)
    lib.fused_launch_shape.restype = ctypes.c_int
    lib.fused_launch_shape.argtypes = [_Params, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    if names is None:  # the whole library: step_kernels.cu's shapes too
        lib.step_kernel_shape.restype = ctypes.c_int
        lib.step_kernel_shape.argtypes = [_Params, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
        lib.forward_eval_shape.restype = ctypes.c_int
        lib.forward_eval_shape.argtypes = [ctypes.c_void_p]
    lib.fused_params_layout.restype = ctypes.c_int
    lib.fused_params_layout.argtypes = [ctypes.c_void_p]
    lib.fused_solve_error_string.restype = ctypes.c_char_p
    lib.fused_solve_error_string.argtypes = [ctypes.c_int]
    return lib


def params_layout(J: int = 3) -> tuple:
    """(size, offset of the last field) of the ctypes mirror of J joints
    (fused_solve.params_type), as the C side's fused_params_layout reports
    them for struct FsParams."""
    from .fused_solve import params_type

    P = params_type(J)
    last = P._fields_[-1][0]
    return ctypes.sizeof(P), getattr(P, last).offset


def check_layout(lib: ctypes.CDLL, J: int = 3) -> None:
    """Refuse a library whose struct FsParams is laid out otherwise than
    the ctypes mirror: a field added on one side only, or elsewhere, would
    shift every later field without any other error."""
    out = (ctypes.c_int * 2)()
    lib.fused_params_layout(out)
    if tuple(out) != params_layout(J):
        raise RuntimeError(
            f"struct FsParams (size, last-field offset) {tuple(out)} differs "
            f"from its ctypes mirror at J={J} {params_layout(J)}: the "
            f"kernels would read shifted parameters"
        )


def load_library(J: int = 3) -> ctypes.CDLL:
    """The kernel library of J joints, built at first use, with its C
    signatures (``bind``) and its parameter layout checked
    (``check_layout``)."""
    J = _check_joints(J)
    with _lock:
        if J not in _libs:
            lib = bind(ctypes.CDLL(build(J)), J=J)
            check_layout(lib, J)
            _libs[J] = lib
    return _libs[J]


def launch(name: str, params, block_b: int, args, device) -> None:
    """Call ``<name>_launch`` of the library with the parameter block, the
    lanes per CTA (K6: threads per block) and ``args`` (ctypes ints as they
    are, tensors as their data pointers) on the current stream of
    ``device``, from the library of the parameter block's J.  Raises when
    the launch is refused."""
    lib = load_library(len(params.link))
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
