"""tools/carry_replica.py loaded by file path, and whether this host's CPU
gives the arithmetic that models/xla_order.py writes out, for the tests
that hold the replica to JAX's CPU bits (tests/test_torch_xla_order.py,
tests/test_torch_carry_replica.py, tests/test_torch_rounding.py).

Two of the replica's pieces are the host's, not XLA's: ``rsqrt`` is the
CPU's ``vrsqrtps`` estimate as the Intel Xeon it was measured on gives it,
and ``sin``/``cos`` are glibc's ``sinf``/``cosf`` (2.28 or later, its FMA
build).  :func:`skip_unless_host` compares them at fixed arguments with
the host's own and skips, naming the CPU and the libc, where they differ.
"""

import functools
import importlib.util
import os
import platform
import sys

import numpy as np
import pytest
import torch

TOOLS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def load_carry_replica():
    """tools/carry_replica.py as the module ``carry_replica`` (the name
    tools/compare_converged.py imports it by)."""
    if "carry_replica" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "carry_replica", os.path.join(TOOLS_DIR, "carry_replica.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["carry_replica"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["carry_replica"]


def _cpu_name():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@functools.lru_cache(maxsize=None)
def host_reason(piece):
    """"" where this host's ``piece`` ("rsqrt" or "sincos") is the one
    xla_order writes out, on 65,536 fixed arguments; else why not."""
    import jax
    import jax.numpy as jnp

    from irm_motion_planning_tpu_torch.models import xla_order

    if piece == "rsqrt":
        x = np.exp(np.linspace(-40, 40, 65536)).astype(np.float32)
        pairs = [(jax.lax.rsqrt, xla_order.rsqrt)]
        what = (f"this CPU's rsqrt estimate ({_cpu_name()}) is not the "
                "table xla_order.rsqrt writes out")
    elif piece == "sincos":
        x = np.linspace(-100, 100, 65536).astype(np.float32)
        pairs = [(jnp.sin, xla_order.sin), (jnp.cos, xla_order.cos)]
        what = (f"this libm's sinf/cosf ({' '.join(platform.libc_ver())}, "
                f"{_cpu_name()}) are not glibc's that xla_order writes out")
    else:
        raise ValueError(piece)
    for jf, tf in pairs:
        if not np.array_equal(_bits(jax.jit(jf)(x)),
                              _bits(tf(torch.from_numpy(x)))):
            return what
    return ""


def skip_unless_host(*pieces):
    """Skip the calling test where a host piece of ``pieces`` differs."""
    for piece in pieces:
        reason = host_reason(piece)
        if reason:
            pytest.skip(reason)
