"""The repository's benchmarks/ scripts (the JAX package's) loaded as
modules by file path, for the tests that hold the port's benchmark modules
to them (tests/test_torch_bench_*.py)."""

import importlib.util
import os
import sys

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")


def load_jax_script(name):
    """benchmarks/<name>.py as a fresh module (benchmarks/ on sys.path:
    quality_sweep.py imports quality)."""
    if BENCH_DIR not in sys.path:
        sys.path.insert(0, BENCH_DIR)
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", os.path.join(BENCH_DIR, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
