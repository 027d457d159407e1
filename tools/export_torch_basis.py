"""Export the JAX package's RKHS basis for the PyTorch port.

The port cannot rebuild the basis itself (the ~1e15-conditioned Gram solve
and JAX's PRNG draw of ``mix`` do not reproduce in torch), so it loads this
export instead.  Run from the repository root:

    JAX_PLATFORMS=cpu python tools/export_torch_basis.py [--sizes 25,50,100]

For each T in ``--sizes`` (default 50) it writes
``irm_motion_planning_tpu_torch/data/basis_T{T}_J{J}.npz`` with the nine
Basis arrays of the default config at that T, the config fields they
depend on, and the warm start's factors of ``km`` as ``jax.lax.linalg.lu``
gives them on the CPU (``lu``, the packed float32 LU, and ``lu_perm``, the
row permutation: ``km[lu_perm] = L U``; the port's init_alpha solves with
them, models/warm_start.py).  The committed exports are T = 25, 50, 100,
150 and 200 (the sizes of benchmarks/problemsize.py); an export holds
5T^2 + 4T floats, T permutation indices and two J x J matrices.
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import irm_motion_planning_tpu as mp  # noqa: E402
from irm_motion_planning_tpu_torch.models import rkhs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="50",
                    help="comma-separated numbers of timesteps T")
    args = ap.parse_args(argv)
    for T in (int(s) for s in args.sizes.split(",")):
        cfg = mp.PlannerConfig(n_timesteps=T)
        basis = mp.make_basis(cfg)
        arrays = {name: np.asarray(getattr(basis, name), dtype=np.float32)
                  for name in basis._fields}
        meta = {k: np.asarray(getattr(cfg, k)) for k in rkhs.BASIS_KEYS}
        lu, _, perm = jax.lax.linalg.lu(basis.km)
        arrays.update(lu=np.asarray(lu, dtype=np.float32),
                      lu_perm=np.asarray(perm))
        path = rkhs.export_path(cfg)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, **arrays, **meta)
        print(f"wrote {os.path.relpath(path, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
