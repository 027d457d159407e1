"""Export the JAX package's default RKHS basis for the PyTorch port.

The port cannot rebuild the basis itself (the ~1e15-conditioned Gram solve
and JAX's PRNG draw of ``mix`` do not reproduce in torch), so it loads this
export instead.  Run from the repository root:

    JAX_PLATFORMS=cpu python tools/export_torch_basis.py

It writes ``irm_motion_planning_tpu_torch/data/basis_T{T}_J{J}.npz`` with the
nine Basis arrays and the config fields they depend on.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import irm_motion_planning_tpu as mp  # noqa: E402
from irm_motion_planning_tpu_torch.models import rkhs  # noqa: E402


def main() -> int:
    cfg = mp.PlannerConfig()
    basis = mp.make_basis(cfg)
    arrays = {name: np.asarray(getattr(basis, name), dtype=np.float32)
              for name in basis._fields}
    meta = {k: np.asarray(getattr(cfg, k)) for k in rkhs.BASIS_KEYS}
    path = rkhs.export_path(cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **arrays, **meta)
    print(f"wrote {os.path.relpath(path, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
