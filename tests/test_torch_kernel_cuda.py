"""The port's CUDA kernel (csrc/fused_solve.cu) against its plain PyTorch
version on the same card.  The kernel has no CPU mode, so every case skips
without a GPU.  The file imports no JAX, so it also runs where JAX is not
installed (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernel_cuda.py
"""

import pytest
import torch

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.solvers import fleet

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA device; the kernel has no CPU mode"),
]

SHORT = dict(max_outer_iteration=1, max_inner_iteration=4, fixed_iters=True,
             max_obstacles=11)
# Not a multiple of 64, 128 or 256: the last block of every launch below is
# partly masked.
BATCH = 1000


@pytest.fixture(scope="module")
def args():
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(**SHORT)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(3), BATCH,
                               device=dev)
    return fleet.fused_args(cfg, basis, scns)


def test_kernel_matches_plain_version_on_the_card(args):
    """Lane agreement with the plain version at 1 round x 4 steps, the bound
    chip_smoke.py holds the kernel to (CARD_SHORT_AGREEMENT_MIN)."""
    before = tfs.fused_solve.launches
    got = tfs.fused_solve(*args)
    assert tfs.fused_solve.launches == before + 1
    ref = tfs.fused_solve_reference(*args)
    torch.cuda.synchronize()
    agree, rel = tfs.lane_agreement(ref, got)
    print(f"lane agreement {agree:.4f}, alpha rel err {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    assert torch.isfinite(got.alpha).all()


@pytest.mark.parametrize("block_b", [64, 256])
def test_kernel_lanes_do_not_depend_on_block_size(args, block_b):
    """Per-lane results do not depend on how lanes are grouped: every block
    size gives the default's outputs bit for bit."""
    want = tfs.fused_solve(*args)
    got = tfs.fused_solve(args[0].replace(pallas_block_b=block_b), *args[1:])
    for x, y in zip(got, want):
        assert torch.equal(x, y)
