"""The port's CUDA kernels (csrc/fused_solve.cu: the whole solve and one
penalty round) against their plain PyTorch versions on the same card, and
the rounds driver against the whole-solve kernel.  The kernels have no CPU
mode, so every case skips without a GPU.  The file imports no JAX, so it
also runs where JAX is not installed (the repository's conftest imports
JAX, hence ``--noconftest``):

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


def _round_args(args, seed=0):
    """fused_round's arguments from fused_solve's: a quarter of the lanes
    fulfilled, penalties escalated x1/x10/x100, four learning rates."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    g = torch.Generator().manual_seed(seed)
    B = a0.shape[-1]
    dev = a0.device
    ful = (torch.rand((1, B), generator=g) < 0.25).float().to(dev)
    esc = torch.tensor([1.0, 10.0, 100.0])[
        torch.randint(0, 3, (1, B), generator=g)].to(dev)
    lr0 = torch.tensor([0.2, 0.1, 0.05, 0.3])[
        torch.randint(0, 4, (1, B), generator=g)].to(dev)
    return (cfg, kv, kvt, mix, a0, lsg * esc, ljl * esc, ful, lr0, 4, start,
            goal, ox, oy, ow)


def _masked_agreement(ref, got, ful):
    """Lane agreement of two FusedRound results on the outputs the caller
    reads: step counts and flags of the live lanes, alpha everywhere."""
    live = ful[0] < 0.5
    same = ((ref.inner == got.inner) & (ref.ok == got.ok))[0] | ~live
    scale = ref.alpha.abs().amax(dim=(0, 1))
    rel = ((ref.alpha - got.alpha).abs().amax(dim=(0, 1)) / scale)[same]
    return float(same.float().mean()), float(rel.max())


def test_round_kernel_matches_plain_version_on_ragged_lanes(args):
    """K2 on 1,000 lanes (the last block masked) at 64, 128 and 256 lanes
    per block: bit for bit the same at every block size, and in agreement
    with the plain version (CARD_SHORT_AGREEMENT_MIN, ALPHA_REL_MAX)."""
    rargs = _round_args(args)
    before = tfs.fused_round.launches
    want = tfs.fused_round(*rargs)
    assert tfs.fused_round.launches == before + 1
    for bt in (64, 256):
        got = tfs.fused_round(rargs[0].replace(pallas_block_b=bt), *rargs[1:])
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    ful = rargs[7]
    assert torch.equal(want.alpha[:, :, ful[0] > 0.5],
                       rargs[4][:, :, ful[0] > 0.5])
    assert (want.inner[ful > 0.5] == 0).all()
    ref = tfs.fused_round_reference(*rargs)
    torch.cuda.synchronize()
    agree, rel = _masked_agreement(ref, want, ful)
    print(f"round kernel: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX


@pytest.mark.parametrize("compact", [False, True])
def test_rounds_driver_equals_whole_solve_kernel(compact):
    """The rounds driver over K2 (one launch per round) equals K1 bit for
    bit on every output field, with and without lane compaction."""
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(max_outer_iteration=3, inner_schedule=(48, 8, 4),
                           max_inner_iteration=48, fixed_iters=True,
                           max_obstacles=11)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(4), 4096,
                               device=dev)
    args = fleet.fused_args(cfg, basis, scns)
    k1 = tfs.fused_solve(*args)
    before = tfs.fused_round.launches
    got = fleet._fused_rounds_solve(cfg.replace(lane_compaction=compact),
                                    args[1:])
    assert tfs.fused_round.launches == before + 3
    want = fleet.kernel_result(k1)
    assert torch.equal(got.alpha, want.alpha)
    for x, y in zip(got.stats, want.stats):
        assert torch.equal(x, y)
