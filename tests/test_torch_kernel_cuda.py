"""The port's CUDA kernels (csrc/fused_solve.cu: the whole solve and one
penalty round, for BLS in either ladder tier and GD; csrc/step_kernels.cu:
the per-step kernels) against their plain PyTorch versions on the same
card, the rounds driver against the whole-solve kernel, the fused GD and
exact-ladder kernels against their per-step paths, and the per-step driver
on the card.  The kernels have no CPU
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
from irm_motion_planning_tpu_torch.ops import step_kernels as sk
from irm_motion_planning_tpu_torch.solvers import fleet

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def card():
    """Skip without a CUDA device (decided when a test runs, not when the
    module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")

SHORT = dict(max_outer_iteration=1, max_inner_iteration=4, fixed_iters=True,
             max_obstacles=11)
# Not a multiple of 64, 128 or 256: the per-step kernels' last block is
# partly masked; the fused kernels' warps draw lanes from a queue until 1,000.
BATCH = 1000


@pytest.fixture(scope="module")
def args():
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(**SHORT)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(3), BATCH,
                               device=dev)
    return fleet.fused_args(cfg, basis, scns)


SOLVERS = pytest.mark.parametrize("solver", ["bls", "gd"])


@SOLVERS
def test_kernel_matches_plain_version_on_the_card(args, solver):
    """Lane agreement with the plain version at 1 round x 4 steps, the bound
    chip_smoke.py holds the kernel to (CARD_SHORT_AGREEMENT_MIN)."""
    before = tfs.fused_solve.launches
    got = tfs.fused_solve(*args, solver=solver)
    assert tfs.fused_solve.launches == before + 1
    ref = tfs.fused_solve_reference(*args, solver=solver)
    torch.cuda.synchronize()
    agree, rel = tfs.lane_agreement(ref, got)
    print(f"lane agreement {agree:.4f}, alpha rel err {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    assert torch.isfinite(got.alpha).all()


@SOLVERS
@pytest.mark.parametrize("block_b", [4, 8])
def test_kernel_lanes_do_not_depend_on_block_size(args, block_b, solver):
    """Per-lane results do not depend on how lanes are grouped: every
    number of lanes (warps) per CTA gives the default's outputs bit for
    bit."""
    want = tfs.fused_solve(*args, solver=solver)
    got = tfs.fused_solve(args[0].replace(pallas_block_b=block_b), *args[1:],
                          solver=solver)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@SOLVERS
@pytest.mark.parametrize("kernel", ["fused_solve", "fused_round"])
def test_kernel_lanes_do_not_depend_on_grid_size(args, kernel, solver):
    """The persistent grid's warps draw lanes from a queue: one CTA, whose
    warps take every lane in turn, gives the full grid's outputs bit for
    bit."""
    if kernel == "fused_solve":
        fn, a = tfs.fused_solve, args
    else:
        fn, a = tfs.fused_round, _round_args(args, solver=solver)
    want = fn(*a, solver=solver)
    got = fn(*a, ctas=1, solver=solver)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@SOLVERS
def test_generic_instantiation_matches_plain_version(solver):
    """Shapes other than the bench's (T=50, O=11) run the fused kernels'
    generic instantiation: at 13 obstacle slots (two of them padding), K1
    and K2 agree with their plain versions as the specialised ones do
    (CARD_SHORT_AGREEMENT_MIN, ALPHA_REL_MAX)."""
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(**{**SHORT, "max_obstacles": 13})
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(6), BATCH,
                               device=dev)
    args = fleet.fused_args(cfg, basis, scns)
    agree, rel = tfs.lane_agreement(
        tfs.fused_solve_reference(*args, solver=solver),
        tfs.fused_solve(*args, solver=solver))
    print(f"K1 generic: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    rargs = _round_args(args, solver=solver)
    agree, rel = _masked_agreement(
        tfs.fused_round_reference(*rargs, solver=solver),
        tfs.fused_round(*rargs, solver=solver), rargs[7])
    print(f"K2 generic: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX


def _round_args(args, seed=0, solver="bls"):
    """fused_round's arguments from fused_solve's: a quarter of the lanes
    fulfilled, penalties escalated x1/x10/x100, four learning rates (BLS's,
    or the GD schedule's first four)."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    g = torch.Generator().manual_seed(seed)
    B = a0.shape[-1]
    dev = a0.device
    ful = (torch.rand((1, B), generator=g) < 0.25).float().to(dev)
    esc = torch.tensor([1.0, 10.0, 100.0])[
        torch.randint(0, 3, (1, B), generator=g)].to(dev)
    lrs = [0.2, 0.1, 0.05, 0.3] if solver == "bls" else list(cfg.gd_lr[:4])
    lr0 = torch.tensor(lrs)[torch.randint(0, 4, (1, B), generator=g)].to(dev)
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


@SOLVERS
def test_round_kernel_matches_plain_version_on_ragged_lanes(args, solver):
    """K2 on 1,000 lanes at 4, 8 and 16 lanes (warps) per CTA: bit for bit
    the same at every CTA shape, and in agreement with the plain version
    (CARD_SHORT_AGREEMENT_MIN, ALPHA_REL_MAX)."""
    rargs = _round_args(args, solver=solver)
    before = tfs.fused_round.launches
    want = tfs.fused_round(*rargs, solver=solver)
    assert tfs.fused_round.launches == before + 1
    for bt in (4, 8):
        got = tfs.fused_round(rargs[0].replace(pallas_block_b=bt), *rargs[1:],
                              solver=solver)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    ful = rargs[7]
    assert torch.equal(want.alpha[:, :, ful[0] > 0.5],
                       rargs[4][:, :, ful[0] > 0.5])
    assert (want.inner[ful > 0.5] == 0).all()
    ref = tfs.fused_round_reference(*rargs, solver=solver)
    torch.cuda.synchronize()
    agree, rel = _masked_agreement(ref, want, ful)
    print(f"round kernel: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX


@SOLVERS
@pytest.mark.parametrize("compact", [False, True])
def test_rounds_driver_equals_whole_solve_kernel(compact, solver):
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
    k1 = tfs.fused_solve(*args, solver=solver)
    before = tfs.fused_round.launches
    got = fleet._fused_rounds_solve(cfg.replace(lane_compaction=compact),
                                    args[1:], solver)
    assert tfs.fused_round.launches == before + 3
    want = fleet.kernel_result(k1)
    assert torch.equal(got.alpha, want.alpha)
    for x, y in zip(got.stats, want.stats):
        assert torch.equal(x, y)


def test_fused_gd_equals_per_step_gd_on_the_card():
    """K1-GD runs the warp form of the lane body's GD op sequence, and the
    per-step GD path (K5 once per round, K4 per step) runs the lane body:
    on 4,096 random scenes at 3 rounds (48/8/4 steps) every output field
    is equal bit for bit."""
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(max_outer_iteration=3, inner_schedule=(48, 8, 4),
                           max_inner_iteration=48, fixed_iters=True,
                           max_obstacles=11)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(8), 4096,
                               device=dev)
    fused = fleet.fleet_solve(cfg, basis, scns, solver="gd", backend="fused")
    step = fleet.fleet_solve(cfg, basis, scns, solver="gd", backend="pallas")
    assert torch.equal(fused.alpha, step.alpha)
    for x, y in zip(fused.stats, step.stats):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def step_args(args):
    """One step's inputs on 1,000 random scenes: K5's state under penalties
    x1/x10/x100, a quarter of the lanes frozen, per-lane learning rates
    (BLS's four, or the GD schedule's first four)."""
    r = _round_args(args)
    cfg, kv, kvt, mix, a0, lsg, ljl, frozen, lr = r[:9]
    start, goal, ox, oy, ow = r[10:]
    ev = sk.cost_grad_eval(cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox,
                           oy, ow)
    g = torch.Generator().manual_seed(1)
    gd_lr = torch.tensor(cfg.gd_lr[:4])[
        torch.randint(0, 4, lr.shape, generator=g)].to(lr.device)
    head = (kv, kvt, mix, a0, ev.grad, ev.traj, ev.vel, ev.loss)
    tail = (frozen, lsg, ljl, start, goal, ox, oy, ow)
    return cfg, head, tail, {"bls": lr, "gd": gd_lr}


def _assert_eval_close(got, want):
    """A kernel's PallasEval against the plain version's, within
    chip_smoke.py's EVAL_BOUNDS: the loss 1e-5 relative, the gradient 1e-4
    of the lane's scale, traj and vel 1e-3 absolute."""
    assert float(((got.loss - want.loss).abs() / want.loss.abs()).max()) <= 1e-5
    scale = want.grad.abs().amax(dim=(0, 1))
    assert float(((got.grad - want.grad).abs().amax(dim=(0, 1))
                  / scale).max()) <= 1e-4
    for x, y in zip(got[2:], want[2:]):
        assert float((x - y).abs().max()) <= 1e-3


def test_eval_kernels_match_plain_versions(args):
    """K5 and K6 against their plain versions (phase 8's bounds), and bit
    for bit the same at 64 and 256 lanes per block."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    eargs = (kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow)
    n5, n6 = sk.cost_grad_eval.launches, sk.forward_eval.launches
    ek = sk.cost_grad_eval(cfg, *eargs)
    fk = sk.forward_eval(cfg, kv, mix, a0)
    assert sk.cost_grad_eval.launches == n5 + 1
    assert sk.forward_eval.launches == n6 + 1
    ep = sk.cost_grad_eval_reference(cfg, *eargs)
    fp = sk.forward_eval_reference(cfg, kv, mix, a0)
    torch.cuda.synchronize()
    _assert_eval_close(ek, ep)
    for x, y in zip(fk, fp):
        assert float((x - y).abs().max()) <= 1e-3
    for bt in (64, 256):
        c = cfg.replace(pallas_block_b=bt)
        for x, y in zip(sk.cost_grad_eval(c, *eargs), ek):
            assert torch.equal(x, y)
        for x, y in zip(sk.forward_eval(c, kv, mix, a0), fk):
            assert torch.equal(x, y)


@pytest.mark.parametrize("solver", ["bls", "gd", "bls_exact"])
def test_step_kernels_match_plain_versions(step_args, solver):
    """K3 (in either ladder tier) and K4, one step: frozen lanes bitwise
    unchanged, stop flags and lr in agreement with the plain version on
    CARD_SHORT_AGREEMENT_MIN of the lanes, and on those lanes alpha within
    ALPHA_REL_MAX and the loss, gradient, traj and vel within the bounds of
    the evaluation kernels; bit for bit the same at 64 and 256 lanes per
    block, and in place (``out`` = the input state) the same as into fresh
    tensors."""
    cfg, head, tail, lrs = step_args
    if solver == "bls_exact":
        cfg, solver = cfg.replace(ladder_eval="exact"), "bls"
    fn = sk.bls_inner_step if solver == "bls" else sk.gd_inner_step
    ref = (sk.bls_inner_step_reference if solver == "bls"
           else sk.gd_inner_step_reference)
    sargs = (*head, lrs[solver], *tail)
    before = fn.launches
    got = fn(cfg, *sargs)
    assert fn.launches == before + 1
    want = ref(cfg, *sargs)
    torch.cuda.synchronize()
    frozen = tail[0][0] > 0.5
    for x, y in zip(got, sargs[3:10]):
        assert torch.equal(x[..., frozen], y[..., frozen])
    same = ((got.minimized == want.minimized) & (got.new_lr == want.new_lr))[0]
    print(f"{cfg.ladder_eval} {solver}: stop flags and lr agree on "
          f"{float(same.float().mean()):.4f}")
    assert float(same.float().mean()) >= tfs.CARD_SHORT_AGREEMENT_MIN
    scale = want.new_alpha.abs().amax(dim=(0, 1))
    rel = ((got.new_alpha - want.new_alpha).abs().amax(dim=(0, 1)) / scale)[same]
    assert float(rel.max()) <= tfs.ALPHA_REL_MAX
    _assert_eval_close(
        sk.PallasEval(got.new_loss[:, same], got.new_grad[..., same],
                      got.new_traj[..., same], got.new_vel[..., same]),
        sk.PallasEval(want.new_loss[:, same], want.new_grad[..., same],
                      want.new_traj[..., same], want.new_vel[..., same]))
    for bt in (64, 256):
        for x, y in zip(fn(cfg.replace(pallas_block_b=bt), *sargs), got):
            assert torch.equal(x, y)
    state = [x.clone() for x in sargs[3:10]]
    fn(cfg, *sargs[:3], *state, *sargs[10:], out=state)
    for x, y in zip(state, got):
        assert torch.equal(x, y)


def _plain(ref):
    """A step or evaluation wrapper that runs the plain version on the card
    and honours ``out`` as the wrapper does."""
    def run(cfg, *args, out=None, work=None):
        res = ref(cfg, *args)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return type(res)(*out)

    run.launches = 0
    return run


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_per_step_driver_launches_the_kernels(monkeypatch, solver):
    """fleet_solve(backend="pallas") on the card at 2 rounds x 6 steps on
    1,000 random scenes: it launches its kernels (K5 per round, K3 or K4 per
    step, K6 per BLS round) and agrees with the same driver over the plain
    versions on the card on CARD_SHORT_AGREEMENT_MIN of the lanes (equal
    step counts, escalations and flags), alpha within ALPHA_REL_MAX."""
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(max_outer_iteration=2, max_inner_iteration=6,
                           fixed_iters=True, max_obstacles=11)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(5), BATCH,
                               device=dev)
    step = sk.bls_inner_step if solver == "bls" else sk.gd_inner_step
    n_step, n_eval = step.launches, sk.cost_grad_eval.launches
    got = fleet.fleet_solve(cfg, basis, scns, solver=solver, backend="pallas")
    torch.cuda.synchronize()
    assert step.launches > n_step and sk.cost_grad_eval.launches == n_eval + 2
    for name in ("bls_inner_step", "gd_inner_step", "cost_grad_eval",
                 "forward_eval"):
        monkeypatch.setattr(sk, name,
                            _plain(getattr(sk, f"{name}_reference")))
    want = fleet.fleet_solve(cfg, basis, scns, solver=solver, backend="pallas")
    agree, rel = tfs.lane_agreement(
        *(tfs.FusedSolve(r.alpha.movedim(0, -1).movedim(1, 0),
                         *(x.to(torch.float32)[None] for x in (
                             r.stats.final_cost, r.stats.converged,
                             r.stats.outer_iters, r.stats.inner_iters)))
          for r in (want, got)))
    print(f"{solver}: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    assert torch.isfinite(got.alpha).all()


def _exact(args):
    return (args[0].replace(ladder_eval="exact"), *args[1:])


def test_exact_kernels_match_plain_versions(args):
    """K1 and K2 in the exact tier (their third program) against their plain
    versions at 1 round x 4 steps (CARD_SHORT_AGREEMENT_MIN, ALPHA_REL_MAX),
    and bit for bit the same at 4 lanes per CTA and on one CTA."""
    a = _exact(args)
    before = tfs.fused_solve.launches
    got = tfs.fused_solve(*a)
    assert tfs.fused_solve.launches == before + 1
    agree, rel = tfs.lane_agreement(tfs.fused_solve_reference(*a), got)
    print(f"K1-exact: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    rargs = _round_args(a)
    k2 = tfs.fused_round(*rargs)
    agree, rel = _masked_agreement(tfs.fused_round_reference(*rargs), k2,
                                   rargs[7])
    print(f"K2-exact: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    for warps, ctas in ((4, 0), (0, 1)):
        c = a[0].replace(pallas_block_b=warps)
        for x, y in zip(tfs.fused_solve(c, *a[1:], ctas=ctas), got):
            assert torch.equal(x, y)
        for x, y in zip(tfs.fused_round(c, *rargs[1:], ctas=ctas), k2):
            assert torch.equal(x, y)


def test_fused_exact_equals_per_step_exact_on_the_card():
    """K1-exact runs the warp form of the lane body's exact BLS step, and
    the per-step exact path (K5 once per round, K3-exact per step, no K6)
    runs the lane body: on 4,096 random scenes at 3 rounds (48/8/4 steps)
    every output field is equal bit for bit; so is the rounds driver over
    K2-exact with lane compaction."""
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(max_outer_iteration=3, inner_schedule=(48, 8, 4),
                           max_inner_iteration=48, fixed_iters=True,
                           max_obstacles=11, ladder_eval="exact")
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(8), 4096,
                               device=dev)
    fused = fleet.fleet_solve(cfg, basis, scns, backend="fused")
    n6 = sk.forward_eval.launches
    step = fleet.fleet_solve(cfg, basis, scns, backend="pallas")
    assert sk.forward_eval.launches == n6
    rounds = fleet.fleet_solve(cfg.replace(lane_compaction=True), basis, scns,
                               backend="fused")
    for other in (step, rounds):
        assert torch.equal(fused.alpha, other.alpha)
        for x, y in zip(fused.stats, other.stats):
            assert torch.equal(x, y)
