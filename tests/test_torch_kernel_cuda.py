"""The port's CUDA kernels (csrc/fused_solve.cu: the whole solve and one
penalty round, for BLS in either ladder tier and GD; csrc/step_kernels.cu:
the per-step kernels) against their plain PyTorch versions on the same
card, the rounds driver against the whole-solve kernel, the fused GD and
exact-ladder kernels against their per-step paths, the per-step driver on
the card, and large T: the streamed programs of K1/K2 (K7) bit for bit the
resident ones at T = 50 and, with K3-K6 in the streamed body (K3-K5) or
tiled (K6), against their plain versions at T = 200, and K1/K2's reach
plan bit for bit the streamed one at T = 200; and the kernel tiers
of K1/K2
(lean, ultra, bf16) against their plain versions at T = 50 and 200; and
K1's phase-ablated builds (``WB_ABLATE_*``), which must launch and leave
the default library as it was.  The
kernels have no CPU
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
# Not a multiple of 3, 16, 64 or 256: the per-step kernels' last tile and
# K6's last block are partly masked; the fused kernels' warps draw lanes from
# a queue until 1,000.
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
    """K1-GD and the per-step GD path (K5 once per round, K4 per step) run
    the warp body's GD step: on 4,096 random scenes at 3 rounds (48/8/4
    steps) every output field is equal bit for bit."""
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
    for bit the same at 64 and 256 threads (K5: 2 and 8 lanes per CTA)."""
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
    the evaluation kernels; bit for bit the same at 64 and 256 threads (2
    and 8 lanes per CTA), and in place (``out`` = the input state) the same
    as into fresh tensors."""
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
    def run(cfg, *args, out=None):
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
    """K1-exact and the per-step exact path (K5 once per round, K3-exact
    per step, no K6) run the warp body's exact BLS step: on 4,096 random
    scenes at 3 rounds (48/8/4 steps) every output field is equal bit for
    bit; so is the rounds driver over K2-exact with lane compaction."""
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


# --------------------------------------------------------------------------
# The streamed body of K1/K2 (K7) and K3-K6 with the basis in device memory.
# --------------------------------------------------------------------------

PROGRAMS = pytest.mark.parametrize("solver,ladder", [
    ("bls", "linearized"), ("gd", "linearized"), ("bls", "exact")])


@PROGRAMS
def test_streamed_kernels_equal_resident_at_t50(args, solver, ladder):
    """At T = 50 both bodies run: K1 and K2 in the streamed plan (the basis
    streamed from device memory by K7, traj/vel/gx/gy in shared memory)
    give the resident plan's outputs bit for bit, for every program, also
    at 4 lanes per CTA and on one CTA."""
    cfg = args[0].replace(ladder_eval=ladder)
    a = (cfg, *args[1:])
    want = tfs.fused_solve(*a, solver=solver, plan="resident")
    for c, ctas in ((cfg, 0), (cfg.replace(pallas_block_b=4), 1)):
        got = tfs.fused_solve(c, *a[1:], solver=solver, plan="streamed",
                              ctas=ctas)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    rargs = _round_args(a, solver=solver)
    want = tfs.fused_round(*rargs, solver=solver, plan="resident")
    got = tfs.fused_round(*rargs, solver=solver, plan="streamed")
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def args200():
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(**{**SHORT, "n_timesteps": 200})
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(7), BATCH,
                               device=dev)
    return fleet.fused_args(cfg, basis, scns)


@PROGRAMS
def test_streamed_kernels_match_plain_versions_at_t200(args200, solver,
                                                        ladder):
    """At T = 200 (the streamed plan: 10 lanes per CTA) K1 and K2 agree with
    their plain versions (CARD_SHORT_AGREEMENT_MIN, ALPHA_REL_MAX), and the
    first 500 lanes alone give the same lanes bit for bit."""
    cfg = args200[0].replace(ladder_eval=ladder)
    a = (cfg, *args200[1:])
    assert tfs.launch_plan(cfg, 11)["plan"] == "streamed"
    got = tfs.fused_solve(*a, solver=solver)
    agree, rel = tfs.lane_agreement(
        tfs.fused_solve_reference(*a, solver=solver), got)
    print(f"K1 T=200: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    cut = tfs.fused_solve(cfg, *a[1:4], *(x[..., :500] for x in a[4:]),
                          solver=solver)
    for x, y in zip(cut, got):
        assert torch.equal(x, y[..., :500])
    rargs = _round_args(a, solver=solver)
    agree, rel = _masked_agreement(
        tfs.fused_round_reference(*rargs, solver=solver),
        tfs.fused_round(*rargs, solver=solver), rargs[7])
    print(f"K2 T=200: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX


@PROGRAMS
def test_reach_layout_equals_streamed_at_t200(args200, solver, ladder):
    """At T = 200 both streamed layouts run: K1 and K2 in the reach plan
    (the gradient pass recomputing FK; GD and the exact ladder without the
    direction planes, the linearized ladder with gx/gy in them) give the
    streamed plan's outputs bit for bit, also at 3 lanes per CTA."""
    cfg = args200[0].replace(ladder_eval=ladder)
    a = (cfg, *args200[1:])
    want = tfs.fused_solve(*a, solver=solver, plan="streamed")
    for c in (cfg, cfg.replace(pallas_block_b=3)):
        got = tfs.fused_solve(c, *a[1:], solver=solver, plan="reach")
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    rargs = _round_args(a, solver=solver)
    want = tfs.fused_round(*rargs, solver=solver, plan="streamed")
    got = tfs.fused_round(*rargs, solver=solver, plan="reach")
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_step_kernels_match_plain_versions_at_t200(args200):
    """At T = 200 K3-K5 run the streamed body (the basis from device memory
    through K7): K5 and K6 within the evaluation bounds of the resident
    comparisons, one K3 step (both tiers) and one K4 step with the stop
    flags and lr equal on CARD_SHORT_AGREEMENT_MIN of the lanes."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args200
    assert all(plan(cfg, 11)["plan"] == "streamed" for plan in (
        sk.bls_step_plan, sk.gd_step_plan, sk.cost_grad_eval_plan))
    eargs = (kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow)
    ev = sk.cost_grad_eval(cfg, *eargs)
    ref = sk.cost_grad_eval_reference(cfg, *eargs)
    assert float(((ev.loss - ref.loss).abs() / ref.loss.abs()).max()) <= 1e-5
    for x, y in zip(ev[2:], ref[2:]):
        assert float((x - y).abs().max()) <= 1e-3
    fw = sk.forward_eval(cfg, kv, mix, a0)
    for x, y in zip(fw, sk.forward_eval_reference(cfg, kv, mix, a0)):
        assert float((x - y).abs().max()) <= 1e-3
    live = torch.zeros_like(lsg)
    for fn, lr, c in (
            (sk.bls_inner_step, cfg.bls_lr_start, cfg),
            (sk.bls_inner_step, cfg.bls_lr_start,
             cfg.replace(ladder_eval="exact")),
            (sk.gd_inner_step, cfg.gd_lr[0], cfg)):
        state = (a0, ev.grad, ev.traj, ev.vel, ev.loss,
                 torch.full_like(lsg, lr), live)
        got = fn(c, kv, kvt, mix, *state, lsg, ljl, start, goal, ox, oy, ow)
        want = (sk.bls_inner_step_reference if fn is sk.bls_inner_step
                else sk.gd_inner_step_reference)(
            c, kv, kvt, mix, *state, lsg, ljl, start, goal, ox, oy, ow)
        same = ((got.minimized == want.minimized)
                & (got.new_lr == want.new_lr))[0]
        assert float(same.float().mean()) >= tfs.CARD_SHORT_AGREEMENT_MIN
        scale = want.new_alpha.abs().amax(dim=(0, 1))
        rel = ((got.new_alpha - want.new_alpha).abs().amax(dim=(0, 1))
               / scale)[same]
        assert float(rel.max()) <= tfs.ALPHA_REL_MAX


@pytest.mark.parametrize("which", ["args", "args200"])
def test_forward_eval_is_cost_grad_evals_evaluation(request, which):
    """K6 (the tiled product) gives K5's traj and vel on the same alpha bit
    for bit, at T = 50 and T = 200, on 1,000 lanes (16-byte copies) and on
    999 (4-byte copies, B not a multiple of 4)."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = (
        request.getfixturevalue(which))
    for n in (BATCH, BATCH - 1):
        cut = [x[..., :n].contiguous() for x in (a0, lsg, ljl, start, goal,
                                                  ox, oy, ow)]
        ev = sk.cost_grad_eval(cfg, kv, kvt, mix, *cut)
        fw = sk.forward_eval(cfg, kv, mix, cut[0])
        assert torch.equal(fw.traj, ev.traj) and torch.equal(fw.vel, ev.vel)


@pytest.mark.parametrize("threads", [32, 160, 512])
def test_gd_step_lanes_do_not_depend_on_lanes_per_cta(args200, threads):
    """K4 at T = 200 (the streamed body) at 1, 5 and 10 lanes (warps) per
    CTA gives the default's outputs bit for bit."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args200
    ev = sk.cost_grad_eval(cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox,
                           oy, ow)
    state = (a0, ev.grad, ev.traj, ev.vel, ev.loss,
             torch.full_like(lsg, cfg.gd_lr[0]), torch.zeros_like(lsg))
    tail = (lsg, ljl, start, goal, ox, oy, ow)
    want = sk.gd_inner_step(cfg, kv, kvt, mix, *state, *tail)
    got = sk.gd_inner_step(cfg.replace(pallas_block_b=threads), kv, kvt, mix,
                           *state, *tail)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kernel", ["bls", "bls_exact", "cost_grad_eval"])
@pytest.mark.parametrize("T", [50, 200])
@pytest.mark.parametrize("threads", [32, 96, 160, 512])
def test_bls_step_and_eval_lanes_do_not_depend_on_lanes_per_cta(
        args, args200, kernel, T, threads):
    """K3 (both ladder tiers) and K5 at T = 50 (the resident body) and T =
    200 (the streamed body) at 1, 3, 5 and 16 lanes (warps) per CTA (the
    streamed plan takes at most 8 at T = 200) give the default's outputs
    bit for bit; a quarter of K3's lanes frozen."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = (
        args if T == 50 else args200)
    if kernel == "bls_exact":
        cfg = cfg.replace(ladder_eval="exact")
    eargs = (kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow)
    ev = sk.cost_grad_eval(cfg, *eargs)
    if kernel == "cost_grad_eval":
        got = sk.cost_grad_eval(cfg.replace(pallas_block_b=threads), *eargs)
        for x, y in zip(got, ev):
            assert torch.equal(x, y)
        return
    frozen = (torch.arange(a0.shape[-1], device=a0.device) % 4 == 1)
    state = (a0, ev.grad, ev.traj, ev.vel, ev.loss,
             torch.full_like(lsg, cfg.bls_lr_start),
             frozen.to(torch.float32)[None])
    tail = (lsg, ljl, start, goal, ox, oy, ow)
    want = sk.bls_inner_step(cfg, kv, kvt, mix, *state, *tail)
    got = sk.bls_inner_step(cfg.replace(pallas_block_b=threads), kv, kvt,
                            mix, *state, *tail)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for x, y in zip(got, state):
        assert torch.equal(x[..., frozen], y[..., frozen])


@pytest.mark.parametrize("T", [50, 200])
def test_fused_bls_equals_per_step_bls_on_the_card(T):
    """K1-BLS and the linearized per-step path (K5 once per round, K3 per
    step, K6 before the constraint check) run the warp body's carry
    program, whose recomputed loss (K3's) is the rung's: on 4,096 random
    scenes at 3 rounds (48/8/4 steps) every output field is equal bit for
    bit, at T = 50 and in the streamed body at T = 200."""
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(max_outer_iteration=3, inner_schedule=(48, 8, 4),
                           max_inner_iteration=48, fixed_iters=True,
                           max_obstacles=11, n_timesteps=T)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(8), 4096,
                               device=dev)
    fused = fleet.fleet_solve(cfg, basis, scns, backend="fused")
    n3 = sk.bls_inner_step.launches
    step = fleet.fleet_solve(cfg, basis, scns, backend="pallas")
    assert sk.bls_inner_step.launches > n3
    assert torch.equal(fused.alpha, step.alpha)
    for x, y in zip(fused.stats, step.stats):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# The kernel tiers of K1/K2 (the linearized ladder's lean, ultra and bf16
# tiers; lean runs the linearized program, fused_solve.program).
# --------------------------------------------------------------------------

TIERS = pytest.mark.parametrize("tier", ["lean", "ultra", "bf16"])


@TIERS
@pytest.mark.parametrize("T", [50, 200])
def test_tier_programs_match_plain_versions(args, args200, tier, T):
    """Each tier's K1 and K2 program against its plain version at T = 50
    (the resident body) and T = 200 (the streamed one; bf16's in the
    half-width layout), within the bounds chip_smoke.py holds the programs
    to (CARD_SHORT_AGREEMENT_MIN, ALPHA_REL_MAX); at T = 50 the streamed
    plan gives the resident plan's outputs bit for bit."""
    a = args if T == 50 else args200
    kw = {tier: True}
    prog = tfs.program(a[0], "bls", **kw)
    assert tfs.launch_plan(a[0], 11, prog=prog)["plan"] == (
        "resident" if T == 50 else "streamed")
    got = tfs.fused_solve(*a, **kw)
    agree, rel = tfs.lane_agreement(tfs.fused_solve_reference(*a, **kw), got)
    print(f"K1 {tier} T={T}: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    rargs = _round_args(a)
    got2 = tfs.fused_round(*rargs, **kw)
    agree, rel = _masked_agreement(tfs.fused_round_reference(*rargs, **kw),
                                   got2, rargs[7])
    print(f"K2 {tier} T={T}: lane agreement {agree:.4f}, alpha rel {rel:.3g}")
    assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN
    assert rel <= tfs.ALPHA_REL_MAX
    if T == 50:
        for x, y in zip(tfs.fused_solve(*a, plan="streamed", **kw), got):
            assert torch.equal(x, y)
        for x, y in zip(tfs.fused_round(*rargs, plan="streamed", **kw), got2):
            assert torch.equal(x, y)


# --------------------------------------------------------------------------
# Other joint counts: the libraries of J = 5 and 7 (and J = 3's).
# --------------------------------------------------------------------------

ARMS = {3: (1.5, 1.0, 0.5), 5: (1.0, 0.8, 0.6, 0.4, 0.2),
        7: (1.0, 0.9, 0.8, 0.6, 0.4, 0.3, 0.2)}
JOINTS = pytest.mark.parametrize("J", sorted(ARMS))


def _arm_args(J, T, batch=BATCH, **kw):
    dev = torch.device("cuda", 0)
    cfg = mt.PlannerConfig(**{**SHORT, **kw}, n_timesteps=T, n_joints=J,
                           link_length=ARMS[J])
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(3), batch,
                               device=dev)
    return fleet.fused_args(cfg, basis, scns)


@JOINTS
@pytest.mark.parametrize("T", [50, 200])
def test_kernels_match_plain_versions_at_each_j(J, T):
    """K1 (BLS, GD) and K2 at 1 round x 4 steps against their plain versions
    (CARD_SHORT_AGREEMENT_MIN), K5 within the evaluation's bounds, K6 bit
    for bit K5's traj/vel, and at T = 200 K7 alone bit for bit K6, in the
    library of J joints."""
    args = _arm_args(J, T)
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    for solver in ("bls", "gd"):
        before = tfs.fused_solve.launches
        got = tfs.fused_solve(*args, solver=solver)
        assert tfs.fused_solve.launches == before + 1
        agree, rel = tfs.lane_agreement(
            tfs.fused_solve_reference(*args, solver=solver), got)
        assert agree >= tfs.CARD_SHORT_AGREEMENT_MIN, (solver, agree)
        assert rel <= tfs.ALPHA_REL_MAX
    ful = (torch.rand((1, BATCH), generator=torch.Generator().manual_seed(0))
           < 0.25).float().to(a0.device)
    lr0 = torch.full_like(ful, tfs.round_lr(cfg, 0, "bls"))
    rin = (cfg, kv, kvt, mix, a0, lsg, ljl, ful, lr0, 4, start, goal, ox, oy,
           ow)
    k2, p2 = tfs.fused_round(*rin), tfs.fused_round_reference(*rin)
    same = ((k2.inner == p2.inner) & (k2.ok == p2.ok)).float().mean()
    assert float(same) >= tfs.CARD_SHORT_AGREEMENT_MIN
    lanes = (lsg, ljl, start, goal, ox, oy, ow)
    ev = sk.cost_grad_eval(cfg, kv, kvt, mix, a0, *lanes)
    ref = sk.cost_grad_eval_reference(cfg, kv, kvt, mix, a0, *lanes)
    assert float(((ev.loss - ref.loss).abs() / ref.loss.abs()).max()) <= 1e-5
    fwd = sk.forward_eval(cfg, kv, mix, a0)
    assert torch.equal(fwd.traj, ev.traj) and torch.equal(fwd.vel, ev.vel)
    if T > 64:
        traj, vel = tfs.k7_forward(cfg, kv, kvt, mix, a0)
        assert torch.equal(traj, fwd.traj) and torch.equal(vel, fwd.vel)


@JOINTS
@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_fleet_solve_launches_each_j_kernels(J, backend):
    """fleet_solve on the kernel backends launches the J library's kernels
    (no J raises, nothing falls back) and gives finite results."""
    cfg = mt.PlannerConfig(**SHORT, n_joints=J, link_length=ARMS[J])
    dev = torch.device("cuda", 0)
    basis = mt.make_basis(cfg, device=dev)
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(4), 256,
                               device=dev)
    counter = (tfs.fused_solve if backend == "fused" else sk.cost_grad_eval)
    before = counter.launches
    res = fleet.fleet_solve(cfg, basis, scns, backend=backend)
    assert counter.launches > before
    assert res.alpha.shape == (256, 50, J)
    assert torch.isfinite(res.alpha).all()


ABLATED = pytest.mark.parametrize("flag", [
    "WB_ABLATE_LADDER1", "WB_ABLATE_DIR_FORWARD", "WB_ABLATE_FK",
    "WB_ABLATE_OBSFIELD", "WB_ABLATE_PULLBACK"])


@ABLATED
def test_ablated_build_launches_and_leaves_the_default(args, flag):
    """Each phase-ablated build of K1 (ops/_build.py ``variant``) compiles
    and launches on the card (its results are wrong by design: finite
    shapes only); outside the block the default library launches again and
    gives its own results bit for bit."""
    from irm_motion_planning_tpu_torch.ops import _build

    before = tfs.fused_solve(*args)
    with _build.variant(3, (flag,)):
        got = tfs.fused_solve(*args)
        torch.cuda.synchronize()
    assert got.alpha.shape == before.alpha.shape
    assert torch.isfinite(got.final_loss).any()
    after = tfs.fused_solve(*args)
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert _build.load_library(3) is not None
