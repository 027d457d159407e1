"""The fused kernels' launch plan (ops/fused_solve.py: one warp per lane,
``pallas_block_b`` lanes per CTA) and the wrappers' CPU path.

The CUDA side (csrc/warp_body.cuh, fused_solve.cu) computes the same shared
memory per CTA and refuses what it cannot take; chip_smoke.py phase 1 holds
the two equal on the card.  Here: the plan's arithmetic and limits, the
checks the wrappers make before any launch, and that on CPU tensors the
wrappers still run the plain versions unchanged.
"""

import pytest
import torch

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops import step_kernels as sk
from irm_motion_planning_tpu_torch.solvers import fleet

SHORT = dict(max_outer_iteration=1, max_inner_iteration=2, fixed_iters=True,
             max_obstacles=11)
# Hopper's opt-in shared memory per block (227 KB) and per SM (228 KB).
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472


@pytest.fixture(scope="module")
def args():
    cfg = mt.PlannerConfig(**SHORT)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(2), 4,
                               device="cpu")
    return fleet.fused_args(cfg, basis, scns)


def _round_args(args):
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    B = a0.shape[-1]
    ful = torch.tensor([[0.0, 1.0, 0.0, 0.0]])
    lr0 = torch.full((1, B), cfg.bls_lr_start)
    return (cfg, kv, kvt, mix, a0, lsg, ljl, ful, lr0, 2, start, goal, ox, oy,
            ow)


@pytest.mark.parametrize("warps", [0, 4, 8, 16])
def test_plan_fits_shared_memory(warps):
    """At T=50, O=11 (the bench) the plan fits one CTA at the default and at
    the shapes chip_smoke.py runs; its pieces are the layout of
    warp_body.cuh: the basis pair transposed and mix per CTA, per warp four
    (J, T) planes, 8 reduction rows of T padded to a multiple of 4, the
    obstacle terms and 20 floats of endpoints."""
    cfg = mt.PlannerConfig(max_obstacles=11, pallas_block_b=warps)
    plan = tfs.launch_plan(cfg, 11)
    w = warps or tfs.DEFAULT_WARPS
    assert plan["warps"] == w
    assert plan["bytes"] == {
        "basis": 4 * 4 * 50 * 50, "mix": 48, "planes": w * 4 * 4 * 3 * 50,
        "buffer": w * 4 * 8 * 52, "obstacles": w * 4 * 4 * 11,
        "endpoints": w * 4 * 20,
    }
    assert plan["total"] == sum(plan["bytes"].values()) <= SMEM_LIMIT
    if w == tfs.DEFAULT_WARPS:
        # Two CTAs of the default fit on one SM (228 KB, 1 KB reserved each).
        assert 2 * (plan["total"] + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("T", [65, 120])
def test_plan_refuses_large_t(T):
    """A T beyond the resident body (two timesteps per thread; a resident
    basis pair of 16 T^2 bytes) gets the streamed plan: no basis in shared
    memory, at most the default's warps per CTA, within the limit; the
    resident plan, asked for at this T, raises NotImplementedError naming
    the streamed plan."""
    cfg = mt.PlannerConfig(n_timesteps=T, max_obstacles=11)
    plan = tfs.launch_plan(cfg, 11)
    assert plan["plan"] == "streamed" and "basis" not in plan["bytes"]
    assert 1 <= plan["warps"] <= tfs.DEFAULT_WARPS
    assert plan["total"] == sum(plan["bytes"].values()) <= SMEM_LIMIT
    with pytest.raises(NotImplementedError, match="streamed plan"):
        tfs.launch_plan(cfg, 11, "resident")


@pytest.mark.parametrize("bad", [-1, 17, 64, 128])
@pytest.mark.parametrize("kernel", ["fused_solve", "fused_round"])
def test_fused_kernels_refuse_bad_lanes_per_cta(args, kernel, bad):
    """For K1/K2 ``pallas_block_b`` is lanes (warps) per CTA, 1..16: other
    values raise ValueError, on the CPU too, before anything runs."""
    cfg = args[0].replace(pallas_block_b=bad)
    with pytest.raises(ValueError, match="warps"):
        tfs.launch_plan(cfg, 11)
    with pytest.raises(ValueError, match="warps"):
        if kernel == "fused_solve":
            tfs.fused_solve(cfg, *args[1:])
        else:
            tfs.fused_round(cfg, *_round_args(args)[1:])


@pytest.mark.parametrize("threads", [64, 128, 256])
def test_step_kernels_keep_threads_per_block(args, threads):
    """K3-K6 read ``pallas_block_b`` as threads (K3-K5: one warp per lane,
    2, 4 and 8 lanes per CTA): 64, 128 and 256 run (the plain versions, on
    the CPU) and give the default's results."""
    cfg, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
    c = cfg.replace(pallas_block_b=threads)
    eargs = (kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow)
    ev = sk.cost_grad_eval(c, *eargs)
    for x, y in zip(ev, sk.cost_grad_eval(cfg, *eargs)):
        assert torch.equal(x, y)
    fw = sk.forward_eval(c, kv, mix, a0)
    assert torch.equal(fw.traj, ev.traj)
    state = (a0, ev.grad, ev.traj, ev.vel, ev.loss)
    tail = (torch.zeros_like(lsg), lsg, ljl, start, goal, ox, oy, ow)
    for step, lr in ((sk.bls_inner_step, cfg.bls_lr_start),
                     (sk.gd_inner_step, cfg.gd_lr[0])):
        lrs = torch.full_like(lsg, lr)
        got = step(c, kv, kvt, mix, *state, lrs, *tail)
        want = step(cfg, kv, kvt, mix, *state, lrs, *tail)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_fused_solve_cpu_runs_plain_version(args):
    """On CPU tensors fused_solve is its plain version, bit for bit, at
    every lanes-per-CTA value and grid size, and launches nothing."""
    before = tfs.fused_solve.launches
    want = tfs.fused_solve_reference(*args)
    for warps, ctas in ((0, 0), (4, 1)):
        got = tfs.fused_solve(args[0].replace(pallas_block_b=warps),
                              *args[1:], ctas=ctas)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert tfs.fused_solve.launches == before


def test_fused_round_cpu_runs_plain_version(args):
    """On CPU tensors fused_round is its plain version, bit for bit (the
    fulfilled lane passes through), and launches nothing."""
    rargs = _round_args(args)
    before = tfs.fused_round.launches
    want = tfs.fused_round_reference(*rargs)
    got = tfs.fused_round(rargs[0].replace(pallas_block_b=8), *rargs[1:],
                          ctas=1)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert torch.equal(got.alpha[..., 1], rargs[4][..., 1])
    assert float(got.ok[0, 1]) == 1.0 and float(got.inner[0, 1]) == 0.0
    assert tfs.fused_round.launches == before


# --------------------------------------------------------------------------
# K4 (one warp per lane, K1-GD's plan) and K6 (the tiled product).
# --------------------------------------------------------------------------


@pytest.mark.parametrize("T,threads,lanes,plan", [
    (50, 0, 16, "resident"), (50, 32, 1, "resident"), (50, 64, 2, "resident"),
    (50, 160, 5, "resident"), (50, 512, 16, "resident"),
    (200, 0, 8, "streamed"), (200, 64, 2, "streamed"),
    (200, 320, 8, "streamed"), (200, 512, 8, "streamed")])
def test_gd_step_plan_is_k1_gds(T, threads, lanes, plan):
    """K4's lanes per CTA are ``pallas_block_b / 32`` (one warp per lane;
    the default 16), in K1-GD's launch plan: the resident body at T = 50,
    the streamed one at T = 200, which takes as many of them as leave its
    K7 ring 48 KB (8; its CTA has fused_solve.STREAM_WARPS warps).
    The plan reports the shared memory per CTA by piece, K1-GD's own, and
    fits a CTA."""
    cfg = mt.PlannerConfig(n_timesteps=T, pallas_block_b=threads,
                           max_obstacles=11)
    got = sk.gd_step_plan(cfg, 11)
    want = tfs.launch_plan(cfg.replace(pallas_block_b=threads // 32), 11,
                           prog="gd")
    assert (got["lanes"], got["plan"]) == (lanes, plan)
    assert got == want
    assert got["total"] == sum(got["bytes"].values()) <= SMEM_LIMIT


@pytest.mark.parametrize("plan", ["bls_step_plan", "cost_grad_eval_plan"])
@pytest.mark.parametrize("ladder", ["linearized", "exact"])
@pytest.mark.parametrize("threads", [48, 544, 1024])
def test_bls_step_plan_refuses_partial_warps(args, plan, ladder, threads):
    """K3's and K5's plans refuse a ``pallas_block_b`` that is not whole
    warps, or more than 16 of them, as K4's does, on the CPU too; so does
    the per-step backend before it runs anything."""
    cfg = args[0].replace(pallas_block_b=threads, ladder_eval=ladder)
    with pytest.raises(ValueError, match="one warp per lane"):
        getattr(sk, plan)(cfg, 11)


@pytest.mark.parametrize("threads", [48, 544, 1024])
def test_gd_step_plan_refuses_partial_warps(args, threads):
    """A ``pallas_block_b`` that is not whole warps, or more than 16 of
    them, is refused before anything runs, on the CPU too."""
    cfg = args[0].replace(pallas_block_b=threads)
    with pytest.raises(ValueError, match="one warp per lane"):
        sk.gd_step_plan(cfg, 11)


@pytest.mark.parametrize("T,row_tiles", [(25, 1), (50, 2), (200, 7)])
def test_forward_plan_reports_its_tile(T, row_tiles):
    """K6's tile: 64 of the 2T output rows by 64 lanes per CTA, 10
    timesteps per stage in two stages, 256 threads, its static shared
    memory by piece (the transposed basis' and alpha's stages: 5,120 and
    15,360 B); the basis' rows padded to the row tiles."""
    plan = sk.forward_plan(mt.PlannerConfig(n_timesteps=T))
    assert (plan["rows"], plan["lanes"], plan["tk"], plan["threads"],
            plan["stages"]) == (64, 64, 10, 256, 2)
    assert plan["row_tiles"] == row_tiles and plan["lda"] == 64 * row_tiles
    assert plan["bytes"] == {"basis": 5120, "alpha": 15360}
    assert plan["total"] == 20480


def test_forward_basis_is_the_padded_transpose():
    """K6 reads kv transposed, its 2T rows zero-padded to the plan's lda,
    built once per basis."""
    cfg = mt.PlannerConfig()
    kv = mt.make_basis(cfg, device="cpu").kv
    lda = sk.forward_plan(cfg)["lda"]
    got = sk.forward_basis(kv, lda)
    assert got.shape == (50, lda)
    assert torch.equal(got[:, :100], kv.T)
    assert not got[:, 100:].any()
    assert sk.forward_basis(kv, lda) is got


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_per_step_backend_takes_threads_per_block(solver):
    """fleet_solve(backend="pallas") reads ``pallas_block_b`` as threads per
    CTA (K3, K4, K5: whole warps, one per lane), not as K1's lanes per
    CTA: 128 runs and gives the default's result."""
    cfg = mt.PlannerConfig(**SHORT)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(2), 2,
                               device="cpu")
    want = fleet.fleet_solve(cfg, basis, scns, solver=solver,
                             backend="pallas")
    got = fleet.fleet_solve(cfg.replace(pallas_block_b=128), basis, scns,
                            solver=solver, backend="pallas")
    assert torch.equal(got.alpha, want.alpha)


@pytest.mark.parametrize("solver,ladder", [
    ("gd", "linearized"), ("bls", "linearized"), ("bls", "exact")])
def test_per_step_driver_takes_no_workspace(monkeypatch, solver, ladder):
    """The per-step driver allocates no workspace: K3, K4 and K5 keep their
    scratch on chip, so each launch takes its inputs and ``out`` (the
    driver's state) and nothing else, and step_kernels has no workspace to
    give."""
    calls = []
    for name in ("bls_inner_step", "gd_inner_step", "cost_grad_eval"):
        def spy(*a, _fn=getattr(sk, name), _name=name, **kw):
            calls.append((_name, sorted(kw)))
            return _fn(*a, **kw)

        monkeypatch.setattr(sk, name, spy)
    cfg = mt.PlannerConfig(ladder_eval=ladder, **SHORT)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(2), 2,
                               device="cpu")
    fleet.fleet_solve(cfg, basis, scns, solver=solver, backend="pallas")
    step = "gd_inner_step" if solver == "gd" else "bls_inner_step"
    assert {name for name, _ in calls} == {step, "cost_grad_eval"}
    assert all(kw == ["out"] for _, kw in calls)
    assert not hasattr(sk, "workspace")
