"""The streamed plan's CTA-cooperative basis stream (K7): its launch plan,
the lockstep contract the kernels are held to, and the design's L2 reads.

A CTA of the streamed plan runs a tile of lanes in lockstep and reads each
basis tile once for the whole tile through a ring of shared-memory stages
(csrc/warp_body.cuh, k7_product).  What the CPU can check: the plan's
pieces (ops/fused_solve.py, launch_plan, the mirror of warp_smem_bytes),
that a lane's plain result does not depend on the lanes solved beside it
(the contract the lockstep kernel meets bit for bit on the card:
chip_smoke.py phases 17 and 18), and the roofline's count of the design's
L2 reads.
"""

import pytest
import torch

import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.ops import fused_solve as tfs
from irm_motion_planning_tpu_torch.ops import roofline
from irm_motion_planning_tpu_torch.solvers import fleet as tfleet

SMEM_LIMIT = 232448
SHORT = dict(max_inner_iteration=6, max_outer_iteration=3, fixed_iters=True,
             max_obstacles=11)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("T,prog,lanes,blocks,kv,kvt,ring", [
    (72, "bls", 15, 8, (144, 1, 56), (72, 1, 113), 65536),
    (100, "bls", 15, 8, (200, 1, 40), (100, 1, 81), 65536),
    (200, "bls", 8, 4, (400, 1, 19), (200, 1, 39), 63872),
    (200, "bls_bf16", 8, 4, (400, 1, 20), (200, 1, 40), 65536),
    (2200, "bls_bf16", 1, 1, (960, 5, 7), (960, 3, 7), 56064),
])
def test_streamed_plan_ring(T, prog, lanes, blocks, kv, kvt, ring):
    """The streamed plan's tile and ring at T = 72, 100, 200 (the float32
    programs, and the bf16 program's half-width layout at T = 200) and the
    bf16 plan at T = 2,200 (one lane fills the CTA): the lanes per CTA (the
    most, at most 15, that leave the ring 48 KB and run each product in one
    pass), the CTA's STREAM_WARPS warps (the lanes', helpers, K7's
    producer), the lane blocks of K7_LANES lanes; per basis product the row
    block (the rows of one pass: K7_ROWS rows a thread of the 15 consumer
    warps' for each lane block, K7_SOLO_ROWS for one lane alone), the
    passes and the timesteps per ring
    stage (the room over K7_STAGES row blocks); the ring's bytes (the room,
    which holds the tile's gx/gy planes between products); the total
    within 232,448 bytes."""
    plan = tfs.launch_plan(mt.PlannerConfig(n_timesteps=T), 11, prog=prog)
    got = plan["ring"]
    assert plan["plan"] == "streamed" and plan["bf16"] == (prog == "bls_bf16")
    assert (plan["lanes"], plan["warps"], got["lane_blocks"]) == (
        lanes, tfs.STREAM_WARPS, blocks)
    assert got["ring_bytes"] == plan["bytes"]["room"] == ring
    consumers = 32 * (tfs.STREAM_WARPS - 1)
    for name, rows, want in (("kv", 2 * T, kv), ("kvt", T, kvt)):
        g = got[name]
        assert (g["row_block"], g["passes"], g["stage_t"]) == want
        assert g["row_block"] % 4 == 0 and g["row_block"] <= -(-rows // 4) * 4
        rows_per_thread = tfs.K7_SOLO_ROWS if lanes == 1 else tfs.K7_ROWS
        assert blocks * g["row_block"] <= rows_per_thread * consumers
        assert g["passes"] * g["row_block"] >= rows
        assert tfs.K7_STAGES * g["stage_t"] * g["row_block"] * 4 <= ring
    assert ring >= 4 * 2 * T * lanes
    assert plan["bytes"]["control"] == 80  # the mbarriers, the tile base
    assert plan["total"] == sum(plan["bytes"].values()) <= SMEM_LIMIT


@pytest.mark.parametrize("prog,plan,T,ok", [
    ("bls", "streamed", 2072, True), ("bls", "streamed", 2073, False),
    ("bls_bf16", "streamed", 2636, True),
    ("bls_bf16", "streamed", 2637, False),
    ("gd", "reach", 2636, True), ("gd", "reach", 2637, False),
    ("bls", "reach", 2156, True), ("bls", "reach", 2157, False)])
def test_ceilings_keep_their_values(prog, plan, T, ok):
    """The ring shares the room of the tile's gx/gy planes, so the plans'
    ceilings at 11 obstacles keep their values: the float32 streamed plan
    holds one lane up to T = 2,072, the bf16 plan up to T = 2,636; the
    reach plan's ring keeps a timestep per stage in what its lane leaves:
    GD's (no direction planes) up to T = 2,636, the linearized ladder's
    (gx/gy in the direction planes, the room the ring's alone) up to
    2,156."""
    cfg = mt.PlannerConfig(n_timesteps=T)
    if ok:
        got = tfs.launch_plan(cfg, 11, plan, prog)
        assert got["lanes"] == 1 and got["total"] <= SMEM_LIMIT
        assert min(got["ring"]["kv"]["stage_t"],
                   got["ring"]["kvt"]["stage_t"]) >= 1
    else:
        with pytest.raises(NotImplementedError):
            tfs.launch_plan(cfg, 11, plan, prog)


@pytest.mark.parametrize("prog", ["bls", "gd", "bls_exact", "bls_ultra",
                                  "bls_bf16"])
def test_ragged_batch_equals_lanes_alone(prog):
    """The lockstep kernel's contract: on a ragged batch, whose lanes stop
    at different steps and rounds, each lane's result is the one it gets
    solved alone (B = 1).  The plain fused_solve at T = 100 (a streamed
    T), six random scenes, three rounds of six steps: alpha, the loss,
    the counts and the flags bit for bit (each lane's sums over T are its
    own row's: fused_solve.t_sums)."""
    solver, ladder, tier = tfs.program_call(prog)
    cfg = mt.PlannerConfig(n_timesteps=100, **SHORT, ladder_eval=ladder)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(3), 6,
                               device="cpu")
    args = tfleet.fused_args(cfg, basis, scns)
    full = tfs.fused_solve_reference(*args, solver=solver, **tier)
    assert len(set(full.inner_iters[0].tolist())) > 1, "lanes not ragged"
    for b in range(6):
        one = tfs.fused_solve_reference(
            cfg, *args[1:4], *(x[..., b:b + 1] for x in args[4:]),
            solver=solver, **tier)
        for name in ("alpha", "final_loss", "fulfilled", "outer_iters",
                     "inner_iters"):
            assert torch.equal(getattr(full, name)[..., b:b + 1],
                               getattr(one, name)), (b, name)


@pytest.mark.parametrize("solver", ["bls", "gd"])
def test_round_passes_fulfilled_lanes_through(solver):
    """K2's lockstep contract: in one round over a batch where a third of
    the lanes come in fulfilled (masked in their tile on the card), every
    other lane's result is the one it gets alone, bit for bit, and a
    fulfilled lane passes through (alpha unchanged, loss 0, ok 1, no
    steps)."""
    cfg = mt.PlannerConfig(n_timesteps=100, **SHORT)
    basis = mt.make_basis(cfg, device="cpu")
    scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(4), 6,
                               device="cpu")
    _, kv, kvt, mix, a0, lsg, ljl, *lanes = tfleet.fused_args(cfg, basis,
                                                              scns)
    ful = torch.tensor([[0.0, 1.0, 0.0, 0.0, 1.0, 0.0]])
    lr0 = torch.full((1, 6), tfs.round_lr(cfg, 0, solver))
    full = tfs.fused_round_reference(cfg, kv, kvt, mix, a0, lsg, ljl, ful,
                                     lr0, 6, *lanes, solver=solver)
    for b in range(6):
        one = tfs.fused_round_reference(
            cfg, kv, kvt, mix, a0[..., b:b + 1], lsg[..., b:b + 1],
            ljl[..., b:b + 1], ful[..., b:b + 1], lr0[..., b:b + 1], 6,
            *(x[..., b:b + 1] for x in lanes), solver=solver)
        for name in ("alpha", "loss", "ok", "inner"):
            assert torch.equal(getattr(full, name)[..., b:b + 1],
                               getattr(one, name)), (b, name)
    passed = ful[0] > 0.5
    assert torch.equal(full.alpha[..., passed], a0[..., passed])
    assert (full.loss[0, passed] == 0).all()
    assert (full.ok[0, passed] == 1).all()
    assert (full.inner[0, passed] == 0).all()


def test_design_l2_reads_once_per_tile():
    """roofline.fused_rounds: the streamed programs' basis products read
    the basis from L2 once per product per tile of ``lanes_per_cta`` lanes
    (the plan's lanes: 8 at T = 200), not per lane; the bound (the
    function's: operations and the inputs read once) does not change.
    K2's launches and K4 likewise."""
    B, T, J, O = 4096, 200, 3, 11
    tally = {"rounds": 10.0 * B, "steps": 150.0 * B, "rungs": 400.0 * B,
             "pullbacks": 140.0 * B, "accepted": 140.0 * B}
    lanes = tfs.launch_plan(mt.PlannerConfig(n_timesteps=T), O)["lanes"]
    assert lanes == 8
    for solver, ladder in (("bls", "linearized"), ("bls", "exact"),
                           ("gd", "linearized")):
        per_lane = roofline.fused_rounds(B, T, J, O, tally, True, solver,
                                         ladder, streamed=True)
        tiled = roofline.fused_rounds(B, T, J, O, tally, True, solver,
                                      ladder, streamed=True,
                                      lanes_per_cta=lanes)
        products = roofline.fused_products(B, tally, True, solver, ladder)
        assert per_lane.l2_bytes == products * roofline.product_bytes(T)
        assert tiled.l2_bytes == pytest.approx(per_lane.l2_bytes / lanes)
        assert (tiled.bytes, tiled.ops, tiled.ms) == (
            per_lane.bytes, per_lane.ops, per_lane.ms)
        k2 = roofline.fused_round_launches(B, T, J, O, tally, [B] * 10,
                                           solver, ladder, streamed=True,
                                           lanes_per_cta=lanes)
        assert k2.l2_bytes == pytest.approx(
            roofline.fused_rounds(B, T, J, O, tally, False, solver, ladder,
                                  streamed=True).l2_bytes / lanes)
    k4 = roofline.gd_inner_step(B, T, J, O, tally, streamed=True)
    k4_tiled = roofline.gd_inner_step(B, T, J, O, tally, streamed=True,
                                      lanes_per_cta=lanes)
    assert k4_tiled.l2_bytes == pytest.approx(k4.l2_bytes / lanes)
    assert k4_tiled.ms == k4.ms
