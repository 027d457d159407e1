"""The per-step kernels and their plain PyTorch versions (counterparts of
``pallas_step.bls_inner_step``, ``gd_inner_step``, ``cost_grad_eval`` and
``forward_eval`` in irm_motion_planning_tpu/ops/pallas_step.py).

* ``bls_inner_step`` (K3): one BLS inner step for every lane, in the ladder
  tier ``cfg.ladder_eval`` (linearized without the FK carry: the loss is
  recomputed at the accepted iterate; or exact); frozen lanes pass through;
* ``gd_inner_step`` (K4): one GD inner step; the stop test rejects the
  trial, lr passes through;
* ``cost_grad_eval`` (K5): loss, gradient and exact (traj, vel) at alpha;
* ``forward_eval`` (K6): the exact (traj, vel) of alpha.

Same names, arguments and layouts as the JAX functions: planes ``(J, T,
B)``, per-lane scalars ``(1, B)``, start/goal ``(J, B)``, obstacles ``(O,
B)``; results as ``PallasStep``/``PallasEval``/``PallasForward``.  CPU
tensors run the ``*_reference`` plain version beside each wrapper (built
from ops/fused_solve.py's pieces); CUDA tensors launch the kernel
(csrc/step_kernels.cu) or raise.  K3, K4 and K5 run the warp body of K1/K2,
one warp per lane, ``cfg.pallas_block_b / 32`` lanes per CTA
(fused_solve.DEFAULT_WARPS when it is 0) in K1's launch plan for their
program (:func:`bls_step_plan`, :func:`gd_step_plan`,
:func:`cost_grad_eval_plan`: the resident body up to T = 64, the streamed
one beyond); K6 is a tiled product whose tile does not depend on it
(:func:`forward_plan`).  None takes a workspace: what a step or an
evaluation computes between its loads and its stores stays on chip.

``out``: where the results go.  For K3/K4 a PallasStep of state tensors;
passing the input state itself updates it in place (what the solver's
driver does: the kernels write each lane's column where it lies).  Without
``out`` the inputs are left as they are.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..config import PlannerConfig
from . import fused_solve as fs

# The per-step kernels of the warp body, in the order of their index in
# csrc/step_kernels.cu (STEP_BLS = 0, STEP_BLS_EXACT = 1, STEP_GD = 2,
# STEP_EVAL = 3): K3 in each ladder tier, K4, K5.
STEP_KERNELS = ("bls_step", "bls_step_exact", "gd_step", "cost_grad_eval")


def _warp_plan(name: str, cfg: PlannerConfig, O: int, prog: str) -> dict:
    bt = cfg.pallas_block_b
    if bt and not (bt % 32 == 0 and 1 <= bt // 32 <= fs.MAX_WARPS):
        raise ValueError(
            f"{name} runs one warp per lane: pallas_block_b must be "
            f"32-{32 * fs.MAX_WARPS} threads in whole warps (0: "
            f"{fs.DEFAULT_WARPS} warps), got {bt}")
    # K1's resident or streamed plan; the reach plan is K1/K2's alone.
    plan = "resident" if cfg.n_timesteps <= fs.WARP_MAX_T else "streamed"
    return fs.launch_plan(cfg.replace(pallas_block_b=bt // 32), O, plan,
                          prog)


def bls_step_plan(cfg: PlannerConfig, O: int) -> dict:
    """K3's launch plan: one warp per lane, ``cfg.pallas_block_b / 32``
    lanes per CTA (fused_solve.DEFAULT_WARPS when it is 0), in K1's plan
    for the program of the ladder tier ``cfg.ladder_eval``
    (fused_solve.launch_plan of ``bls`` or ``bls_exact``: the resident body
    up to T = 64, the streamed one beyond, which takes as many of those
    lanes as fit, one warp each, in a CTA of fused_solve.STREAM_WARPS
    warps), with its shared memory per CTA by piece.  Raises ValueError for
    a ``pallas_block_b`` that is not 32-512 threads in whole warps (or 0),
    NotImplementedError where no plan fits (fleet_solve then runs xla)."""
    return _warp_plan("bls_inner_step", cfg, O,
                      "bls_exact" if cfg.ladder_eval == "exact" else "bls")


def gd_step_plan(cfg: PlannerConfig, O: int) -> dict:
    """K4's launch plan: as :func:`bls_step_plan`, in K1-GD's plan."""
    return _warp_plan("gd_inner_step", cfg, O, "gd")


def cost_grad_eval_plan(cfg: PlannerConfig, O: int) -> dict:
    """K5's launch plan: as :func:`bls_step_plan`, in K1-BLS's plan (the
    same on both per-step paths)."""
    return _warp_plan("cost_grad_eval", cfg, O, "bls")


def _step_shape(kernel: str, lp: dict, cfg: PlannerConfig, O: int,
                B: int) -> dict:
    from ._build import load_library

    out = (ctypes.c_int * 3)()
    err = load_library(cfg.n_joints).step_kernel_shape(
        fs.kernel_params(cfg, O, B, schedule=False),
        STEP_KERNELS.index(kernel), lp["lanes"], fs.PLANS.index(lp["plan"]),
        out)
    if err:
        raise RuntimeError(f"{kernel}: launch shape refused (CUDA error "
                           f"{err})")
    return {"ctas_per_sm": out[0], "sms": out[1], "smem": out[2],
            "warps_per_sm": out[0] * lp["warps"]}


def bls_step_shape(cfg: PlannerConfig, O: int, B: int) -> dict:
    """What the card makes of K3's plan (:func:`bls_step_plan`) in the
    ladder tier of ``cfg``: CTAs per SM (the occupancy calculator), SMs,
    shared memory per CTA as the C side computes it (step_kernel_shape in
    csrc/step_kernels.cu), warps per SM.  Needs the card."""
    return _step_shape("bls_step_exact" if cfg.ladder_eval == "exact"
                       else "bls_step", bls_step_plan(cfg, O), cfg, O, B)


def gd_step_shape(cfg: PlannerConfig, O: int, B: int) -> dict:
    """The same for K4 (:func:`gd_step_plan`)."""
    return _step_shape("gd_step", gd_step_plan(cfg, O), cfg, O, B)


def cost_grad_eval_shape(cfg: PlannerConfig, O: int, B: int) -> dict:
    """The same for K5 (:func:`cost_grad_eval_plan`)."""
    return _step_shape("cost_grad_eval", cost_grad_eval_plan(cfg, O), cfg,
                       O, B)


# K6's tile (csrc/step_kernels.cu, K6_*): output rows of kv per CTA, lanes
# per CTA (K6_LANES at J <= 4, K6_LANES_WIDE beyond: a thread's 4 rows x 4
# or 2 lanes x J accumulators), timesteps per stage, threads; two stages.
K6_ROWS, K6_LANES, K6_TK, K6_THREADS, K6_STAGES = 64, 64, 10, 256, 2
K6_LANES_WIDE = 32
# From J = fused_solve.WIDE_J up (csrc/wide/wide_steps.cu) a thread keeps
# K6_JOINTS joints of chains a pass over t, and a scratch column of J floats
# for the mix combine (dynamic shared memory).
K6_JOINTS = 4


def forward_plan(cfg: PlannerConfig) -> dict:
    """K6's tile: a CTA computes K6_ROWS of the 2T output rows of kv for
    K6_LANES consecutive lanes (K6_LANES_WIDE past J = 4) and all J
    joints, staging K6_TK timesteps of the transposed basis and of alpha
    per stage, K6_STAGES stages (static shared memory, mirror of K6Tiles);
    the grid is ``row_tiles`` x the lane tiles, row tiles fastest.  From
    J = WIDE_J up the stages hold K6_JOINTS joints of alpha (one pass over
    t per block of them) and each thread a ``scratch`` column of J floats.
    Returns {"rows", "lanes", "tk", "threads", "stages", "row_tiles", "lda"
    (the transposed basis' padded row count), "bytes": {piece: bytes},
    "total"}."""
    T, J = cfg.n_timesteps, cfg.n_joints
    lanes = K6_LANES if J <= 4 else K6_LANES_WIDE
    row_tiles = -(-2 * T // K6_ROWS)
    f = 4
    wide = J >= fs.WIDE_J
    pieces = {"basis": f * K6_STAGES * K6_TK * K6_ROWS,
              "alpha": f * K6_STAGES * (K6_JOINTS if wide else J) * K6_TK
              * lanes}
    if wide:
        pieces["scratch"] = f * J * K6_THREADS
    return {"rows": K6_ROWS, "lanes": lanes, "tk": K6_TK,
            "threads": K6_THREADS, "stages": K6_STAGES,
            "row_tiles": row_tiles, "lda": row_tiles * K6_ROWS,
            "bytes": pieces, "total": sum(pieces.values())}


def forward_eval_shape(J: int = 3) -> dict:
    """K6's tile as the library of J joints was compiled
    (forward_eval_shape in csrc/step_kernels.cu): rows, lanes, timesteps
    per stage, threads, shared memory per CTA, and the CTAs that fit on one
    SM.  Needs the card."""
    from ._build import load_library, wide

    out = (ctypes.c_int * 6)()
    err = load_library(J).forward_eval_shape(*([J] if wide(J) else []), out)
    if err:
        raise RuntimeError(f"forward_eval: shape refused (CUDA error {err})")
    return dict(zip(("rows", "lanes", "tk", "threads", "smem", "ctas_per_sm"),
                    out))


def forward_basis(kv, lda: int):
    """kv (2T, T) as K6 reads it: transposed, (T, lda), its 2T rows padded
    with zeros to ``lda`` (forward_plan's); built once per basis
    (fused_solve.memo)."""
    def build(m):
        out = torch.zeros((m.shape[1], lda), dtype=m.dtype, device=m.device)
        out[:, :m.shape[0]] = m.T
        return out

    return fs.memo("forward_basis", build, kv)


class PallasStep(NamedTuple):
    new_alpha: torch.Tensor  # (J, T, B)
    new_grad: torch.Tensor
    new_traj: torch.Tensor
    new_vel: torch.Tensor
    new_loss: torch.Tensor   # (1, B)
    new_lr: torch.Tensor     # (1, B)
    minimized: torch.Tensor  # (1, B) f32 0/1, sticky stop flag


class PallasEval(NamedTuple):
    loss: torch.Tensor       # (1, B)
    grad: torch.Tensor       # (J, T, B)
    traj: torch.Tensor
    vel: torch.Tensor


class PallasForward(NamedTuple):
    traj: torch.Tensor       # (J, T, B)
    vel: torch.Tensor


_STEP_LABELS = ("kv", "kvt", "mix", "alpha", "grad", "traj", "vel", "loss",
                "lr", "minimized", "lam_sg", "lam_jl", "start", "goal", "ox",
                "oy", "ow")


def _step_shapes(J, T, O, B):
    return ((2 * T, T), (T, 2 * T), (J, J), (J, T, B), (J, T, B), (J, T, B),
            (J, T, B), (1, B), (1, B), (1, B), (1, B), (1, B), (J, B), (J, B),
            (O, B), (O, B), (O, B))


def _lanes(x):
    """(1, B) -> (B,)."""
    return x.reshape(x.shape[-1])


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------


def bls_inner_step_reference(cfg: PlannerConfig, kv, kvt, mix, alpha, grad,
                             traj, vel, loss, bls_lr, minimized, lam_sg,
                             lam_jl, start, goal, ox, oy, ow,
                             tally=None) -> PallasStep:
    """Plain version of :func:`bls_inner_step`: fused_solve.bls_step
    without the FK carry.  ``tally``: see fused_solve.count_work."""
    frozen = _lanes(minimized) > 0.5
    a, g, t, v, lo, lr, mn = fs.bls_step(
        cfg, fs.consts(cfg), kv, kvt, mix, start, goal, fs.obs_ctx(ox, oy, ow),
        _lanes(lam_sg), _lanes(lam_jl), alpha, grad, traj, vel, _lanes(loss),
        _lanes(bls_lr), frozen, tally=tally,
    )
    new_min = torch.where(frozen, _lanes(minimized), mn.to(torch.float32))
    return PallasStep(a, g, t, v, lo[None], lr[None], new_min[None])


def gd_inner_step_reference(cfg: PlannerConfig, kv, kvt, mix, alpha, grad,
                            traj, vel, loss, lr, minimized, lam_sg, lam_jl,
                            start, goal, ox, oy, ow,
                            tally=None) -> PallasStep:
    """Plain version of :func:`gd_inner_step`: fused_solve.gd_step.
    ``tally``: see fused_solve.count_work."""
    frozen = _lanes(minimized) > 0.5
    a, g, t, v, lo, _, mn = fs.gd_step(
        cfg, fs.consts(cfg), kv, kvt, mix, start, goal, fs.obs_ctx(ox, oy, ow),
        _lanes(lam_sg), _lanes(lam_jl), alpha, grad, traj, vel, _lanes(loss),
        _lanes(lr), frozen, tally=tally,
    )
    new_min = torch.where(frozen, _lanes(minimized), mn.to(torch.float32))
    return PallasStep(a, g, t, v, lo[None], lr.clone(), new_min[None])


def cost_grad_eval_reference(cfg: PlannerConfig, kv, kvt, mix, alpha, lam_sg,
                             lam_jl, start, goal, ox, oy, ow) -> PallasEval:
    """Plain version of :func:`cost_grad_eval`: fused_solve.cost_grad_eval."""
    loss, grad, traj, vel, _, _ = fs.cost_grad_eval(
        cfg, fs.consts(cfg), kv, kvt, mix, alpha, start, goal,
        fs.obs_ctx(ox, oy, ow), _lanes(lam_sg), _lanes(lam_jl),
    )
    return PallasEval(loss[None], grad, traj, vel)


def forward_eval_reference(cfg: PlannerConfig, kv, mix,
                           alpha) -> PallasForward:
    """Plain version of :func:`forward_eval`: fused_solve.forward_planes."""
    return PallasForward(*fs.forward_planes(kv, mix, alpha))


# ---------------------------------------------------------------------------
# The wrappers.
# ---------------------------------------------------------------------------


def _check_out(name: str, out, like) -> None:
    for o, x in zip(out, like):
        if (o.shape != x.shape or o.dtype != torch.float32
                or o.device != x.device or not o.is_contiguous()):
            raise ValueError(f"{name}: out tensors must be contiguous float32 "
                             f"of the result's shape on the inputs' device")


def _into(out, res):
    """The plain version's results ``res``, copied into ``out`` when the
    caller gave it."""
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return out


def _warp_launch(name: str, lp: dict, cfg: PlannerConfig, O: int, B: int,
                 dev, kv, kvt, ints, args) -> None:
    """Launch ``<name>_launch``, a kernel of the warp body, in its launch
    plan ``lp`` (the streamed body takes the basis pair as
    fused_solve.streamed_basis gives it for the plan's ring)."""
    from ._build import launch

    streamed = lp["plan"] == "streamed"
    if streamed:
        kv, kvt = fs.streamed_basis(kv, kvt, lp["ring"])
    launch(name, fs.kernel_params(cfg, O, B, schedule=False), lp["lanes"],
           [ctypes.c_int(int(streamed)), *ints, kv, kvt, *args], dev)


def _step(name: str, cfg: PlannerConfig, args, out, gd: bool, reference,
          wrapper) -> PallasStep:
    supported = fs.solver_check("gd" if gd else "bls")
    where = fs._check_args(name, cfg, tuple(zip(_STEP_LABELS, args)),
                           _step_shapes, supported)
    state = args[3:10]
    if out is not None:
        out = PallasStep(*out)
        _check_out(name, out, state)
    if where == "cpu":
        return _into(out, reference(cfg, *args))
    B = args[3].shape[2]
    if out is None:
        out = PallasStep(*(x.contiguous().clone() for x in state))
    else:
        for o, x in zip(out, state):
            if o.data_ptr() != x.data_ptr():
                o.copy_(x)
    kv, kvt, mix, *tail = (x.contiguous() for x in args[:3] + args[10:])
    O = tail[-1].shape[0]
    if gd:
        lp, ints = gd_step_plan(cfg, O), []
    else:
        # The BLS step's program (a kernel template argument): the ladder
        # tier.
        lp = bls_step_plan(cfg, O)
        ints = [ctypes.c_int(int(cfg.ladder_eval == "exact"))]
    _warp_launch(name, lp, cfg, O, B, args[3].device, kv, kvt, ints,
                 [mix, *tail, *out])
    wrapper.launches += 1
    return out


def bls_inner_step(cfg: PlannerConfig, kv, kvt, mix, alpha, grad, traj, vel,
                   loss, bls_lr, minimized, lam_sg, lam_jl, start, goal, ox,
                   oy, ow, out: Optional[PallasStep] = None) -> PallasStep:
    """One BLS inner step for every lane (K3: one warp per lane, in the plan
    of :func:`bls_step_plan`), in the ladder tier ``cfg.ladder_eval``.
    Lanes with ``minimized > 0.5`` pass through unchanged.  The Armijo
    baseline is the carried ``loss``."""
    args = (kv, kvt, mix, alpha, grad, traj, vel, loss, bls_lr, minimized,
            lam_sg, lam_jl, start, goal, ox, oy, ow)
    return _step("bls_step", cfg, args, out, False, bls_inner_step_reference,
                 bls_inner_step)


bls_inner_step.launches = 0


def gd_inner_step(cfg: PlannerConfig, kv, kvt, mix, alpha, grad, traj, vel,
                  loss, lr, minimized, lam_sg, lam_jl, start, goal, ox, oy,
                  ow, out: Optional[PallasStep] = None) -> PallasStep:
    """One GD inner step for every lane (K4: one warp per lane, in the plan
    of :func:`gd_step_plan`).  On stop the trial is rejected; ``lr`` passes
    through; frozen lanes pass through.  The traj and vel it returns are
    exact evaluations at the returned alpha."""
    args = (kv, kvt, mix, alpha, grad, traj, vel, loss, lr, minimized,
            lam_sg, lam_jl, start, goal, ox, oy, ow)
    return _step("gd_step", cfg, args, out, True, gd_inner_step_reference,
                 gd_inner_step)


gd_inner_step.launches = 0


def cost_grad_eval(cfg: PlannerConfig, kv, kvt, mix, alpha, lam_sg, lam_jl,
                   start, goal, ox, oy, ow,
                   out: Optional[PallasEval] = None) -> PallasEval:
    """Fused loss, gradient and exact evaluation at alpha for every lane
    (K5: one warp per lane, in the plan of :func:`cost_grad_eval_plan`);
    ``out`` (a PallasEval) may be given to receive the results."""
    args = (kv, kvt, mix, alpha, lam_sg, lam_jl, start, goal, ox, oy, ow)
    where = fs._check_args("cost_grad_eval", cfg, tuple(zip(fs._LABELS, args)),
                           lambda J, T, O, B: (
                               (2 * T, T), (T, 2 * T), (J, J), (J, T, B),
                               (1, B), (1, B), (J, B), (J, B), (O, B), (O, B),
                               (O, B)),
                           fs.check_precision)
    J, T, B = alpha.shape
    if out is not None:
        out = PallasEval(*out)
        _check_out("cost_grad_eval", out, (lam_sg, alpha, alpha, alpha))
    if where == "cpu":
        return _into(out, cost_grad_eval_reference(cfg, *args))
    dev = alpha.device
    if out is None:
        out = PallasEval(*(torch.empty(s, dtype=torch.float32, device=dev)
                           for s in ((1, B), (J, T, B), (J, T, B), (J, T, B))))
    kv, kvt, *rest = (x.contiguous() for x in args)
    O = ox.shape[0]
    _warp_launch("cost_grad_eval", cost_grad_eval_plan(cfg, O), cfg, O, B,
                 dev, kv, kvt, [], [*rest, *out])
    cost_grad_eval.launches += 1
    return out


cost_grad_eval.launches = 0


def forward_eval(cfg: PlannerConfig, kv, mix, alpha,
                 out: Optional[PallasForward] = None) -> PallasForward:
    """Exact (traj, vel) of alpha for every lane (K6, the tiled product of
    :func:`forward_plan`): the floats of the kernels' in-kernel
    re-evaluation.  Used by the per-step backend for the end-of-round exact
    constraint check."""
    args = (kv, mix, alpha)
    where = fs._check_args("forward_eval", cfg,
                           tuple(zip(("kv", "mix", "alpha"), args)),
                           lambda J, T, O, B: ((2 * T, T), (J, J), (J, T, B)),
                           fs.check_precision)
    if out is not None:
        out = PallasForward(*out)
        _check_out("forward_eval", out, (alpha, alpha))
    if where == "cpu":
        return _into(out, forward_eval_reference(cfg, *args))
    B = alpha.shape[2]
    from ._build import launch

    dev = alpha.device
    if out is None:
        out = PallasForward(torch.empty_like(alpha), torch.empty_like(alpha))
    plan = forward_plan(cfg)
    kvT = forward_basis(kv.contiguous(), plan["lda"])
    alpha = alpha.contiguous()
    # 16-byte copies and stores where every row of a plane is 16-byte
    # aligned.
    vec = B % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in (alpha, *out))
    launch("forward_eval", fs.kernel_params(cfg, 0, B, schedule=False),
           plan["threads"], [ctypes.c_int(int(vec)), ctypes.c_int(plan["lda"]),
                             kvT, mix.contiguous(), alpha, *out], dev)
    forward_eval.launches += 1
    return out


forward_eval.launches = 0
