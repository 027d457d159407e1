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
(csrc/step_kernels.cu, ``cfg.pallas_block_b`` lanes per block, 128 when 0)
or raise.

``out``: where the results go.  For K3/K4 a PallasStep of state tensors;
passing the input state itself updates it in place (what the solver's
driver does: the kernels write each lane's column where it lies).  Without
``out`` the inputs are left as they are.  ``work``: the kernels' workspace
(:func:`workspace`), allocated by the caller once per solve; without it a
call allocates its own.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..config import PlannerConfig
from . import fused_solve as fs

# Lanes (threads) per block of K3-K6 when ``cfg.pallas_block_b`` is 0.  The
# fused kernels K1/K2 read the same field as warps per CTA
# (fused_solve.DEFAULT_WARPS).
DEFAULT_BLOCK_B = 128


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


def workspace(J: int, T: int, B: int, device, trial: bool = False):
    """The per-step kernels' scratch planes, (2J + 2, T, B): the direction
    planes dir_t, dir_v and the obstacle-gradient planes gx, gy; with
    ``trial`` also a trial alpha (GD's trial, the exact ladder's rung
    candidate), (3J + 2, T, B).  The larger size serves every kernel."""
    planes = (3 if trial else 2) * J + 2
    return torch.empty((planes, T, B), dtype=torch.float32, device=device)


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


def _check_work(name: str, work, J, T, B, dev, trial: bool) -> torch.Tensor:
    if work is None:
        return workspace(J, T, B, dev, trial)
    need = (3 if trial else 2) * J + 2
    if (work.dim() != 3 or work.shape[0] < need or tuple(work.shape[1:]) != (T, B)
            or work.dtype != torch.float32 or work.device != dev
            or not work.is_contiguous()):
        raise ValueError(f"{name}: work must be contiguous float32 "
                         f"(>= {need}, {T}, {B}) on {dev}")
    return work


def _launch(name: str, cfg: PlannerConfig, O: int, B: int, dev, args):
    from ._build import launch

    launch(name, fs.kernel_params(cfg, O, B, schedule=False),
           cfg.pallas_block_b or DEFAULT_BLOCK_B, args, dev)


def _into(out, res):
    """The plain version's results ``res``, copied into ``out`` when the
    caller gave it."""
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return out


def _step(name: str, cfg: PlannerConfig, args, out, work, gd: bool,
          reference, wrapper) -> PallasStep:
    supported = fs.solver_check("gd" if gd else "bls")
    where = fs._check_args(name, cfg, tuple(zip(_STEP_LABELS, args)),
                           _step_shapes, supported)
    state = args[3:10]
    if out is not None:
        out = PallasStep(*out)
        _check_out(name, out, state)
    if where == "cpu":
        return _into(out, reference(cfg, *args))
    J, T, B = args[3].shape
    if J != 3:
        raise NotImplementedError("the CUDA kernels are built for J=3 joints")
    if out is None:
        out = PallasStep(*(x.contiguous().clone() for x in state))
    else:
        for o, x in zip(out, state):
            if o.data_ptr() != x.data_ptr():
                o.copy_(x)
    dev = args[3].device
    # The BLS step's instantiation (a kernel template argument): the ladder
    # tier; the exact ladder stages its rung candidates in the trial plane.
    exact = not gd and cfg.ladder_eval == "exact"
    work = _check_work(name, work, J, T, B, dev, gd or exact)
    kv, kvt, mix, lam_sg, lam_jl, start, goal, ox, oy, ow = (
        x.contiguous() for x in args[:3] + args[10:])
    _launch(name, cfg, ox.shape[0], B, dev,
            ([] if gd else [ctypes.c_int(int(exact))])
            + [kv, kvt, mix, lam_sg, lam_jl, start, goal, ox, oy, ow, *out,
               work])
    wrapper.launches += 1
    return out


def bls_inner_step(cfg: PlannerConfig, kv, kvt, mix, alpha, grad, traj, vel,
                   loss, bls_lr, minimized, lam_sg, lam_jl, start, goal, ox,
                   oy, ow, out: Optional[PallasStep] = None,
                   work: Optional[torch.Tensor] = None) -> PallasStep:
    """One BLS inner step for every lane (K3), in the ladder tier
    ``cfg.ladder_eval``.  Lanes with ``minimized > 0.5`` pass through
    unchanged.  The Armijo baseline is the carried ``loss``.  ``work``
    needs the trial plane (:func:`workspace`) in the exact tier."""
    args = (kv, kvt, mix, alpha, grad, traj, vel, loss, bls_lr, minimized,
            lam_sg, lam_jl, start, goal, ox, oy, ow)
    return _step("bls_step", cfg, args, out, work, False,
                 bls_inner_step_reference, bls_inner_step)


bls_inner_step.launches = 0


def gd_inner_step(cfg: PlannerConfig, kv, kvt, mix, alpha, grad, traj, vel,
                  loss, lr, minimized, lam_sg, lam_jl, start, goal, ox, oy,
                  ow, out: Optional[PallasStep] = None,
                  work: Optional[torch.Tensor] = None) -> PallasStep:
    """One GD inner step for every lane (K4).  On stop the trial is
    rejected; ``lr`` passes through; frozen lanes pass through.  The traj
    and vel it returns are exact evaluations at the returned alpha."""
    args = (kv, kvt, mix, alpha, grad, traj, vel, loss, lr, minimized,
            lam_sg, lam_jl, start, goal, ox, oy, ow)
    return _step("gd_step", cfg, args, out, work, True,
                 gd_inner_step_reference, gd_inner_step)


gd_inner_step.launches = 0


def cost_grad_eval(cfg: PlannerConfig, kv, kvt, mix, alpha, lam_sg, lam_jl,
                   start, goal, ox, oy, ow, out: Optional[PallasEval] = None,
                   work: Optional[torch.Tensor] = None) -> PallasEval:
    """Fused loss, gradient and exact evaluation at alpha for every lane
    (K5); ``out`` (a PallasEval) may be given to receive the results."""
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
    if J != 3:
        raise NotImplementedError("the CUDA kernels are built for J=3 joints")
    dev = alpha.device
    if out is None:
        out = PallasEval(*(torch.empty(s, dtype=torch.float32, device=dev)
                           for s in ((1, B), (J, T, B), (J, T, B), (J, T, B))))
    work = _check_work("cost_grad_eval", work, J, T, B, dev, False)
    args = [x.contiguous() for x in args]
    _launch("cost_grad_eval", cfg, ox.shape[0], B, dev, [*args, *out, work])
    cost_grad_eval.launches += 1
    return out


cost_grad_eval.launches = 0


def forward_eval(cfg: PlannerConfig, kv, mix, alpha,
                 out: Optional[PallasForward] = None) -> PallasForward:
    """Exact (traj, vel) of alpha for every lane (K6): the op sequence of
    the kernels' in-kernel re-evaluation.  Used by the per-step backend for
    the end-of-round exact constraint check."""
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
    J, T, B = alpha.shape
    if J != 3:
        raise NotImplementedError("the CUDA kernels are built for J=3 joints")
    dev = alpha.device
    if out is None:
        out = PallasForward(torch.empty_like(alpha), torch.empty_like(alpha))
    _launch("forward_eval", cfg, 0, B, dev,
            [*(x.contiguous() for x in args), *out])
    forward_eval.launches += 1
    return out


forward_eval.launches = 0
