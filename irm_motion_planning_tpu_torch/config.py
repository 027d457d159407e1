"""Typed configuration of the PyTorch/CUDA port.

``PlannerConfig`` has the same fields, defaults and validation as
``irm_motion_planning_tpu.config.PlannerConfig`` so the two compare field by
field.  The JAX module is not imported: importing it runs the JAX package's
``__init__``, which imports jax.

Fields that were TPU execution knobs keep their name; their meaning on the
GPU is:

* ``pallas_block_b`` — for the fused kernels (K1/K2, one warp per lane):
  lanes (warps) per CTA, 1..16, 0 picks the default (16); past T = 64 (the
  streamed plan, a CTA of 16 warps on a tile of lanes) at most 15 and as
  many as leave K7's ring 48 KB of shared memory; for the per-step
  kernels: threads per CTA in whole warps, 32-512, 0 picks the default (16
  warps): K3, K4 and K5 run a lane per warp (pallas_block_b / 32 lanes per
  CTA, in K1's plan), K6's tile does not depend on it.  Per-lane results
  do not depend on it.
* ``recip_newton`` — no effect: the port's kernels and plain versions
  divide exactly (IEEE ``1.0f / s``).  In the JAX package's fused kernel
  it selects the obstacle field's reciprocal: ``False`` the approximate
  ``pl.reciprocal(s, approx=True)`` alone (on a TPU its hardware estimate;
  in the Pallas interpreter on a CPU ``1 / bf16(s)``, relative error up to
  3.9e-3), ``True`` that refined by one Newton step ``r (2 - s r)``
  (relative error up to 1.5e-5 interpreted; ``models/xla_order.py``
  ``interp_recip`` reproduces it, ``tools/carry_replica.py`` runs the
  port's plain K1 in it).
* ``matmul_precision`` — only ``"highest"`` (full fp32, no TF32) is
  implemented; the solver raises ``NotImplementedError`` for any other value.
* ``bls_bf16_ladder`` — the opt-in to the bf16 ladder tier's launch plan,
  as in JAX: past the float32 plans' ceiling (the reach plan's: BLS from
  T = 2,157 at 11 obstacles) ``fleet_solve(backend="fused")`` runs BLS
  with the linearized ladder in
  the bf16 tier (its ladder planes stored as bfloat16) up to T = 2,636,
  where without it the plain engine runs; the tier itself is the
  ``bf16=True`` keyword of ``fused_solve``/``fused_round``.  Under the
  exact ladder, which has no ladder planes, ``True`` raises
  ``NotImplementedError``.
* ``bls_ladder_unroll`` — results do not depend on it (the TPU kernel's
  unrolled rungs are bitwise-neutral); the GPU kernel runs every rung in one
  early-exit loop.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

# Default GD per-outer-iteration learning-rate schedule (ref: main.py:85-86).
_DEFAULT_GD_LR: Tuple[float, ...] = (
    2e-3, 1e-4, 1e-5, 1e-6, 1e-7, 1e-8, 1e-8, 1e-8, 1e-8, 1e-8,
)

# Fixed-horizon per-penalty-round inner-step budgets of the benchmark
# protocol (see irm_motion_planning_tpu/config.py for how they were chosen).
REFERENCE_INNER_SCHEDULE_BLS: Tuple[int, ...] = (48, 8, 4, 32, 64, 16, 8, 8, 8, 8)
REFERENCE_INNER_SCHEDULE_GD: Tuple[int, ...] = (172, 8, 12, 20, 16, 24, 40, 40, 24, 4)

# Final avg/max unpenalized obstacle costs of the reference's flagship runs
# on the reference scene (ref: main.py:141-143): the quality-gate targets.
REFERENCE_FINAL_COST = {
    "bls": (1.6370234, 2.1964114),
    "gd": (1.6673477, 2.2091691),
}


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Static configuration; hashable.  Defaults reproduce the reference's
    flagship problem (ref: main.py:13-102)."""

    # --- Trajectory parametrization ---
    n_timesteps: int = 50
    rbf_variance: float = 0.1
    mix_scale: float = 0.15
    mix_seed: int = 0

    # --- Robot ---
    n_joints: int = 3
    link_length: Tuple[float, ...] = (1.5, 1.0, 0.5)
    max_joint_velocity: float = 7.0
    max_joint_position: float = 2.0
    min_joint_position: float = -1.0

    # --- Environment padding (zero-weight obstacles are exact no-ops) ---
    max_obstacles: int = 16

    # --- Loss ---
    lambda_max_cost: float = 0.5
    lambda_reg: float = 1e-4
    constraint_violating_dependant_loss: bool = True
    joint_safety_limit: float = 0.98

    # --- Constraint tolerances ---
    eps_position: float = 0.01
    eps_velocity: float = 0.01

    # --- Penalty-method dual loop ---
    max_outer_iteration: int = 10
    lambda_constraint_increase: float = 10.0
    lambda_sg_constraint: float = 0.5
    lambda_jl_constraint: float = 0.1

    # --- Inner minimization ---
    max_inner_iteration: int = 200
    loop_loss_reduction: float = 1e-3
    # Per-penalty-round inner-step budget (fixed_iters mode only).
    inner_schedule: Optional[Tuple[int, ...]] = None

    # --- Backtracking line search ---
    max_bls_iteration: int = 20
    bls_lr_start: float = 0.2
    bls_alpha: float = 0.01
    bls_beta_plus: float = 1.2
    bls_beta_minus: float = 0.5

    # --- Gradient descent ---
    gd_lr: Tuple[float, ...] = _DEFAULT_GD_LR

    # --- Execution knobs (see the module docstring for their GPU meaning) ---
    bls_mode: Literal["sequential", "ladder"] = "ladder"
    fixed_iters: bool = False
    ladder_eval: Literal["linearized", "exact"] = "linearized"
    matmul_precision: Literal["default", "high", "highest"] = "highest"
    pallas_block_b: int = 0
    lane_compaction: bool = False
    bls_ladder_unroll: int = 2
    # Re-evaluate (traj, vel) exactly from alpha before each end-of-round
    # constraint check (the linearized ladder's carry drifts).
    exact_constraint_eval: bool = True
    recip_newton: bool = False
    bls_bf16_ladder: bool = False

    def __post_init__(self) -> None:
        if self.n_joints != len(self.link_length):
            raise ValueError(
                f"n_joints ({self.n_joints}) and link_length "
                f"({len(self.link_length)}) do not match"
            )
        if self.max_outer_iteration > len(self.gd_lr):
            raise ValueError(
                "max_outer_iteration exceeds the gd_lr schedule length"
            )
        if self.inner_schedule is not None:
            if len(self.inner_schedule) != self.max_outer_iteration:
                raise ValueError(
                    f"inner_schedule length ({len(self.inner_schedule)}) must "
                    f"equal max_outer_iteration ({self.max_outer_iteration})"
                )
            if any(int(n) < 1 for n in self.inner_schedule):
                raise ValueError("inner_schedule entries must be >= 1")
        for field, allowed in (
            ("bls_mode", ("sequential", "ladder")),
            ("ladder_eval", ("linearized", "exact")),
            ("matmul_precision", ("default", "high", "highest")),
        ):
            value = getattr(self, field)
            if value not in allowed:
                raise ValueError(f"{field}={value!r} not in {allowed}")

    def replace(self, **kw) -> "PlannerConfig":
        return dataclasses.replace(self, **kw)
