"""Solve results (counterpart of irm_motion_planning_tpu/solvers/common.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SolveStats(NamedTuple):
    """Per-lane telemetry of a solve."""

    outer_iters: torch.Tensor   # int32 — penalty escalations used
    inner_iters: torch.Tensor   # int32 — descent steps across all rounds
    converged: torch.Tensor     # bool — hard constraints fulfilled
    final_cost: torch.Tensor    # f32 — penalized cost at the final penalty


class SolveResult(NamedTuple):
    alpha: torch.Tensor         # (B, T, J)
    stats: SolveStats
