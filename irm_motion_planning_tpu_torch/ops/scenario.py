"""Scenario: start, goal and the padded obstacle set of one planning problem
(counterpart of irm_motion_planning_tpu/ops/scenario.py).

The obstacle set is padded to ``cfg.max_obstacles`` with zero-weight
obstacles, which contribute exactly 0 to cost and gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import PlannerConfig

REFERENCE_START = (0.0, 0.0, 0.0)
REFERENCE_GOAL = (1.2, 0.8, 0.3)
REFERENCE_OBSTACLES = (
    (2, -3), (-2, 2), (3, 3), (-1, -2), (-2, 1), (-1, -1),
    (-2, -3), (-2, 0), (1, 3), (3, 2), (2, 3),
)


class Scenario(NamedTuple):
    """start, goal: (J,); obstacles: (O_max, 2); obstacle_weight: (O_max,)
    — with a leading batch axis on every field for a batch of scenes."""

    start: torch.Tensor
    goal: torch.Tensor
    obstacles: torch.Tensor
    obstacle_weight: torch.Tensor


def make_scenario(cfg: PlannerConfig, start, goal, obstacles,
                  obstacle_weight=None, device=None) -> Scenario:
    """Build a Scenario, padding the obstacle set to ``cfg.max_obstacles``."""
    f32 = dict(dtype=torch.float32, device=device)
    start = torch.as_tensor(start, **f32)
    goal = torch.as_tensor(goal, **f32)
    obstacles = torch.as_tensor(obstacles, **f32).reshape(-1, 2)
    n = obstacles.shape[0]
    if n > cfg.max_obstacles:
        raise ValueError(
            f"{n} obstacles exceed cfg.max_obstacles={cfg.max_obstacles}"
        )
    if obstacle_weight is None:
        obstacle_weight = torch.ones((n,), **f32)
    pad = cfg.max_obstacles - n
    obstacles = torch.cat([obstacles, torch.zeros((pad, 2), **f32)])
    obstacle_weight = torch.cat([
        torch.as_tensor(obstacle_weight, **f32), torch.zeros((pad,), **f32)
    ])
    return Scenario(start, goal, obstacles, obstacle_weight)


def reference_scenario(cfg: PlannerConfig, device=None) -> Scenario:
    """The reference's demo problem (ref: environment.py:12-29)."""
    return make_scenario(cfg, REFERENCE_START, REFERENCE_GOAL,
                         REFERENCE_OBSTACLES, device=device)


def random_scenarios(cfg: PlannerConfig, generator: torch.Generator,
                     batch: int, n_obstacles: Optional[int] = None,
                     workspace_radius: float = 3.5, device=None) -> Scenario:
    """A batch of random scenes, with the distribution of the JAX package's
    ``random_scenarios``: starts and goals uniform inside the joint box less
    a 10% margin, obstacles uniform in a square workspace, the first
    ``n_obstacles`` slots live.  The draws come from ``generator`` (on the
    CPU) and differ from JAX's for the same seed."""
    if n_obstacles is None:
        n_obstacles = len(REFERENCE_OBSTACLES)
    if n_obstacles > cfg.max_obstacles:
        raise ValueError("n_obstacles exceeds cfg.max_obstacles")
    lo, hi = cfg.min_joint_position, cfg.max_joint_position
    margin = 0.1 * (hi - lo)

    def uniform(shape, a, b):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (a + (b - a) * u).to(device)

    J, O = cfg.n_joints, cfg.max_obstacles
    start = uniform((batch, J), lo + margin, hi - margin)
    goal = uniform((batch, J), lo + margin, hi - margin)
    obstacles = uniform((batch, O, 2), -workspace_radius, workspace_radius)
    weight = (torch.arange(O, device=device) < n_obstacles).to(torch.float32)
    return Scenario(start, goal, obstacles, weight.expand(batch, O))


def replicate_scenario(scn: Scenario, batch: int) -> Scenario:
    """Tile one scenario along a new leading batch axis (views, no copy)."""
    return Scenario(*(x.expand((batch,) + x.shape) for x in scn))
