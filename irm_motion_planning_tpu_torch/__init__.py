"""irm_motion_planning_tpu_torch — the PyTorch/CUDA port of
irm_motion_planning_tpu.

RKHS trajectory optimization for a planar n-link arm (penalty method around
a backtracking line search or gradient descent), batched over many scenes,
with the whole solve in one hand-written CUDA kernel for Hopper GPUs
(ops/fused_solve.py, csrc/fused_solve.cu).  Imports torch, never jax.
"""

import torch

# The basis products cancel O(1e4) coefficients down to O(1): TF32 (about
# three decimal digits) would destroy them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import (  # noqa: E402
    PlannerConfig,
    REFERENCE_FINAL_COST,
    REFERENCE_INNER_SCHEDULE_BLS,
    REFERENCE_INNER_SCHEDULE_GD,
)
from .models.rkhs import (  # noqa: E402
    Basis, basis_from_numpy, make_basis, evaluate, evaluate_at, init_alpha,
)
from .ops.scenario import (  # noqa: E402
    Scenario,
    make_scenario,
    reference_scenario,
    random_scenarios,
    replicate_scenario,
)
from .ops.costs import (  # noqa: E402
    Penalty,
    initial_penalty,
    total_cost,
    total_cost_grad,
    cost_and_grad,
    constraints_fulfilled,
    constraint_report,
    solution_quality,
)

__version__ = "0.1.0"
