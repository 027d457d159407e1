"""Scene-axis parallelism across devices and processes (counterpart of
irm_motion_planning_tpu/parallel): the mesh, the process group and the
sharded solvers."""

from . import distributed, mesh, sharded  # noqa: F401
