// The float32 programs of K1 and K2 for J >= 16 in the streamed body's
// reach layouts (the launch plan "reach", past the T where the streamed
// layout leaves no room for one lane): GD and the exact ladder without
// direction planes, the linearized ladder's programs with the tile's gx/gy
// in them (wide_body.cuh, stream_layout).  Compiled beside wide_solve.cu.

#include "wide_kernels.cuh"

const void* wide_reach_kernel(int which, int solver) {
  switch (solver) {
    case SOLVER_BLS:
      return wide_kernel_of<SOLVER_BLS, WB_BODY_REACH>(which);
    case SOLVER_GD:
      return wide_kernel_of<SOLVER_GD, WB_BODY_REACH>(which);
    case SOLVER_BLS_EXACT:
      return wide_kernel_of<SOLVER_BLS_EXACT, WB_BODY_REACH>(which);
    case SOLVER_BLS_ULTRA:
      return wide_kernel_of<SOLVER_BLS_ULTRA, WB_BODY_REACH>(which);
  }
  return nullptr;
}
