// The reach layouts of K1 (fused_solve_kernel) and K2 (fused_round_kernel):
// the float32 programs (bls, gd, bls_exact, bls_ultra) in the streamed
// body's reach layouts, which run one lane per CTA past the T where the
// streamed layout leaves no room for one (J = 3, 11 obstacles: T > 2,072).
// Like the TPU kernel's lean/ultra plans (irm_motion_planning_tpu/ops/
// pallas_step.py, choose_kernel_plan and _make_solve_kernel's carried
// planes), each drops on-chip state it can recompute: the gradient pass
// recomputes the FK tangents from (traj, vel), the same floats, instead of
// reading them back from the direction planes; GD and the exact ladder
// then drop those planes, the linearized ladder's programs hold the tile's
// gx/gy planes in them (warp_body.cuh, SWarpT).  The op sequence is the streamed body's, so each lane's result
// is the streamed layout's bit for bit wherever both fit.  Generic
// instantiations only (T and O read at run time); compiled by nvcc beside
// fused_solve.cu, which launches them.
//
// What bounds them at these T: operations (ops/roofline.py, which counts
// the gradient pass's FK), with one lane per CTA: K7 splits each basis
// product among the CTA's warps, the elementwise passes run on the lane's
// own warp.

#include "fused_kernels.cuh"

template <int SOLVER>
static const void* reach_kernel(int which) {
  return which == 0
             ? (const void*)fused_solve_kernel<SOLVER, 0, 0, WB_BODY_REACH>
             : (const void*)fused_round_kernel<SOLVER, 0, 0, WB_BODY_REACH>;
}

const void* reach_kernel_for(int which, int solver) {
  switch (solver) {
    case SOLVER_BLS:
      return reach_kernel<SOLVER_BLS>(which);
    case SOLVER_GD:
      return reach_kernel<SOLVER_GD>(which);
    case SOLVER_BLS_EXACT:
      return reach_kernel<SOLVER_BLS_EXACT>(which);
    case SOLVER_BLS_ULTRA:
      return reach_kernel<SOLVER_BLS_ULTRA>(which);
    default:
      return nullptr;
  }
}
