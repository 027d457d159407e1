// The kernel tiers of K1 and K2 for the linearized Armijo ladder: the
// programs ultra (SOLVER_BLS_ULTRA) and bf16 (SOLVER_BLS_BF16) of
// irm_motion_planning_tpu/ops/pallas_step.py's _make_solve_kernel (the
// ultra and bf16 compilations of fused_solve and fused_round; its lean
// compilation is SOLVER_BLS; bls_step in warp_body.cuh says what each
// computes).
// Each in the generic resident body and the streamed one (the bf16 tier's
// streamed program in the half-width body, HWarp), from the kernel
// templates of fused_kernels.cuh; compiled by nvcc beside fused_solve.cu,
// which launches them.

#include "fused_kernels.cuh"

template <int SOLVER>
static const void* tier_kernel(int which, bool streamed) {
  if (streamed)
    return which == 0 ? (const void*)fused_solve_kernel<SOLVER, 0, 0, true>
                      : (const void*)fused_round_kernel<SOLVER, 0, 0, true>;
  return which == 0 ? (const void*)fused_solve_kernel<SOLVER, 0, 0, false>
                    : (const void*)fused_round_kernel<SOLVER, 0, 0, false>;
}

const void* tier_kernel_for(int which, int solver, bool streamed) {
  if (solver == SOLVER_BLS_ULTRA)
    return tier_kernel<SOLVER_BLS_ULTRA>(which, streamed);
  if (solver == SOLVER_BLS_BF16)
    return tier_kernel<SOLVER_BLS_BF16>(which, streamed);
  return nullptr;
}
