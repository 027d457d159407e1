// The linearized ladder's kernel tiers ultra and bf16 (pallas_step's
// ultra/bf16 compilations) of K1 and K2 for J >= 16, in the resident and
// the streamed body (wide_body.cuh's ls_bls_step says what each computes).
// At J >= 16 the bf16 tier's program holds its bfloat16-rounded planes as
// float32 in every plan (as the J <= 15 resident plan does), so its plans
// are the float32 programs'.  Compiled beside wide_solve.cu.

#include "wide_kernels.cuh"

const void* wide_tier_kernel(int which, int solver, int body) {
  if (body == WB_BODY_RESIDENT) {
    if (solver == SOLVER_BLS_ULTRA)
      return wide_kernel_of<SOLVER_BLS_ULTRA, WB_BODY_RESIDENT>(which);
    if (solver == SOLVER_BLS_BF16)
      return wide_kernel_of<SOLVER_BLS_BF16, WB_BODY_RESIDENT>(which);
  } else if (body == WB_BODY_STREAMED) {
    if (solver == SOLVER_BLS_ULTRA)
      return wide_kernel_of<SOLVER_BLS_ULTRA, WB_BODY_STREAMED>(which);
    if (solver == SOLVER_BLS_BF16)
      return wide_kernel_of<SOLVER_BLS_BF16, WB_BODY_STREAMED>(which);
  }
  return nullptr;
}
