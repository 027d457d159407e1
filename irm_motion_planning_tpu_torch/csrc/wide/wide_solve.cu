// K1 and K2 for arms of J >= 16 joints on NVIDIA Hopper (sm_90a), J a
// run-time value: one library for every such J (ops/_build.py), where the
// J <= 15 libraries take J at compile time (csrc/fused_solve.cu).  They
// replace the same TPU kernels as csrc/fused_solve.cu
// (irm_motion_planning_tpu/ops/pallas_step.py: fused_solve / fused_round,
// _make_solve_kernel), which JAX's planner plans at any J, in every
// program: bls, gd and bls_exact here, the tiers ultra and bf16 in
// wide_tiers.cu, the reach layouts in wide_reach.cu.
//
// What bounds them on this card: operations, as at J <= 15
// (ops/roofline.py counts them at any J: the basis products grow with J,
// the mix combines with J^2).  What the design does about J: the body of
// wide_body.cuh keeps every plane of a lane in shared memory and runs every
// joint loop over the planes, so no thread holds J registers of anything;
// the products keep 8 joints' chains a pass (the K7 ring streams a row
// block once per 8 joints), and the mix combine reads mix from shared
// memory.  The launch plans (ops/fused_solve.py, launch_plan) are the J <=
// 15 ones with the resident body's traj/vel and gx/gy planes in its warps'
// regions, and link beside mix.  Also here: K7 alone (wide_k7_forward),
// the forward product of the streamed body on its own.

#include "wide_kernels.cuh"

static const void* kernel_for(int which, int solver, int body) {
  if (body == WB_BODY_REACH) return wide_reach_kernel(which, solver);
  if (body == WB_BODY_STREAMED) {
    if (solver == SOLVER_BLS)
      return wide_kernel_of<SOLVER_BLS, WB_BODY_STREAMED>(which);
    if (solver == SOLVER_GD)
      return wide_kernel_of<SOLVER_GD, WB_BODY_STREAMED>(which);
    if (solver == SOLVER_BLS_EXACT)
      return wide_kernel_of<SOLVER_BLS_EXACT, WB_BODY_STREAMED>(which);
  } else if (body == WB_BODY_RESIDENT) {
    if (solver == SOLVER_BLS)
      return wide_kernel_of<SOLVER_BLS, WB_BODY_RESIDENT>(which);
    if (solver == SOLVER_GD)
      return wide_kernel_of<SOLVER_GD, WB_BODY_RESIDENT>(which);
    if (solver == SOLVER_BLS_EXACT)
      return wide_kernel_of<SOLVER_BLS_EXACT, WB_BODY_RESIDENT>(which);
  }
  return wide_tier_kernel(which, solver, body);
}

// The kernel's dynamic shared memory, CTAs per SM and SMs for ``kernel``
// at ``warps`` warps and ``smem`` bytes; refuses what does not fit.
int wide_occupancy(const void* kernel, int warps, size_t smem, int& per_sm,
                   int& sms) {
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        32 * warps, smem);
  if (err != cudaSuccess) return (int)err;
  return per_sm < 1 ? (int)cudaErrorInvalidValue : 0;
}

static int launch_shape(const WParams& p, int lanes, int which, int solver,
                        int body, const void*& kernel, int& warps,
                        size_t& smem, int& per_sm, int& sms) {
  if (body < WB_BODY_RESIDENT || body > WB_BODY_REACH)
    return (int)cudaErrorInvalidValue;
  kernel = kernel_for(which, solver, body);
  warps = body ? WB_STREAM_WARPS : lanes;
  if (!kernel || lanes < 1 || lanes > warps - (body ? 1 : 0) ||
      warps > WB_MAX_WARPS || p.T < 1 || (body ? p.T < 32 : p.T > WB_MAX_T) ||
      p.O < 0 || p.B <= 0 || p.rounds > MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  smem = warp_smem_bytes(p, lanes, body != 0, stream_layout(solver, body));
  return wide_occupancy(kernel, warps, smem, per_sm, sms);
}

static unsigned grid_size(const WParams& p, int lanes, int ctas, int per_sm,
                          int sms) {
  const long long need = ((long long)p.B + lanes - 1) / lanes;
  const long long full = ctas > 0 ? ctas : (long long)per_sm * sms;
  return (unsigned)(full < need ? full : need);
}

extern "C" int fused_launch_shape(WParams p, int lanes,
                                  int which, int solver, int body, int* out) {
  if (!wide_ok(p)) return (int)cudaErrorInvalidValue;
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err = launch_shape(p, lanes, which, solver, body, kernel, warps,
                               smem, per_sm, sms);
  if (err) return err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = (int)smem;
  out[3] = warps;
  return 0;
}

// The parameter block's layout (fused_solve.params_type(J) at J >= 16): its
// size and the offset of its last field, link.
extern "C" int fused_params_layout(int* out) {
  out[0] = (int)sizeof(WParams);
  out[1] = (int)offsetof(WParams, link);
  return 0;
}

extern "C" int fused_solve_launch(WParams p, int lanes,
                                  int solver, int body, int ctas,
                                  const float* kv, const float* kvt,
                                  const float* mix, const float* lam_sg0,
                                  const float* lam_jl0, const float* start,
                                  const float* goal, const float* ox,
                                  const float* oy, const float* ow,
                                  float* alpha, float* out_loss,
                                  float* out_ful, float* out_outer,
                                  float* out_inner, int* queue,
                                  void* stream) {
  if (!wide_ok(p) || ctas < 0) return (int)cudaErrorInvalidValue;
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err = launch_shape(p, lanes, 0, solver, body, kernel, warps, smem,
                               per_sm, sms);
  if (err) return err;
  void* args[] = {&p,     &lanes, &kv,   &kvt,  &mix,   &lam_sg0,  &lam_jl0,
                  &start, &goal,  &ox,   &oy,   &ow,    &alpha,
                  &out_loss, &out_ful, &out_outer, &out_inner, &queue};
  return (int)cudaLaunchKernel(kernel,
                               dim3(grid_size(p, lanes, ctas, per_sm, sms)),
                               dim3(32 * warps), args, smem,
                               (cudaStream_t)stream);
}

extern "C" int fused_round_launch(WParams p, int lanes,
                                  int solver, int body, int ctas, int n_r,
                                  const float* kv, const float* kvt,
                                  const float* mix, const float* lam_sg,
                                  const float* lam_jl, const float* ful,
                                  const float* lr0, const float* start,
                                  const float* goal, const float* ox,
                                  const float* oy, const float* ow,
                                  float* alpha, float* out_loss, float* out_ok,
                                  float* out_inner, int* queue, void* stream) {
  if (!wide_ok(p) || ctas < 0 || n_r < 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err = launch_shape(p, lanes, 1, solver, body, kernel, warps, smem,
                               per_sm, sms);
  if (err) return err;
  void* args[] = {&p,     &lanes, &n_r,   &kv,   &kvt, &mix, &lam_sg,
                  &lam_jl, &ful,  &lr0,   &start, &goal, &ox, &oy,    &ow,
                  &alpha, &out_loss, &out_ok, &out_inner, &queue};
  return (int)cudaLaunchKernel(kernel,
                               dim3(grid_size(p, lanes, ctas, per_sm, sms)),
                               dim3(32 * warps), args, smem,
                               (cudaStream_t)stream);
}

// K7 alone: (traj, vel) = kv @ alpha with the mix combine for every lane,
// through the streamed body's product on tiles of ``lanes`` lanes (the
// J <= 15 library's k7_forward_kernel); bit for bit K6.
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, 1)
wide_k7_forward_kernel(const WParams p, int lanes,
                       const float* __restrict__ kvT,
                       const float* __restrict__ mix, const float* alpha,
                       float* traj, float* vel, int* queue) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  auto w = bind_streamed<WB_BODY_STREAMED, WB_LY_STREAMED>(
      p, smem, p.T, p.O, lanes, kvT, kvT, mix);
  const int T = p.T, rows = p.J * T;
  const size_t B = p.B;
  float* region0 = w.alpha - (size_t)w.lane * w.stride;
  const int traj_at = (int)(w.traj - w.alpha), vel_at = (int)(w.vel - w.alpha);
  for (int b0 = next_tile(w, queue); b0 < p.B; b0 = next_tile(w, queue)) {
    const int n = min(lanes, p.B - b0);
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
      const int row = i / n, l = i - row * n;
      region0[(size_t)l * w.stride + row] = alpha[(size_t)row * B + b0 + l];
    }
    __syncthreads();
    const bool on = w.sub == 0 && w.lane < n;
    if (on) stage_input(w, w.alpha, 1.f);
    eval_staged(w, on);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
      const int row = i / n, l = i - row * n;
      const float* r = region0 + (size_t)l * w.stride;
      traj[(size_t)row * B + b0 + l] = r[traj_at + row];
      vel[(size_t)row * B + b0 + l] = r[vel_at + row];
    }
  }
}

extern "C" int k7_forward_launch(WParams p, int lanes,
                                 const float* kvT, const float* mix,
                                 const float* alpha, float* traj, float* vel,
                                 int* queue, void* stream) {
  if (!wide_ok(p) || lanes < 1 || lanes >= WB_STREAM_WARPS ||
      p.T < 32 || p.B <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = warp_smem_bytes(p, lanes, true, WB_LY_STREAMED);
  const void* kernel = (const void*)wide_k7_forward_kernel;
  int per_sm, sms;
  const int err = wide_occupancy(kernel, WB_STREAM_WARPS, smem, per_sm, sms);
  if (err) return err;
  void* args[] = {&p, &lanes, &kvT, &mix, &alpha, &traj, &vel, &queue};
  return (int)cudaLaunchKernel(kernel,
                               dim3(grid_size(p, lanes, 0, per_sm, sms)),
                               dim3(32 * WB_STREAM_WARPS), args, smem,
                               (cudaStream_t)stream);
}

extern "C" const char* fused_solve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
