// The fused kernels for NVIDIA Hopper (sm_90a): the whole penalty-method
// solve (K1) and one penalty round (K2), each for the BLS and the GD solver.
//
// K1, fused_solve_kernel, replaces the TPU kernel program
// irm_motion_planning_tpu/ops/pallas_step.py: fused_solve /
// _make_solve_kernel(per_round=False) in its compilations:
//  * solver="bls" with ladder_eval="linearized": the BLS step _bls_step,
//    the FK carry and the exact end-of-round constraint evaluation;
//  * solver="bls" with ladder_eval="exact": _bls_step's exact tier (each
//    Armijo rung's candidate alpha through the basis, the accepted iterate
//    evaluated exactly), with neither the FK carry nor the end-of-round
//    re-evaluation (the carried evaluation is exact);
//  * solver="gd": the GD step _gd_step (the stop test rejects the trial),
//    round r's learning rate from the gd_lr schedule (gd_lr[min(r, len -
//    1)], an unrolled select there, FsParams.gd_lr here) and no end-of-round
//    re-evaluation (GD's carried evaluation is exact);
//  * the kernel tiers ultra and bf16 of the linearized ladder (the
//    ultra/bf16 compilations), instantiated in fused_tiers.cu and launched
//    from here (bls_step in warp_body.cuh says what each computes);
//  * the float32 programs in the reach layouts of the streamed body, past
//    the T where its own layout leaves no room for one lane (the TPU
//    kernel's lean/ultra plans, which drop planes to reach larger T),
//    instantiated in fused_reach.cu.  The
//    lean compilation computes the linearized program's floats here, and
//    for GD and the exact ladder every tier compiles what these programs
//    compute (ops/fused_solve.py, program).
// K2, fused_round_kernel, replaces pallas_step.fused_round /
// _make_solve_kernel(per_round=True) (round_kernel) in the same
// compilations: one round, the inner budget n_r and a per-lane learning
// rate as inputs, the penalty escalation left to the caller (the host
// driver re-sorts lanes between rounds).  Both compute what the TPU kernels
// compute, lane by lane; neither is a block-by-block copy.
//
// Both are built from the warp body (warp_body.cuh): ONE WARP PER LANE, the
// lane's solver state on chip (registers and per-warp shared memory).  The
// program (the solver, and BLS's ladder tier) is a template argument of
// both kernels and of the round body warp_round (bls_step<false>,
// bls_step<true> or gd_step), and so is the body (STREAM): the resident one
// (T <= 64, the basis pair staged once per CTA) or the streamed one (any T
// from 32 up, the basis pair read from device memory by K7, the streamed
// basis contraction that replaces pallas_step's _Body._streamed_matmul).
// Each program is compiled on its own and none reads a run-time switch.  K1 loops warp_round over the schedule with the x10
// penalty escalation in between; K2 runs it once, and a lane that comes in
// fulfilled passes through.  Sharing the round body is what makes the host
// rounds driver over K2 equal K1 bit for bit, as pallas_step's run_inner
// does for the two TPU kernels.  The per-step kernels K3, K4 and K5
// (step_kernels.cu) are built from this warp body too, so a lane's result
// does not depend on which kernel ran it: K1 gives the per-step path's (K5
// once per round, then K3 or K4 per step) results in every program.
//
// What bounds K1 and K2 on this card: operations.  ops/roofline.py counts
// the work of the run (rounds, steps, ladder rungs, accepted trials,
// pull-backs), each sincosf and division counted as one operation although
// an accurate sincosf is some 20-40 instructions and an IEEE division about
// 10 (no fast math: the Armijo and stop decisions sit at a 1e-3 threshold
// that fp-path changes flip).  The bytes they must move (alpha in and out,
// penalties, scene, per-lane results) are under 1 GB.
//
// What the design does about it:
//  * no per-lane state in device memory: the previous one-thread-per-lane
//    version kept grad, traj, vel and the direction planes there (3.4 GB at
//    1M lanes) and streamed ~30 KB per lane per step through it;
//  * one warp per lane: the rung loop, the Armijo exit, the stop test and
//    the round loop are warp-uniform, so lanes of one warp no longer wait
//    for each other (on random scenes they took different numbers of steps
//    and rungs);
//  * a persistent grid (SMs x the CTAs that fit per SM) whose warps draw
//    lanes from a device counter that the wrapper zeroes before each
//    launch: a warp that finishes a short lane takes the next, so the
//    launch's tail is one lane long, not one block of lanes;
//  * the basis products read the transposed basis in shared memory (32
//    neighbouring words per warp load) and a broadcast float4 of the staged
//    input; the sums over t are sequential chains, run by
//    one thread each, up to 7 at once, so the results stay bit for bit (a
//    build with shuffle-tree sums instead was at most 2% faster); the first
//    argmax is a shuffle tree, exact;
//  * the FK tangents of an evaluation's cost pass are kept for its gradient
//    pass in the direction planes (free between a step's update and the
//    next direction; GD uses them for nothing else), and K1 starts a round
//    from the previous round's exact end-of-round evaluation: each saves a
//    recomputation of values it already holds, bit for bit;
//  * GD needs no plane beyond BLS's: the trial is staged in the buffer as a
//    product input, its evaluation goes to the traj/vel registers, and the
//    stop test comes before the gradient pass, so a rejected trial leaves
//    alpha and grad untouched (warp_body.cuh, gd_step); the exact ladder
//    likewise stages each rung's candidate alpha in the buffer and
//    evaluates it into the traj/vel registers, where the accepted rung's
//    evaluation is the new iterate's;
//  * an instantiation specialised to the bench's T=50 and O=11, whose
//    offsets and loop bounds are constants (a generic one runs other
//    shapes, with the same results);
//  * 16 warps per CTA and 2 CTAs per SM (32 warps): __launch_bounds__ caps a
//    thread at 64 registers and the specialised kernels spill a few dozen
//    bytes a thread, which costs less than halving the warps in flight
//    (tools/fused_variants.py measures both; PERF.md).
// The streamed programs (T > 64) keep the lane state on chip and stream the
// basis from L2 (the basis at T = 2,000 is 32 MB, within the 50 MB L2).
// Past T = 2,072 (J = 3, 11 obstacles) one lane's state no longer fits
// beside the room; the reach layouts recompute the FK tangents in the
// gradient pass instead of keeping them in the direction planes, and GD
// and the exact ladder drop those planes (T <= 2,636) while the linearized
// ladder holds the tile's gx/gy planes in them (T <= 2,156):
// warp_body.cuh, SWarpT.  A
// CTA of WB_STREAM_WARPS warps runs a tile of lanes, one warp each, in
// lockstep: the most lanes (at most 15) that leave K7's ring 48 KB of
// shared memory (launch_plan: 8 at T = 200); each basis product reads the
// basis (8 T^2 bytes) once for the whole tile through K7's ring of TMA bulk
// copies, computed by every warp but the ring's producer (warp_body.cuh);
// one CTA per SM, at most 128 registers a thread (__launch_bounds__(512,
// 1)).  The function's bound is the operations' (ops/roofline.py); the
// design's L2 reads are a diagnostic beside it.  The basis contractions
// stay fp32 chains (no wgmma: TF32 would change the results).

#include "fused_kernels.cuh"

#include <stddef.h>

#ifdef WB_ABLATED
// A phase-ablated build (warp_body.cuh, WB_ABLATE_*: timing only, wrong
// results by design) holds K1 and K2 of the linearized program in the
// resident body alone, the instantiations benchmarks/epilogue.py times;
// nullptr for any other program or body.
static const void* kernel_for(const FsParams& p, int which, int solver,
                              int body) {
  if (solver != SOLVER_BLS || body) return nullptr;
#if NJ == 3
  if (specialised(p))
    return which == 0
               ? (const void*)
                     fused_solve_kernel<SOLVER_BLS, WB_SPEC_T, WB_SPEC_O, false>
               : (const void*)
                     fused_round_kernel<SOLVER_BLS, WB_SPEC_T, WB_SPEC_O, false>;
#endif
  return which == 0 ? (const void*)fused_solve_kernel<SOLVER_BLS, 0, 0, false>
                    : (const void*)fused_round_kernel<SOLVER_BLS, 0, 0, false>;
}
#else
// K1's and K2's instantiations of one program: streamed (generic), or
// resident, specialised (J = 3 only: the bench's arm) or generic.
template <int SOLVER>
static const void* kernel_of(const FsParams& p, int which, bool streamed) {
  if (streamed)
    return which == 0 ? (const void*)fused_solve_kernel<SOLVER, 0, 0, true>
                      : (const void*)fused_round_kernel<SOLVER, 0, 0, true>;
#if NJ == 3
  if (specialised(p))
    return which == 0
               ? (const void*)
                     fused_solve_kernel<SOLVER, WB_SPEC_T, WB_SPEC_O, false>
               : (const void*)
                     fused_round_kernel<SOLVER, WB_SPEC_T, WB_SPEC_O, false>;
#endif
  return which == 0 ? (const void*)fused_solve_kernel<SOLVER, 0, 0, false>
                    : (const void*)fused_round_kernel<SOLVER, 0, 0, false>;
}

// The instantiation of K1 (which = 0) or K2 (which = 1) for the program
// ``solver`` (SOLVER_BLS ... SOLVER_BLS_BF16) in the body ``body``
// (WB_BODY_*) that runs p; nullptr for another value.  The kernel tiers'
// programs have no specialised instantiation (fused_tiers.cu); the reach
// body holds the float32 programs' generic ones (fused_reach.cu).
static const void* kernel_for(const FsParams& p, int which, int solver,
                              int body) {
  if (body == WB_BODY_REACH) return reach_kernel_for(which, solver);
  const bool streamed = body == WB_BODY_STREAMED;
  if (solver == SOLVER_BLS) return kernel_of<SOLVER_BLS>(p, which, streamed);
  if (solver == SOLVER_GD) return kernel_of<SOLVER_GD>(p, which, streamed);
  if (solver == SOLVER_BLS_EXACT)
    return kernel_of<SOLVER_BLS_EXACT>(p, which, streamed);
  return tier_kernel_for(which, solver, streamed);
}
#endif  // WB_ABLATED

// The launch shape of K1 (which = 0) or K2 (which = 1) for ``solver`` in
// the body ``streamed`` (0: resident, 1: streamed, 2: the streamed body's
// reach layout; launch_plan's "plan") at ``lanes`` lanes per CTA: the warps
// per CTA (the resident body one per lane, the streamed ones
// WB_STREAM_WARPS), the dynamic shared memory per CTA, the CTAs that fit on
// one SM and the SM count.  Refuses what the kernels cannot take: the
// resident body past WB_MAX_T timesteps, the streamed ones below 32 (a
// thread owns at least one timestep) or past WB_STREAM_WARPS - 1 lanes, a
// program the body does not hold.
static int launch_shape(const FsParams& p, int lanes, int which, int solver,
                        int streamed, const void*& kernel, int& warps,
                        size_t& smem, int& per_sm, int& sms) {
  if (streamed < WB_BODY_RESIDENT || streamed > WB_BODY_REACH)
    return (int)cudaErrorInvalidValue;
  kernel = kernel_for(p, which, solver, streamed);
  warps = streamed ? WB_STREAM_WARPS : lanes;
  if (!kernel || lanes < 1 || lanes > warps - (streamed ? 1 : 0) ||
      warps > WB_MAX_WARPS || p.T < 1 ||
      (streamed ? p.T < 32 : p.T > WB_MAX_T) || p.O < 0 || p.B <= 0 ||
      p.rounds > MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  smem = warp_smem_bytes(p, lanes, streamed != 0,
                         stream_layout(solver, streamed));
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

// The persistent grid: ``ctas`` CTAs when > 0, else every CTA that fits on
// the card; never more than the lanes need.
static unsigned grid_size(const FsParams& p, int lanes, int ctas, int per_sm,
                          int sms) {
  const long long need = ((long long)p.B + lanes - 1) / lanes;
  const long long full = ctas > 0 ? ctas : (long long)per_sm * sms;
  return (unsigned)(full < need ? full : need);
}

extern "C" int fused_launch_shape(FsParams p, int lanes, int which,
                                  int solver, int streamed, int* out) {
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err = launch_shape(p, lanes, which, solver, streamed, kernel,
                               warps, smem, per_sm, sms);
  if (err) return err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = (int)smem;
  out[3] = warps;
  return 0;
}

// The layout of FsParams as this build compiled it: its size and the
// offset of its last field, which ops/_build.py holds against the ctypes
// mirror before any launch.
extern "C" int fused_params_layout(int* out) {
  out[0] = (int)sizeof(FsParams);
  out[1] = (int)offsetof(FsParams, gd_lr);
  return 0;
}

extern "C" int fused_solve_launch(FsParams p, int lanes, int solver,
                                  int streamed, int ctas, const float* kv,
                                  const float* kvt,
                                  const float* mix, const float* lam_sg0,
                                  const float* lam_jl0, const float* start,
                                  const float* goal, const float* ox,
                                  const float* oy, const float* ow,
                                  float* alpha, float* out_loss,
                                  float* out_ful, float* out_outer,
                                  float* out_inner, int* queue,
                                  void* stream) {
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err = launch_shape(p, lanes, 0, solver, streamed, kernel, warps,
                               smem, per_sm, sms);
  if (err) return err;
  if (ctas < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&p,     &lanes, &kv,   &kvt,  &mix,   &lam_sg0,  &lam_jl0,
                  &start, &goal,  &ox,   &oy,   &ow,    &alpha,
                  &out_loss, &out_ful, &out_outer, &out_inner, &queue};
  return (int)cudaLaunchKernel(kernel,
                               dim3(grid_size(p, lanes, ctas, per_sm, sms)),
                               dim3(32 * warps), args, smem,
                               (cudaStream_t)stream);
}

extern "C" int fused_round_launch(FsParams p, int lanes, int solver,
                                  int streamed, int ctas, int n_r,
                                  const float* kv, const float* kvt,
                                  const float* mix, const float* lam_sg,
                                  const float* lam_jl, const float* ful,
                                  const float* lr0, const float* start,
                                  const float* goal, const float* ox,
                                  const float* oy, const float* ow,
                                  float* alpha, float* out_loss, float* out_ok,
                                  float* out_inner, int* queue, void* stream) {
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err = launch_shape(p, lanes, 1, solver, streamed, kernel, warps,
                               smem, per_sm, sms);
  if (err) return err;
  if (ctas < 0 || n_r < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&p,     &lanes, &n_r,   &kv,   &kvt, &mix, &lam_sg,
                  &lam_jl, &ful,  &lr0,   &start, &goal, &ox, &oy,    &ow,
                  &alpha, &out_loss, &out_ok, &out_inner, &queue};
  return (int)cudaLaunchKernel(kernel,
                               dim3(grid_size(p, lanes, ctas, per_sm, sms)),
                               dim3(32 * warps), args, smem,
                               (cudaStream_t)stream);
}

#ifndef WB_ABLATED  // an ablated build holds no streamed body
// K7 alone, for measurement and its check: (traj, vel) = kv @ alpha with the
// mix combine, for every lane (alpha, traj, vel (J, T, B)), through the
// streamed body's product (eval_staged, k7_product) on tiles of ``lanes``
// lanes, as K1's and K2's streamed programs run it; kvT is kv as
// fused_solve.streamed_basis gives it.  A tile's alpha comes in, and its
// traj/vel go out, a row of ``lanes`` consecutive words at a time.  Bit for
// bit K6's forward_eval (the same chains and mix combine).
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, 1)
k7_forward_kernel(FsParams p, int lanes, const float* __restrict__ kvT,
                  const float* __restrict__ mix, const float* alpha,
                  float* traj, float* vel, int* queue) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  SWarp w = bind_swarp(smem, p.T, p.O, lanes, kvT, kvT, mix);
  const int T = p.T, rows = NJ * T;
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
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
      const int row = i / n, l = i - row * n;
      const float* r = region0 + (size_t)l * w.stride;
      traj[(size_t)row * B + b0 + l] = r[traj_at + row];
      vel[(size_t)row * B + b0 + l] = r[vel_at + row];
    }
  }
}

// K7 alone at ``lanes`` lanes per CTA (the streamed plan's): every CTA that
// fits, never more than the tiles.
extern "C" int k7_forward_launch(FsParams p, int lanes, const float* kvT,
                                 const float* mix, const float* alpha,
                                 float* traj, float* vel, int* queue,
                                 void* stream) {
  const int warps = WB_STREAM_WARPS;
  if (lanes < 1 || lanes >= warps || p.T < 32 || p.B <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = warp_smem_bytes(p, lanes, true, WB_LY_STREAMED);
  const void* kernel = (const void*)k7_forward_kernel;
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        32 * warps, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {&p, &lanes, &kvT, &mix, &alpha, &traj, &vel, &queue};
  return (int)cudaLaunchKernel(kernel,
                               dim3(grid_size(p, lanes, 0, per_sm, sms)),
                               dim3(32 * warps), args, smem,
                               (cudaStream_t)stream);
}
#endif  // WB_ABLATED

extern "C" const char* fused_solve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
