// The fused kernels for NVIDIA Hopper (sm_90a): the whole penalty-method
// solve (K1) and one penalty round (K2), each for the BLS and the GD solver.
//
// K1, fused_solve_kernel, replaces the TPU kernel program
// irm_motion_planning_tpu/ops/pallas_step.py: fused_solve /
// _make_solve_kernel(per_round=False) in its three compilations:
//  * solver="bls" with ladder_eval="linearized": the BLS step _bls_step,
//    the FK carry and the exact end-of-round constraint evaluation;
//  * solver="bls" with ladder_eval="exact": _bls_step's exact tier (each
//    Armijo rung's candidate alpha through the basis, the accepted iterate
//    evaluated exactly), with neither the FK carry nor the end-of-round
//    re-evaluation (the carried evaluation is exact);
//  * solver="gd": the GD step _gd_step (the stop test rejects the trial),
//    round r's learning rate from the gd_lr schedule (gd_lr[min(r, len -
//    1)], an unrolled select there, FsParams.gd_lr here) and no end-of-round
//    re-evaluation (GD's carried evaluation is exact).
// K2, fused_round_kernel, replaces pallas_step.fused_round /
// _make_solve_kernel(per_round=True) (round_kernel) in the same three
// compilations: one round, the inner budget n_r and a per-lane learning
// rate as inputs, the penalty escalation left to the caller (the host
// driver re-sorts lanes between rounds).  Both compute what the TPU kernels
// compute, lane by lane; neither is a block-by-block copy.
//
// Both are built from the warp body (warp_body.cuh): ONE WARP PER LANE, the
// lane's solver state on chip (registers and per-warp shared memory), the
// basis pair staged once per CTA.  The program (the solver, and BLS's
// ladder tier) is a template argument of both kernels and of the round body
// warp_round (bls_step<false>, bls_step<true> or gd_step), so each of the
// six programs is compiled on its own and none reads a run-time switch.  K1 loops warp_round over the schedule with the x10
// penalty escalation in between; K2 runs it once, and a lane that comes in
// fulfilled passes through.  Sharing the round body is what makes the host
// rounds driver over K2 equal K1 bit for bit, as pallas_step's run_inner
// does for the two TPU kernels.  The per-step kernels K3-K6
// (step_kernels.cu) are built from the one-thread-per-lane lane body
// (lane_body.cuh); the warp body runs the same op sequence, so a lane's
// result does not depend on which body ran it: K1-GD gives the per-step GD
// path's (K5 once per round, then K4 per step) results.
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
//    input; the sums over t are the lane body's sequential chains, run by
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
// wgmma and TMA are for later versions.

#include "warp_body.cuh"

#include <stddef.h>

// The specialised instantiation: the bench's T and obstacle slots.  Other
// shapes run the generic one (TT = OO = 0: T and O read at run time), with
// the same op sequence and results.
#define WB_SPEC_T 50
#define WB_SPEC_O 11

template <int SOLVER, int TT, int OO>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, WB_MIN_CTAS)
fused_solve_kernel(FsParams p, const float* __restrict__ kv,
                   const float* __restrict__ kvt,
                   const float* __restrict__ mix,
                   const float* __restrict__ lam_sg0,
                   const float* __restrict__ lam_jl0,
                   const float* __restrict__ start,
                   const float* __restrict__ goal,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ ow, float* alpha, float* out_loss,
                   float* out_ful, float* out_outer, float* out_inner,
                   int* queue) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int T = TT ? TT : p.T, O = TT ? OO : p.O;
  stage_cta(T, kv, kvt, mix, smem);
  Warp w = bind_warp(smem, T, O);
  for (int b = next_lane(queue, w.lid); b < p.B;
       b = next_lane(queue, w.lid)) {
    load_lane(p, w, b, alpha, start, goal, ox, oy, ow, lam_sg0[b],
              lam_jl0[b]);
    bool fulfilled = false;
    float outer = 0.f, inner = 0.f, floss = INFINITY;
    for (int r = 0; r < p.rounds && !fulfilled; ++r) {
      const float lr0 = SOLVER == SOLVER_GD ? p.gd_lr[r] : p.lr_start;
      fulfilled = warp_round<SOLVER>(p, w, p.sched[r], lr0, floss, inner,
                                     r > 0);
      if (!fulfilled) {
        outer += 1.f;
        w.lam_sg = w.lam_sg * p.inc;
        w.lam_jl = w.lam_jl * p.inc;
      }
    }
    store_alpha(p, w, b, alpha);
    if (w.lid == 0) {
      out_loss[b] = floss;
      out_ful[b] = fulfilled ? 1.f : 0.f;
      out_outer[b] = outer;
      out_inner[b] = inner;
    }
  }
}

// One round for every lane; alpha is updated in place.  A lane that comes
// in fulfilled passes through: alpha unchanged, no steps, loss 0 and ok 1
// (the caller masks both with the round-start flag).
template <int SOLVER, int TT, int OO>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, WB_MIN_CTAS)
fused_round_kernel(FsParams p, int n_r, const float* __restrict__ kv,
                   const float* __restrict__ kvt,
                   const float* __restrict__ mix,
                   const float* __restrict__ lam_sg,
                   const float* __restrict__ lam_jl,
                   const float* __restrict__ ful,
                   const float* __restrict__ lr0,
                   const float* __restrict__ start,
                   const float* __restrict__ goal,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ ow, float* alpha, float* out_loss,
                   float* out_ok, float* out_inner, int* queue) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int T = TT ? TT : p.T, O = TT ? OO : p.O;
  stage_cta(T, kv, kvt, mix, smem);
  Warp w = bind_warp(smem, T, O);
  for (int b = next_lane(queue, w.lid); b < p.B;
       b = next_lane(queue, w.lid)) {
    if (ful[b] > 0.5f) {
      if (w.lid == 0) {
        out_loss[b] = 0.f;
        out_ok[b] = 1.f;
        out_inner[b] = 0.f;
      }
      continue;
    }
    load_lane(p, w, b, alpha, start, goal, ox, oy, ow, lam_sg[b], lam_jl[b]);
    float loss, inner = 0.f;
    const bool ok = warp_round<SOLVER>(p, w, n_r, lr0[b], loss, inner, false);
    store_alpha(p, w, b, alpha);
    if (w.lid == 0) {
      out_loss[b] = loss;
      out_ok[b] = ok ? 1.f : 0.f;
      out_inner[b] = inner;
    }
  }
}

static bool specialised(const FsParams& p) {
  return p.T == WB_SPEC_T && p.O == WB_SPEC_O;
}

// K1's and K2's instantiations of one program, specialised or generic.
template <int SOLVER>
static const void* kernel_of(const FsParams& p, int which) {
  if (specialised(p))
    return which == 0
               ? (const void*)fused_solve_kernel<SOLVER, WB_SPEC_T, WB_SPEC_O>
               : (const void*)fused_round_kernel<SOLVER, WB_SPEC_T, WB_SPEC_O>;
  return which == 0 ? (const void*)fused_solve_kernel<SOLVER, 0, 0>
                    : (const void*)fused_round_kernel<SOLVER, 0, 0>;
}

// The instantiation of K1 (which = 0) or K2 (which = 1) for the program
// ``solver`` (SOLVER_BLS, SOLVER_GD or SOLVER_BLS_EXACT) that runs p;
// nullptr for another value.
static const void* kernel_for(const FsParams& p, int which, int solver) {
  if (solver == SOLVER_BLS) return kernel_of<SOLVER_BLS>(p, which);
  if (solver == SOLVER_GD) return kernel_of<SOLVER_GD>(p, which);
  if (solver == SOLVER_BLS_EXACT) return kernel_of<SOLVER_BLS_EXACT>(p, which);
  return nullptr;
}

// The launch shape of K1 (which = 0) or K2 (which = 1) for ``solver`` at
// ``warps`` lanes per CTA: the dynamic shared memory per CTA, the CTAs that
// fit on one SM and the SM count.  Refuses what the kernels cannot take.
static int launch_shape(const FsParams& p, int warps, int which, int solver,
                        const void*& kernel, size_t& smem, int& per_sm,
                        int& sms) {
  kernel = kernel_for(p, which, solver);
  if (!kernel || warps < 1 || warps > WB_MAX_WARPS || p.T < 1 ||
      p.T > WB_MAX_T || p.O < 0 || p.B <= 0 || p.rounds > MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  smem = warp_smem_bytes(p, warps);
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
static unsigned grid_size(const FsParams& p, int warps, int ctas, int per_sm,
                          int sms) {
  const long long need = ((long long)p.B + warps - 1) / warps;
  const long long full = ctas > 0 ? ctas : (long long)per_sm * sms;
  return (unsigned)(full < need ? full : need);
}

extern "C" int fused_launch_shape(FsParams p, int warps, int which,
                                  int solver, int* out) {
  const void* kernel;
  size_t smem;
  int per_sm, sms;
  const int err =
      launch_shape(p, warps, which, solver, kernel, smem, per_sm, sms);
  if (err) return err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = (int)smem;
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

extern "C" int fused_solve_launch(FsParams p, int warps, int solver,
                                  int ctas, const float* kv, const float* kvt,
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
  int per_sm, sms;
  const int err = launch_shape(p, warps, 0, solver, kernel, smem, per_sm, sms);
  if (err) return err;
  if (ctas < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&p,     &kv,   &kvt,  &mix,   &lam_sg0,  &lam_jl0,
                  &start, &goal, &ox,   &oy,    &ow,       &alpha,
                  &out_loss, &out_ful, &out_outer, &out_inner, &queue};
  return (int)cudaLaunchKernel(kernel,
                               dim3(grid_size(p, warps, ctas, per_sm, sms)),
                               dim3(32 * warps), args, smem,
                               (cudaStream_t)stream);
}

extern "C" int fused_round_launch(FsParams p, int warps, int solver, int ctas,
                                  int n_r, const float* kv, const float* kvt,
                                  const float* mix, const float* lam_sg,
                                  const float* lam_jl, const float* ful,
                                  const float* lr0, const float* start,
                                  const float* goal, const float* ox,
                                  const float* oy, const float* ow,
                                  float* alpha, float* out_loss, float* out_ok,
                                  float* out_inner, int* queue, void* stream) {
  const void* kernel;
  size_t smem;
  int per_sm, sms;
  const int err = launch_shape(p, warps, 1, solver, kernel, smem, per_sm, sms);
  if (err) return err;
  if (ctas < 0 || n_r < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&p,     &n_r,   &kv,   &kvt, &mix, &lam_sg,   &lam_jl,
                  &ful,   &lr0,   &start, &goal, &ox, &oy,      &ow,
                  &alpha, &out_loss, &out_ok, &out_inner, &queue};
  return (int)cudaLaunchKernel(kernel,
                               dim3(grid_size(p, warps, ctas, per_sm, sms)),
                               dim3(32 * warps), args, smem,
                               (cudaStream_t)stream);
}

extern "C" const char* fused_solve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
