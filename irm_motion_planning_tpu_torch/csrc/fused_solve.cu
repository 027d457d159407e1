// Fused BLS kernels for NVIDIA Hopper (sm_90a): the whole solve (K1) and
// one penalty round (K2).
//
// K1, fused_solve_kernel, replaces the TPU kernel
// irm_motion_planning_tpu/ops/pallas_step.py: fused_solve /
// _make_solve_kernel(solver="bls", per_round=False) with
// ladder_eval="linearized", the FK carry and the exact end-of-round
// constraint evaluation.  K2, fused_round_kernel, replaces
// pallas_step.fused_round / _make_solve_kernel(per_round=True)
// (round_kernel): one round, the inner budget n_r and a per-lane learning
// rate as inputs, the penalty escalation left to the caller (the host
// driver re-sorts lanes between rounds).  Both compute what the TPU kernels
// compute, lane by lane; neither is a block-by-block copy.
//
// Design (first, simple version): ONE THREAD PER LANE.  Each thread runs its
// lane's penalty rounds through one device function, lane_round: the fused
// cost/gradient evaluation, the inner BLS loop (normalized direction,
// Armijo ladder on the linearized trajectory, first pass wins, gradient
// pull-back), the exact re-evaluation of (traj, vel) and the hard-constraint
// check.  K1 loops it over the schedule with the x10 penalty escalation in
// between; K2 runs it once.  Sharing the op sequence is what makes the host
// rounds driver over K2 equal K1 bit for bit, as pallas_step's run_inner
// does for the two TPU kernels.  A thread stops its ladder at its lane's
// first Armijo pass, its inner loop once its lane is minimized, and its
// rounds once its lane is fulfilled (in K2 a lane that comes in fulfilled
// returns at once): per-lane results do not depend on how lanes are
// grouped, so this equals the TPU kernels' whole-tile skips.
//
// What bounds K1 on this card:
//  * the workspace traffic of the per-lane state planes.  alpha, grad,
//    traj, vel and the direction planes live in device memory, lanes
//    trailing ((J, T, B): neighbouring threads read neighbouring addresses).
//    Each ladder rung reads traj, vel and both direction planes (12 floats a
//    timestep), and the two basis products of a step stream their input
//    planes once per chunk of ROWS output rows;
//  * the arithmetic of each rung: J accurate sincosf and O IEEE divides per
//    timestep (no fast math: the rungs' Armijo decisions sit at a 1e-3
//    threshold that fp-path changes flip).
// What the design does about it: the basis pair kv/kvt (2 x 2T x T fp32,
// 40 KB at T=50), mix and the lane's obstacle terms sit in shared memory,
// so the products and the obstacle loop read no device memory for them;
// the basis products keep ROWS x J accumulators in registers, which cuts
// the re-reads of the input planes by ROWS; the FK tangents of the accepted
// rung are recomputed at the pull-back (bitwise the carried values: the
// accepted iterate is the rung's candidate, formed by the same expression)
// instead of being stored per rung; a stopping step skips the pull-back
// (its gradient is kept and the lane is frozen for the rest of the round).
//
// K2 has K1's bounds plus a round trip of the lane's state through device
// memory at each round boundary: alpha in and out, 2 x J*T*4 = 1.2 KB per
// lane per round at T=50, J=3, and the per-lane scalars; and it stages the
// basis and obstacle terms in shared memory once per round instead of once
// per solve.  Against a round's work (tens of BLS steps, each streaming the
// state planes several times) that is a few percent of the traffic, so the
// design keeps K1's layout and workspace and does nothing more about it:
// alpha is updated in place in the output buffer, and the workspace planes
// are re-derived from alpha at the round start as in K1.
// wgmma, TMA and register tiling across lanes are for later versions.
//
// The lane body (FK, the cost sums, the ladder rung, the basis products,
// the fused evaluation, the BLS step and the block staging) is in
// lane_body.cuh, shared with the per-step kernels K3-K6 (step_kernels.cu).

#include "lane_body.cuh"

// One penalty round of a live lane under its current penalties: round-start
// exact evaluation, loss and gradient; up to n_r BLS steps from learning
// rate lr0; the exact re-evaluation from the final alpha and the constraint
// check.  Returns whether the constraints hold; the round's final loss goes
// to ``loss`` and each accepted step adds one to ``inner``.
__device__ bool lane_round(const FsParams& p, const Lane& L, int n_r,
                           float lr0, float& loss, float& inner) {
  forward_planes(p, L, L.alpha, 1.f, false);
  loss = cost_grad_from_traj(p, L, true);
  float lr = lr0;
  for (int k = 0; k < n_r; ++k) {
    if (bls_step<true>(p, L, loss, lr)) break;
    inner += 1.f;  // live before the step and after it
  }
  forward_planes(p, L, L.alpha, 1.f, false);
  return constraints_ok(p, L);
}

__global__ void fused_solve_kernel(FsParams p, const float* __restrict__ kv,
                                   const float* __restrict__ kvt,
                                   const float* __restrict__ mix,
                                   const float* __restrict__ lam_sg0,
                                   const float* __restrict__ lam_jl0,
                                   const float* __restrict__ start,
                                   const float* __restrict__ goal,
                                   const float* __restrict__ ox,
                                   const float* __restrict__ oy,
                                   const float* __restrict__ ow, float* alpha,
                                   float* out_loss, float* out_ful,
                                   float* out_outer, float* out_inner,
                                   float* work) {
  extern __shared__ float smem[];
  stage_block(p, kv, kvt, mix, ox, oy, ow, smem);
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)p.B) return;
  Lane L = bind_lane(p, smem, b, start, goal, lam_sg0[b], lam_jl0[b], alpha,
                     work);

  bool fulfilled = false;
  float outer = 0.f, inner = 0.f, floss = INFINITY;
  for (int r = 0; r < p.rounds && !fulfilled; ++r) {
    fulfilled = lane_round(p, L, p.sched[r], p.lr_start, floss, inner);
    if (!fulfilled) {
      outer += 1.f;
      L.lam_sg = L.lam_sg * p.inc;
      L.lam_jl = L.lam_jl * p.inc;
    }
  }
  out_loss[b] = floss;
  out_ful[b] = fulfilled ? 1.f : 0.f;
  out_outer[b] = outer;
  out_inner[b] = inner;
}

// One round for every lane; alpha is updated in place.  A lane that comes
// in fulfilled passes through: alpha unchanged, no steps, loss 0 and ok 1
// (the caller masks both with the round-start flag).
__global__ void fused_round_kernel(FsParams p, int n_r,
                                   const float* __restrict__ kv,
                                   const float* __restrict__ kvt,
                                   const float* __restrict__ mix,
                                   const float* __restrict__ lam_sg,
                                   const float* __restrict__ lam_jl,
                                   const float* __restrict__ ful,
                                   const float* __restrict__ lr0,
                                   const float* __restrict__ start,
                                   const float* __restrict__ goal,
                                   const float* __restrict__ ox,
                                   const float* __restrict__ oy,
                                   const float* __restrict__ ow, float* alpha,
                                   float* out_loss, float* out_ok,
                                   float* out_inner, float* work) {
  extern __shared__ float smem[];
  stage_block(p, kv, kvt, mix, ox, oy, ow, smem);
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)p.B) return;
  if (ful[b] > 0.5f) {
    out_loss[b] = 0.f;
    out_ok[b] = 1.f;
    out_inner[b] = 0.f;
    return;
  }
  Lane L = bind_lane(p, smem, b, start, goal, lam_sg[b], lam_jl[b], alpha,
                     work);
  float loss, inner = 0.f;
  const bool ok = lane_round(p, L, n_r, lr0[b], loss, inner);
  out_loss[b] = loss;
  out_ok[b] = ok ? 1.f : 0.f;
  out_inner[b] = inner;
}

extern "C" int fused_solve_launch(FsParams p, int block_b, const float* kv,
                                  const float* kvt, const float* mix,
                                  const float* lam_sg0, const float* lam_jl0,
                                  const float* start, const float* goal,
                                  const float* ox, const float* oy,
                                  const float* ow, float* alpha,
                                  float* out_loss, float* out_ful,
                                  float* out_outer, float* out_inner,
                                  float* work, void* stream) {
  if (bad_launch(p, block_b)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p, block_b);
  cudaError_t err = cudaFuncSetAttribute(
      fused_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((p.B + block_b - 1) / block_b);
  fused_solve_kernel<<<grid, block_b, smem, (cudaStream_t)stream>>>(
      p, kv, kvt, mix, lam_sg0, lam_jl0, start, goal, ox, oy, ow, alpha,
      out_loss, out_ful, out_outer, out_inner, work);
  return (int)cudaGetLastError();
}

extern "C" int fused_round_launch(FsParams p, int block_b, int n_r,
                                  const float* kv, const float* kvt,
                                  const float* mix, const float* lam_sg,
                                  const float* lam_jl, const float* ful,
                                  const float* lr0, const float* start,
                                  const float* goal, const float* ox,
                                  const float* oy, const float* ow,
                                  float* alpha, float* out_loss, float* out_ok,
                                  float* out_inner, float* work,
                                  void* stream) {
  if (bad_launch(p, block_b) || n_r < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p, block_b);
  cudaError_t err = cudaFuncSetAttribute(
      fused_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((p.B + block_b - 1) / block_b);
  fused_round_kernel<<<grid, block_b, smem, (cudaStream_t)stream>>>(
      p, n_r, kv, kvt, mix, lam_sg, lam_jl, ful, lr0, start, goal, ox, oy, ow,
      alpha, out_loss, out_ok, out_inner, work);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_solve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
