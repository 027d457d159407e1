// The per-step kernels for NVIDIA Hopper (sm_90a): K3 one BLS inner step,
// K4 one GD inner step, K5 the fused cost/gradient/evaluation and K6 the
// forward evaluation.  Together with the host driver in solvers/fleet.py
// (_pallas_solve) they run the per-step backend, fleet_solve(backend=
// "pallas"): K5 at each round start, one K3 or K4 launch per inner step,
// K6 before the end-of-round constraint check (BLS).
//
// They replace, in irm_motion_planning_tpu/ops/pallas_step.py:
//  * K3 bls_step_kernel: bls_inner_step / _make_step_kernel -> _bls_step
//    without the FK carry (the loss is recomputed at the accepted iterate),
//    in its two compilations, one per ladder tier: linearized
//    (bls_step_kernel<false>) and exact (<true>: each rung's candidate alpha
//    through the basis, from the workspace's trial plane);
//  * K4 gd_step_kernel: gd_inner_step / _make_gd_step_kernel -> _gd_step
//    (the stop test rejects the trial; lr passes through);
//  * K5 cost_grad_eval_kernel: cost_grad_eval / _make_eval_kernel ->
//    _Body.cost_grad_eval;
//  * K6 forward_eval_kernel: forward_eval / _make_forward_kernel ->
//    _Body.forward_planes.
// Each computes what its TPU kernel computes, lane by lane, from the lane
// body (lane_body.cuh), whose op sequence K1/K2's warp body also runs: ONE
// THREAD PER LANE, the basis pair, mix and the block's obstacle terms staged
// in shared memory, the state planes in device memory with lanes trailing.
//
// State in place.  K3 and K4 update alpha, grad, traj, vel, loss, lr and
// the minimized flag where they lie: each thread reads and writes only its
// own lane's column, so no thread sees another's update.  A frozen lane
// (minimized > 0.5) is not touched at all, which is the TPU kernels'
// pass-through; a block whose lanes are all frozen returns before it stages
// anything (the TPU kernel's whole-tile skip).  The workspace (dir_t, dir_v
// (J, T, B), gx, gy (T, B), and for K4 and the exact K3 the trial alpha
// (J, T, B)) is
// allocated by the caller once per solve.
//
// What bounds them on this card (bounds from the shapes in PERF.md):
//  * K6 moves alpha in and (traj, vel) out, 3 x 600 B per lane at T=50,
//    J=3, against 31.5 kFLOP of basis product: bound by bytes, 0.56 ms at
//    1M lanes.  This version re-reads each lane's alpha column once per
//    ROWS output rows (10 times at T=50), mostly from L2.
//  * K5 adds the fused evaluation and the pull-back, about 76 kFLOP per
//    lane against 2.6 KB: bound by operations, 1.19 ms at 1M lanes.
//  * K3 and K4 read and write the four state planes (2.4 KB in, 2.4 KB out
//    per lane) around one to several evaluations (K3: the direction's
//    forward product, each ladder rung, the pull-back; K4: the trial's
//    forward, the evaluation, the pull-back): bound by operations too, by
//    the ladder's rung count for K3.  The workspace traffic (the direction
//    planes read by every rung) is the design's extra cost.
// What the design does about it: the basis, mix and obstacle terms never
// come from device memory in the inner loops; the basis products keep ROWS
// x J accumulators in registers; frozen lanes and frozen blocks skip all
// work.  wgmma, TMA and register tiling across lanes are for later
// versions.

#include "lane_body.cuh"

// This thread's view of lane b for the per-step kernels: the staged shared
// memory, the lane's endpoints and penalties, the state planes and the
// workspace [dir_t, dir_v (J, T, B); gx, gy (T, B)].
static __device__ Lane bind_step_lane(const FsParams& p, float* smem, size_t b,
                                      const float* __restrict__ start,
                                      const float* __restrict__ goal,
                                      float lam_sg, float lam_jl, float* alpha,
                                      float* grad, float* traj, float* vel,
                                      float* work) {
  Lane L = bind_lane(p, smem, b, start, goal, lam_sg, lam_jl, alpha, work);
  const size_t plane = (size_t)NJ * p.T * p.B;
  L.grad = grad;
  L.traj = traj;
  L.vel = vel;
  L.dir_t = work;
  L.dir_v = work + plane;
  L.gx = work + 2 * plane;
  L.gy = L.gx + (size_t)p.T * p.B;
  return L;
}

// Whether lane b runs this step; every thread of the block must call it.
// False for the whole block (all lanes frozen or past B) lets the block
// return before it stages.
__device__ __forceinline__ bool step_live(const FsParams& p,
                                          const float* minimized, size_t b,
                                          bool& block_live) {
  const bool live = b < (size_t)p.B && !(minimized[b] > 0.5f);
  block_live = __syncthreads_or(live) != 0;
  return live;
}

// The trial plane of the workspace [dir_t, dir_v (J, T, B); gx, gy (T, B);
// trial (J, T, B)].
static __device__ __forceinline__ float* trial_plane(const FsParams& p,
                                                     float* work) {
  return work + 2 * (size_t)NJ * p.T * p.B + 2 * (size_t)p.T * p.B;
}

// K3: one BLS inner step for every live lane, in place, in the ladder tier
// EXACT (a template argument: two programs, no run-time switch).
template <bool EXACT>
__global__ void bls_step_kernel(
    FsParams p, const float* __restrict__ kv, const float* __restrict__ kvt,
    const float* __restrict__ mix, const float* __restrict__ lam_sg,
    const float* __restrict__ lam_jl, const float* __restrict__ start,
    const float* __restrict__ goal, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ ow, float* alpha,
    float* grad, float* traj, float* vel, float* loss, float* lr,
    float* minimized, float* work) {
  extern __shared__ float smem[];
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool block_live;
  const bool live = step_live(p, minimized, b, block_live);
  if (!block_live) return;
  stage_block(p, kv, kvt, mix, ox, oy, ow, smem);
  if (!live) return;
  Lane L = bind_step_lane(p, smem, b, start, goal, lam_sg[b], lam_jl[b],
                          alpha, grad, traj, vel, work);
  float l = loss[b], r = lr[b];
  const bool stop = bls_step<EXACT>(p, L, trial_plane(p, work), l, r);
  loss[b] = l;
  lr[b] = r;
  minimized[b] = fmaxf(minimized[b], stop ? 1.f : 0.f);
}

// K4: one GD inner step for every live lane, in place; lr is read only.
__global__ void gd_step_kernel(
    FsParams p, const float* __restrict__ kv, const float* __restrict__ kvt,
    const float* __restrict__ mix, const float* __restrict__ lam_sg,
    const float* __restrict__ lam_jl, const float* __restrict__ start,
    const float* __restrict__ goal, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ ow, float* alpha,
    float* grad, float* traj, float* vel, float* loss,
    const float* __restrict__ lr, float* minimized, float* work) {
  extern __shared__ float smem[];
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool block_live;
  const bool live = step_live(p, minimized, b, block_live);
  if (!block_live) return;
  stage_block(p, kv, kvt, mix, ox, oy, ow, smem);
  if (!live) return;
  Lane L = bind_step_lane(p, smem, b, start, goal, lam_sg[b], lam_jl[b],
                          alpha, grad, traj, vel, work);
  float l = loss[b];
  const bool stop = gd_step(p, L, trial_plane(p, work), l, lr[b]);
  loss[b] = l;
  minimized[b] = fmaxf(minimized[b], stop ? 1.f : 0.f);
}

// K5: loss, gradient and exact (traj, vel) at alpha, for every lane.
__global__ void cost_grad_eval_kernel(
    FsParams p, const float* __restrict__ kv, const float* __restrict__ kvt,
    const float* __restrict__ mix, const float* alpha,
    const float* __restrict__ lam_sg, const float* __restrict__ lam_jl,
    const float* __restrict__ start, const float* __restrict__ goal,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ ow, float* loss, float* grad, float* traj,
    float* vel, float* work) {
  extern __shared__ float smem[];
  stage_block(p, kv, kvt, mix, ox, oy, ow, smem);
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)p.B) return;
  Lane L = bind_step_lane(p, smem, b, start, goal, lam_sg[b], lam_jl[b],
                          (float*)alpha, grad, traj, vel, work);
  forward_planes(p, L, L.alpha, 1.f, false);
  loss[b] = cost_grad_from_traj(p, L, true);
}

// K6: (traj, vel) = the exact evaluation of alpha, for every lane.  Only
// kv and mix are staged.
__global__ void forward_eval_kernel(FsParams p,
                                    const float* __restrict__ kv,
                                    const float* __restrict__ mix,
                                    const float* alpha, float* traj,
                                    float* vel) {
  extern __shared__ float smem[];
  const int T = p.T, BT = blockDim.x, tid = threadIdx.x;
  for (int i = tid; i < 2 * T * T; i += BT) smem[i] = kv[i];
  if (tid < NJ * NJ) smem[2 * T * T + tid] = mix[tid];
  __syncthreads();
  const size_t b = (size_t)blockIdx.x * BT + tid;
  if (b >= (size_t)p.B) return;
  Lane L;
  L.b = b;
  L.B = p.B;
  L.T = T;
  L.kv = smem;
  L.mix = smem + 2 * T * T;
  L.traj = traj;
  L.vel = vel;
  forward_planes(p, L, alpha, 1.f, false);
}

template <typename Kernel>
static int launch_config(const FsParams& p, int block_b, Kernel kernel,
                         size_t smem, unsigned& grid) {
  if (bad_launch(p, block_b)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  grid = (unsigned)((p.B + block_b - 1) / block_b);
  return 0;
}

template <bool EXACT>
static int bls_step_run(FsParams p, int block_b, const float* kv,
                        const float* kvt, const float* mix,
                        const float* lam_sg, const float* lam_jl,
                        const float* start, const float* goal, const float* ox,
                        const float* oy, const float* ow, float* alpha,
                        float* grad, float* traj, float* vel, float* loss,
                        float* lr, float* minimized, float* work,
                        void* stream) {
  const size_t smem = smem_bytes(p, block_b);
  unsigned grid;
  int err = launch_config(p, block_b, bls_step_kernel<EXACT>, smem, grid);
  if (err) return err;
  bls_step_kernel<EXACT><<<grid, block_b, smem, (cudaStream_t)stream>>>(
      p, kv, kvt, mix, lam_sg, lam_jl, start, goal, ox, oy, ow, alpha, grad,
      traj, vel, loss, lr, minimized, work);
  return (int)cudaGetLastError();
}

// ``exact`` picks the program of the ladder tier (the exact one needs the
// workspace's trial plane).
extern "C" int bls_step_launch(FsParams p, int block_b, int exact,
                               const float* kv, const float* kvt,
                               const float* mix, const float* lam_sg,
                               const float* lam_jl, const float* start,
                               const float* goal, const float* ox,
                               const float* oy, const float* ow, float* alpha,
                               float* grad, float* traj, float* vel,
                               float* loss, float* lr, float* minimized,
                               float* work, void* stream) {
  return (exact ? bls_step_run<true> : bls_step_run<false>)(
      p, block_b, kv, kvt, mix, lam_sg, lam_jl, start, goal, ox, oy, ow, alpha,
      grad, traj, vel, loss, lr, minimized, work, stream);
}

extern "C" int gd_step_launch(FsParams p, int block_b, const float* kv,
                              const float* kvt, const float* mix,
                              const float* lam_sg, const float* lam_jl,
                              const float* start, const float* goal,
                              const float* ox, const float* oy,
                              const float* ow, float* alpha, float* grad,
                              float* traj, float* vel, float* loss,
                              const float* lr, float* minimized, float* work,
                              void* stream) {
  const size_t smem = smem_bytes(p, block_b);
  unsigned grid;
  int err = launch_config(p, block_b, gd_step_kernel, smem, grid);
  if (err) return err;
  gd_step_kernel<<<grid, block_b, smem, (cudaStream_t)stream>>>(
      p, kv, kvt, mix, lam_sg, lam_jl, start, goal, ox, oy, ow, alpha, grad,
      traj, vel, loss, lr, minimized, work);
  return (int)cudaGetLastError();
}

extern "C" int cost_grad_eval_launch(FsParams p, int block_b, const float* kv,
                                     const float* kvt, const float* mix,
                                     const float* alpha, const float* lam_sg,
                                     const float* lam_jl, const float* start,
                                     const float* goal, const float* ox,
                                     const float* oy, const float* ow,
                                     float* loss, float* grad, float* traj,
                                     float* vel, float* work, void* stream) {
  const size_t smem = smem_bytes(p, block_b);
  unsigned grid;
  int err = launch_config(p, block_b, cost_grad_eval_kernel, smem, grid);
  if (err) return err;
  cost_grad_eval_kernel<<<grid, block_b, smem, (cudaStream_t)stream>>>(
      p, kv, kvt, mix, alpha, lam_sg, lam_jl, start, goal, ox, oy, ow, loss,
      grad, traj, vel, work);
  return (int)cudaGetLastError();
}

extern "C" int forward_eval_launch(FsParams p, int block_b, const float* kv,
                                   const float* mix, const float* alpha,
                                   float* traj, float* vel, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * p.T * p.T + NJ * NJ);
  unsigned grid;
  int err = launch_config(p, block_b, forward_eval_kernel, smem, grid);
  if (err) return err;
  forward_eval_kernel<<<grid, block_b, smem, (cudaStream_t)stream>>>(
      p, kv, mix, alpha, traj, vel);
  return (int)cudaGetLastError();
}
