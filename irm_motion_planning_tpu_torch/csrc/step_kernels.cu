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
// Each computes what its TPU kernel computes, lane by lane; a lane's result
// does not depend on which kernel or body ran it (same op sequence).
//
// K3 and K5 run the lane body (lane_body.cuh): ONE THREAD PER LANE, mix and
// the block's obstacle terms staged in shared memory, the state planes in
// device memory with lanes trailing.  The basis pair is staged too while it
// fits in shared memory beside them; beyond (the step plan of
// ops/step_kernels.py: T past about 110 at 128 lanes per block), each
// kernel's DEV instantiation reads it from device memory, where a warp's 32
// lanes read the same word at once (one L1 broadcast).
//
// K4 runs the warp body of K1/K2 (warp_body.cuh, its gd_step): ONE WARP PER
// LANE, the lane's state on chip for the step, in the plan of K1-GD (the
// resident body for T <= 64, the streamed one, through K7, beyond).  A CTA
// takes a tile of consecutive lanes, one warp each, and moves their planes
// between device memory and the warps' shared memory together, so that a
// load or store of a plane row is W consecutive words (lanes trailing); it
// reads alpha, grad and the scene, and writes alpha, grad, traj, vel, loss
// and the stop flag.  The trial, its evaluation's scratch and the gradient
// pass's rows never leave the chip.  The grid is persistent (the CTAs that
// fit, from the occupancy calculator), each CTA walking tiles, so the
// resident body stages the basis once per CTA.
//
// K6 is a register-tiled float32 product: a CTA owns K6_BM output rows of
// kv (of the 2T) by K6_BN consecutive lanes, all J joints; tiles of the
// transposed basis and of alpha go through shared memory in two stages
// (cp.async); each thread holds K6_TM rows x K6_TN lanes x J accumulators.
// Each output element is still the lane body's sequential fmaf chain over
// t = 0 .. T-1 (the tiles come in order of t and nothing splits the sum),
// followed by its mix combine, so K6 gives forward_planes' floats bit for
// bit.  The row tile is the fastest grid index: the CTAs of one lane tile
// run together and read its alpha from device memory once, then from L2.
//
// State in place.  K3 and K4 update alpha, grad, traj, vel, loss, lr (K3)
// and the minimized flag where they lie; each lane's columns are read and
// written by its own thread (K3) or warp (K4, through its CTA's tile).  A
// frozen lane (minimized > 0.5) is not touched at all, which is the TPU
// kernels' pass-through; a block or tile whose lanes are all frozen skips
// all work (the TPU kernel's whole-tile skip).  The workspace of K3 and K5
// (dir_t, dir_v (J, T, B), gx, gy (T, B), and for the exact K3 the trial
// alpha (J, T, B)) is allocated by the caller once per solve; K4 and K6
// take none.
//
// What bounds them on this card (bounds from the shapes in PERF.md):
//  * K6 moves alpha in and (traj, vel) out, 3 x 600 B per lane at T=50,
//    J=3, against 31.5 kFLOP of basis product: bound by bytes at T=50
//    (0.56 ms at 1M lanes), by operations at T=200.  The design reads alpha
//    from HBM once per lane tile and keeps J x K6_TM x K6_TN accumulators
//    per thread: 12 FMAs per shared-memory load instruction.
//  * K5 adds the fused evaluation and the pull-back, about 76 kFLOP per
//    lane against 2.6 KB: bound by operations, 1.19 ms at 1M lanes.
//  * K3 and K4 read and write the four state planes (2.4 KB in, 2.4 KB out
//    per lane) around one to several evaluations (K3: the direction's
//    forward product, each ladder rung, the pull-back; K4: the trial's
//    forward, the evaluation, the pull-back): bound by operations too, by
//    the ladder's rung count for K3.  K3's workspace traffic (the direction
//    planes read by every rung) is the design's extra cost; K4 has none.
//  * With the basis in device memory (K3/K5 DEV), every basis product reads
//    8 T^2 bytes per warp of 32 lanes from L2 (ops/roofline.py); K4's
//    streamed body reads them per lane, as K1's does.
// wgmma and TMA are for later versions.

#include "fused_kernels.cuh"

#include <limits.h>

// This thread's view of lane b for the per-step kernels: the staged shared
// memory, the lane's endpoints and penalties, the state planes and the
// workspace [dir_t, dir_v (J, T, B); gx, gy (T, B)].
template <bool DEV>
static __device__ Lane bind_step_lane(const FsParams& p, float* smem, size_t b,
                                      const float* kv, const float* kvt,
                                      const float* __restrict__ start,
                                      const float* __restrict__ goal,
                                      float lam_sg, float lam_jl, float* alpha,
                                      float* grad, float* traj, float* vel,
                                      float* work) {
  Lane L = bind_lane<DEV>(p, smem, b, kv, kvt, start, goal, lam_sg, lam_jl,
                          alpha, work);
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
// EXACT (a template argument: two programs, no run-time switch), with the
// basis staged or, DEV, in device memory.
template <bool EXACT, bool DEV>
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
  stage_block<DEV>(p, kv, kvt, mix, ox, oy, ow, smem);
  if (!live) return;
  Lane L = bind_step_lane<DEV>(p, smem, b, kv, kvt, start, goal, lam_sg[b],
                               lam_jl[b], alpha, grad, traj, vel, work);
  float l = loss[b], r = lr[b];
  const bool stop = bls_step<EXACT>(p, L, trial_plane(p, work), l, r);
  loss[b] = l;
  lr[b] = r;
  minimized[b] = fmaxf(minimized[b], stop ? 1.f : 0.f);
}

// ---------------------------------------------------------------------------
// K4: the warp body's GD step on a tile of lanes.
// ---------------------------------------------------------------------------

// Where the pieces of lane l's per-warp region lie (l = 0 .. W-1, the
// tile's lanes; offsets in floats from the region's start, which is its
// alpha plane), from the own warp's view: K4's loads and stores write and
// read every warp's region of the tile.
struct TileMap {
  float* base;    // lane 0's region
  size_t stride;  // floats per region
  int grad, traj, vel, obs, ends;

  __device__ __forceinline__ float* region(int l) const {
    return base + (size_t)l * stride;
  }
};

// The accepted trial's evaluation for the tile's store, and the map: the
// resident body holds traj/vel in registers, which go into the direction
// planes (free once the gradient pass has read the FK tangents there); the
// streamed body holds them in its traj/vel planes already.
static __device__ __forceinline__ void keep_eval(Warp& w) {
  __syncwarp();  // the gradient pass's reads of the tangents are done
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    if (!w.owns(s)) continue;
    const int t = w.tt(s);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      w.dir_t[j * w.T + t] = w.traj[s][j];
      w.dir_v[j * w.T + t] = w.vel[s][j];
    }
  }
}
static __device__ __forceinline__ void keep_eval(SWarp&) {}

static __device__ __forceinline__ TileMap tile_map(const Warp& w, int wid) {
  const size_t stride = wb_warp_floats(w.T, w.O);
  return {w.alpha - wid * stride, stride, (int)(w.grad - w.alpha),
          (int)(w.dir_t - w.alpha), (int)(w.dir_v - w.alpha),
          (int)((float*)w.obs - w.alpha), (int)(w.ends - w.alpha)};
}
static __device__ __forceinline__ TileMap tile_map(const SWarp& w, int wid) {
  const size_t stride = w.stride;
  return {w.alpha - wid * stride, stride, (int)(w.grad - w.alpha),
          (int)(w.traj - w.alpha), (int)(w.vel - w.alpha),
          (int)((float*)w.obs - w.alpha), (int)(w.ends - w.alpha)};
}

// K4: one GD inner step for every live lane, in place; lr is read only.
// TT/OO: the specialised resident instantiation (0: T and O at run time);
// STREAM: the streamed body (the transposed, padded basis pair in device
// memory, fused_solve.streamed_basis; the tile's lanes in lockstep, their
// products one K7 product each).  W = ``lanes`` lanes per tile, one warp
// each (the streamed CTA's other warps help with the products).
template <int TT, int OO, bool STREAM>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, STREAM ? 1 : WB_MIN_CTAS)
gd_step_kernel(FsParams p, int lanes, const float* __restrict__ kv,
               const float* __restrict__ kvt, const float* __restrict__ mix,
               const float* __restrict__ lam_sg,
               const float* __restrict__ lam_jl,
               const float* __restrict__ start,
               const float* __restrict__ goal, const float* __restrict__ ox,
               const float* __restrict__ oy, const float* __restrict__ ow,
               float* alpha, float* grad, float* traj, float* vel,
               float* loss, const float* __restrict__ lr, float* minimized) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int T = TT ? TT : p.T, O = TT ? OO : p.O;
  const int W = lanes, wid = threadIdx.x >> 5;
  const size_t B = p.B;
  auto w = bind_body<SOLVER_GD, STREAM>(smem, T, O, W, kv, kvt, mix);
  int own = wid;  // the warp's lane in the tile (a helper's view: lane 0's)
  if constexpr (STREAM) own = w.lane;
  const TileMap m = tile_map(w, own);
  const int rows = NJ * T;
  const size_t tiles = (B + W - 1) / W;
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t b0 = tile * W, b = b0 + wid;
    const bool live = wid < W && b < B && !(minimized[b] > 0.5f);
    // The whole-tile skip; the barrier also ends the previous tile's store.
    if (!__syncthreads_or(live)) continue;
    if (wid < W && w.lid == 0) w.ends[WB_OUTCOME] = live ? 1.f : 0.f;
    __syncthreads();
    // The live lanes' alpha and grad rows, obstacle terms and endpoints,
    // each row W consecutive words of device memory.
    for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
      const int row = i / W, l = i - row * W;
      float* r = m.region(l);
      if (r[m.ends + WB_OUTCOME] == 0.f) continue;
      const size_t g = (size_t)row * B + b0 + l;
      r[row] = alpha[g];
      r[m.grad + row] = grad[g];
    }
    for (int i = threadIdx.x; i < O * W; i += blockDim.x) {
      const int o = i / W, l = i - o * W;
      float* r = m.region(l);
      if (r[m.ends + WB_OUTCOME] == 0.f) continue;
      const size_t g = (size_t)o * B + b0 + l;
      const float x = ox[g], y = oy[g], wt = ow[g];
      ((float4*)(r + m.obs))[o] =
          make_float4(x, y, 0.5f + 0.5f * (x * x + y * y), 0.8f * wt);
    }
    for (int i = threadIdx.x; i < NJ * W; i += blockDim.x) {
      const int j = i / W, l = i - j * W;
      float* r = m.region(l);
      if (r[m.ends + WB_OUTCOME] == 0.f) continue;
      const size_t g = (size_t)j * B + b0 + l;
      r[m.ends + j] = start[g];
      r[m.ends + NJ + j] = goal[g];
    }
    __syncthreads();
    if constexpr (STREAM) {
      float l = 0.f;
      if (live) {
        w.lam_sg = lam_sg[b];
        w.lam_jl = lam_jl[b];
        l = loss[b];
      }
      const bool stop = ls_gd_step(p, w, l, live ? lr[b] : 0.f, live);
      if (live) {
        __syncwarp();
        if (w.lid == 0) {
          w.ends[WB_OUTCOME] = stop ? 0.f : 2.f;
          if (!stop) loss[b] = l;
          minimized[b] = fmaxf(minimized[b], stop ? 1.f : 0.f);
        }
      }
    } else if (live) {
      w.lam_sg = lam_sg[b];
      w.lam_jl = lam_jl[b];
      float l = loss[b];
      const bool stop = gd_step(p, w, l, lr[b]);
      if (!stop) keep_eval(w);
      __syncwarp();
      if (w.lid == 0) {
        w.ends[WB_OUTCOME] = stop ? 0.f : 2.f;
        if (!stop) loss[b] = l;
        minimized[b] = fmaxf(minimized[b], stop ? 1.f : 0.f);
      }
    }
    __syncthreads();
    // The accepted lanes' new alpha, grad, traj and vel rows.
    for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
      const int row = i / W, l = i - row * W;
      const float* r = m.region(l);
      if (r[m.ends + WB_OUTCOME] != 2.f) continue;
      const size_t g = (size_t)row * B + b0 + l;
      alpha[g] = r[row];
      grad[g] = r[m.grad + row];
      traj[g] = r[m.traj + row];
      vel[g] = r[m.vel + row];
    }
  }
}

// K4's instantiation for p in the body ``streamed``.
static const void* gd_kernel_of(const FsParams& p, bool streamed) {
  if (streamed) return (const void*)gd_step_kernel<0, 0, true>;
  if (specialised(p))
    return (const void*)gd_step_kernel<WB_SPEC_T, WB_SPEC_O, false>;
  return (const void*)gd_step_kernel<0, 0, false>;
}

// K4's launch shape at ``lanes`` lanes per CTA in the body ``streamed``
// (launch_plan of K1-GD): the kernel, its warps per CTA (one per lane;
// streamed: WB_STREAM_WARPS), its dynamic shared memory (the warp body's
// plan), the CTAs that fit on one SM and the SM count.
static int gd_shape(const FsParams& p, int lanes, int streamed,
                    const void*& kernel, int& warps, size_t& smem,
                    int& per_sm, int& sms) {
  warps = streamed ? WB_STREAM_WARPS : lanes;
  if (lanes < 1 || lanes > warps - (streamed ? 1 : 0) ||
      warps > WB_MAX_WARPS || p.T < 1 ||
      (streamed ? p.T < 32 : p.T > WB_MAX_T) || p.O < 0 || p.B <= 0 ||
      (streamed != 0 && streamed != 1))
    return (int)cudaErrorInvalidValue;
  kernel = gd_kernel_of(p, streamed != 0);
  smem = warp_smem_bytes(p, lanes, streamed != 0, false);
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

extern "C" int gd_step_shape(FsParams p, int lanes, int streamed, int* out) {
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err =
      gd_shape(p, lanes, streamed, kernel, warps, smem, per_sm, sms);
  if (err) return err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = (int)smem;
  return 0;
}

// K4 at ``lanes`` lanes per CTA, in the body ``streamed`` (then kv and kvt
// are the transposed, blocked pair), on the persistent grid: every CTA that
// fits, never more than the tiles.
extern "C" int gd_step_launch(FsParams p, int lanes, int streamed,
                              const float* kv, const float* kvt,
                              const float* mix, const float* lam_sg,
                              const float* lam_jl, const float* start,
                              const float* goal, const float* ox,
                              const float* oy, const float* ow, float* alpha,
                              float* grad, float* traj, float* vel,
                              float* loss, const float* lr, float* minimized,
                              void* stream) {
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err =
      gd_shape(p, lanes, streamed, kernel, warps, smem, per_sm, sms);
  if (err) return err;
  const long long tiles = ((long long)p.B + lanes - 1) / lanes;
  const long long full = (long long)per_sm * sms;
  void* args[] = {&p,    &lanes, &kv,    &kvt,  &mix,  &lam_sg, &lam_jl,
                  &start, &goal, &ox,    &oy,   &ow,    &alpha, &grad,
                  &traj, &vel,  &loss,  &lr,    &minimized};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)(full < tiles ? full
                                                                    : tiles)),
                               dim3(32 * warps), args, smem,
                               (cudaStream_t)stream);
}

// K5: loss, gradient and exact (traj, vel) at alpha, for every lane.
template <bool DEV>
__global__ void cost_grad_eval_kernel(
    FsParams p, const float* __restrict__ kv, const float* __restrict__ kvt,
    const float* __restrict__ mix, const float* alpha,
    const float* __restrict__ lam_sg, const float* __restrict__ lam_jl,
    const float* __restrict__ start, const float* __restrict__ goal,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ ow, float* loss, float* grad, float* traj,
    float* vel, float* work) {
  extern __shared__ float smem[];
  stage_block<DEV>(p, kv, kvt, mix, ox, oy, ow, smem);
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)p.B) return;
  Lane L = bind_step_lane<DEV>(p, smem, b, kv, kvt, start, goal, lam_sg[b],
                               lam_jl[b], (float*)alpha, grad, traj, vel,
                               work);
  forward_planes(p, L, L.alpha, 1.f, false);
  loss[b] = cost_grad_from_traj(p, L, true);
}

// ---------------------------------------------------------------------------
// K6: the forward evaluation as a register-tiled float32 product.
// ---------------------------------------------------------------------------

// The tile (mirror of forward_plan in ops/step_kernels.py): K6_BM output
// rows of kv by K6_BN lanes per CTA, K6_TK timesteps per stage, two stages;
// each thread K6_TM rows by K6_TN lanes, all J joints.
#define K6_BM 64
#define K6_BN 64
#define K6_TK 10
#define K6_TM 4
#define K6_TN 4
#define K6_THREADS ((K6_BM / K6_TM) * (K6_BN / K6_TN))

struct K6Tiles {
  float a[2][K6_TK][K6_BM];      // the basis: a[s][t][r] = kv[r0 + r][t0 + t]
  float x[2][NJ][K6_TK][K6_BN];  // alpha[j][t0 + t][b0 + n]
};

// cp.async of 4 or 16 bytes; ``ok`` false zero-fills the destination and
// reads nothing (the source then is any valid address).
static __device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                                 bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
static __device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                                  bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Stage ``s`` of the product: timesteps t0 .. t0 + K6_TK - 1 of the
// transposed basis kvT (T, lda; lda a multiple of K6_BM, zero beyond 2T)
// at rows r0.., and of alpha (J, T, B) at lanes b0..; zeros past T and B.
// VEC: 16-byte copies (B a multiple of 4, 16-byte aligned planes).
template <bool VEC>
static __device__ __forceinline__ void k6_stage(K6Tiles& sm, int s,
                                                const float* kvT, int lda,
                                                const float* alpha, int T,
                                                size_t B, int t0, int r0,
                                                size_t b0) {
  const int tid = threadIdx.x;
  for (int i = tid; i < K6_TK * K6_BM / 4; i += K6_THREADS) {
    const int t = i / (K6_BM / 4), c = 4 * (i - t * (K6_BM / 4));
    const bool ok = t0 + t < T;
    cp_async16(&sm.a[s][t][c],
               ok ? kvT + (size_t)(t0 + t) * lda + r0 + c : kvT, ok);
  }
  if constexpr (VEC) {
    for (int i = tid; i < NJ * K6_TK * K6_BN / 4; i += K6_THREADS) {
      const int jt = i / (K6_BN / 4), n = 4 * (i - jt * (K6_BN / 4));
      const int j = jt / K6_TK, t = jt - j * K6_TK;
      const bool ok = t0 + t < T && b0 + n < B;
      cp_async16(&sm.x[s][j][t][n],
                 ok ? alpha + ((size_t)j * T + t0 + t) * B + b0 + n : alpha,
                 ok);
    }
  } else {
    for (int i = tid; i < NJ * K6_TK * K6_BN; i += K6_THREADS) {
      const int jt = i / K6_BN, n = i - jt * K6_BN;
      const int j = jt / K6_TK, t = jt - j * K6_TK;
      const bool ok = t0 + t < T && b0 + n < B;
      cp_async4(&sm.x[s][j][t][n],
                ok ? alpha + ((size_t)j * T + t0 + t) * B + b0 + n : alpha,
                ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The products of ``n`` timesteps of stage s into the accumulators, one
// fmaf each, in order of t.
template <int N>
static __device__ __forceinline__ void k6_fma(const K6Tiles& sm, int s, int n,
                                              int ty, int tx,
                                              float acc[K6_TM][K6_TN][NJ]) {
#pragma unroll
  for (int t = 0; t < (N ? N : K6_TK); ++t) {
    if (!N && t >= n) break;
    const float4 a4 = *(const float4*)&sm.a[s][t][ty * K6_TM];
    const float a[K6_TM] = {a4.x, a4.y, a4.z, a4.w};
    float x[NJ][K6_TN];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 x4 = *(const float4*)&sm.x[s][j][t][tx * K6_TN];
      x[j][0] = x4.x;
      x[j][1] = x4.y;
      x[j][2] = x4.z;
      x[j][3] = x4.w;
    }
#pragma unroll
    for (int m = 0; m < K6_TM; ++m)
#pragma unroll
      for (int q = 0; q < K6_TN; ++q)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[m][q][j] = fmaf(a[m], x[j][q], acc[m][q][j]);
  }
}

// K6: (traj, vel) = the exact evaluation of alpha, for every lane.  Block
// bid takes row tile bid % RT and lane tile bid / RT.
template <bool VEC>
__global__ void __launch_bounds__(K6_THREADS)
forward_eval_kernel(FsParams p, const float* __restrict__ kvT, int lda,
                    const float* __restrict__ mix,
                    const float* __restrict__ alpha, float* traj,
                    float* vel) {
  __shared__ __align__(16) K6Tiles sm;
  const int T = p.T, R2 = 2 * T;
  const size_t B = p.B;
  const int RT = (R2 + K6_BM - 1) / K6_BM;
  const int r0 = (int)(blockIdx.x % RT) * K6_BM;
  const size_t b0 = (size_t)(blockIdx.x / RT) * K6_BN;
  const int ty = threadIdx.x / (K6_BN / K6_TN);
  const int tx = threadIdx.x - ty * (K6_BN / K6_TN);
  float acc[K6_TM][K6_TN][NJ];
#pragma unroll
  for (int m = 0; m < K6_TM; ++m)
#pragma unroll
    for (int q = 0; q < K6_TN; ++q)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[m][q][j] = 0.f;
  const int nk = (T + K6_TK - 1) / K6_TK;
  k6_stage<VEC>(sm, 0, kvT, lda, alpha, T, B, 0, r0, b0);
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) {
      k6_stage<VEC>(sm, (k + 1) & 1, kvT, lda, alpha, T, B, (k + 1) * K6_TK,
                    r0, b0);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int n = min(K6_TK, T - k * K6_TK);
    if (n == K6_TK)
      k6_fma<K6_TK>(sm, k & 1, n, ty, tx, acc);
    else
      k6_fma<0>(sm, k & 1, n, ty, tx, acc);
    __syncthreads();  // the stage is read before the next copy overwrites it
  }
  float mx[NJ * NJ];
#pragma unroll
  for (int i = 0; i < NJ * NJ; ++i) mx[i] = __ldg(mix + i);
  const size_t b = b0 + tx * K6_TN;
#pragma unroll
  for (int m = 0; m < K6_TM; ++m) {
    const int r = r0 + ty * K6_TM + m;
    if (r >= R2) break;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      float v[K6_TN];
#pragma unroll
      for (int q = 0; q < K6_TN; ++q) {
        float x = acc[m][q][0] * mx[0 * NJ + i];
        x = x + acc[m][q][1] * mx[1 * NJ + i];
        x = x + acc[m][q][2] * mx[2 * NJ + i];
        v[q] = x;
      }
      float* out = r < T ? traj + ((size_t)i * T + r) * B
                         : vel + ((size_t)i * T + r - T) * B;
      if constexpr (VEC) {
        if (b < B) *(float4*)(out + b) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < K6_TN; ++q)
          if (b + q < B) out[b + q] = v[q];
      }
    }
  }
}

// K6's tile as the kernel was compiled: rows, lanes, timesteps per stage,
// threads, shared memory per CTA (bytes), and the CTAs that fit on one SM.
extern "C" int forward_eval_shape(int* out) {
  int per_sm;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, forward_eval_kernel<true>, K6_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = K6_BM;
  out[1] = K6_BN;
  out[2] = K6_TK;
  out[3] = K6_THREADS;
  out[4] = (int)sizeof(K6Tiles);
  out[5] = per_sm;
  return 0;
}

// K6 with ``threads`` per block (the plan's, K6_THREADS), ``vec`` the
// 16-byte copies, kvT the transposed basis (T, lda) zero-padded to lda rows
// (a multiple of K6_BM, at least 2T).
extern "C" int forward_eval_launch(FsParams p, int threads, int vec, int lda,
                                   const float* kvT, const float* mix,
                                   const float* alpha, float* traj,
                                   float* vel, void* stream) {
  const long long rt = (2LL * p.T + K6_BM - 1) / K6_BM;
  const long long blocks = rt * (((long long)p.B + K6_BN - 1) / K6_BN);
  if (threads != K6_THREADS || p.T < 1 || p.B <= 0 || lda % K6_BM ||
      lda < rt * K6_BM || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (vec)
    forward_eval_kernel<true><<<(unsigned)blocks, K6_THREADS, 0,
                                (cudaStream_t)stream>>>(p, kvT, lda, mix,
                                                        alpha, traj, vel);
  else
    forward_eval_kernel<false><<<(unsigned)blocks, K6_THREADS, 0,
                                 (cudaStream_t)stream>>>(p, kvT, lda, mix,
                                                         alpha, traj, vel);
  return (int)cudaGetLastError();
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

template <bool EXACT, bool DEV>
static int bls_step_run(FsParams p, int block_b, const float* kv,
                        const float* kvt, const float* mix,
                        const float* lam_sg, const float* lam_jl,
                        const float* start, const float* goal, const float* ox,
                        const float* oy, const float* ow, float* alpha,
                        float* grad, float* traj, float* vel, float* loss,
                        float* lr, float* minimized, float* work,
                        void* stream) {
  const size_t smem = smem_bytes(p, block_b, DEV);
  unsigned grid;
  int err = launch_config(p, block_b, bls_step_kernel<EXACT, DEV>, smem, grid);
  if (err) return err;
  bls_step_kernel<EXACT, DEV><<<grid, block_b, smem, (cudaStream_t)stream>>>(
      p, kv, kvt, mix, lam_sg, lam_jl, start, goal, ox, oy, ow, alpha, grad,
      traj, vel, loss, lr, minimized, work);
  return (int)cudaGetLastError();
}

// The launches of K3 and K5: ``dev`` picks the instantiation that reads the
// basis from device memory (the step plan's "device"; 0: staged), ``exact``
// K3's program of the ladder tier (the exact one needs the workspace's
// trial plane).
extern "C" int bls_step_launch(FsParams p, int block_b, int dev, int exact,
                               const float* kv, const float* kvt,
                               const float* mix, const float* lam_sg,
                               const float* lam_jl, const float* start,
                               const float* goal, const float* ox,
                               const float* oy, const float* ow, float* alpha,
                               float* grad, float* traj, float* vel,
                               float* loss, float* lr, float* minimized,
                               float* work, void* stream) {
  auto run = dev ? (exact ? bls_step_run<true, true> : bls_step_run<false, true>)
                 : (exact ? bls_step_run<true, false>
                          : bls_step_run<false, false>);
  return run(p, block_b, kv, kvt, mix, lam_sg, lam_jl, start, goal, ox, oy, ow,
             alpha, grad, traj, vel, loss, lr, minimized, work, stream);
}

template <bool DEV>
static int cost_grad_eval_run(FsParams p, int block_b, const float* kv,
                              const float* kvt, const float* mix,
                              const float* alpha, const float* lam_sg,
                              const float* lam_jl, const float* start,
                              const float* goal, const float* ox,
                              const float* oy, const float* ow, float* loss,
                              float* grad, float* traj, float* vel,
                              float* work, void* stream) {
  const size_t smem = smem_bytes(p, block_b, DEV);
  unsigned grid;
  int err = launch_config(p, block_b, cost_grad_eval_kernel<DEV>, smem, grid);
  if (err) return err;
  cost_grad_eval_kernel<DEV><<<grid, block_b, smem, (cudaStream_t)stream>>>(
      p, kv, kvt, mix, alpha, lam_sg, lam_jl, start, goal, ox, oy, ow, loss,
      grad, traj, vel, work);
  return (int)cudaGetLastError();
}

extern "C" int cost_grad_eval_launch(FsParams p, int block_b, int dev,
                                     const float* kv, const float* kvt,
                                     const float* mix, const float* alpha,
                                     const float* lam_sg, const float* lam_jl,
                                     const float* start, const float* goal,
                                     const float* ox, const float* oy,
                                     const float* ow, float* loss, float* grad,
                                     float* traj, float* vel, float* work,
                                     void* stream) {
  return (dev ? cost_grad_eval_run<true> : cost_grad_eval_run<false>)(
      p, block_b, kv, kvt, mix, alpha, lam_sg, lam_jl, start, goal, ox, oy, ow,
      loss, grad, traj, vel, work, stream);
}
