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
//    in its two compilations, one per ladder tier: the programs SOLVER_BLS
//    (linearized) and SOLVER_BLS_EXACT of the warp body;
//  * K4 gd_step_kernel: gd_inner_step / _make_gd_step_kernel -> _gd_step
//    (the stop test rejects the trial; lr passes through);
//  * K5 cost_grad_eval_kernel: cost_grad_eval / _make_eval_kernel ->
//    _Body.cost_grad_eval;
//  * K6 forward_eval_kernel: forward_eval / _make_forward_kernel ->
//    _Body.forward_planes.
// Each computes what its TPU kernel computes, lane by lane; a lane's result
// does not depend on which kernel ran it (same op sequence).
//
// K3, K4 and K5 run the warp body of K1/K2 (warp_body.cuh: bls_step,
// gd_step, and the round start's evaluation eval_alpha, cost_pass and
// grad_pass): ONE WARP PER LANE, the lane's state on chip for the launch,
// in the launch plan of K1 (ops/fused_solve.py launch_plan: the resident
// body for T <= 64, the streamed one, through K7, beyond).  A CTA takes a
// tile of consecutive lanes, one warp each, and moves their planes between
// device memory and the warps' shared memory together, so that a load or
// store of a plane row is W consecutive words (lanes trailing).  K3 reads
// alpha, grad, traj and vel (the exact ladder: alpha and grad), loss, lr
// and the scene and writes the four planes, loss, lr and the stop flag; K4
// reads alpha, grad, loss and the scene and writes the planes and loss of
// an accepted trial; K5 reads alpha and the scene and writes loss, grad,
// traj and vel.  The direction planes, the ladder's candidates, a trial's
// evaluation and the gradient pass's rows never leave the chip, so none
// takes a workspace.  The grid is persistent (the CTAs that fit, from the
// occupancy calculator), each CTA walking tiles, so the resident body
// stages the basis once per CTA.
//
// K6 is a register-tiled float32 product: a CTA owns K6_BM output rows of
// kv (of the 2T) by K6_BN consecutive lanes, all J joints; tiles of the
// transposed basis and of alpha go through shared memory in two stages
// (cp.async); each thread holds K6_TM rows x K6_TN lanes x J accumulators.
// Each output element is still one sequential fmaf chain over t = 0 .. T-1
// (the tiles come in order of t and nothing splits the sum), followed by
// its mix combine, so K6 gives the warp body's evaluation (K5's traj and
// vel) bit for bit.  The row tile is the fastest grid index: the CTAs of
// one lane tile run together and read its alpha from device memory once,
// then from L2.
//
// State in place.  K3 and K4 update alpha, grad, traj, vel, loss, lr (K3)
// and the minimized flag where they lie, each lane's columns through its
// own warp's region of the tile.  A frozen lane (minimized > 0.5) is not
// touched at all, which is the TPU kernels' pass-through; a tile whose
// lanes are all frozen skips all work (the TPU kernel's whole-tile skip).
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
//    the ladder's rung count for K3.
//  * The warp body keeps everything between the loads and the stores on
//    chip (K1's design); the streamed body reads the basis from L2 once per
//    product and tile of lanes (K7), as K1's does.
// wgmma is for later versions.

#include "fused_kernels.cuh"

#include <limits.h>

// ---------------------------------------------------------------------------
// K3, K4 and K5: the warp body on tiles of lanes.
// ---------------------------------------------------------------------------

// Where the pieces of lane l's per-warp region lie (l = 0 .. W-1, the
// tile's lanes; offsets in floats from the region's start, which is its
// alpha plane), from the own warp's view: the tile's loads and stores write
// and read every warp's region of the tile.
struct TileMap {
  float* base;    // lane 0's region
  size_t stride;  // floats per region
  int grad, traj, vel, obs, ends;

  __device__ __forceinline__ float* region(int l) const {
    return base + (size_t)l * stride;
  }
};

// The resident body holds traj/vel in registers, which the tile moves
// through the direction planes (free at a step's start and, once the
// gradient pass has read the FK tangents there, at its end); the streamed
// body holds them in its traj/vel planes.
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

// (traj, vel) from the tile's load into the resident body's registers (the
// slots past T hold copies of t = T - 1, as an evaluation leaves them).
static __device__ __forceinline__ void take_eval(Warp& w) {
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    const int t = w.ts(s);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      w.traj[s][j] = w.dir_t[j * w.T + t];
      w.vel[s][j] = w.dir_v[j * w.T + t];
    }
  }
}
static __device__ __forceinline__ void take_eval(SWarp&) {}

// (traj, vel) from the resident body's registers for the tile's store.
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

// A lane's outcome in its region's ends[WB_OUTCOME]: 0 the lane sits the
// launch out, 1 it takes part, 2 its results are stored.
#define TILE_OUT 0.f
#define TILE_IN 1.f
#define TILE_STORE 2.f

// Rows [0, rows) of the N planes src[k] (lanes trailing) into offset off[k]
// of the regions of the tile's lanes that take part; each row is W
// consecutive words of device memory.
template <int N>
static __device__ __forceinline__ void tile_load(const TileMap& m, int W,
                                                 int rows, size_t B,
                                                 size_t b0, const int* off,
                                                 const float* const* src) {
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int row = i / W, l = i - row * W;
    float* r = m.region(l);
    if (r[m.ends + WB_OUTCOME] == TILE_OUT) continue;
    const size_t g = (size_t)row * B + b0 + l;
#pragma unroll
    for (int k = 0; k < N; ++k) r[off[k] + row] = src[k][g];
  }
}

// The same rows back from the regions of the lanes whose results are
// stored.
template <int N>
static __device__ __forceinline__ void tile_store(const TileMap& m, int W,
                                                  int rows, size_t B,
                                                  size_t b0, const int* off,
                                                  float* const* dst) {
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int row = i / W, l = i - row * W;
    const float* r = m.region(l);
    if (r[m.ends + WB_OUTCOME] != TILE_STORE) continue;
    const size_t g = (size_t)row * B + b0 + l;
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k][g] = r[off[k] + row];
  }
}

// The scene of the tile's lanes that take part: the obstacle terms (ox,
// oy, q_o = 0.5 + 0.5 |o|^2, 0.8 w_o) and the endpoints.
static __device__ __forceinline__ void tile_load_scene(
    const TileMap& m, int W, int O, size_t B, size_t b0,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ ow, const float* __restrict__ start,
    const float* __restrict__ goal) {
  for (int i = threadIdx.x; i < O * W; i += blockDim.x) {
    const int o = i / W, l = i - o * W;
    float* r = m.region(l);
    if (r[m.ends + WB_OUTCOME] == TILE_OUT) continue;
    const size_t g = (size_t)o * B + b0 + l;
    const float x = ox[g], y = oy[g], wt = ow[g];
    ((float4*)(r + m.obs))[o] =
        make_float4(x, y, 0.5f + 0.5f * (x * x + y * y), 0.8f * wt);
  }
  for (int i = threadIdx.x; i < NJ * W; i += blockDim.x) {
    const int j = i / W, l = i - j * W;
    float* r = m.region(l);
    if (r[m.ends + WB_OUTCOME] == TILE_OUT) continue;
    const size_t g = (size_t)j * B + b0 + l;
    r[m.ends + j] = start[g];
    r[m.ends + NJ + j] = goal[g];
  }
}

// Mark this warp's lane of the tile (every thread of the CTA calls it);
// returns whether any lane of the tile takes part.  The barrier also ends
// the previous tile's store.
template <class W>
static __device__ __forceinline__ bool tile_begin(W& w, int lanes, bool in) {
  if (!__syncthreads_or(in)) return false;
  if ((int)(threadIdx.x >> 5) < lanes && w.lid == 0)
    w.ends[WB_OUTCOME] = in ? TILE_IN : TILE_OUT;
  __syncthreads();
  return true;
}

// K3: one BLS inner step for every live lane, in place, in the program
// PROGRAM (SOLVER_BLS: the linearized ladder, whose recomputed loss is the
// accepted rung's, bls_step; SOLVER_BLS_EXACT: the exact ladder).  Each
// live lane's alpha, grad, traj, vel, loss and lr are stored: the stop test
// does not reject the step (alpha, traj and vel move, grad is kept).
// In K3, K4 and K5: TT/OO the specialised resident instantiation (0: T and
// O at run time); STREAM the streamed body (the transposed, blocked basis
// pair in device memory, fused_solve.streamed_basis; the tile's lanes in
// lockstep, their products one K7 product each); W = ``lanes`` lanes per
// tile, one warp each (the streamed CTA's other warps help with the
// products and view lane 0).
template <int PROGRAM, int TT, int OO, bool STREAM>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, STREAM ? 1 : WB_MIN_CTAS)
bls_step_kernel(FsParams p, int lanes, const float* __restrict__ kv,
                const float* __restrict__ kvt, const float* __restrict__ mix,
                const float* __restrict__ lam_sg,
                const float* __restrict__ lam_jl,
                const float* __restrict__ start,
                const float* __restrict__ goal, const float* __restrict__ ox,
                const float* __restrict__ oy, const float* __restrict__ ow,
                float* alpha, float* grad, float* traj, float* vel,
                float* loss, float* lr, float* minimized) {
  // The exact ladder evaluates each rung's candidate: it never reads the
  // incoming (traj, vel).
  constexpr bool EXACT = PROGRAM == SOLVER_BLS_EXACT;
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int T = TT ? TT : p.T, O = TT ? OO : p.O;
  const int W = lanes, wid = threadIdx.x >> 5;
  const size_t B = p.B;
  auto w = bind_body<PROGRAM, STREAM>(smem, T, O, W, kv, kvt, mix);
  int own = wid;
  if constexpr (STREAM) own = w.lane;
  const TileMap m = tile_map(w, own);
  const int rows = NJ * T;
  const int off[] = {0, m.grad, m.traj, m.vel};
  const float* const in[] = {alpha, grad, traj, vel};
  float* const out[] = {alpha, grad, traj, vel};
  const size_t tiles = (B + W - 1) / W;
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t b0 = tile * W, b = b0 + wid;
    const bool live = wid < W && b < B && !(minimized[b] > 0.5f);
    if (!tile_begin(w, W, live)) continue;  // the whole-tile skip
    tile_load<EXACT ? 2 : 4>(m, W, rows, B, b0, off, in);
    tile_load_scene(m, W, O, B, b0, ox, oy, ow, start, goal);
    __syncthreads();
    float l = 0.f, r = 0.f;
    if (live) {
      w.lam_sg = lam_sg[b];
      w.lam_jl = lam_jl[b];
      l = loss[b];
      r = lr[b];
    }
    bool stop = false;
    if constexpr (STREAM) {
      stop = ls_bls_step<PROGRAM>(p, w, l, r, live);
    } else if (live) {
      if constexpr (!EXACT) take_eval(w);
      stop = bls_step<PROGRAM>(p, w, l, r);
      keep_eval(w);
    }
    if (live) {
      __syncwarp();
      if (w.lid == 0) {
        w.ends[WB_OUTCOME] = TILE_STORE;
        loss[b] = l;
        lr[b] = r;
        minimized[b] = fmaxf(minimized[b], stop ? 1.f : 0.f);
      }
    }
    __syncthreads();
    tile_store<4>(m, W, rows, B, b0, off, out);
  }
}

// K4: one GD inner step for every live lane, in place; lr is read only.  A
// stop rejects the trial: only the stop flag is written.
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
  int own = wid;
  if constexpr (STREAM) own = w.lane;
  const TileMap m = tile_map(w, own);
  const int rows = NJ * T;
  const int off[] = {0, m.grad, m.traj, m.vel};
  const float* const in[] = {alpha, grad};
  float* const out[] = {alpha, grad, traj, vel};
  const size_t tiles = (B + W - 1) / W;
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t b0 = tile * W, b = b0 + wid;
    const bool live = wid < W && b < B && !(minimized[b] > 0.5f);
    if (!tile_begin(w, W, live)) continue;  // the whole-tile skip
    tile_load<2>(m, W, rows, B, b0, off, in);
    tile_load_scene(m, W, O, B, b0, ox, oy, ow, start, goal);
    __syncthreads();
    float l = 0.f;
    if (live) {
      w.lam_sg = lam_sg[b];
      w.lam_jl = lam_jl[b];
      l = loss[b];
    }
    bool stop = true;
    if constexpr (STREAM) {
      stop = ls_gd_step(p, w, l, live ? lr[b] : 0.f, live);
    } else if (live) {
      stop = gd_step(p, w, l, lr[b]);
      if (!stop) keep_eval(w);
    }
    if (live) {
      __syncwarp();
      if (w.lid == 0) {
        w.ends[WB_OUTCOME] = stop ? TILE_OUT : TILE_STORE;
        if (!stop) loss[b] = l;
        minimized[b] = fmaxf(minimized[b], stop ? 1.f : 0.f);
      }
    }
    __syncthreads();
    tile_store<4>(m, W, rows, B, b0, off, out);
  }
}

// K5: loss, gradient and exact (traj, vel) at alpha for every lane: the
// warp body's round-start evaluation (eval_alpha, the cost pass with the
// loss, the gradient pass), in the plan of the BLS program.
template <int TT, int OO, bool STREAM>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, STREAM ? 1 : WB_MIN_CTAS)
cost_grad_eval_kernel(FsParams p, int lanes, const float* __restrict__ kv,
                      const float* __restrict__ kvt,
                      const float* __restrict__ mix,
                      const float* __restrict__ alpha,
                      const float* __restrict__ lam_sg,
                      const float* __restrict__ lam_jl,
                      const float* __restrict__ start,
                      const float* __restrict__ goal,
                      const float* __restrict__ ox,
                      const float* __restrict__ oy,
                      const float* __restrict__ ow, float* loss, float* grad,
                      float* traj, float* vel) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int T = TT ? TT : p.T, O = TT ? OO : p.O;
  const int W = lanes, wid = threadIdx.x >> 5;
  const size_t B = p.B;
  auto w = bind_body<SOLVER_BLS, STREAM>(smem, T, O, W, kv, kvt, mix);
  int own = wid;
  if constexpr (STREAM) own = w.lane;
  const TileMap m = tile_map(w, own);
  const int rows = NJ * T;
  const int in_off[] = {0};
  const float* const in[] = {alpha};
  const int out_off[] = {m.grad, m.traj, m.vel};
  float* const out[] = {grad, traj, vel};
  const size_t tiles = (B + W - 1) / W;
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t b0 = tile * W, b = b0 + wid;
    const bool live = wid < W && b < B;
    tile_begin(w, W, live);
    tile_load<1>(m, W, rows, B, b0, in_off, in);
    tile_load_scene(m, W, O, B, b0, ox, oy, ow, start, goal);
    __syncthreads();
    if (live) {
      w.lam_sg = lam_sg[b];
      w.lam_jl = lam_jl[b];
    }
    float l = 0.f;
    if constexpr (STREAM) {
      eval_alpha(w, live);
      int first = 0;
      if (live) l = cost_pass(p, w, true, first);
      grad_pass(p, w, first, live);
    } else if (live) {
      eval_alpha(w);
      int first;
      l = cost_pass(p, w, true, first);
      grad_pass(p, w, first);
      keep_eval(w);
    }
    if (live) {
      __syncwarp();
      if (w.lid == 0) {
        w.ends[WB_OUTCOME] = TILE_STORE;
        loss[b] = l;
      }
    }
    __syncthreads();
    tile_store<3>(m, W, rows, B, b0, out_off, out);
  }
}

// The per-step kernels of the warp body, by the index the wrappers pass
// (ops/step_kernels.py STEP_KERNELS): K3 in the linearized and the exact
// ladder, K4, K5.
#define STEP_BLS 0
#define STEP_BLS_EXACT 1
#define STEP_GD 2
#define STEP_EVAL 3

template <int PROGRAM>
struct BlsStep {
  template <int TT, int OO, bool S>
  static const void* of() {
    return (const void*)bls_step_kernel<PROGRAM, TT, OO, S>;
  }
};
struct GdStep {
  template <int TT, int OO, bool S>
  static const void* of() {
    return (const void*)gd_step_kernel<TT, OO, S>;
  }
};
struct EvalStep {
  template <int TT, int OO, bool S>
  static const void* of() {
    return (const void*)cost_grad_eval_kernel<TT, OO, S>;
  }
};

// K's instantiation for p in the body ``streamed``.
template <class K>
static const void* step_instance(const FsParams& p, bool streamed) {
  if (streamed) return K::template of<0, 0, true>();
#if NJ == 3
  if (specialised(p)) return K::template of<WB_SPEC_T, WB_SPEC_O, false>();
#endif
  return K::template of<0, 0, false>();
}

static const void* step_kernel_of(int kernel, const FsParams& p,
                                  bool streamed) {
  switch (kernel) {
    case STEP_BLS:
      return step_instance<BlsStep<SOLVER_BLS>>(p, streamed);
    case STEP_BLS_EXACT:
      return step_instance<BlsStep<SOLVER_BLS_EXACT>>(p, streamed);
    case STEP_GD:
      return step_instance<GdStep>(p, streamed);
    case STEP_EVAL:
      return step_instance<EvalStep>(p, streamed);
  }
  return nullptr;
}

// A per-step kernel's launch shape at ``lanes`` lanes per CTA in the body
// ``streamed`` (launch_plan of K1 in its program): the kernel, its warps
// per CTA (one per lane; streamed: WB_STREAM_WARPS), its dynamic shared
// memory (the warp body's plan), the CTAs that fit on one SM and the SM
// count.
static int step_shape(const FsParams& p, int which, int lanes, int streamed,
                      const void*& kernel, int& warps, size_t& smem,
                      int& per_sm, int& sms) {
  warps = streamed ? WB_STREAM_WARPS : lanes;
  if (lanes < 1 || lanes > warps - (streamed ? 1 : 0) ||
      warps > WB_MAX_WARPS || p.T < 1 ||
      (streamed ? p.T < 32 : p.T > WB_MAX_T) || p.O < 0 || p.B <= 0 ||
      (streamed != 0 && streamed != 1))
    return (int)cudaErrorInvalidValue;
  kernel = step_kernel_of(which, p, streamed != 0);
  if (!kernel) return (int)cudaErrorInvalidValue;
  smem = warp_smem_bytes(p, lanes, streamed != 0, WB_LY_STREAMED);
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

// The CTAs that fit on one SM, the SM count and the shared memory per CTA
// of the per-step kernel ``which`` (STEP_*) at ``lanes`` lanes per CTA.
extern "C" int step_kernel_shape(FsParams p, int which, int lanes,
                                 int streamed, int* out) {
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err =
      step_shape(p, which, lanes, streamed, kernel, warps, smem, per_sm, sms);
  if (err) return err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = (int)smem;
  return 0;
}

// Launch the per-step kernel ``which`` with its arguments ``args`` (p and
// lanes first) on the persistent grid: every CTA that fits, never more
// than the tiles.
static int step_launch(const FsParams& p, int which, int lanes, int streamed,
                       void** args, void* stream) {
  const void* kernel;
  size_t smem;
  int warps, per_sm, sms;
  const int err =
      step_shape(p, which, lanes, streamed, kernel, warps, smem, per_sm, sms);
  if (err) return err;
  const long long tiles = ((long long)p.B + lanes - 1) / lanes;
  const long long full = (long long)per_sm * sms;
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)(full < tiles ? full
                                                                    : tiles)),
                               dim3(32 * warps), args, smem,
                               (cudaStream_t)stream);
}

// K3 at ``lanes`` lanes per CTA, in the body ``streamed`` (then kv and kvt
// are the transposed, blocked pair), in the ladder tier ``exact``.
extern "C" int bls_step_launch(FsParams p, int lanes, int streamed, int exact,
                               const float* kv, const float* kvt,
                               const float* mix, const float* lam_sg,
                               const float* lam_jl, const float* start,
                               const float* goal, const float* ox,
                               const float* oy, const float* ow, float* alpha,
                               float* grad, float* traj, float* vel,
                               float* loss, float* lr, float* minimized,
                               void* stream) {
  if (exact != 0 && exact != 1) return (int)cudaErrorInvalidValue;
  void* args[] = {&p,    &lanes, &kv,    &kvt,  &mix,  &lam_sg, &lam_jl,
                  &start, &goal, &ox,    &oy,   &ow,    &alpha, &grad,
                  &traj, &vel,  &loss,  &lr,    &minimized};
  return step_launch(p, exact ? STEP_BLS_EXACT : STEP_BLS, lanes, streamed,
                     args, stream);
}

// K4, likewise.
extern "C" int gd_step_launch(FsParams p, int lanes, int streamed,
                              const float* kv, const float* kvt,
                              const float* mix, const float* lam_sg,
                              const float* lam_jl, const float* start,
                              const float* goal, const float* ox,
                              const float* oy, const float* ow, float* alpha,
                              float* grad, float* traj, float* vel,
                              float* loss, const float* lr, float* minimized,
                              void* stream) {
  void* args[] = {&p,    &lanes, &kv,    &kvt,  &mix,  &lam_sg, &lam_jl,
                  &start, &goal, &ox,    &oy,   &ow,    &alpha, &grad,
                  &traj, &vel,  &loss,  &lr,    &minimized};
  return step_launch(p, STEP_GD, lanes, streamed, args, stream);
}

// K5, likewise.
extern "C" int cost_grad_eval_launch(FsParams p, int lanes, int streamed,
                                     const float* kv, const float* kvt,
                                     const float* mix, const float* alpha,
                                     const float* lam_sg, const float* lam_jl,
                                     const float* start, const float* goal,
                                     const float* ox, const float* oy,
                                     const float* ow, float* loss, float* grad,
                                     float* traj, float* vel, void* stream) {
  void* args[] = {&p,     &lanes, &kv, &kvt, &mix, &alpha, &lam_sg, &lam_jl,
                  &start, &goal,  &ox, &oy,  &ow,  &loss,  &grad,   &traj,
                  &vel};
  return step_launch(p, STEP_EVAL, lanes, streamed, args, stream);
}

// ---------------------------------------------------------------------------
// K6: the forward evaluation as a register-tiled float32 product.
// ---------------------------------------------------------------------------

// The tile (mirror of forward_plan in ops/step_kernels.py): K6_BM output
// rows of kv by K6_BN lanes per CTA, K6_TK timesteps per stage, two stages;
// each thread K6_TM rows by K6_TN lanes, all J joints: K6_TM K6_TN J
// accumulators: 16 J at J <= 4 (48 at J = 3), 8 J beyond (half the lanes).
#define K6_BM 64
#define K6_TK 10
#define K6_TM 4
#if NJ <= 4
#define K6_BN 64
#define K6_TN 4
#else
#define K6_BN 32
#define K6_TN 2
#endif
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
      if constexpr (K6_TN == 4) {
        const float4 x4 = *(const float4*)&sm.x[s][j][t][tx * K6_TN];
        x[j][0] = x4.x;
        x[j][1] = x4.y;
        x[j][2] = x4.z;
        x[j][3] = x4.w;
      } else {
        const float2 x2 = *(const float2*)&sm.x[s][j][t][tx * K6_TN];
        x[j][0] = x2.x;
        x[j][1] = x2.y;
      }
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
      for (int q = 0; q < K6_TN; ++q) v[q] = mixed<false>(mx, i, acc[m][q]);
      float* out = r < T ? traj + ((size_t)i * T + r) * B
                         : vel + ((size_t)i * T + r - T) * B;
      if constexpr (VEC && K6_TN == 4) {
        if (b < B) *(float4*)(out + b) = make_float4(v[0], v[1], v[2], v[3]);
      } else if constexpr (VEC) {
        if (b < B) *(float2*)(out + b) = make_float2(v[0], v[1]);
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
