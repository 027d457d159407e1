// The per-step kernels for arms of J >= 16 joints (csrc/step_kernels.cu's,
// J at run time): K3 one BLS inner step (the linearized and the exact
// ladder), K4 one GD inner step, K5 the fused cost/gradient/evaluation and
// K6 the forward evaluation.  They replace, as at J <= 15,
// irm_motion_planning_tpu/ops/pallas_step.py's bls_inner_step,
// gd_inner_step, cost_grad_eval and forward_eval.
//
// K3, K4 and K5 run wide_body.cuh's steps on tiles of lanes in K1's launch
// plan for their program, one warp per lane; a tile's planes move between
// device memory (lanes trailing) and the warps' regions together, straight
// into the traj/vel planes every body of wide_body.cuh keeps.  A lane's
// floats are K1's bit for bit (the same functions).
//
// K6: a tiled float32 product blocked over joints.  A CTA owns K6_BM rows
// of kv by K6_BN lanes; each thread K6_TM rows x K6_TN lanes x K6_JB
// joints of chains (32 registers at any J), one pass over t per block of
// K6_JB joints through two shared-memory stages (cp.async); each block's
// raw chains go to the output planes, and the mix combine then reads a
// row's J chains back (the thread's own writes) into its column of a
// shared-memory scratch (J floats a thread: dynamic shared memory) and
// writes the mixed values over them, mix read from device memory (L1).
// Each output is one sequential fmaf chain over t followed by the mix
// combine in order of j: K5's traj/vel (and K7's) bit for bit.  Bound:
// bytes at T = 50 (alpha in, traj/vel out; the design moves the outputs
// three times), operations at T = 200 (ops/roofline.py).

#include "wide_body.cuh"

int wide_occupancy(const void* kernel, int warps, size_t smem, int& per_sm,
                   int& sms);

template <class V>
struct TileMap {
  float* base;
  size_t stride;
  int grad, traj, vel, obs, ends;
  __device__ __forceinline__ float* region(int l) const {
    return base + (size_t)l * stride;
  }
};
template <class V>
static __device__ __forceinline__ TileMap<V> tile_map(const V& w, int own) {
  return {w.alpha - own * w.stride, w.stride, (int)(w.grad - w.alpha),
          (int)(w.traj - w.alpha), (int)(w.vel - w.alpha),
          (int)((float*)w.obs - w.alpha), (int)(w.ends - w.alpha)};
}

#define TILE_OUT 0.f
#define TILE_IN 1.f
#define TILE_STORE 2.f

template <int N, class M>
static __device__ __forceinline__ void tile_load(const M& m, int J, int W,
                                                 int rows, size_t B,
                                                 size_t b0, const int* off,
                                                 const float* const* src) {
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int row = i / W, l = i - row * W;
    float* r = m.region(l);
    if (r[m.ends + wb_outcome(J)] == TILE_OUT) continue;
    const size_t g = (size_t)row * B + b0 + l;
#pragma unroll
    for (int k = 0; k < N; ++k) r[off[k] + row] = src[k][g];
  }
}

template <int N, class M>
static __device__ __forceinline__ void tile_store(const M& m, int J, int W,
                                                  int rows, size_t B,
                                                  size_t b0, const int* off,
                                                  float* const* dst) {
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int row = i / W, l = i - row * W;
    const float* r = m.region(l);
    if (r[m.ends + wb_outcome(J)] != TILE_STORE) continue;
    const size_t g = (size_t)row * B + b0 + l;
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k][g] = r[off[k] + row];
  }
}

template <class M>
static __device__ __forceinline__ void tile_load_scene(
    const M& m, int J, int W, int O, size_t B, size_t b0,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ ow, const float* __restrict__ start,
    const float* __restrict__ goal) {
  for (int i = threadIdx.x; i < O * W; i += blockDim.x) {
    const int o = i / W, l = i - o * W;
    float* r = m.region(l);
    if (r[m.ends + wb_outcome(J)] == TILE_OUT) continue;
    const size_t g = (size_t)o * B + b0 + l;
    const float x = ox[g], y = oy[g], wt = ow[g];
    ((float4*)(r + m.obs))[o] =
        make_float4(x, y, 0.5f + 0.5f * (x * x + y * y), 0.8f * wt);
  }
  for (int i = threadIdx.x; i < J * W; i += blockDim.x) {
    const int j = i / W, l = i - j * W;
    float* r = m.region(l);
    if (r[m.ends + wb_outcome(J)] == TILE_OUT) continue;
    const size_t g = (size_t)j * B + b0 + l;
    r[m.ends + j] = start[g];
    r[m.ends + J + j] = goal[g];
  }
}

template <class V>
static __device__ __forceinline__ bool tile_begin(V& w, int lanes, bool in) {
  if (!__syncthreads_or(in)) return false;
  if ((int)(threadIdx.x >> 5) < lanes && w.lid == 0)
    w.ends[wb_outcome(w.J)] = in ? TILE_IN : TILE_OUT;
  __syncthreads();
  return true;
}

template <class V>
static __device__ __forceinline__ int own_lane(const V& w) {
  return V::kStreamed ? w.lane : (int)(threadIdx.x >> 5);
}

// K3 in the program PROGRAM (SOLVER_BLS or SOLVER_BLS_EXACT).
template <int PROGRAM, int BODY>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, 1)
wide_bls_step_kernel(const WParams p, int lanes, const float* __restrict__ kv,
                     const float* __restrict__ kvt,
                     const float* __restrict__ mix,
                     const float* __restrict__ lam_sg,
                     const float* __restrict__ lam_jl,
                     const float* __restrict__ start,
                     const float* __restrict__ goal,
                     const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ ow, float* alpha, float* grad,
                     float* traj, float* vel, float* loss, float* lr,
                     float* minimized) {
  constexpr bool EXACT = PROGRAM == SOLVER_BLS_EXACT;
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int T = p.T, O = p.O, J = p.J;
  const int W = lanes, wid = threadIdx.x >> 5;
  const size_t B = p.B;
  auto w = bind_body<PROGRAM, BODY>(p, smem, T, O, W, kv, kvt, mix);
  const auto m = tile_map(w, own_lane(w));
  const int rows = J * T;
  const int off[] = {0, m.grad, m.traj, m.vel};
  const float* const in[] = {alpha, grad, traj, vel};
  float* const out[] = {alpha, grad, traj, vel};
  const size_t tiles = (B + W - 1) / W;
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t b0 = tile * W, b = b0 + wid;
    const bool live = wid < W && b < B && !(minimized[b] > 0.5f);
    if (!tile_begin(w, W, live)) continue;
    tile_load<EXACT ? 2 : 4>(m, J, W, rows, B, b0, off, in);
    tile_load_scene(m, J, W, O, B, b0, ox, oy, ow, start, goal);
    __syncthreads();
    float l = 0.f, r = 0.f;
    if (live) {
      w.lam_sg = lam_sg[b];
      w.lam_jl = lam_jl[b];
      l = loss[b];
      r = lr[b];
    }
    const bool stop = ls_bls_step<PROGRAM>(p, w, l, r, live);
    if (live) {
      __syncwarp();
      if (w.lid == 0) {
        w.ends[wb_outcome(J)] = TILE_STORE;
        loss[b] = l;
        lr[b] = r;
        minimized[b] = fmaxf(minimized[b], stop ? 1.f : 0.f);
      }
    }
    __syncthreads();
    tile_store<4>(m, J, W, rows, B, b0, off, out);
  }
}

// K4.
template <int BODY>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, 1)
wide_gd_step_kernel(const WParams p, int lanes, const float* __restrict__ kv,
                    const float* __restrict__ kvt,
                    const float* __restrict__ mix,
                    const float* __restrict__ lam_sg,
                    const float* __restrict__ lam_jl,
                    const float* __restrict__ start,
                    const float* __restrict__ goal,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ ow, float* alpha, float* grad,
                    float* traj, float* vel, float* loss,
                    const float* __restrict__ lr, float* minimized) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int T = p.T, O = p.O, J = p.J;
  const int W = lanes, wid = threadIdx.x >> 5;
  const size_t B = p.B;
  auto w = bind_body<SOLVER_GD, BODY>(p, smem, T, O, W, kv, kvt, mix);
  const auto m = tile_map(w, own_lane(w));
  const int rows = J * T;
  const int off[] = {0, m.grad, m.traj, m.vel};
  const float* const in[] = {alpha, grad};
  float* const out[] = {alpha, grad, traj, vel};
  const size_t tiles = (B + W - 1) / W;
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t b0 = tile * W, b = b0 + wid;
    const bool live = wid < W && b < B && !(minimized[b] > 0.5f);
    if (!tile_begin(w, W, live)) continue;
    tile_load<2>(m, J, W, rows, B, b0, off, in);
    tile_load_scene(m, J, W, O, B, b0, ox, oy, ow, start, goal);
    __syncthreads();
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
        w.ends[wb_outcome(J)] = stop ? TILE_OUT : TILE_STORE;
        if (!stop) loss[b] = l;
        minimized[b] = fmaxf(minimized[b], stop ? 1.f : 0.f);
      }
    }
    __syncthreads();
    tile_store<4>(m, J, W, rows, B, b0, off, out);
  }
}

// K5, in the plan of the BLS program.
template <int BODY>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, 1)
wide_cost_grad_eval_kernel(const WParams p, int lanes,
                           const float* __restrict__ kv,
                           const float* __restrict__ kvt,
                           const float* __restrict__ mix,
                           const float* __restrict__ alpha,
                           const float* __restrict__ lam_sg,
                           const float* __restrict__ lam_jl,
                           const float* __restrict__ start,
                           const float* __restrict__ goal,
                           const float* __restrict__ ox,
                           const float* __restrict__ oy,
                           const float* __restrict__ ow, float* loss,
                           float* grad, float* traj, float* vel) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int T = p.T, O = p.O, J = p.J;
  const int W = lanes, wid = threadIdx.x >> 5;
  const size_t B = p.B;
  auto w = bind_body<SOLVER_BLS, BODY>(p, smem, T, O, W, kv, kvt, mix);
  const auto m = tile_map(w, own_lane(w));
  const int rows = J * T;
  const int in_off[] = {0};
  const float* const in[] = {alpha};
  const int out_off[] = {m.grad, m.traj, m.vel};
  float* const out[] = {grad, traj, vel};
  const size_t tiles = (B + W - 1) / W;
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t b0 = tile * W, b = b0 + wid;
    const bool live = wid < W && b < B;
    tile_begin(w, W, live);
    tile_load<1>(m, J, W, rows, B, b0, in_off, in);
    tile_load_scene(m, J, W, O, B, b0, ox, oy, ow, start, goal);
    __syncthreads();
    if (live) {
      w.lam_sg = lam_sg[b];
      w.lam_jl = lam_jl[b];
    }
    float l = 0.f;
    eval_alpha(w, live);
    int first = 0;
    if (live) l = cost_pass(p, w, true, first);
    grad_pass(p, w, first, live);
    if (live) {
      __syncwarp();
      if (w.lid == 0) {
        w.ends[wb_outcome(J)] = TILE_STORE;
        loss[b] = l;
      }
    }
    __syncthreads();
    tile_store<3>(m, J, W, rows, B, b0, out_off, out);
  }
}

#define STEP_BLS 0
#define STEP_BLS_EXACT 1
#define STEP_GD 2
#define STEP_EVAL 3

template <int BODY>
static const void* step_kernel_in(int kernel) {
  switch (kernel) {
    case STEP_BLS:
      return (const void*)wide_bls_step_kernel<SOLVER_BLS, BODY>;
    case STEP_BLS_EXACT:
      return (const void*)wide_bls_step_kernel<SOLVER_BLS_EXACT, BODY>;
    case STEP_GD:
      return (const void*)wide_gd_step_kernel<BODY>;
    case STEP_EVAL:
      return (const void*)wide_cost_grad_eval_kernel<BODY>;
  }
  return nullptr;
}

static int step_shape(const WParams& p, int which, int lanes, int streamed,
                      const void*& kernel, int& warps, size_t& smem,
                      int& per_sm, int& sms) {
  warps = streamed ? WB_STREAM_WARPS : lanes;
  if (lanes < 1 || lanes > warps - (streamed ? 1 : 0) ||
      warps > WB_MAX_WARPS || p.T < 1 ||
      (streamed ? p.T < 32 : p.T > WB_MAX_T) || p.O < 0 || p.B <= 0 ||
      (streamed != 0 && streamed != 1))
    return (int)cudaErrorInvalidValue;
  kernel = streamed ? step_kernel_in<WB_BODY_STREAMED>(which)
                    : step_kernel_in<WB_BODY_RESIDENT>(which);
  if (!kernel) return (int)cudaErrorInvalidValue;
  smem = warp_smem_bytes(p, lanes, streamed != 0, WB_LY_STREAMED);
  return wide_occupancy(kernel, warps, smem, per_sm, sms);
}

extern "C" int step_kernel_shape(WParams p, int which,
                                 int lanes, int streamed, int* out) {
  if (!wide_ok(p)) return (int)cudaErrorInvalidValue;
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

static int step_launch(const WParams& p, int which, int lanes, int streamed,
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

extern "C" int bls_step_launch(WParams p, int lanes,
                               int streamed, int exact, const float* kv,
                               const float* kvt, const float* mix,
                               const float* lam_sg, const float* lam_jl,
                               const float* start, const float* goal,
                               const float* ox, const float* oy,
                               const float* ow, float* alpha, float* grad,
                               float* traj, float* vel, float* loss,
                               float* lr, float* minimized, void* stream) {
  if (!wide_ok(p) || (exact != 0 && exact != 1))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&p,    &lanes, &kv,    &kvt,  &mix,  &lam_sg, &lam_jl,
                  &start, &goal, &ox,    &oy,   &ow,    &alpha, &grad,
                  &traj, &vel,  &loss,  &lr,    &minimized};
  return step_launch(p, exact ? STEP_BLS_EXACT : STEP_BLS, lanes, streamed,
                     args, stream);
}

extern "C" int gd_step_launch(WParams p, int lanes, int streamed,
                              const float* kv, const float* kvt,
                              const float* mix, const float* lam_sg,
                              const float* lam_jl, const float* start,
                              const float* goal, const float* ox,
                              const float* oy, const float* ow, float* alpha,
                              float* grad, float* traj, float* vel,
                              float* loss, const float* lr, float* minimized,
                              void* stream) {
  if (!wide_ok(p)) return (int)cudaErrorInvalidValue;
  void* args[] = {&p,    &lanes, &kv,    &kvt,  &mix,  &lam_sg, &lam_jl,
                  &start, &goal, &ox,    &oy,   &ow,    &alpha, &grad,
                  &traj, &vel,  &loss,  &lr,    &minimized};
  return step_launch(p, STEP_GD, lanes, streamed, args, stream);
}

extern "C" int cost_grad_eval_launch(WParams p, int lanes,
                                     int streamed, const float* kv,
                                     const float* kvt, const float* mix,
                                     const float* alpha, const float* lam_sg,
                                     const float* lam_jl, const float* start,
                                     const float* goal, const float* ox,
                                     const float* oy, const float* ow,
                                     float* loss, float* grad, float* traj,
                                     float* vel, void* stream) {
  if (!wide_ok(p)) return (int)cudaErrorInvalidValue;
  void* args[] = {&p,     &lanes, &kv, &kvt, &mix, &alpha, &lam_sg, &lam_jl,
                  &start, &goal,  &ox, &oy,  &ow,  &loss,  &grad,   &traj,
                  &vel};
  return step_launch(p, STEP_EVAL, lanes, streamed, args, stream);
}

// ---------------------------------------------------------------------------
// K6 (mirror of forward_plan in ops/step_kernels.py at J >= 16).
// ---------------------------------------------------------------------------

#define K6_BM 64
#define K6_TK 10
#define K6_TM 4
#define K6_BN 32
#define K6_TN 2
#define K6_JB 4
#define K6_THREADS ((K6_BM / K6_TM) * (K6_BN / K6_TN))

struct K6Tiles {
  float a[2][K6_TK][K6_BM];         // a[s][t][r] = kv[r0 + r][t0 + t]
  float x[2][K6_JB][K6_TK][K6_BN];  // alpha[j0 + j][t0 + t][b0 + n]
};

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

// Stage s: timesteps t0 .. t0 + K6_TK - 1 of the transposed basis at rows
// r0.. and of alpha's joints j0 .. j0 + K6_JB - 1 at lanes b0..; zeros
// past T, J and B.
template <bool VEC>
static __device__ __forceinline__ void k6_stage(K6Tiles& sm, int s,
                                                const float* kvT, int lda,
                                                const float* alpha, int J,
                                                int T, size_t B, int t0,
                                                int j0, int r0, size_t b0) {
  const int tid = threadIdx.x;
  for (int i = tid; i < K6_TK * K6_BM / 4; i += K6_THREADS) {
    const int t = i / (K6_BM / 4), c = 4 * (i - t * (K6_BM / 4));
    const bool ok = t0 + t < T;
    cp_async16(&sm.a[s][t][c],
               ok ? kvT + (size_t)(t0 + t) * lda + r0 + c : kvT, ok);
  }
  if constexpr (VEC) {
    for (int i = tid; i < K6_JB * K6_TK * K6_BN / 4; i += K6_THREADS) {
      const int jt = i / (K6_BN / 4), n = 4 * (i - jt * (K6_BN / 4));
      const int j = jt / K6_TK, t = jt - j * K6_TK;
      const bool ok = j0 + j < J && t0 + t < T && b0 + n < B;
      cp_async16(&sm.x[s][j][t][n],
                 ok ? alpha + ((size_t)(j0 + j) * T + t0 + t) * B + b0 + n
                    : alpha,
                 ok);
    }
  } else {
    for (int i = tid; i < K6_JB * K6_TK * K6_BN; i += K6_THREADS) {
      const int jt = i / K6_BN, n = i - jt * K6_BN;
      const int j = jt / K6_TK, t = jt - j * K6_TK;
      const bool ok = j0 + j < J && t0 + t < T && b0 + n < B;
      cp_async4(&sm.x[s][j][t][n],
                ok ? alpha + ((size_t)(j0 + j) * T + t0 + t) * B + b0 + n
                   : alpha,
                ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// K6: block bid takes row tile bid % RT and lane tile bid / RT.
template <bool VEC>
__global__ void __launch_bounds__(K6_THREADS)
wide_forward_eval_kernel(const WParams p, const float* __restrict__ kvT,
                         int lda, const float* __restrict__ mix,
                         const float* __restrict__ alpha, float* traj,
                         float* vel) {
  __shared__ __align__(16) K6Tiles sm;
  extern __shared__ float scratch[];  // J x K6_THREADS: a row's chains
  const int T = p.T, R2 = 2 * T, J = p.J;
  const size_t B = p.B;
  const int RT = (R2 + K6_BM - 1) / K6_BM;
  const int r0 = (int)(blockIdx.x % RT) * K6_BM;
  const size_t b0 = (size_t)(blockIdx.x / RT) * K6_BN;
  const int ty = threadIdx.x / (K6_BN / K6_TN);
  const int tx = threadIdx.x - ty * (K6_BN / K6_TN);
  const int nk = (T + K6_TK - 1) / K6_TK;
  auto plane = [&](int j, int r) {
    return r < T ? traj + ((size_t)j * T + r) * B
                 : vel + ((size_t)j * T + r - T) * B;
  };
  for (int j0 = 0; j0 < J; j0 += K6_JB) {
    float acc[K6_TM][K6_TN][K6_JB];
#pragma unroll
    for (int m = 0; m < K6_TM; ++m)
#pragma unroll
      for (int q = 0; q < K6_TN; ++q)
#pragma unroll
        for (int j = 0; j < K6_JB; ++j) acc[m][q][j] = 0.f;
    k6_stage<VEC>(sm, 0, kvT, lda, alpha, J, T, B, 0, j0, r0, b0);
    for (int k = 0; k < nk; ++k) {
      if (k + 1 < nk) {
        k6_stage<VEC>(sm, (k + 1) & 1, kvT, lda, alpha, J, T, B,
                      (k + 1) * K6_TK, j0, r0, b0);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      const int s = k & 1, n = min(K6_TK, T - k * K6_TK);
      for (int t = 0; t < n; ++t) {
        const float4 a4 = *(const float4*)&sm.a[s][t][ty * K6_TM];
        const float a[K6_TM] = {a4.x, a4.y, a4.z, a4.w};
        float x[K6_JB][K6_TN];
#pragma unroll
        for (int j = 0; j < K6_JB; ++j) {
          const float2 x2 = *(const float2*)&sm.x[s][j][t][tx * K6_TN];
          x[j][0] = x2.x;
          x[j][1] = x2.y;
        }
#pragma unroll
        for (int m = 0; m < K6_TM; ++m)
#pragma unroll
          for (int q = 0; q < K6_TN; ++q)
#pragma unroll
            for (int j = 0; j < K6_JB; ++j)
              acc[m][q][j] = fmaf(a[m], x[j][q], acc[m][q][j]);
      }
      __syncthreads();  // the stage is read before the next copy
    }
    // The block's raw chains into the output planes.
#pragma unroll
    for (int m = 0; m < K6_TM; ++m) {
      const int r = r0 + ty * K6_TM + m;
      if (r >= R2) break;
#pragma unroll
      for (int q = 0; q < K6_TN; ++q) {
        const size_t b = b0 + tx * K6_TN + q;
        if (b >= B) continue;
#pragma unroll
        for (int j = 0; j < K6_JB; ++j)
          if (j0 + j < J) plane(j0 + j, r)[b] = acc[m][q][j];
      }
    }
  }
  // The mix combine of each of the thread's (row, lane) outputs: its J
  // chains into its scratch column, then out_i = sum_j raw_j mix[j, i] in
  // order of j, 8 outputs a pass.
  float* col = scratch + threadIdx.x;
  for (int m = 0; m < K6_TM; ++m) {
    const int r = r0 + ty * K6_TM + m;
    if (r >= R2) break;
    for (int q = 0; q < K6_TN; ++q) {
      const size_t b = b0 + tx * K6_TN + q;
      if (b >= B) continue;
      for (int j = 0; j < J; ++j) col[j * K6_THREADS] = plane(j, r)[b];
      for (int i0 = 0; i0 < J; i0 += WB_JB) {
        const int n = min(WB_JB, J - i0);
        float v[WB_JB];
        const float x0 = col[0];
#pragma unroll
        for (int u = 0; u < WB_JB; ++u)
          if (u < n) v[u] = x0 * __ldg(mix + i0 + u);
        for (int j = 1; j < J; ++j) {
          const float x = col[j * K6_THREADS];
#pragma unroll
          for (int u = 0; u < WB_JB; ++u)
            if (u < n) v[u] = v[u] + x * __ldg(mix + j * J + i0 + u);
        }
#pragma unroll
        for (int u = 0; u < WB_JB; ++u)
          if (u < n) plane(i0 + u, r)[b] = v[u];
      }
    }
  }
}

static size_t k6_scratch_bytes(int J) {
  return sizeof(float) * (size_t)J * K6_THREADS;
}

// K6's tile: rows, lanes, timesteps per stage, threads, shared memory per
// CTA (static tiles and the scratch at J), CTAs per SM.
extern "C" int forward_eval_shape(int J, int* out) {
  if (J < 1 || J > WW_MAX_J) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)wide_forward_eval_kernel<true>;
  const size_t dyn = k6_scratch_bytes(J);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        K6_THREADS, dyn);
  if (err != cudaSuccess) return (int)err;
  out[0] = K6_BM;
  out[1] = K6_BN;
  out[2] = K6_TK;
  out[3] = K6_THREADS;
  out[4] = (int)(sizeof(K6Tiles) + dyn);
  out[5] = per_sm;
  return 0;
}

extern "C" int forward_eval_launch(WParams p, int threads,
                                   int vec, int lda, const float* kvT,
                                   const float* mix, const float* alpha,
                                   float* traj, float* vel, void* stream) {
  if (!wide_ok(p)) return (int)cudaErrorInvalidValue;
  const long long rt = (2LL * p.T + K6_BM - 1) / K6_BM;
  const long long blocks = rt * (((long long)p.B + K6_BN - 1) / K6_BN);
  if (threads != K6_THREADS || p.T < 1 || p.B <= 0 || lda % K6_BM ||
      lda < rt * K6_BM || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const void* kernel = vec ? (const void*)wide_forward_eval_kernel<true>
                           : (const void*)wide_forward_eval_kernel<false>;
  const size_t dyn = k6_scratch_bytes(p.J);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p, &kvT, &lda, &mix, &alpha, &traj, &vel};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)blocks),
                               dim3(K6_THREADS), args, dyn,
                               (cudaStream_t)stream);
}
