// The warp body of the kernels for arms of J >= 16 joints (the "wide"
// library; ops/_build.py builds it once for every such J): K1/K2
// (wide_solve.cu, wide_tiers.cu, wide_reach.cu), K3/K4/K5, K6 and K7
// (wide_steps.cu, wide_solve.cu).  The arithmetic, the programs and the
// launch plans are csrc/warp_body.cuh's (the J <= 15 libraries, whose J is
// a compile-time constant and whose per-timestep values live in registers
// of J floats each); here J is a run-time value (WParams.J) and nothing of
// a lane is held in an array of J registers:
//
//  * every plane of a lane (alpha, grad, dir_t, dir_v, traj, vel, gx, gy)
//    lives in shared memory, in the resident body too (the streamed
//    body's SWarp layout, with the resident basis pair in shared memory);
//  * every joint loop runs over the planes one joint at a time (FK, the
//    cost rows, the stacked gradient: its suffix sums run from J - 1 down
//    and write each joint's stacked row as they go);
//  * a basis product keeps WB_JB (8) joints' chains per output row in
//    registers and runs one pass over t per block of joints; its raw
//    chains go into the destination planes, and the mix combine reads them
//    back row by row (through the lane's buffer, free once the product is
//    done) with mix from shared memory;
//  * a reduction's 2 J + 1 rows are chained by threads lid, lid + 32, ...,
//    each writing its sum over the row's first word for the readers.
//
// Op order: every value is formed by the same operations in the same order
// as in warp_body.cuh (each basis-product row one sequential fmaf chain
// over t from 0, then the mix combine summed in order of j; every sum over
// t one sequential chain; FK, the field and the loss as lane_body.cuh).
// Every kernel of this library runs these functions, so a lane's floats do
// not depend on which kernel (K1/K2, or K5 then K3/K4) or which body ran
// it, and K6 and K7 give K5's evaluation bit for bit.
//
// The parameter block: WParams, J and link last, link in its first J of
// WW_MAX_J slots; the C entry points take it by value, as its ctypes mirror
// (fused_solve.params_type(J) at J >= 16) lays it out.  A CTA copies link
// and mix into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

#define MAX_ROUNDS 32
#define WW_MAX_J 256  // the most joints the parameter block holds
#define WB_JB 8       // joints per block of a product's register chains

struct WParams {
  int T, O, B, rounds, n_bls, masked;
  int sched[MAX_ROUNDS];
  float mean_jp, inv_std_jp_h, inv_vmax_h, inv_T, inv_std2_T, inv_vmax2_T;
  float lam_max, mean_w, pos_hi, pos_lo, vel_hi;
  float lambda_reg, bls_alpha, beta_plus, beta_minus, lr_fail, lr_start;
  float loss_red, inc, eps_pos, eps_vel, max_jp, min_jp, max_jv;
  float gd_lr[MAX_ROUNDS];
  int J;
  float link[WW_MAX_J];
};

// Whether the block holds a J of 1 .. WW_MAX_J.
static inline bool wide_ok(const WParams& p) {
  return p.J >= 1 && p.J <= WW_MAX_J;
}

#define SOLVER_BLS 0
#define SOLVER_GD 1
#define SOLVER_BLS_EXACT 2
#define SOLVER_BLS_ULTRA 3
#define SOLVER_BLS_BF16 4

#define WB_BODY_RESIDENT 0
#define WB_BODY_STREAMED 1
#define WB_BODY_REACH 2
#define WB_LY_STREAMED 0
#define WB_LY_REACH_NODIR 2
#define WB_LY_REACH_GXDIR 3

#define WB_MAX_T 64          // the resident body: T <= 64
#define WB_MAX_WARPS 16
#define WB_CTL_FLOATS 20     // full[2], empty[2] mbarriers, tile base
#define WB_SMEM_MAX 232448
#define WB_STREAM_WARPS 16
#define WB_K7_STAGES 2
#define WB_K7_LANES 2
#define WB_K7_ROWS 2
#define WB_K7_SOLO_ROWS 2
#define WB_RING_CAP 16384
#define FULL_MASK 0xffffffffu

// The layout pieces at J (floats; mirror of launch_plan in
// ops/fused_solve.py).
__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int wb_js(int J) { return pad4(J); }
__host__ __device__ __forceinline__ int wb_rows(int J) {
  return 2 * J + 1 > 2 * pad4(J) ? 2 * J + 1 : 2 * pad4(J);
}
__host__ __device__ __forceinline__ int wb_lane_floats(int J) {
  return pad4(6 * J + 2);  // start, goal, t0, tN, v0, vN, two pad slots
}
__host__ __device__ __forceinline__ int wb_outcome(int J) { return 6 * J; }
__host__ __device__ __forceinline__ int wb_k7_on(int J) { return 6 * J + 1; }
__host__ __device__ __forceinline__ int wb_mix_floats(int J) {
  return pad4(J * J);
}
// mix, link (CTA pieces of both bodies).
__host__ __device__ __forceinline__ int wb_consts_floats(int J) {
  return wb_mix_floats(J) + pad4(J);
}
__host__ __device__ __forceinline__ int wb_row_stride(int T) {
  return (T + 3) & ~3;
}
__host__ __device__ __forceinline__ size_t wb_tail_floats(int J, int T,
                                                          int O) {
  return (size_t)wb_rows(J) * wb_row_stride(T) + (size_t)4 * O +
         wb_lane_floats(J);
}
// The resident body: per CTA the basis pair transposed, mix and link; per
// warp the six planes and gx/gy (padded to 4), the buffer, the obstacle
// terms and the endpoints.
__host__ __device__ __forceinline__ size_t wb_basis_floats(int T, int J) {
  return (size_t)4 * T * T + wb_consts_floats(J);
}
__host__ __device__ __forceinline__ size_t wb_warp_floats(int J, int T,
                                                          int O) {
  return (size_t)pad4(6 * J * T + 2 * T) + wb_tail_floats(J, T, O);
}
__host__ __device__ constexpr int stream_layout(int solver, int body) {
  return body == WB_BODY_REACH
             ? (solver == SOLVER_GD || solver == SOLVER_BLS_EXACT
                    ? WB_LY_REACH_NODIR
                    : WB_LY_REACH_GXDIR)
             : WB_LY_STREAMED;
}
// A streamed lane's region (warp_body.cuh's lane_floats).
__host__ __device__ __forceinline__ size_t lane_floats(int layout, int J,
                                                       int T, int O) {
  const size_t planes = layout == WB_LY_REACH_NODIR
                            ? (size_t)4 * J * T
                            : (size_t)pad4(6 * J * T);
  return planes + wb_tail_floats(J, T, O);
}
__host__ __device__ __forceinline__ int k7_lane_blocks(int L) {
  return (L + WB_K7_LANES - 1) / WB_K7_LANES;
}
__host__ __device__ __forceinline__ int k7_rows(int L) {
  return L == 1 ? WB_K7_SOLO_ROWS : WB_K7_ROWS;
}
__host__ __device__ __forceinline__ int k7_row_block(int rows, int L) {
  const int per =
      k7_rows(L) * (32 * (WB_STREAM_WARPS - 1) / k7_lane_blocks(L));
  const int need = (rows + 3) & ~3;
  return per < need ? per : need;
}
__host__ __device__ __forceinline__ size_t ws_room_floats(int J, int T, int O,
                                                          int L, int layout) {
  const size_t used = (size_t)wb_consts_floats(J) + WB_CTL_FLOATS +
                      (size_t)L * lane_floats(layout, J, T, O);
  const size_t left = WB_SMEM_MAX / 4 > used ? WB_SMEM_MAX / 4 - used : 0;
  const size_t room = (left < WB_RING_CAP ? left : WB_RING_CAP) & ~(size_t)3;
  if (layout == WB_LY_REACH_GXDIR) return room;
  const size_t planes = ((size_t)2 * T * L + 3) & ~(size_t)3;
  return room > planes ? room : planes;
}
static size_t warp_smem_bytes(const WParams& p, int lanes, bool streamed,
                              int layout) {
  if (streamed)
    return sizeof(float) *
           ((size_t)wb_consts_floats(p.J) + WB_CTL_FLOATS +
            ws_room_floats(p.J, p.T, p.O, lanes, layout) +
            (size_t)lanes * lane_floats(layout, p.J, p.T, p.O));
  return sizeof(float) * (wb_basis_floats(p.T, p.J) +
                          (size_t)lanes * wb_warp_floats(p.J, p.T, p.O));
}

// ---------------------------------------------------------------------------
// The view of a lane.
// ---------------------------------------------------------------------------

// One warp's view of its lane.  BODY: the resident body (the basis pair in
// shared memory, one warp per lane, each warp on its own) or a streamed
// one (the transposed, blocked basis in device memory, a tile of L lanes in
// lockstep, each product one K7 product for the tile; ``sub`` 0 for a
// lane's own warp, 1 for a helper or the producer, whose view is lane 0's).
// LY: the lane layout (the resident body's is WB_LY_STREAMED's planes plus
// gx/gy in the warp's region).
template <int BODY, int LY>
struct WView {
  static constexpr bool kStreamed = BODY != WB_BODY_RESIDENT;
  // Pass A keeps its FK tangents for pass B in the direction planes; the
  // reach layouts recompute them.
  static constexpr bool kKeepsFk = LY == WB_LY_STREAMED;
  static constexpr int kLayout = LY;
  int L, W, lane, sub;
  unsigned long long* full;
  unsigned long long* empty;
  int* base;
  float* room;
  size_t room_floats, stride;
  unsigned seq;
  const float* kvT;   // resident: shared (T, 2T); streamed: device blocks
  const float* kvtT;  // resident: shared (2T, T); streamed: device blocks
  const float* mix;   // shared (J, J)
  const float* link;  // shared (J,)
  float *alpha, *grad, *dir_t, *dir_v, *traj, *vel;  // (J, T)
  float *gx, *gy;                                     // (T,)
  float* buf;
  float4* obs;
  float* ends;
  int J, JS, T, O, RS, lid, G;
  float lam_sg, lam_jl;

  __device__ __forceinline__ int tt(int g) const { return lid + 32 * g; }
  __device__ __forceinline__ bool owns(int g) const { return tt(g) < T; }
  __device__ __forceinline__ WView at(int l) const {
    WView v = *this;
    const ptrdiff_t d = (ptrdiff_t)(l - lane) * (ptrdiff_t)stride;
    v.alpha += d;
    v.grad += d;
    if constexpr (LY != WB_LY_REACH_NODIR) {
      v.dir_t += d;
      v.dir_v += d;
    }
    v.traj += d;
    v.vel += d;
    v.buf += d;
    v.ends += d;
    v.obs = (float4*)((float*)v.obs + d);
    if constexpr (LY == WB_LY_REACH_GXDIR) {
      v.gx = v.dir_t;
      v.gy = v.dir_v;
    } else if constexpr (kStreamed) {
      v.gx += (ptrdiff_t)(l - lane) * 2 * T;
      v.gy = v.gx + T;
    } else {
      v.gx += d;
      v.gy += d;
    }
    v.lane = l;
    return v;
  }
};

// Any of the tile's lanes (the resident body: this warp's own, which is
// warp-uniform).
template <class V>
static __device__ __forceinline__ bool any_lane(const V&, bool x) {
  if constexpr (V::kStreamed) return __syncthreads_or(x) != 0;
  return x;
}

static __device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The CTA's constants: mix and link.
static __device__ void stage_consts(const WParams& p,
                                    const float* __restrict__ mix,
                                    float* dst) {
  const int J = p.J;
  for (int i = threadIdx.x; i < J * J; i += blockDim.x) dst[i] = mix[i];
  for (int i = threadIdx.x; i < J; i += blockDim.x)
    dst[wb_mix_floats(J) + i] = p.link[i];
}

template <class V>
static __device__ __forceinline__ void bind_common(V& w, const WParams& p,
                                                   int T, int O) {
  w.J = p.J;
  w.JS = wb_js(p.J);
  w.T = T;
  w.O = O;
  w.RS = wb_row_stride(T);
  w.lid = threadIdx.x & 31;
  w.G = (T + 31) >> 5;
}

// The resident body's view: stages the basis pair transposed, mix and
// link; one __syncthreads.
template <int LY>
static __device__ WView<WB_BODY_RESIDENT, LY> bind_resident(
    const WParams& p, float* smem, int T, int O, const float* __restrict__ kv,
    const float* __restrict__ kvt, const float* __restrict__ mix) {
  const int R2 = 2 * T, n = R2 * T, J = p.J;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / T, t = i - r * T;
    smem[t * R2 + r] = kv[i];
    const int r2 = i / R2, t2 = i - r2 * R2;
    smem[n + t2 * T + r2] = kvt[i];
  }
  stage_consts(p, mix, smem + 2 * n);
  __syncthreads();
  WView<WB_BODY_RESIDENT, LY> w;
  bind_common(w, p, T, O);
  w.L = 1;
  w.W = 1;
  w.lane = 0;
  w.sub = 0;
  w.seq = 0;
  w.kvT = smem;
  w.kvtT = smem + n;
  w.mix = smem + 2 * n;
  w.link = w.mix + wb_mix_floats(J);
  w.stride = wb_warp_floats(J, T, O);
  float* mine = smem + wb_basis_floats(T, J) +
                (size_t)(threadIdx.x >> 5) * w.stride;
  const int plane = J * T;
  w.alpha = mine;
  w.grad = mine + plane;
  w.dir_t = mine + 2 * plane;
  w.dir_v = mine + 3 * plane;
  w.traj = mine + 4 * plane;
  w.vel = mine + 5 * plane;
  w.gx = mine + 6 * plane;
  w.gy = w.gx + T;
  w.buf = mine + pad4(6 * plane + 2 * T);
  w.obs = (float4*)(w.buf + (size_t)wb_rows(J) * w.RS);
  w.ends = (float*)(w.obs + O);
  return w;
}

// The mbarrier and bulk-copy operations of the K7 ring (PTX; sm_90).
static __device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}
static __device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                                 unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
static __device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
static __device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// A protocol fault traps after some seconds instead of holding the card.
static __device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                                 unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 35)) __trap();
  }
}
static __device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                                 unsigned bytes,
                                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The streamed bodies' view of layout LY: CTA pieces (mix, link, the
// control block, the room), then the lane regions; warp i < lanes runs
// lane i.  One __syncthreads.
template <int BODY, int LY>
static __device__ WView<BODY, LY> bind_streamed(
    const WParams& p, float* smem, int T, int O, int lanes,
    const float* kvT_dev, const float* kvtT_dev,
    const float* __restrict__ mix) {
  WView<BODY, LY> w;
  bind_common(w, p, T, O);
  const int J = p.J;
  const int W = blockDim.x >> 5, wid = threadIdx.x >> 5;
  w.L = lanes;
  w.W = W;
  w.sub = wid < lanes ? 0 : 1;
  w.lane = wid < lanes ? wid : 0;
  w.mix = smem;
  w.link = smem + wb_mix_floats(J);
  w.full = (unsigned long long*)(smem + wb_consts_floats(J));
  w.empty = w.full + WB_K7_STAGES;
  w.base = (int*)(w.empty + WB_K7_STAGES);
  w.room = smem + wb_consts_floats(J) + WB_CTL_FLOATS;
  w.room_floats = ws_room_floats(J, T, O, lanes, LY);
  w.seq = 0;
  stage_consts(p, mix, smem);
  if (threadIdx.x == 0) {
    for (int i = 0; i < WB_K7_STAGES; ++i) {
      mbar_init(w.full + i, 1);
      mbar_init(w.empty + i, W - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  w.kvT = kvT_dev;
  w.kvtT = kvtT_dev;
  w.stride = lane_floats(LY, J, T, O);
  float* mine = w.room + w.room_floats + (size_t)w.lane * w.stride;
  const int plane = J * T;
  w.alpha = mine;
  w.grad = mine + plane;
  if constexpr (LY == WB_LY_REACH_NODIR) {
    w.dir_t = w.dir_v = nullptr;
    w.traj = mine + 2 * plane;
    w.vel = mine + 3 * plane;
    w.buf = mine + 4 * plane;
  } else {
    w.dir_t = mine + 2 * plane;
    w.dir_v = mine + 3 * plane;
    w.traj = mine + 4 * plane;
    w.vel = mine + 5 * plane;
    w.buf = mine + pad4(6 * plane);
  }
  if constexpr (LY == WB_LY_REACH_GXDIR) {
    w.gx = w.dir_t;
    w.gy = w.dir_v;
  } else {
    w.gx = w.room + (size_t)w.lane * 2 * T;
    w.gy = w.gx + T;
  }
  w.obs = (float4*)(w.buf + (size_t)wb_rows(J) * w.RS);
  w.ends = (float*)(w.obs + O);
  return w;
}

template <int SOLVER, int BODY>
static __device__ __forceinline__ auto bind_body(
    const WParams& p, float* smem, int T, int O, int lanes, const float* kv,
    const float* kvt, const float* mix) {
  constexpr int LY = stream_layout(SOLVER, BODY);
  if constexpr (BODY == WB_BODY_RESIDENT)
    return bind_resident<LY>(p, smem, T, O, kv, kvt, mix);
  else
    return bind_streamed<BODY, LY>(p, smem, T, O, lanes, kv, kvt, mix);
}

template <class V>
static __device__ __forceinline__ int next_tile(const V& w, int* queue) {
  __syncthreads();
  if (threadIdx.x == 0) *w.base = atomicAdd(queue, w.L);
  __syncthreads();
  return *w.base;
}

static __device__ __forceinline__ int next_lane(int* queue, int lid) {
  int b = 0;
  if (lid == 0) b = atomicAdd(queue, 1);
  return __shfl_sync(FULL_MASK, b, 0);
}

template <class V>
static __device__ __forceinline__ void load_lane(
    const WParams& p, V& w, size_t b, const float* alpha,
    const float* __restrict__ start, const float* __restrict__ goal,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ ow, float lam_sg, float lam_jl) {
  const size_t B = p.B;
  const int J = w.J;
  __syncwarp();
  for (int i = w.lid; i < J * w.T; i += 32) w.alpha[i] = alpha[i * B + b];
  for (int o = w.lid; o < w.O; o += 32) {
    const float x = ox[o * B + b], y = oy[o * B + b], wt = ow[o * B + b];
    w.obs[o] = make_float4(x, y, 0.5f + 0.5f * (x * x + y * y), 0.8f * wt);
  }
  for (int j = w.lid; j < J; j += 32) {
    w.ends[j] = start[j * B + b];
    w.ends[J + j] = goal[j * B + b];
  }
  w.lam_sg = lam_sg;
  w.lam_jl = lam_jl;
  __syncwarp();
}

template <class V>
static __device__ __forceinline__ void store_alpha(const WParams& p,
                                                   const V& w, size_t b,
                                                   float* alpha) {
  __syncwarp();
  for (int i = w.lid; i < w.J * w.T; i += 32)
    alpha[i * (size_t)p.B + b] = w.alpha[i];
}

// ---------------------------------------------------------------------------
// Reductions.
// ---------------------------------------------------------------------------

// Rows 0 .. n-1 of the buffer: thread lid chains rows lid, lid + 32, ...
// (((0 + x_0) + x_1) + ..., warp_body.cuh's chains) and writes each sum
// over the row's first word (row_sum reads it).
template <class V>
static __device__ __forceinline__ void chain_rows(const V& w, int n) {
  __syncwarp();
  for (int k = w.lid; k < n; k += 32) {
    float* row = w.buf + (size_t)k * w.RS;
    const float4* row4 = (const float4*)row;
    float sum = 0.f;
    int t = 0;
    for (; t + 4 <= w.T; t += 4) {
      const float4 v = row4[t >> 2];
      sum = sum + v.x;
      sum = sum + v.y;
      sum = sum + v.z;
      sum = sum + v.w;
    }
    for (; t < w.T; ++t) sum = sum + row[t];
    row[0] = sum;
  }
  __syncwarp();
}
template <class V>
static __device__ __forceinline__ float row_sum(const V& w, int k) {
  return w.buf[(size_t)k * w.RS];
}

static __device__ __forceinline__ void argmax_tree(float& m, int& f) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float om = __shfl_xor_sync(FULL_MASK, m, off);
    const int of = __shfl_xor_sync(FULL_MASK, f, off);
    if (om > m || (om == m && of < f)) {
      m = om;
      f = of;
    }
  }
}

template <class V>
static __device__ __forceinline__ void put_row(const V& w, int k, int g,
                                               float x) {
  if (w.owns(g)) w.buf[(size_t)k * w.RS + w.tt(g)] = x;
}

// The penalized loss from the chained cost rows (lane_body.cuh's
// cost_total, every thread the same floats).
template <class V>
static __device__ __forceinline__ float rows_loss(const WParams& p,
                                                  const V& w, float cmax) {
  chain_rows(w, 1 + 2 * w.J);
  const int J = w.J;
  const float* e = w.ends;
  const float toc = p.lam_max * cmax + p.mean_w * row_sum(w, 0);
  float sgpc = 0.f, sgvc = 0.f, jpc = 0.f, jvc = 0.f;
  for (int j = 0; j < J; ++j) {
    const float ds = e[2 * J + j] - e[j];
    const float dg = e[3 * J + j] - e[J + j];
    sgpc = sgpc + 0.5f * (ds * ds + dg * dg);
    const float v0 = e[4 * J + j], vN = e[5 * J + j];
    sgvc = sgvc + 0.5f * (v0 * v0 + vN * vN);
    jpc = jpc + row_sum(w, 1 + j) * p.inv_T;
    jvc = jvc + row_sum(w, 1 + J + j) * p.inv_T;
  }
  __syncwarp();  // the sums are read before the buffer is reused
  return toc + w.lam_sg * (sgpc + sgvc) + w.lam_jl * (jpc + jvc);
}

// The hard-constraint check from rows 0 .. 2J-1 of the buffer (traj, vel).
template <class V>
static __device__ __forceinline__ bool rows_ok(const WParams& p,
                                               const V& w) {
  const int T = w.T, RS = w.RS, J = w.J;
  __syncwarp();
  int ok = 0;
  if (w.lid == 0) {
    const float* tr = w.buf;
    const float* ve = w.buf + (size_t)J * RS;
    float ps = 0.f, pg = 0.f, vs = 0.f, vg = 0.f;
    float tmax = tr[0], tmin = tmax;
    float vmax = fabsf(ve[0]);
    for (int j = 0; j < J; ++j) {
      const float d0 = tr[j * RS] - w.ends[j];
      const float dN = tr[j * RS + T - 1] - w.ends[J + j];
      ps = ps + d0 * d0;
      pg = pg + dN * dN;
      const float v0 = ve[j * RS], vN = ve[j * RS + T - 1];
      vs = vs + v0 * v0;
      vg = vg + vN * vN;
      for (int t = 0; t < T; ++t) {
        const float x = tr[j * RS + t];
        tmax = fmaxf(tmax, x);
        tmin = fminf(tmin, x);
        vmax = fmaxf(vmax, fabsf(ve[j * RS + t]));
      }
    }
    const bool pos_ok = sqrtf(ps) < p.eps_pos && sqrtf(pg) < p.eps_pos;
    const bool vel_ok = sqrtf(vs) < p.eps_vel && sqrtf(vg) < p.eps_vel;
    const bool box_ok = tmax <= p.max_jp && tmin >= p.min_jp;
    ok = pos_ok && vel_ok && box_ok && vmax <= p.max_jv;
  }
  return __shfl_sync(FULL_MASK, ok, 0) != 0;
}

// ---------------------------------------------------------------------------
// Per-timestep pieces.
// ---------------------------------------------------------------------------

// src (J, T) * scale, the own timesteps, into the buffer as a product input:
// JS floats per timestep, the pad joints zero.
template <class V>
static __device__ __forceinline__ void stage_input(const V& w,
                                                   const float* src,
                                                   float scale) {
  __syncwarp();
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    float* in = w.buf + (size_t)t * w.JS;
    for (int j = 0; j < w.J; ++j) in[j] = src[j * w.T + t] * scale;
    for (int j = w.J; j < w.JS; ++j) in[j] = 0.f;
  }
  __syncwarp();
}

// The candidate alpha (warp_body.cuh's stage_candidate).
template <class V, bool SCALED>
static __device__ __forceinline__ void stage_candidate(const V& w, float a_fac,
                                                       float lr,
                                                       float scale) {
  const int T = w.T;
  __syncwarp();
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    float* in = w.buf + (size_t)t * w.JS;
    for (int j = 0; j < w.J; ++j) {
      const float gr = SCALED ? w.grad[j * T + t] * scale : w.grad[j * T + t];
      in[j] = fmaf(a_fac, w.alpha[j * T + t], -(lr * gr));
    }
    for (int j = w.J; j < w.JS; ++j) in[j] = 0.f;
  }
  __syncwarp();
}

// The masked limit losses of one joint at one timestep.
static __device__ __forceinline__ void limit_terms(const WParams& p, float tr,
                                                   float ve, float& pl,
                                                   float& vl) {
  const float zp = (tr - p.mean_jp) * p.inv_std_jp_h;
  pl = zp * zp;
  const float zv = ve * p.inv_vmax_h;
  vl = zv * zv;
  if (p.masked) {
    if (!(tr > p.pos_hi || tr < p.pos_lo)) pl = 0.f;
    if (!(fabsf(ve) > p.vel_hi)) vl = 0.f;
  }
}

// FK at timestep (group) g of the point pt(j, tr, ve) (lane_body.cuh's
// fk_point, one joint at a time): the end effector; KEEP: the tangents
// into the direction planes (owners); ROWS: the limit-loss rows 1 .. 2J
// and, at t = 0 and T - 1, the endpoint values.
template <bool KEEP, bool ROWS, class V, class Pt>
static __device__ __forceinline__ void fk_rows(const WParams& p, const V& w,
                                               int g, Pt pt, float& ex,
                                               float& ey) {
  const int J = w.J, T = w.T, t = w.tt(g);
  const bool own = w.owns(g);
  const bool end = own && (t == 0 || t == T - 1);
  float* e = w.ends + 2 * J + (t == 0 ? 0 : J);
  float c = 0.f;
  ex = 0.f;
  ey = 0.f;
  for (int j = 0; j < J; ++j) {
    float tr, ve;
    pt(j, tr, ve);
    c = j == 0 ? tr : c + tr;
    float s, co;
    sincosf(c, &s, &co);
    const float px = w.link[j] * co, py = w.link[j] * s;
    ex = j == 0 ? px : ex + px;
    ey = j == 0 ? py : ey + py;
    if constexpr (KEEP) {
      if (own) {
        w.dir_t[j * T + t] = px;
        w.dir_v[j * T + t] = py;
      }
    }
    if constexpr (ROWS) {
      float pl, vl;
      limit_terms(p, tr, ve, pl, vl);
      put_row(w, 1 + j, g, pl);
      put_row(w, 1 + J + j, g, vl);
      if (end) {
        e[j] = tr;
        e[2 * J + j] = ve;
      }
    }
  }
}

// The obstacle field at (ex, ey) (warp_body.cuh's field).
template <class V>
static __device__ __forceinline__ float field(const V& w, float ex,
                                              float ey) {
  const float h = 0.5f * (ex * ex + ey * ey);
  float acc = 0.f;
  for (int o = 0; o < w.O; ++o) {
    const float4 ob = w.obs[o];
    const float s = (h + ob.z) - (ob.x * ex + ob.y * ey);
    acc = acc + ob.w * (1.0f / s);
  }
  return acc;
}

// Pass A at group g of the planes traj/vel (warp_body.cuh's cost_point):
// FK (tangents kept where the layout keeps them), the field and its
// factored gradient into gx/gy, and when want_loss the cost rows.  Returns
// the obstacle cost.
template <class V>
static __device__ __forceinline__ float cost_point(const WParams& p,
                                                   const V& w, int g,
                                                   bool want_loss) {
  const int T = w.T, t = w.tt(g);
  auto pt = [&](int j, float& tr, float& ve) {
    tr = w.traj[j * T + t];
    ve = w.vel[j * T + t];
  };
  float ex, ey;
  if (want_loss)
    fk_rows<V::kKeepsFk, true>(p, w, g, pt, ex, ey);
  else
    fk_rows<V::kKeepsFk, false>(p, w, g, pt, ex, ey);
  const float h = 0.5f * (ex * ex + ey * ey);
  float cv = 0.f, csum = 0.f, cox = 0.f, coy = 0.f;
  for (int o = 0; o < w.O; ++o) {
    const float4 ob = w.obs[o];
    const float sd = (h + ob.z) - (ob.x * ex + ob.y * ey);
    const float inv = 1.0f / sd;
    const float winv = ob.w * inv;
    cv = cv + winv;
    const float coef = winv * inv;
    csum = csum + coef;
    cox = cox + coef * ob.x;
    coy = coy + coef * ob.y;
  }
  w.gx[t] = cox - ex * csum;
  w.gy[t] = coy - ey * csum;
  if (want_loss) put_row(w, 0, g, cv);
  return cv;
}

// Pass B at the own timestep t (warp_body.cuh's stacked_grad): the stacked
// position (gp, at stack timestep t) and velocity (gv, at T + t) gradient
// rows, joint by joint from J - 1 down; the FK tangents from the direction
// planes or, in the layouts that do not keep them, recomputed into those
// stack slots first.
template <class V>
static __device__ __forceinline__ void stacked_grad(const WParams& p,
                                                    const V& w, int t,
                                                    int first) {
  const int T = w.T, J = w.J, JS = w.JS;
  float* gp = w.buf + (size_t)t * JS;
  float* gv = w.buf + (size_t)(T + t) * JS;
  if constexpr (!V::kKeepsFk) {
    float c = 0.f;
    for (int j = 0; j < J; ++j) {
      c = j == 0 ? w.traj[t] : c + w.traj[j * T + t];
      float s, co;
      sincosf(c, &s, &co);
      gp[j] = w.link[j] * co;
      gv[j] = w.link[j] * s;
    }
  }
  const float wt = p.lam_max * (t == first ? 1.f : 0.f) + p.mean_w;
  const float wgx = wt * w.gx[t];
  const float wgy = wt * w.gy[t];
  float accx = 0.f, accy = 0.f;
  for (int j = J - 1; j >= 0; --j) {
    float px, py;
    if constexpr (V::kKeepsFk) {
      px = w.dir_t[j * T + t];
      py = w.dir_v[j * T + t];
    } else {
      px = gp[j];
      py = gv[j];
    }
    accx = accx + (-py);
    accy = accy + px;
    const float tr = w.traj[j * T + t], ve = w.vel[j * T + t];
    const float toc_g = wgx * accx + wgy * accy;
    float sgp = 0.f, sgv = 0.f;
    if (t == 0) {
      sgp = tr - w.ends[j];
      sgv = ve;
    } else if (t == T - 1) {
      sgp = tr - w.ends[J + j];
      sgv = ve;
    }
    float jp = (tr - p.mean_jp) * p.inv_std2_T;
    float jv = ve * p.inv_vmax2_T;
    if (p.masked) {
      if (!(tr > p.pos_hi || tr < p.pos_lo)) jp = 0.f;
      if (!(fabsf(ve) > p.vel_hi)) jv = 0.f;
    }
    gp[j] = (toc_g + w.lam_sg * sgp) + w.lam_jl * jp;
    gv[j] = w.lam_sg * sgv + w.lam_jl * jv;
  }
  for (int j = J; j < JS; ++j) {
    gp[j] = 0.f;
    gv[j] = 0.f;
  }
}

// One rung's cost at group g of the point pt (warp_body.cuh's rung_point).
template <class V, class Pt>
static __device__ __forceinline__ float rung_point(const WParams& p,
                                                   const V& w, int g, Pt pt) {
  float ex, ey;
  fk_rows<false, true>(p, w, g, pt, ex, ey);
  const float cv = field(w, ex, ey);
  put_row(w, 0, g, cv);
  return cv;
}

// 1 / |grad| and alpha_norm (warp_body.cuh's grad_norms).
template <class V>
static __device__ __forceinline__ void grad_norms(const V& w, float& inv_norm,
                                                  float& alpha_norm) {
  const int T = w.T, J = w.J;
  __syncwarp();
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    for (int j = 0; j < J; ++j) {
      const float x = w.grad[j * T + t];
      put_row(w, j, g, x * x);
    }
  }
  chain_rows(w, J);
  float g2 = 0.f;
  for (int j = 0; j < J; ++j) g2 = g2 + row_sum(w, j);
  __syncwarp();
  inv_norm = 1.0f / sqrtf(g2);
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    float gs = w.grad[t];
    for (int j = 1; j < J; ++j) gs = gs + w.grad[j * T + t];
    put_row(w, 0, g, gs * (gs * inv_norm));
  }
  chain_rows(w, 1);
  alpha_norm = row_sum(w, 0);
  __syncwarp();
}

template <class V>
static __device__ __forceinline__ void accept_trial(const V& w, float a_fac,
                                                    float lr) {
  const int T = w.T;
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    for (int j = 0; j < w.J; ++j) {
      const int i = j * T + t;
      w.alpha[i] = fmaf(a_fac, w.alpha[i], -(lr * w.grad[i]));
    }
  }
}

// ---------------------------------------------------------------------------
// Basis products: the raw chains (rows x J, one sequential fmaf chain over
// t each, WB_JB joints a pass) into the destination, then the mix combine.
// ---------------------------------------------------------------------------

// The staged input's joints j0 .. j0 + 7 at timestep t (zero past JS).
static __device__ __forceinline__ void load_block(const float* in, int JS,
                                                  int t, int j0, float* a) {
  const float4* row = (const float4*)(in + (size_t)t * JS + j0);
  const float4 v0 = row[0];
  a[0] = v0.x;
  a[1] = v0.y;
  a[2] = v0.z;
  a[3] = v0.w;
  if (j0 + 4 < JS) {
    const float4 v1 = row[1];
    a[4] = v1.x;
    a[5] = v1.y;
    a[6] = v1.z;
    a[7] = v1.w;
  } else {
    a[4] = a[5] = a[6] = a[7] = 0.f;
  }
}

// The resident body's product: rows [0, R) of M @ in, M (R, n_t) given
// transposed in shared memory (MT[t R + r]), the input staged in the
// buffer; thread lid takes rows lid + 32 s (s < S), WB_JB joints a pass;
// raw(r, j, chain) for every row and joint.
template <int S, class V, class Raw>
static __device__ __forceinline__ void warp_product(const V& w,
                                                    const float* MT, int R,
                                                    int n_t, Raw raw) {
  const int J = w.J;
  int row[S];
#pragma unroll
  for (int s = 0; s < S; ++s) row[s] = min(w.lid + 32 * s, R - 1);
  for (int j0 = 0; j0 < J; j0 += WB_JB) {
    float acc[S][WB_JB];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int q = 0; q < WB_JB; ++q) acc[s][q] = 0.f;
    for (int t = 0; t < n_t; ++t) {
      float a[WB_JB];
      load_block(w.buf, w.JS, t, j0, a);
      const float* k = MT + (size_t)t * R;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float kk = k[row[s]];
#pragma unroll
        for (int q = 0; q < WB_JB; ++q) acc[s][q] = fmaf(kk, a[q], acc[s][q]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = w.lid + 32 * s;
      if (r >= R) continue;
#pragma unroll
      for (int q = 0; q < WB_JB; ++q)
        if (j0 + q < J) raw(r, j0 + q, acc[s][q]);
    }
  }
}

// The mix combine of the rows [0, R) of one lane, by its own warp: each
// row's J raw chains get(r, j) copied to the lane's buffer, then out_i =
// sum_j raw_j mix[j, i] (TRANS: mix[i, j]) in order of j, to put(r, i, v),
// WB_JB outputs a pass.  The buffer must be free (the product done).
template <bool TRANS, class V, class Get, class Put>
static __device__ __forceinline__ void mix_rows(const V& w, int R, Get get,
                                                Put put) {
  const int J = w.J;
  float* tmp = w.buf;
  for (int r = w.lid; r < R; r += 32) {
    for (int j = 0; j < J; ++j) tmp[(size_t)j * R + r] = get(r, j);
    for (int i0 = 0; i0 < J; i0 += WB_JB) {
      const int n = min(WB_JB, J - i0);
      float v[WB_JB];
      {
        const float x = tmp[r];
#pragma unroll
        for (int q = 0; q < WB_JB; ++q)
          if (q < n) v[q] = x * w.mix[TRANS ? (i0 + q) * J : i0 + q];
      }
      for (int j = 1; j < J; ++j) {
        const float x = tmp[(size_t)j * R + r];
#pragma unroll
        for (int q = 0; q < WB_JB; ++q)
          if (q < n)
            v[q] = v[q] + x * w.mix[TRANS ? (i0 + q) * J + j
                                          : j * J + i0 + q];
      }
#pragma unroll
      for (int q = 0; q < WB_JB; ++q)
        if (q < n) put(r, i0 + q, v[q]);
    }
  }
  __syncwarp();
}

// Whether a lane of block b takes the product.
template <class V>
static __device__ __forceinline__ bool k7_block_on(const V& w, int b,
                                                   int LB) {
  bool on = false;
  for (int i = 0; i < LB && b * LB + i < w.L; ++i)
    on = on || w.at(b * LB + i).ends[wb_k7_on(w.J)] != 0.f;
  return on;
}

// The ring's uses of one product: row blocks x joint blocks x stages.
template <class V>
static __device__ __forceinline__ int k7_uses(const V& w, int rows, int n_t,
                                              int& R, int& st, int& nck,
                                              int& ntile) {
  R = k7_row_block(rows, w.L);
  st = (int)(w.room_floats / (WB_K7_STAGES * R));
  nck = (w.J + WB_JB - 1) / WB_JB;
  ntile = (n_t + st - 1) / st;
  return ((rows + R - 1) / R) * nck * ntile;
}

// K7 (warp_body.cuh's k7_run), the register block blocked over joints: a
// consumer thread keeps RT rows x LB lanes x WB_JB joints of chains, and
// the ring streams each row block once per block of WB_JB joints (row
// block, then joint block, then the stages of t).  raw(view of the lane,
// r, j, chain) for the lanes that take the product.
template <int RT, int LB, class V, class Raw>
static __device__ __forceinline__ void k7_run(V& w, const float* MT,
                                              int rows, int n_t, Raw& raw) {
  constexpr int S = WB_K7_STAGES;
  const int L = w.L, C = w.W - 1, J = w.J;
  int R, st, nck, ntile;
  const int uses = k7_uses(w, rows, n_t, R, st, nck, ntile);
  if ((int)(threadIdx.x >> 5) == C) {  // the producer
    if (w.lid == 0) {
      for (int u = 0; u < uses; ++u) {
        const unsigned g = w.seq + (unsigned)u, slot = g % S;
        mbar_wait(w.empty + slot, ((g / S) & 1u) ^ 1u);
        const int blk = u / (nck * ntile), tile = u % ntile;
        const int t0 = tile * st;
        const unsigned bytes = (unsigned)(min(st, n_t - t0) * R) * 4u;
        mbar_expect(w.full + slot, bytes);
        bulk_load(w.room + (size_t)slot * R * st,
                  MT + ((size_t)blk * n_t + t0) * R, bytes, w.full + slot);
      }
    }
    return;
  }
  const int units = R / RT, c = threadIdx.x;
  const int lb = c / units, q = RT * (c - lb * units);
  const bool act = lb < k7_lane_blocks(L) && k7_block_on(w, lb, LB);
  const int l0 = act ? lb * LB : 0;
  const float* in[LB];
#pragma unroll
  for (int i = 0; i < LB; ++i)
    in[i] = w.buf + (ptrdiff_t)((l0 + i < L ? l0 + i : l0) - w.lane) *
                        (ptrdiff_t)w.stride;
  float acc[RT][LB][WB_JB];
  for (int u = 0; u < uses; ++u) {
    const int blk = u / (nck * ntile), ck = (u / ntile) % nck;
    const int tile = u % ntile, j0 = ck * WB_JB;
    const unsigned g = w.seq + (unsigned)u, slot = g % S;
    if (tile == 0) {
#pragma unroll
      for (int h = 0; h < RT; ++h)
#pragma unroll
        for (int i = 0; i < LB; ++i)
#pragma unroll
          for (int jq = 0; jq < WB_JB; ++jq) acc[h][i][jq] = 0.f;
    }
    mbar_wait(w.full + slot, (g / S) & 1u);
    const int t0 = tile * st, nt = min(st, n_t - t0);
    if (act && blk * R + q < rows) {
      const float* stg = w.room + (size_t)slot * R * st + q;
      for (int k = 0; k < nt; ++k) {
        const float2 k2 = *(const float2*)(stg + (size_t)k * R);
        const float kk[2] = {k2.x, k2.y};
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          float a[WB_JB];
          load_block(in[i], w.JS, t0 + k, j0, a);
#pragma unroll
          for (int h = 0; h < RT; ++h)
#pragma unroll
            for (int jq = 0; jq < WB_JB; ++jq)
              acc[h][i][jq] = fmaf(kk[h], a[jq], acc[h][i][jq]);
        }
      }
    }
    __syncwarp();
    if (w.lid == 0) mbar_arrive(w.empty + slot);
    if (tile == ntile - 1 && act) {
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        if (l0 + i >= L) break;
        const V v = w.at(l0 + i);
        if (v.ends[wb_k7_on(J)] == 0.f) continue;
#pragma unroll
        for (int h = 0; h < RT; ++h) {
          const int r = blk * R + q + h;
          if (r >= rows) continue;
#pragma unroll
          for (int jq = 0; jq < WB_JB; ++jq)
            if (j0 + jq < J) raw(v, r, j0 + jq, acc[h][i][jq]);
        }
      }
    }
  }
}

// One basis product for the lanes that take it (``on``: this warp's lane
// does): rows [0, rows) of M @ in, raw(view, r, j, chain) into the
// destination; every warp of a streamed CTA calls it at the same call
// site.  Returns whether this warp's lane took it.
template <class V, class Raw>
static __device__ bool product(V& w, const float* MT, int rows, int n_t,
                               bool on, Raw raw) {
  if constexpr (V::kStreamed) {
    static_assert(WB_K7_ROWS == 2 && WB_K7_SOLO_ROWS == 2,
                  "k7_run reads two rows of a stage at once");
    if (w.sub == 0 && w.lid == 0) w.ends[wb_k7_on(w.J)] = on ? 1.f : 0.f;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (!__syncthreads_or(on)) return false;
    if (w.L == 1)
      k7_run<WB_K7_SOLO_ROWS, 1>(w, MT, rows, n_t, raw);
    else
      k7_run<WB_K7_ROWS, WB_K7_LANES>(w, MT, rows, n_t, raw);
    int R, st, nck, ntile;
    w.seq += (unsigned)k7_uses(w, rows, n_t, R, st, nck, ntile);
    __syncthreads();  // the raw chains are visible; the room is free again
  } else {
    if (!on) return false;
    __syncwarp();
    auto r1 = [&](int r, int j, float x) { raw(w, r, j, x); };
    if (rows > 64)
      warp_product<4>(w, MT, rows, n_t, r1);
    else
      warp_product<2>(w, MT, rows, n_t, r1);
    __syncwarp();
  }
  return on;
}

// The forward product of the staged input into (traj, vel) (raw, then the
// mix combine): the destination's row r < T is traj's timestep r, beyond
// vel's r - T.  out(v, plane of traj or vel, t, i, mixed) stores.
template <class V, class Out>
static __device__ __forceinline__ void forward_into(V& w, bool on,
                                                    float* V::*dt,
                                                    float* V::*dv,
                                                    Out out) {
  const int T = w.T;
  auto raw = [&](const V& v, int r, int j, float x) {
    (r < T ? v.*dt : v.*dv)[j * T + (r < T ? r : r - T)] = x;
  };
  if (!product(w, w.kvT, 2 * T, T, on, raw)) return;
  float* pt = w.*dt;
  float* pv = w.*dv;
  mix_rows<false>(
      w, 2 * T,
      [&](int r, int j) {
        return (r < T ? pt : pv)[j * T + (r < T ? r : r - T)];
      },
      [&](int r, int i, float x) { out(r < T, r < T ? r : r - T, i, x); });
}

// (traj, vel) = the staged input through kv.
template <class V>
static __device__ __forceinline__ void eval_staged(V& w, bool on) {
  const int T = w.T;
  float* tr = w.traj;
  float* ve = w.vel;
  forward_into(w, on, &V::traj, &V::vel, [&](bool pos, int t, int i, float x) {
    (pos ? tr : ve)[i * T + t] = x;
  });
}

template <class V>
static __device__ __forceinline__ void eval_alpha(V& w, bool on) {
  if (on) stage_input(w, w.alpha, 1.f);
  eval_staged(w, on);
}

// The search direction: dir = lambda_reg (traj, vel) + the normalized
// gradient's forward evaluation (HALF: lambda_reg and dir rounded to
// bfloat16, the bf16 tier's program).
template <bool HALF, class V>
static __device__ __forceinline__ void direction(const WParams& p, V& w,
                                                 float inv_norm, bool on) {
  static_assert(V::kLayout != WB_LY_REACH_NODIR,
                "a layout without direction planes");
  const int T = w.T;
  const float lam = HALF ? bf16_round(p.lambda_reg) : p.lambda_reg;
  if (on) stage_input(w, w.grad, inv_norm);
  const float* tr = w.traj;
  const float* ve = w.vel;
  float* dt = w.dir_t;
  float* dv = w.dir_v;
  forward_into(w, on, &V::dir_t, &V::dir_v,
               [&](bool pos, int t, int i, float x) {
                 float d = lam * (pos ? tr : ve)[i * T + t] + x;
                 if constexpr (HALF) d = bf16_round(d);
                 (pos ? dt : dv)[i * T + t] = d;
               });
}

// The ultra and bf16 tiers' step start: (traj, vel) = the exact evaluation
// of alpha, rounded to bfloat16 when HALF (held as float32).
template <bool HALF, class V>
static __device__ __forceinline__ void eval_start(V& w, bool on) {
  const int T = w.T;
  if (on) stage_input(w, w.alpha, 1.f);
  float* tr = w.traj;
  float* ve = w.vel;
  forward_into(w, on, &V::traj, &V::vel, [&](bool pos, int t, int i, float x) {
    (pos ? tr : ve)[i * T + t] = HALF ? bf16_round(x) : x;
  });
}

// The accepted step; the new alpha rounded once (fmaf), as in JAX's kernel.
template <bool EXACT, class V>
static __device__ __forceinline__ void accept_step(const WParams& p, V& w,
                                                   float lr_eff,
                                                   float inv_norm) {
  const int T = w.T;
  const float a_fac = 1.f - p.lambda_reg * lr_eff;
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    for (int j = 0; j < w.J; ++j) {
      const int i = j * T + t;
      w.alpha[i] = fmaf(a_fac, w.alpha[i], -(lr_eff * (w.grad[i] * inv_norm)));
      if constexpr (!EXACT) {
        w.traj[i] = w.traj[i] - lr_eff * w.dir_t[i];
        w.vel[i] = w.vel[i] - lr_eff * w.dir_v[i];
      }
    }
  }
}

// This thread's first argmax over its timesteps, the warp's by the shuffle
// tree, and the loss when want_loss.  A thread that owns no timestep (T <
// 32 in the resident body) takes part with (-inf, INT_MAX).
template <class V>
static __device__ __forceinline__ float cost_reduce(const WParams& p,
                                                    const V& w, float m,
                                                    int f, bool want_loss,
                                                    int& first) {
  argmax_tree(m, f);
  first = f;
  if (!want_loss) return 0.f;
  return rows_loss(p, w, m);
}

// Pass A at the planes' (traj, vel).
template <class V>
static __device__ __forceinline__ float cost_pass(const WParams& p, V& w,
                                                  bool want_loss, int& first) {
  __syncwarp();
  float m = -INFINITY;
  int f = INT_MAX;
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const float cv = cost_point(p, w, g, want_loss);
    if (f == INT_MAX || cv > m) {
      m = cv;
      f = w.tt(g);
    }
  }
  return cost_reduce(p, w, m, f, want_loss, first);
}

// Passes B and C: the stacked gradient into the buffer, then the pull-back
// through kvt and the mix^T combine into grad.
template <class V>
static __device__ __forceinline__ void grad_pass(const WParams& p, V& w,
                                                 int first, bool on) {
  const int T = w.T;
  if (on) {
    __syncwarp();
    for (int g = 0; g < w.G; ++g)
      if (w.owns(g)) stacked_grad(p, w, w.tt(g), first);
  }
  auto raw = [&](const V& v, int r, int j, float x) { v.grad[j * T + r] = x; };
  if (!product(w, w.kvtT, T, 2 * T, on, raw)) return;
  float* gr = w.grad;
  mix_rows<true>(
      w, T, [&](int r, int j) { return gr[j * T + r]; },
      [&](int r, int i, float x) { gr[i * T + r] = x; });
}

// Loss of one ladder rung (warp_body.cuh's rung_cost): linearized, the
// candidate (traj - lr dir_t, vel - lr dir_v); BASE the zero-lr candidate;
// EXACT the candidate alpha's evaluation through kv into traj/vel, a
// product (``on``: this lane takes it; every warp of a streamed tile calls
// the exact rung).
template <bool EXACT, bool BASE = false, class V>
static __device__ __forceinline__ float rung_cost(const WParams& p, V& w,
                                                  float lr, float inv_norm,
                                                  bool on = true) {
  const int T = w.T;
  if constexpr (EXACT) {
    if (on)
      stage_candidate<V, true>(w, 1.f - p.lambda_reg * lr, lr, inv_norm);
    eval_staged(w, on);
    if (!on) return 0.f;
  }
  __syncwarp();
  float m = -INFINITY;
  int f = INT_MAX;
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    float cv;
    if constexpr (EXACT || BASE) {
      cv = rung_point(p, w, g, [&](int j, float& tr, float& ve) {
        tr = w.traj[j * T + t];
        ve = w.vel[j * T + t];
      });
    } else {
      cv = rung_point(p, w, g, [&](int j, float& tr, float& ve) {
        tr = w.traj[j * T + t] - lr * w.dir_t[j * T + t];
        ve = w.vel[j * T + t] - lr * w.dir_v[j * T + t];
      });
    }
    if (f == INT_MAX || cv > m) {
      m = cv;
      f = t;
    }
  }
  int first;
  return cost_reduce(p, w, m, f, true, first);
}

template <class V>
static __device__ __forceinline__ bool constraints_ok(const WParams& p,
                                                      const V& w) {
  const int T = w.T;
  __syncwarp();
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    for (int j = 0; j < w.J; ++j) {
      put_row(w, j, g, w.traj[j * T + t]);
      put_row(w, w.J + j, g, w.vel[j * T + t]);
    }
  }
  return rows_ok(p, w);
}

// ---------------------------------------------------------------------------
// The steps and the round (warp_body.cuh's ls_bls_step, ls_gd_step and
// ls_round, which the resident body runs too: ``live`` this warp's lane
// takes part; any_lane is the tile's lockstep in the streamed bodies and
// the lane's own flag in the resident one).
// ---------------------------------------------------------------------------

template <int SOLVER, class V>
static __device__ __forceinline__ bool ls_bls_step(const WParams& p, V& w,
                                                   float& loss, float& lr,
                                                   bool live) {
  constexpr bool EXACT = SOLVER == SOLVER_BLS_EXACT;
  constexpr bool HALF = SOLVER == SOLVER_BLS_BF16;
  constexpr bool ULTRA = HALF || SOLVER == SOLVER_BLS_ULTRA;
  constexpr bool CARRY = SOLVER == SOLVER_BLS;
  if constexpr (ULTRA) eval_start<HALF>(w, live);
  float inv_norm = 0.f, alpha_norm = 0.f;
  if (live) grad_norms(w, inv_norm, alpha_norm);
  if constexpr (!EXACT) direction<HALF>(p, w, inv_norm, live);
  float base = loss;
  if constexpr (HALF) {
    if (live) base = rung_cost<false, true>(p, w, 0.f, inv_norm);
  }

  bool found = false;
  float lr_best = 0.f, loss_best = base, rung = 1.f;
  if constexpr (EXACT) {
    bool want = live;
    for (int k = 0; k < p.n_bls; ++k) {
      if (!any_lane(w, want)) break;
      const float lr_r = lr * rung;
      const float closs = rung_cost<true>(p, w, lr_r, inv_norm, want);
      if (want) {
        const float required = base - p.bls_alpha * lr_r * alpha_norm;
        if (closs <= required) {
          found = true;
          lr_best = lr_r;
          loss_best = closs;
          want = false;
        } else {
          rung = rung * p.beta_minus;
        }
      }
    }
  } else if (live) {
    for (int k = 0; k < p.n_bls; ++k) {
      const float lr_r = lr * rung;
      const float closs = rung_cost<false>(p, w, lr_r, inv_norm);
      const float required = base - p.bls_alpha * lr_r * alpha_norm;
      if (closs <= required) {
        found = true;
        lr_best = lr_r;
        loss_best = closs;
        break;
      }
      rung = rung * p.beta_minus;
    }
  }
  const float lr_eff = found ? lr_best : 0.f;
  const float new_lr = found ? lr_best * p.beta_plus : lr * p.lr_fail;
  const bool stop = (base - loss_best) < p.loss_red;

  // Every program rounds the accepted alpha once here, the carry program
  // too (as JAX's kernel does; ops/fused_solve.py, bls_step, says why the
  // J <= 15 carry program rounds it twice and this one does not).
  if (live) accept_step<EXACT>(p, w, lr_eff, inv_norm);
  if constexpr (EXACT) eval_alpha(w, live && !found);
  float nloss = loss_best;
  const bool pull = live && !stop;
  int first = 0;
  if (pull) {
    if constexpr (CARRY)
      cost_pass(p, w, false, first);
    else
      nloss = cost_pass(p, w, true, first);
  }
  grad_pass(p, w, first, pull);
  if (live) {
    loss = nloss;
    lr = new_lr;
  }
  return stop;
}

template <class V>
static __device__ __forceinline__ bool ls_gd_step(const WParams& p, V& w,
                                                  float& loss, float lr,
                                                  bool live) {
  const float a_fac = 1.f - p.lambda_reg * lr;
  if (live) stage_candidate<V, false>(w, a_fac, lr, 1.f);
  eval_staged(w, live);
  int first = 0;
  float nloss = 0.f;
  bool stop = true;
  if (live) {
    nloss = cost_pass(p, w, true, first);
    stop = (loss - nloss) < p.loss_red;
    if (!stop) accept_trial(w, a_fac, lr);
  }
  grad_pass(p, w, first, live && !stop);
  if (live && !stop) loss = nloss;
  return stop;
}

template <int SOLVER, class V>
static __device__ __forceinline__ bool ls_round(const WParams& p, V& w,
                                                int n_r, float lr0,
                                                float& loss, float& inner,
                                                bool evaluated, bool live) {
  eval_alpha(w, live && !evaluated);
  int first = 0;
  if (live) loss = cost_pass(p, w, true, first);
  grad_pass(p, w, first, live);
  if constexpr (SOLVER == SOLVER_GD) {
    bool go = live, rejected = false;
    for (int k = 0; k < n_r; ++k) {
      if (!any_lane(w, go)) break;
      const bool stop = ls_gd_step(p, w, loss, lr0, go);
      if (go) {
        if (stop) {
          rejected = true;
          go = false;
        } else {
          inner += 1.f;
        }
      }
    }
    eval_alpha(w, rejected);
  } else {
    float lr = lr0;
    bool go = live;
    for (int k = 0; k < n_r; ++k) {
      if (!any_lane(w, go)) break;
      const bool stop = ls_bls_step<SOLVER>(p, w, loss, lr, go);
      if (go) {
        if (stop)
          go = false;
        else
          inner += 1.f;
      }
    }
    if constexpr (SOLVER != SOLVER_BLS_EXACT) eval_alpha(w, live);
  }
  return live && constraints_ok(p, w);
}
