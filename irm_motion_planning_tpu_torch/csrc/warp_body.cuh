// The warp body of the fused kernels K1 and K2 (fused_solve.cu): ONE WARP
// PER LANE.  The 32 threads of a warp share one lane's T timesteps, thread
// i owning t = i + 32 g for g = 0, 1, ..., so every loop over rungs, steps
// and rounds is per lane and warp-uniform.  No per-lane state lives in
// device memory: a lane's alpha, penalties and scene are read once and its
// alpha and results written once.  Each kernel runs one of two bodies, a
// template argument of the kernel (the launch plan of ops/fused_solve.py
// picks it):
//
// The resident body (struct Warp, T <= 64).  Thread i owns t = i and
// t = i + 32.  In registers, each thread's timesteps of traj, vel and the
// obstacle-gradient planes gx, gy (read by every ladder rung or written and
// read within one evaluation).  In per-warp shared memory, the planes
// alpha, grad, dir_t and dir_v (J, T) (each thread touches only its own
// timesteps of them; between an evaluation's passes the direction planes
// hold its FK tangents), one buffer that holds in turn the staged input of
// a basis product (float4 per timestep: one broadcast load gives all J
// joints), the stacked gradient of the pull-back, or the rows of a
// reduction, the lane's obstacle terms (float4 per obstacle: ox, oy,
// q_o = 0.5 + 0.5 |o|^2, 0.8 w_o) and the lane's endpoints.  Per CTA, the
// basis pair transposed: kvT[t][r] = kv[r][t] and kvtT[t2][r] = kvt[r][t2],
// so the 32 output rows a warp computes at once are 32 neighbouring words
// (no bank conflicts), and mix.
//
// The streamed body (struct SWarp, any T >= 32), for the T whose basis
// pair (16 T^2 bytes) does not fit in shared memory beside the lane state.
// The basis stays in device memory (in L2: 640 KB at T = 200), transposed
// and zero-padded to 32 columns by the wrapper, and each basis product
// streams it through K7 (k7_product): for each timestep, the warp's 32
// threads read one aligned 128-byte line of 32 output rows with __ldg; no
// CTA-wide barrier, since the warps of a CTA run different lanes at
// different rungs.  (A version that double-buffered tiles of 32 timesteps
// x 32 rows per warp in shared memory with cp.async was 18% slower at
// T = 200 and held 8 KB per warp: PERF.md.)  traj, vel, gx and gy move
// from registers into per-warp shared-memory planes; everything else is
// laid out as in the resident body.  This replaces pallas_step's
// _Body._streamed_matmul (stream_rb > 0), which streams row blocks of the
// basis from HBM through double-buffered VMEM.
//
// The half-width streamed body (struct HWarp), for the bf16 tier's program
// (SOLVER_BLS_BF16) in the streamed plan: the ladder planes traj, vel,
// dir_t and dir_v, which hold bfloat16-rounded values in that program, are
// stored as bfloat16 (4 J T halves in the room of the float32 traj/vel
// planes, which they hold at the round start and end instead), and no
// plane holds FK tangents: the gradient pass recomputes FK from the
// iterate, which it forms per timestep from the half-width planes and the
// accepted learning rate (the same floats as the cost pass's).  24 bytes
// per timestep less than SWarp at J = 3, which lifts the ceiling of one
// warp per CTA from T = 2,072 to T = 2,636 at 11 obstacles.
//
// Op order.  Every basis-product row is the sequential fmaf chain over t of
// the lane body (lane_body.cuh, which K3 and K5 are built from), followed by
// the same mix combine; in the streamed body thread i computes rows
// r = 32 g + i, each one whole chain over t across the tiles (no split over
// t).  Every sum over t (the cost sums, the gradient norm, alpha_norm) and
// the constraint extrema are the lane body's sequential chains, each run by
// one thread over a row the owners wrote and broadcast with __shfl_sync;
// the blend's first argmax is a shuffle tree, which rounds nothing.  Each
// lane therefore runs the lane body's op sequence (its bls_step or
// gd_step) in either body, and K1/K2 give the one-thread-per-lane kernels'
// results bit for bit, streamed or resident.  FK and the penalized loss are
// the lane body's own functions.

#pragma once

#include <cuda_bf16.h>

#include "lane_body.cuh"

#define WB_SLOTS 2                 // timesteps per thread (resident body)
#define WB_MAX_T (32 * WB_SLOTS)
#ifndef WB_MAX_WARPS
#define WB_MAX_WARPS 16            // warps (lanes in flight) per CTA
#endif
#ifndef WB_MIN_CTAS
#define WB_MIN_CTAS 2              // CTAs of WB_MAX_WARPS per SM: <= 64 regs
#endif
#define WB_ROWS 8                  // reduction rows in the buffer
#define WB_LANE_FLOATS 20          // start, goal, t0, tN, v0, vN (+2 pad)
#define WB_MIX_FLOATS 12           // mix (J x J), padded to 16 bytes
#define WB_OUTCOME (6 * NJ)        // K4: a lane's step outcome (ends' pad)
#define FULL_MASK 0xffffffffu

// The specialised instantiation of the resident body's kernels (K1, K2,
// K4): the bench's T and obstacle slots.  Other shapes run the generic one
// (TT = OO = 0: T and O read at run time), with the same op sequence and
// results.
#define WB_SPEC_T 50
#define WB_SPEC_O 11

static inline bool specialised(const FsParams& p) {
  return p.T == WB_SPEC_T && p.O == WB_SPEC_O;
}

// The shared-memory plans (floats); mirror of launch_plan in
// ops/fused_solve.py.  A reduction row is padded to a multiple of 4 floats
// so a chain reads it as float4.
__host__ __device__ __forceinline__ int wb_row_stride(int T) {
  return (T + 3) & ~3;
}
__host__ __device__ __forceinline__ size_t wb_basis_floats(int T) {
  return (size_t)4 * T * T + WB_MIX_FLOATS;  // kvT, kvtT, mix
}
__host__ __device__ __forceinline__ size_t wb_warp_floats(int T, int O) {
  return (size_t)4 * NJ * T + (size_t)WB_ROWS * wb_row_stride(T) +
         (size_t)4 * O + WB_LANE_FLOATS;
}
// Streamed: the resident body's per-warp pieces and the traj/vel/gx/gy
// planes ((2J + 2) T); per CTA only mix.
__host__ __device__ __forceinline__ size_t ws_warp_floats(int T, int O) {
  return wb_warp_floats(T, O) + (size_t)(2 * NJ + 2) * T;
}
// Half-width streamed (HWarp): alpha, grad (J, T), gx, gy (T,), the ladder
// planes (4 J T bfloat16 = 2 J T floats, padded to 4 floats), the buffer,
// obstacles and endpoints.
__host__ __device__ __forceinline__ int hs_ladder_floats(int T) {
  return (2 * NJ * T + 3) & ~3;
}
__host__ __device__ __forceinline__ size_t hs_warp_floats(int T, int O) {
  return (size_t)(2 * NJ + 2) * T + hs_ladder_floats(T) +
         (size_t)WB_ROWS * wb_row_stride(T) + (size_t)4 * O + WB_LANE_FLOATS;
}
// The row stride of a transposed basis in device memory: its rows (the
// product's output rows) padded to a multiple of 32 with zeros, so the 32
// rows a warp computes at one timestep are one aligned 128-byte line.
__host__ __device__ __forceinline__ int ws_ld(int rows) {
  return (rows + 31) & ~31;
}
static size_t warp_smem_bytes(const FsParams& p, int warps, bool streamed,
                              bool half) {
  if (streamed)
    return sizeof(float) *
           (WB_MIX_FLOATS +
            (size_t)warps *
                (half ? hs_warp_floats(p.T, p.O) : ws_warp_floats(p.T, p.O)));
  return sizeof(float) *
         (wb_basis_floats(p.T) + (size_t)warps * wb_warp_floats(p.T, p.O));
}

// One warp's view of its lane in the resident body: per-CTA basis, the
// per-warp planes and buffers, and this thread's timesteps in registers.
struct Warp {
  static constexpr int G = WB_SLOTS;  // timesteps per thread
  const float* kvT;   // (T, 2T)
  const float* kvtT;  // (2T, T)
  const float* mix;   // (J, J)
  float *alpha, *grad, *dir_t, *dir_v;  // (J, T), [j * T + t]
  float* buf;         // WB_ROWS rows of RS, or 2T float4
  float4* obs;        // (O,)
  float* ends;        // start[J], goal[J], t0[J], tN[J], v0[J], vN[J]
  int T, O, RS, lid;
  float lam_sg, lam_jl;
  float traj[WB_SLOTS][NJ], vel[WB_SLOTS][NJ], gx[WB_SLOTS], gy[WB_SLOTS];
  // An evaluation's cost pass keeps its FK tangents for the gradient pass
  // (in dir_t/dir_v).
  static constexpr bool kKeepsFk = true;

  // This thread's timestep in slot s: thread i owns t = i and i + 32, so
  // the warp's 32 threads touch 32 neighbouring words of a plane or row.
  __device__ __forceinline__ int tt(int s) const { return lid + 32 * s; }
  // The same, clamped to T - 1 for the slots past T (they compute a copy of
  // t = T - 1 that nothing stores).
  __device__ __forceinline__ int ts(int s) const { return min(tt(s), T - 1); }
  __device__ __forceinline__ bool owns(int s) const { return tt(s) < T; }
};

// The streamed body's view: the transposed basis pair in device memory,
// and every plane (traj, vel, gx, gy too) in per-warp shared memory.
// Thread i owns t = i + 32 g for the G = ceil(T / 32) groups g.
struct SWarp {
  const float* kvT;   // device memory (T, ws_ld(2T)): kv transposed
  const float* kvtT;  // device memory (2T, ws_ld(T)): kvt transposed
  const float* mix;   // shared (J, J)
  float *alpha, *grad, *dir_t, *dir_v;  // (J, T), [j * T + t]
  float *traj, *vel;  // (J, T)
  float *gx, *gy;     // (T,)
  float* buf;         // WB_ROWS rows of RS, or 2T float4
  float4* obs;        // (O,)
  float* ends;        // as Warp's
  int T, O, RS, lid, G;
  float lam_sg, lam_jl;
  static constexpr bool kKeepsFk = true;

  __device__ __forceinline__ int tt(int g) const { return lid + 32 * g; }
  __device__ __forceinline__ int ts(int g) const { return min(tt(g), T - 1); }
  __device__ __forceinline__ bool owns(int g) const { return tt(g) < T; }
};

// The half-width streamed body's view (the bf16 tier's program): SWarp's,
// with the ladder planes traj_h, vel_h, dir_th, dir_vh (J, T) bfloat16 in
// the room where traj and vel (J, T) float32 sit at the round start and
// end.  ``half``: the iterate is the accepted linearized one, formed per
// timestep as traj_h - lr_acc dir_th (load_point); otherwise traj/vel.
struct HWarp {
  const float* kvT;   // device memory, as SWarp's
  const float* kvtT;
  const float* mix;   // shared (J, J)
  float *alpha, *grad;  // (J, T)
  float *gx, *gy;       // (T,)
  float *traj, *vel;    // (J, T) float32: the round start's and end's
  __nv_bfloat16 *traj_h, *vel_h, *dir_th, *dir_vh;  // (J, T), same room
  float* buf;
  float4* obs;
  float* ends;
  int T, O, RS, lid, G;
  float lam_sg, lam_jl;
  float lr_acc;
  bool half;
  static constexpr bool kKeepsFk = false;

  __device__ __forceinline__ int tt(int g) const { return lid + 32 * g; }
  __device__ __forceinline__ int ts(int g) const { return min(tt(g), T - 1); }
  __device__ __forceinline__ bool owns(int g) const { return tt(g) < T; }
};

// A float rounded to bfloat16 (nearest even) and back: the values the bf16
// tier's ladder planes hold (JAX's astype, torch's .to(torch.bfloat16)).
static __device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage the basis pair (transposed) and mix; every thread of the CTA takes
// part; one __syncthreads, the CTA's only block-wide barrier.
static __device__ void stage_cta(int T, const float* __restrict__ kv,
                                 const float* __restrict__ kvt,
                                 const float* __restrict__ mix, float* smem) {
  const int R2 = 2 * T, n = R2 * T;
  float* kvT = smem;
  float* kvtT = smem + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / T, t = i - r * T;       // kv (2T, T)
    kvT[t * R2 + r] = kv[i];
    const int r2 = i / R2, t2 = i - r2 * R2;  // kvt (T, 2T)
    kvtT[t2 * T + r2] = kvt[i];
  }
  if (threadIdx.x < NJ * NJ) smem[2 * n + threadIdx.x] = mix[threadIdx.x];
  __syncthreads();
}

// This warp's view; T and O are compile-time constants in the kernels'
// specialised instantiation, which turns every offset into an immediate.
static __device__ __forceinline__ Warp bind_warp(float* smem, int T, int O) {
  Warp w;
  w.T = T;
  w.O = O;
  w.RS = wb_row_stride(T);
  w.lid = threadIdx.x & 31;
  w.kvT = smem;
  w.kvtT = smem + 2 * T * T;
  w.mix = smem + 4 * T * T;
  float* mine = smem + wb_basis_floats(T) +
                (size_t)(threadIdx.x >> 5) * wb_warp_floats(T, O);
  const int plane = NJ * T;
  w.alpha = mine;
  w.grad = mine + plane;
  w.dir_t = mine + 2 * plane;
  w.dir_v = mine + 3 * plane;
  w.buf = mine + 4 * plane;
  w.obs = (float4*)(w.buf + WB_ROWS * w.RS);
  w.ends = (float*)(w.obs + w.O);
  return w;
}

// Stage mix (the streamed body's only per-CTA piece) and bind this warp's
// view of the transposed basis kvT_dev / kvtT_dev in device memory.
static __device__ SWarp bind_swarp(float* smem, int T, int O,
                                   const float* kvT_dev, const float* kvtT_dev,
                                   const float* __restrict__ mix) {
  if (threadIdx.x < NJ * NJ) smem[threadIdx.x] = mix[threadIdx.x];
  __syncthreads();
  SWarp w;
  w.T = T;
  w.O = O;
  w.RS = wb_row_stride(T);
  w.lid = threadIdx.x & 31;
  w.G = (T + 31) >> 5;
  w.kvT = kvT_dev;
  w.kvtT = kvtT_dev;
  w.mix = smem;
  float* mine = smem + WB_MIX_FLOATS +
                (size_t)(threadIdx.x >> 5) * ws_warp_floats(T, O);
  const int plane = NJ * T;
  w.alpha = mine;
  w.grad = mine + plane;
  w.dir_t = mine + 2 * plane;
  w.dir_v = mine + 3 * plane;
  w.traj = mine + 4 * plane;
  w.vel = mine + 5 * plane;
  w.gx = mine + 6 * plane;
  w.gy = w.gx + T;
  w.buf = w.gy + T;
  w.obs = (float4*)(w.buf + WB_ROWS * w.RS);
  w.ends = (float*)(w.obs + w.O);
  return w;
}

// Stage mix and bind this warp's half-width view (the layout of
// hs_warp_floats).
static __device__ HWarp bind_hwarp(float* smem, int T, int O,
                                   const float* kvT_dev, const float* kvtT_dev,
                                   const float* __restrict__ mix) {
  if (threadIdx.x < NJ * NJ) smem[threadIdx.x] = mix[threadIdx.x];
  __syncthreads();
  HWarp w;
  w.T = T;
  w.O = O;
  w.RS = wb_row_stride(T);
  w.lid = threadIdx.x & 31;
  w.G = (T + 31) >> 5;
  w.kvT = kvT_dev;
  w.kvtT = kvtT_dev;
  w.mix = smem;
  float* mine = smem + WB_MIX_FLOATS +
                (size_t)(threadIdx.x >> 5) * hs_warp_floats(T, O);
  const int plane = NJ * T;
  w.alpha = mine;
  w.grad = mine + plane;
  w.gx = mine + 2 * plane;
  w.gy = w.gx + T;
  float* ladder = w.gy + T;
  w.traj = ladder;
  w.vel = ladder + plane;
  w.traj_h = (__nv_bfloat16*)ladder;
  w.vel_h = w.traj_h + plane;
  w.dir_th = w.vel_h + plane;
  w.dir_vh = w.dir_th + plane;
  w.buf = ladder + hs_ladder_floats(T);
  w.obs = (float4*)(w.buf + WB_ROWS * w.RS);
  w.ends = (float*)(w.obs + w.O);
  w.lr_acc = 0.f;
  w.half = false;
  return w;
}

// The warp's next lane from the device queue (lane 0 draws, all receive).
static __device__ __forceinline__ int next_lane(int* queue, int lid) {
  int b = 0;
  if (lid == 0) b = atomicAdd(queue, 1);
  return __shfl_sync(FULL_MASK, b, 0);
}

// Read lane b's alpha (J, T, B), scene and endpoints into the warp's
// shared memory; the penalties into registers.
template <class W>
static __device__ __forceinline__ void load_lane(
    const FsParams& p, W& w, size_t b, const float* alpha,
    const float* __restrict__ start, const float* __restrict__ goal,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ ow, float lam_sg, float lam_jl) {
  const size_t B = p.B;
  __syncwarp();  // the previous lane's readers are done
  for (int i = w.lid; i < NJ * w.T; i += 32) w.alpha[i] = alpha[i * B + b];
  for (int o = w.lid; o < w.O; o += 32) {
    const float x = ox[o * B + b], y = oy[o * B + b], wt = ow[o * B + b];
    w.obs[o] = make_float4(x, y, 0.5f + 0.5f * (x * x + y * y), 0.8f * wt);
  }
  if (w.lid < NJ) {
    w.ends[w.lid] = start[w.lid * B + b];
    w.ends[NJ + w.lid] = goal[w.lid * B + b];
  }
  w.lam_sg = lam_sg;
  w.lam_jl = lam_jl;
  __syncwarp();
}

template <class W>
static __device__ __forceinline__ void store_alpha(const FsParams& p,
                                                   const W& w, size_t b,
                                                   float* alpha) {
  __syncwarp();  // the owners' last updates are visible
  for (int i = w.lid; i < NJ * w.T; i += 32)
    alpha[i * (size_t)p.B + b] = w.alpha[i];
}

// ---------------------------------------------------------------------------
// Reductions: sequential chains over rows of the buffer.
// ---------------------------------------------------------------------------

// Each of the first n threads runs the lane body's chain over row ``lid``:
// sum = ((0 + x_0) + x_1) + ...  With WB_TREE_SUMS (a phase-ablated build
// for measurement, not bitwise: tools/fused_variants.py)
// every thread takes part in a shuffle tree per row instead.
template <class W>
static __device__ __forceinline__ float chains(const W& w, int n) {
  __syncwarp();  // the owners' rows are visible
  float sum = 0.f;
#ifdef WB_TREE_SUMS
  for (int k = 0; k < n; ++k) {
    const float* row = w.buf + k * w.RS;
    float x = 0.f;
    for (int t = w.lid; t < w.T; t += 32) x += row[t];
    for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
    if (w.lid == k) sum = x;
  }
#else
  if (w.lid < n) {
    const float* row = w.buf + w.lid * w.RS;
    const float4* row4 = (const float4*)row;
    int t = 0;
    for (; t + 4 <= w.T; t += 4) {
      const float4 v = row4[t >> 2];
      sum = sum + v.x;
      sum = sum + v.y;
      sum = sum + v.z;
      sum = sum + v.w;
    }
    for (; t < w.T; ++t) sum = sum + row[t];
  }
#endif
  __syncwarp();  // the chains' reads are done before the buffer is reused
  return sum;
}

// The shuffle tree of the first argmax over the threads' (value, first t):
// the larger value wins, a tie goes to the smaller t.  For inputs without
// NaN this is the lane body's sequential `t == 0 || cv > cmax` result
// exactly (a max rounds nothing).
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

// The first argmax of the cost over t (the value and its first t) from the
// owners' values.
static __device__ __forceinline__ void tree_argmax(const Warp& w,
                                                   const float* cv, float& mx,
                                                   int& first) {
  float m = cv[0];
  int f = w.tt(0);
  if (w.owns(1) && cv[1] > m) {
    m = cv[1];
    f = w.tt(1);
  }
  argmax_tree(m, f);
  mx = m;
  first = f;
}

// Write one timestep's value of reduction row k (owners only).
template <class W>
static __device__ __forceinline__ void put_row(const W& w, int k, int s,
                                               float x) {
  if (w.owns(s)) w.buf[k * w.RS + w.tt(s)] = x;
}

// The masked limit losses of one timestep (the lane body's cost_add terms).
static __device__ __forceinline__ void limit_terms(const FsParams& p,
                                                   const float* tr,
                                                   const float* ve, float* pl,
                                                   float* vl) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float zp = (tr[j] - p.mean_jp) * p.inv_std_jp_h;
    pl[j] = zp * zp;
    float zv = ve[j] * p.inv_vmax_h;
    vl[j] = zv * zv;
    if (p.masked) {
      if (!(tr[j] > p.pos_hi || tr[j] < p.pos_lo)) pl[j] = 0.f;
      if (!(fabsf(ve[j]) > p.vel_hi)) vl[j] = 0.f;
    }
  }
}

// Rows of one evaluated timestep: the obstacle cost (row 0), the limit
// losses (rows 1..J, J+1..2J) and, at t = 0 and T - 1, the endpoint values.
template <class W>
static __device__ __forceinline__ void put_cost_rows(const FsParams& p,
                                                     const W& w, int s,
                                                     float cv, const float* tr,
                                                     const float* ve) {
  float pl[NJ], vl[NJ];
  limit_terms(p, tr, ve, pl, vl);
  put_row(w, 0, s, cv);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    put_row(w, 1 + j, s, pl[j]);
    put_row(w, 1 + NJ + j, s, vl[j]);
  }
  const int t = w.tt(s);
  if (t == 0 || t == w.T - 1) {
    float* e = w.ends + 2 * NJ + (t == 0 ? 0 : NJ);  // t0 or tN
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      e[j] = tr[j];
      e[2 * NJ + j] = ve[j];  // v0 or vN
    }
  }
}

// The penalized loss from the cost rows (the lane body's cost_total, on
// every thread from the same broadcast values: the result is warp-uniform).
template <class W>
static __device__ __forceinline__ float rows_loss(const FsParams& p,
                                                  const W& w, float cmax,
                                                  int first) {
  CostAcc a;
  a.cmax = cmax;
  const float sum = chains(w, 1 + 2 * NJ);
  a.csum = __shfl_sync(FULL_MASK, sum, 0);
  a.first = first;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    a.psum[j] = __shfl_sync(FULL_MASK, sum, 1 + j);
    a.vsum[j] = __shfl_sync(FULL_MASK, sum, 1 + NJ + j);
  }
  Lane L;
  const float* e = w.ends;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    L.start[j] = e[j];
    L.goal[j] = e[NJ + j];
  }
  L.lam_sg = w.lam_sg;
  L.lam_jl = w.lam_jl;
  return cost_total(p, L, a, e + 2 * NJ, e + 3 * NJ, e + 4 * NJ, e + 5 * NJ);
}

// The reduction of the cost rows: the blend's first argmax and, when
// want_loss, the penalized loss.
static __device__ __forceinline__ float cost_reduce(const FsParams& p,
                                                    const Warp& w,
                                                    const float* cv,
                                                    bool want_loss,
                                                    int& first) {
  float cmax;
  tree_argmax(w, cv, cmax, first);
  if (!want_loss) return 0.f;
  return rows_loss(p, w, cmax, first);
}

// The hard-constraint check from rows 0..2J-1 of the buffer (traj, then
// vel): the lane body's constraints_ok, its extrema chains run by thread 0.
template <class W>
static __device__ __forceinline__ bool rows_ok(const FsParams& p,
                                               const W& w) {
  const int T = w.T, RS = w.RS;
  __syncwarp();
  int ok = 0;
  if (w.lid == 0) {
    const float* tr = w.buf;
    const float* ve = w.buf + NJ * RS;
    float ps = 0.f, pg = 0.f, vs = 0.f, vg = 0.f;
    float tmax = tr[0], tmin = tmax;
    float vmax = fabsf(ve[0]);
    for (int j = 0; j < NJ; ++j) {
      const float d0 = tr[j * RS] - w.ends[j];
      const float dN = tr[j * RS + T - 1] - w.ends[NJ + j];
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
// Per-timestep pieces of both bodies.
// ---------------------------------------------------------------------------

// Stage src (J, T) * scale (per-warp plane, own timesteps) into the buffer
// as float4 per timestep.
template <class W>
static __device__ __forceinline__ void stage_input(const W& w,
                                                   const float* src,
                                                   float scale) {
  __syncwarp();
  float4* in = (float4*)w.buf;
#pragma unroll
  for (int s = 0; s < w.G; ++s) {
    if (!w.owns(s)) continue;
    const int t = w.tt(s);
    in[t] = make_float4(src[t] * scale, src[w.T + t] * scale,
                        src[2 * w.T + t] * scale, 0.f);
  }
  __syncwarp();
}

// Stage the candidate alpha (1 - lambda_reg lr) alpha - lr (grad scale) of
// the own timesteps into the buffer as a product input (float4 per
// timestep), rounded once (fmaf, as XLA contracts it on the CPU): the exact
// ladder's rung (scale inv_norm: the normalized direction) and GD's trial
// (scale 1: the raw gradient, multiplied by nothing, as the plain gd_step
// computes it).
template <class W, bool SCALED>
static __device__ __forceinline__ void stage_candidate(const W& w, float a_fac,
                                                       float lr,
                                                       float scale) {
  const int T = w.T;
  __syncwarp();  // the buffer's last readers are done
  float4* in = (float4*)w.buf;
#pragma unroll
  for (int s = 0; s < w.G; ++s) {
    if (!w.owns(s)) continue;
    const int t = w.tt(s);
    float c[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float g = SCALED ? w.grad[j * T + t] * scale : w.grad[j * T + t];
      c[j] = fmaf(a_fac, w.alpha[j * T + t], -(lr * g));
    }
    in[t] = make_float4(c[0], c[1], c[2], 0.f);
  }
  __syncwarp();
}

// Obstacle field at one end-effector point (the lane body's obstacle_point).
template <class W>
static __device__ __forceinline__ float field(const W& w, float ex,
                                              float ey) {
  float h = 0.5f * (ex * ex + ey * ey);
  float acc = 0.f;
  for (int o = 0; o < w.O; ++o) {
    const float4 ob = w.obs[o];
    float s = (h + ob.z) - (ob.x * ex + ob.y * ey);
    acc = acc + ob.w * (1.0f / s);
  }
  return acc;
}

// Pass A at one timestep (slot or group s) of (tr, ve): FK (its tangents
// kept for pass B in the direction planes when s is owned, in the bodies
// that keep them: W::kKeepsFk), the obstacle
// field and its factored gradient into gxo/gyo, and when want_loss the cost
// rows.  Returns the obstacle cost.
template <class W>
static __device__ __forceinline__ float cost_point(const FsParams& p, W& w,
                                                   int s, const float* tr,
                                                   const float* ve,
                                                   bool want_loss, float& gxo,
                                                   float& gyo) {
  float px[NJ], py[NJ], ex, ey;
  fk_point(p, tr, px, py, ex, ey);
  if constexpr (W::kKeepsFk) {
    if (w.owns(s)) {  // the FK tangents for pass B, in the free dir planes
      const int t = w.tt(s);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        w.dir_t[j * w.T + t] = px[j];
        w.dir_v[j * w.T + t] = py[j];
      }
    }
  }
  float h = 0.5f * (ex * ex + ey * ey);
  float cv = 0.f, csum = 0.f, cox = 0.f, coy = 0.f;
  for (int o = 0; o < w.O; ++o) {
    const float4 ob = w.obs[o];
    float sd = (h + ob.z) - (ob.x * ex + ob.y * ey);
    float inv = 1.0f / sd;
    float winv = ob.w * inv;
    cv = cv + winv;
    float coef = winv * inv;
    csum = csum + coef;
    cox = cox + coef * ob.x;
    coy = coy + coef * ob.y;
  }
  gxo = cox - ex * csum;
  gyo = coy - ey * csum;
  if (want_loss) put_cost_rows(p, w, s, cv, tr, ve);
  return cv;
}

// Pass B at timestep t of (tr, ve) with the obstacle gradient (gxs, gys)
// and the FK tangents (from the direction planes, or recomputed from tr by
// the bodies that do not keep them: the same floats): the stacked position
// (gp) and velocity (gv) gradient rows.
template <class W>
static __device__ __forceinline__ void stacked_grad(const FsParams& p,
                                                    const W& w, int t,
                                                    int first, const float* tr,
                                                    const float* ve, float gxs,
                                                    float gys, float* gp,
                                                    float* gv) {
  const int T = w.T;
  const float* start = w.ends;
  const float* goal = w.ends + NJ;
  float px[NJ], py[NJ];
  if constexpr (W::kKeepsFk) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      px[j] = w.dir_t[j * T + t];
      py[j] = w.dir_v[j * T + t];
    }
  } else {
    float ex, ey;
    fk_point(p, tr, px, py, ex, ey);
  }
  const float wt = p.lam_max * (t == first ? 1.f : 0.f) + p.mean_w;
  const float wgx = wt * gxs;
  const float wgy = wt * gys;
  float jx[NJ], jy[NJ], accx = 0.f, accy = 0.f;
#pragma unroll
  for (int j = NJ - 1; j >= 0; --j) {
    accx = accx + (-py[j]);
    accy = accy + px[j];
    jx[j] = accx;
    jy[j] = accy;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float toc_g = wgx * jx[j] + wgy * jy[j];
    float sgp = 0.f, sgv = 0.f;
    if (t == 0) {
      sgp = tr[j] - start[j];
      sgv = ve[j];
    } else if (t == T - 1) {
      sgp = tr[j] - goal[j];
      sgv = ve[j];
    }
    float jp = (tr[j] - p.mean_jp) * p.inv_std2_T;
    float jv = ve[j] * p.inv_vmax2_T;
    if (p.masked) {
      if (!(tr[j] > p.pos_hi || tr[j] < p.pos_lo)) jp = 0.f;
      if (!(fabsf(ve[j]) > p.vel_hi)) jv = 0.f;
    }
    gp[j] = (toc_g + w.lam_sg * sgp) + w.lam_jl * jp;
    gv[j] = w.lam_sg * sgv + w.lam_jl * jv;
  }
}

// One rung's cost at timestep (slot or group) s of the candidate (tr, ve):
// FK, the obstacle field and the cost rows.
template <class W>
static __device__ __forceinline__ float rung_point(const FsParams& p,
                                                   const W& w, int s,
                                                   const float* tr,
                                                   const float* ve) {
  float px[NJ], py[NJ], ex, ey;
  fk_point(p, tr, px, py, ex, ey);
  const float cv = field(w, ex, ey);
  put_cost_rows(p, w, s, cv, tr, ve);
  return cv;
}

// The normalized direction's scalars: 1 / |grad| (per joint sum_t g^2,
// then their sum) and the reference quirk alpha_norm, the sum over all
// (J, J) entries of grad^T n_grad.
template <class W>
static __device__ __forceinline__ void grad_norms(const W& w, float& inv_norm,
                                                  float& alpha_norm) {
  const int T = w.T;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < w.G; ++s)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float g = w.grad[j * T + w.ts(s)];
      put_row(w, j, s, g * g);
    }
  float sum = chains(w, NJ);
  float g2 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) g2 = g2 + __shfl_sync(FULL_MASK, sum, j);
  inv_norm = 1.0f / sqrtf(g2);
#pragma unroll
  for (int s = 0; s < w.G; ++s) {
    const int t = w.ts(s);
    float gs = w.grad[t];
#pragma unroll
    for (int j = 1; j < NJ; ++j) gs = gs + w.grad[j * T + t];
    put_row(w, 0, s, gs * (gs * inv_norm));
  }
  sum = chains(w, 1);
  alpha_norm = __shfl_sync(FULL_MASK, sum, 0);
}

// GD's accepted trial: alpha = a_fac alpha - lr grad on the own timesteps,
// rounded once, as stage_candidate forms it.
template <class W>
static __device__ __forceinline__ void accept_trial(const W& w, float a_fac,
                                                    float lr) {
  const int T = w.T;
#pragma unroll
  for (int s = 0; s < w.G; ++s) {
    if (!w.owns(s)) continue;
    const int t = w.tt(s);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = j * T + t;
      w.alpha[i] = fmaf(a_fac, w.alpha[i], -(lr * w.grad[i]));
    }
  }
}

// ---------------------------------------------------------------------------
// The resident body: basis products from shared memory, traj/vel/gx/gy in
// registers.
// ---------------------------------------------------------------------------

// The staged input through kv, this thread's rows: out[s] the traj rows
// t(s), out[WB_SLOTS + s] the vel rows T + t(s), each mixed.
static __device__ __forceinline__ void forward_rows(
    const Warp& w, float out[2 * WB_SLOTS][NJ]) {
  const int T = w.T, R2 = 2 * T;
  const float4* in = (const float4*)w.buf;
  int row[2 * WB_SLOTS];
  float acc[2 * WB_SLOTS][NJ];
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    row[s] = w.ts(s);
    row[WB_SLOTS + s] = T + w.ts(s);
  }
#pragma unroll
  for (int r = 0; r < 2 * WB_SLOTS; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float4 a = in[t];
    const float* k = w.kvT + t * R2;
#pragma unroll
    for (int r = 0; r < 2 * WB_SLOTS; ++r) {
      const float kk = k[row[r]];
      acc[r][0] = fmaf(kk, a.x, acc[r][0]);
      acc[r][1] = fmaf(kk, a.y, acc[r][1]);
      acc[r][2] = fmaf(kk, a.z, acc[r][2]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2 * WB_SLOTS; ++r)
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      float v = acc[r][0] * w.mix[0 * NJ + i];
      v = v + acc[r][1] * w.mix[1 * NJ + i];
      v = v + acc[r][2] * w.mix[2 * NJ + i];
      out[r][i] = v;
    }
}

// (traj, vel) = the staged input through kv, into this thread's registers.
static __device__ __forceinline__ void eval_staged(Warp& w) {
  float out[2 * WB_SLOTS][NJ];
  forward_rows(w, out);
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s)
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      w.traj[s][i] = out[s][i];
      w.vel[s][i] = out[WB_SLOTS + s][i];
    }
}

// The search direction, hoisted: dir = lambda_reg (traj, vel) + the
// normalized gradient's forward evaluation, into dir_t/dir_v.  HALF (the
// bf16 tier): lambda_reg rounded to bfloat16 (JAX's weak typing on
// bfloat16 planes) and dir rounded to bfloat16.
template <bool HALF>
static __device__ __forceinline__ void direction(const FsParams& p, Warp& w,
                                                 float inv_norm) {
  const int T = w.T;
  const float lam = HALF ? bf16_round(p.lambda_reg) : p.lambda_reg;
  stage_input(w, w.grad, inv_norm);
  float out[2 * WB_SLOTS][NJ];
  forward_rows(w, out);
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    if (!w.owns(s)) continue;
    const int t = w.tt(s);
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      float dt = lam * w.traj[s][i] + out[s][i];
      float dv = lam * w.vel[s][i] + out[WB_SLOTS + s][i];
      if constexpr (HALF) {
        dt = bf16_round(dt);
        dv = bf16_round(dv);
      }
      w.dir_t[i * T + t] = dt;
      w.dir_v[i * T + t] = dv;
    }
  }
}

// The ultra and bf16 tiers' step start: (traj, vel) = the exact
// evaluation of alpha, rounded to bfloat16 when HALF (held as float32 in
// the registers).
template <bool HALF>
static __device__ __forceinline__ void eval_start(Warp& w) {
  stage_input(w, w.alpha, 1.f);
  eval_staged(w);
  if constexpr (HALF) {
#pragma unroll
    for (int s = 0; s < WB_SLOTS; ++s)
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        w.traj[s][i] = bf16_round(w.traj[s][i]);
        w.vel[s][i] = bf16_round(w.vel[s][i]);
      }
  }
}

// The new alpha = a_fac alpha - lr_eff (grad inv_norm), rounded once
// (fmaf) when FUSED: every program but the linearized ladder's carry
// program (bls_step says why).
template <bool FUSED>
static __device__ __forceinline__ float new_alpha(float a_fac, float alpha,
                                                  float lr_eff, float ng) {
  if constexpr (FUSED) return fmaf(a_fac, alpha, -(lr_eff * ng));
  return a_fac * alpha - lr_eff * ng;
}

// The accepted BLS step: alpha = a_fac alpha - lr_eff (grad inv_norm) on
// the own timesteps (new_alpha) and, in the linearized ladder, (traj, vel)
// = x - lr_eff dir.
template <bool EXACT, bool FUSED>
static __device__ __forceinline__ void accept_step(const FsParams& p, Warp& w,
                                                   float lr_eff,
                                                   float inv_norm) {
  const int T = w.T;
  const float a_fac = 1.f - p.lambda_reg * lr_eff;
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    const int t = w.ts(s);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = j * T + t;
      if (w.owns(s))
        w.alpha[i] = new_alpha<FUSED>(a_fac, w.alpha[i], lr_eff,
                                      w.grad[i] * inv_norm);
      if constexpr (!EXACT) {
        w.traj[s][j] = w.traj[s][j] - lr_eff * w.dir_t[i];
        w.vel[s][j] = w.vel[s][j] - lr_eff * w.dir_v[i];
      }
    }
  }
}

// Pass A at the current (traj, vel): FK (its tangents kept for pass B in
// the direction planes, free from here to the next step's direction), the
// obstacle field and its factored gradient into gx/gy, the blend's first
// argmax and, when want_loss, the cost rows and their reduction.
static __device__ __forceinline__ float cost_pass(const FsParams& p, Warp& w,
                                                  bool want_loss, int& first) {
  __syncwarp();  // the buffer's last readers are done
  float cvs[WB_SLOTS];
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s)
    cvs[s] = cost_point(p, w, s, w.traj[s], w.vel[s], want_loss, w.gx[s],
                        w.gy[s]);
  return cost_reduce(p, w, cvs, want_loss, first);
}

// Passes B and C: the stacked position/velocity gradient (float4 rows of
// the buffer, positions then velocities), then the pull-back through kvt
// and the mix^T combine, into grad.
static __device__ __forceinline__ void grad_pass(const FsParams& p, Warp& w,
                                                 int first) {
  const int T = w.T;
  float4* stack = (float4*)w.buf;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    const int t = w.ts(s);
    float gp[NJ], gv[NJ];
    stacked_grad(p, w, t, first, w.traj[s], w.vel[s], w.gx[s], w.gy[s], gp,
                 gv);
    if (w.owns(s)) {
      stack[t] = make_float4(gp[0], gp[1], gp[2], 0.f);
      stack[T + t] = make_float4(gv[0], gv[1], gv[2], 0.f);
    }
  }
  __syncwarp();

  // Pass C: this thread's rows t(s) of kvt @ stack, mixed by mix^T.
  float acc[WB_SLOTS][NJ];
  int row[WB_SLOTS];
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    row[s] = w.ts(s);
#pragma unroll
    for (int i = 0; i < NJ; ++i) acc[s][i] = 0.f;
  }
  for (int t2 = 0; t2 < 2 * T; ++t2) {
    const float4 g = stack[t2];
    const float* k = w.kvtT + t2 * T;
#pragma unroll
    for (int s = 0; s < WB_SLOTS; ++s) {
      const float kk = k[row[s]];
      acc[s][0] = fmaf(kk, g.x, acc[s][0]);
      acc[s][1] = fmaf(kk, g.y, acc[s][1]);
      acc[s][2] = fmaf(kk, g.z, acc[s][2]);
    }
  }
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    if (!w.owns(s)) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float v = acc[s][0] * w.mix[j * NJ + 0];
      v = v + acc[s][1] * w.mix[j * NJ + 1];
      v = v + acc[s][2] * w.mix[j * NJ + 2];
      w.grad[j * T + row[s]] = v;
    }
  }
}

// Loss of one ladder rung at learning rate lr.  Linearized: the candidate
// (traj - lr dir_t, vel - lr dir_v); BASE: the zero-lr candidate (traj,
// vel) itself (the bf16 tier's baseline).  EXACT: the candidate alpha
// (1 - lambda_reg lr) alpha - lr (grad inv_norm), in the operand order of
// the accepted update, staged as a product input (float4 per timestep, as
// gd_step stages its trial) and evaluated through kv into the traj/vel
// registers, which the exact ladder does not read (bls_step re-evaluates
// them); then the same cost rows and reduction.
template <bool EXACT, bool BASE = false>
static __device__ __forceinline__ float rung_cost(const FsParams& p, Warp& w,
                                                  float lr, float inv_norm) {
  const int T = w.T;
  if constexpr (EXACT) {
    stage_candidate<Warp, true>(w, 1.f - p.lambda_reg * lr, lr, inv_norm);
    eval_staged(w);
  }
  __syncwarp();  // the product's reads of the buffer are done
  float cvs[WB_SLOTS];
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    [[maybe_unused]] const int t = w.ts(s);
    float tr[NJ], ve[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if constexpr (EXACT || BASE) {
        tr[j] = w.traj[s][j];
        ve[j] = w.vel[s][j];
      } else {
        tr[j] = w.traj[s][j] - lr * w.dir_t[j * T + t];
        ve[j] = w.vel[s][j] - lr * w.dir_v[j * T + t];
      }
    }
    cvs[s] = rung_point(p, w, s, tr, ve);
  }
  int first;
  return cost_reduce(p, w, cvs, true, first);
}

// The hard-constraint check on the exact (traj, vel).
static __device__ __forceinline__ bool constraints_ok(const FsParams& p,
                                                      const Warp& w) {
  __syncwarp();
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      put_row(w, j, s, w.traj[s][j]);
      put_row(w, NJ + j, s, w.vel[s][j]);
    }
  return rows_ok(p, w);
}

// ---------------------------------------------------------------------------
// The streamed body and K7, its basis product.
// ---------------------------------------------------------------------------

// K7: rows [0, rows) of M @ in, with M (rows, n_t) given transposed in
// device memory (MT[t * ws_ld(rows) + r] = M[r][t]) and in the buffer's
// n_t staged float4 (one per t, J joints).  Thread lid computes the rows
// r = 32 g + lid, each one sequential fmaf chain over t = 0 .. n_t - 1 per
// joint, and hands it to sink(r, acc0, acc1, acc2) (rows past ``rows`` too:
// the padding's zeros, which the sink drops).  At each t the warp reads one
// aligned 128-byte line of MT through the read-only cache (__ldg) and one
// broadcast float4 of the input.
template <class SW, class Sink>
static __device__ __forceinline__ void k7_product(const SW& w,
                                                  const float* MT, int rows,
                                                  int n_t, Sink sink) {
  const int ld = ws_ld(rows), groups = (rows + 31) >> 5;
  const float4* in = (const float4*)w.buf;
  __syncwarp();  // the staged input is visible
  for (int g = 0; g < groups; ++g) {
    const float* col = MT + 32 * g + w.lid;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int t = 0; t < n_t; ++t) {
      const float4 a = in[t];
      const float kk = __ldg(col + (size_t)t * ld);
      a0 = fmaf(kk, a.x, a0);
      a1 = fmaf(kk, a.y, a1);
      a2 = fmaf(kk, a.z, a2);
    }
    sink(32 * g + w.lid, a0, a1, a2);
  }
  __syncwarp();  // the sink's rows are visible to their owners
}

// (traj, vel) = the staged input through kv, into the traj/vel planes.
static __device__ __forceinline__ void eval_staged(SWarp& w) {
  const int T = w.T;
  k7_product(w, w.kvT, 2 * T, T, [&](int r, float a0, float a1, float a2) {
    if (r >= 2 * T) return;
    float* out = r < T ? w.traj + r : w.vel + (r - T);
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      float v = a0 * w.mix[0 * NJ + i];
      v = v + a1 * w.mix[1 * NJ + i];
      v = v + a2 * w.mix[2 * NJ + i];
      out[i * T] = v;
    }
  });
}

// The search direction (the resident direction's, through K7; the bf16
// tier's program runs the half-width body instead).
template <bool HALF>
static __device__ __forceinline__ void direction(const FsParams& p, SWarp& w,
                                                 float inv_norm) {
  static_assert(!HALF, "the bf16 tier streams through HWarp");
  const int T = w.T;
  stage_input(w, w.grad, inv_norm);
  k7_product(w, w.kvT, 2 * T, T, [&](int r, float a0, float a1, float a2) {
    if (r >= 2 * T) return;
    const bool pos = r < T;
    const int t = pos ? r : r - T;
    const float* x = pos ? w.traj : w.vel;
    float* d = pos ? w.dir_t : w.dir_v;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      float v = a0 * w.mix[0 * NJ + i];
      v = v + a1 * w.mix[1 * NJ + i];
      v = v + a2 * w.mix[2 * NJ + i];
      d[i * T + t] = p.lambda_reg * x[i * T + t] + v;
    }
  });
}

// The ultra tier's step start (the resident eval_start's).
template <bool HALF>
static __device__ __forceinline__ void eval_start(SWarp& w) {
  static_assert(!HALF, "the bf16 tier streams through HWarp");
  stage_input(w, w.alpha, 1.f);
  eval_staged(w);
}

// The accepted BLS step (the resident accept_step's, on the planes).
template <bool EXACT, bool FUSED>
static __device__ __forceinline__ void accept_step(const FsParams& p,
                                                   SWarp& w, float lr_eff,
                                                   float inv_norm) {
  const int T = w.T;
  const float a_fac = 1.f - p.lambda_reg * lr_eff;
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = j * T + t;
      w.alpha[i] = new_alpha<FUSED>(a_fac, w.alpha[i], lr_eff,
                                    w.grad[i] * inv_norm);
      if constexpr (!EXACT) {
        w.traj[i] = w.traj[i] - lr_eff * w.dir_t[i];
        w.vel[i] = w.vel[i] - lr_eff * w.dir_v[i];
      }
    }
  }
}

// The own timesteps' (traj, vel) from the planes.
static __device__ __forceinline__ void load_point(const SWarp& w, int t,
                                                  float* tr, float* ve) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    tr[j] = w.traj[j * w.T + t];
    ve[j] = w.vel[j * w.T + t];
  }
}

// This thread's first argmax over its timesteps (ascending t, so a strict
// > keeps the first), then the warp's by the shuffle tree, and the loss
// from the cost rows when want_loss.  Every thread owns group 0 (T >= 32).
// For both streamed bodies (SWarp, HWarp), as are cost_pass, grad_pass and
// constraints_ok, which read the iterate through load_point.
template <class SW>
static __device__ __forceinline__ float cost_reduce(const FsParams& p,
                                                    const SW& w, float m,
                                                    int f, bool want_loss,
                                                    int& first) {
  argmax_tree(m, f);
  first = f;
  if (!want_loss) return 0.f;
  return rows_loss(p, w, m, f);
}

// Pass A (the resident cost_pass's, from the planes).
template <class SW>
static __device__ __forceinline__ float cost_pass(const FsParams& p, SW& w,
                                                  bool want_loss, int& first) {
  __syncwarp();  // the buffer's last readers are done
  float m = 0.f;
  int f = 0;
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    float tr[NJ], ve[NJ];
    load_point(w, t, tr, ve);
    const float cv =
        cost_point(p, w, g, tr, ve, want_loss, w.gx[t], w.gy[t]);
    if (g == 0 || cv > m) {
      m = cv;
      f = t;
    }
  }
  return cost_reduce(p, w, m, f, want_loss, first);
}

// Passes B and C (the resident grad_pass's; pass C through K7 over kvt).
template <class SW>
static __device__ __forceinline__ void grad_pass(const FsParams& p, SW& w,
                                                 int first) {
  const int T = w.T;
  float4* stack = (float4*)w.buf;
  __syncwarp();
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    float tr[NJ], ve[NJ], gp[NJ], gv[NJ];
    load_point(w, t, tr, ve);
    stacked_grad(p, w, t, first, tr, ve, w.gx[t], w.gy[t], gp, gv);
    stack[t] = make_float4(gp[0], gp[1], gp[2], 0.f);
    stack[T + t] = make_float4(gv[0], gv[1], gv[2], 0.f);
  }
  k7_product(w, w.kvtT, T, 2 * T, [&](int r, float a0, float a1, float a2) {
    if (r >= T) return;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float v = a0 * w.mix[j * NJ + 0];
      v = v + a1 * w.mix[j * NJ + 1];
      v = v + a2 * w.mix[j * NJ + 2];
      w.grad[j * T + r] = v;
    }
  });
}

// Loss of one ladder rung (the resident rung_cost's; the exact candidate's
// evaluation goes into the traj/vel planes).
template <bool EXACT, bool BASE = false>
static __device__ __forceinline__ float rung_cost(const FsParams& p, SWarp& w,
                                                  float lr, float inv_norm) {
  static_assert(!BASE, "the bf16 tier streams through HWarp");
  const int T = w.T;
  if constexpr (EXACT) {
    stage_candidate<SWarp, true>(w, 1.f - p.lambda_reg * lr, lr, inv_norm);
    eval_staged(w);
  }
  __syncwarp();  // the product's reads of the buffer are done
  float m = 0.f;
  int f = 0;
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    float tr[NJ], ve[NJ];
    load_point(w, t, tr, ve);
    if constexpr (!EXACT) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        tr[j] = tr[j] - lr * w.dir_t[j * T + t];
        ve[j] = ve[j] - lr * w.dir_v[j * T + t];
      }
    }
    const float cv = rung_point(p, w, g, tr, ve);
    if (g == 0 || cv > m) {
      m = cv;
      f = t;
    }
  }
  int first;
  return cost_reduce(p, w, m, f, true, first);
}

// The hard-constraint check on the exact (traj, vel) planes.
template <class SW>
static __device__ __forceinline__ bool constraints_ok(const FsParams& p,
                                                      const SW& w) {
  __syncwarp();
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    float tr[NJ], ve[NJ];
    load_point(w, w.tt(g), tr, ve);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      put_row(w, j, g, tr[j]);
      put_row(w, NJ + j, g, ve[j]);
    }
  }
  return rows_ok(p, w);
}

// ---------------------------------------------------------------------------
// The half-width streamed body (HWarp, the bf16 tier's program): the pieces
// that read or write the ladder planes.
// ---------------------------------------------------------------------------

// (traj, vel) = the staged input through kv, float32, into the ladder room
// (the round start's and end's evaluation).
static __device__ __forceinline__ void eval_staged(HWarp& w) {
  const int T = w.T;
  k7_product(w, w.kvT, 2 * T, T, [&](int r, float a0, float a1, float a2) {
    if (r >= 2 * T) return;
    float* out = r < T ? w.traj + r : w.vel + (r - T);
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      float v = a0 * w.mix[0 * NJ + i];
      v = v + a1 * w.mix[1 * NJ + i];
      v = v + a2 * w.mix[2 * NJ + i];
      out[i * T] = v;
    }
  });
  w.half = false;
}

// The step start: the exact evaluation of alpha, rounded to bfloat16, into
// traj_h/vel_h.
template <bool HALF>
static __device__ __forceinline__ void eval_start(HWarp& w) {
  static_assert(HALF, "HWarp runs the bf16 tier only");
  const int T = w.T;
  stage_input(w, w.alpha, 1.f);
  k7_product(w, w.kvT, 2 * T, T, [&](int r, float a0, float a1, float a2) {
    if (r >= 2 * T) return;
    __nv_bfloat16* out = r < T ? w.traj_h + r : w.vel_h + (r - T);
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      float v = a0 * w.mix[0 * NJ + i];
      v = v + a1 * w.mix[1 * NJ + i];
      v = v + a2 * w.mix[2 * NJ + i];
      out[i * T] = __float2bfloat16_rn(v);
    }
  });
}

// The search direction (the resident direction<true>'s), into dir_th/dir_vh.
template <bool HALF>
static __device__ __forceinline__ void direction(const FsParams& p, HWarp& w,
                                                 float inv_norm) {
  static_assert(HALF, "HWarp runs the bf16 tier only");
  const int T = w.T;
  const float lam = bf16_round(p.lambda_reg);
  stage_input(w, w.grad, inv_norm);
  k7_product(w, w.kvT, 2 * T, T, [&](int r, float a0, float a1, float a2) {
    if (r >= 2 * T) return;
    const bool pos = r < T;
    const int t = pos ? r : r - T;
    const __nv_bfloat16* x = pos ? w.traj_h : w.vel_h;
    __nv_bfloat16* d = pos ? w.dir_th : w.dir_vh;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      float v = a0 * w.mix[0 * NJ + i];
      v = v + a1 * w.mix[1 * NJ + i];
      v = v + a2 * w.mix[2 * NJ + i];
      d[i * T + t] =
          __float2bfloat16_rn(lam * __bfloat162float(x[i * T + t]) + v);
    }
  });
}

// The accepted BLS step: alpha on the own timesteps; the iterate is formed
// per timestep from then on (load_point).
template <bool EXACT, bool FUSED>
static __device__ __forceinline__ void accept_step(const FsParams& p,
                                                   HWarp& w, float lr_eff,
                                                   float inv_norm) {
  static_assert(!EXACT && FUSED, "HWarp runs the bf16 tier only");
  const int T = w.T;
  const float a_fac = 1.f - p.lambda_reg * lr_eff;
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = j * T + t;
      w.alpha[i] = new_alpha<FUSED>(a_fac, w.alpha[i], lr_eff,
                                    w.grad[i] * inv_norm);
    }
  }
  w.lr_acc = lr_eff;
  w.half = true;
}

// The iterate at timestep t: the accepted linearized one (traj_h - lr_acc
// dir_th, in float32, the accept_step of the other bodies) or the float32
// evaluation.
static __device__ __forceinline__ void load_point(const HWarp& w, int t,
                                                  float* tr, float* ve) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int i = j * w.T + t;
    if (w.half) {
      tr[j] = __bfloat162float(w.traj_h[i]) -
              w.lr_acc * __bfloat162float(w.dir_th[i]);
      ve[j] = __bfloat162float(w.vel_h[i]) -
              w.lr_acc * __bfloat162float(w.dir_vh[i]);
    } else {
      tr[j] = w.traj[i];
      ve[j] = w.vel[i];
    }
  }
}

// Loss of one ladder rung from the half-width planes (BASE: the zero-lr
// candidate, the baseline).
template <bool EXACT, bool BASE = false>
static __device__ __forceinline__ float rung_cost(const FsParams& p, HWarp& w,
                                                  float lr, float inv_norm) {
  static_assert(!EXACT, "HWarp runs the bf16 tier only");
  const int T = w.T;
  __syncwarp();  // the buffer's last readers are done
  float m = 0.f;
  int f = 0;
  for (int g = 0; g < w.G; ++g) {
    if (!w.owns(g)) continue;
    const int t = w.tt(g);
    float tr[NJ], ve[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = j * T + t;
      tr[j] = __bfloat162float(w.traj_h[i]);
      ve[j] = __bfloat162float(w.vel_h[i]);
      if constexpr (!BASE) {
        tr[j] = tr[j] - lr * __bfloat162float(w.dir_th[i]);
        ve[j] = ve[j] - lr * __bfloat162float(w.dir_vh[i]);
      }
    }
    const float cv = rung_point(p, w, g, tr, ve);
    if (g == 0 || cv > m) {
      m = cv;
      f = t;
    }
  }
  int first;
  return cost_reduce(p, w, m, f, true, first);
}

// ---------------------------------------------------------------------------
// The BLS and GD steps and the round, for either body (W = Warp or SWarp).
// ---------------------------------------------------------------------------

// (traj, vel) = the exact evaluation of alpha.
template <class W>
static __device__ __forceinline__ void eval_alpha(W& w) {
  stage_input(w, w.alpha, 1.f);
  eval_staged(w);
}

// The programs of the round body (template argument, never a run-time
// switch): the index ops/fused_solve.py's PROGRAMS gives each.  BLS has one
// per ladder tier, and the linearized ladder one per kernel tier that
// changes its floats (ultra, bf16: pallas_step's ultra/bf16 compilations;
// its lean compilation is SOLVER_BLS here, see bls_step).
#define SOLVER_BLS 0
#define SOLVER_GD 1
#define SOLVER_BLS_EXACT 2
#define SOLVER_BLS_ULTRA 3
#define SOLVER_BLS_BF16 4

// One BLS inner step of a live lane (the lane body's bls_step<EXACT>, and
// pallas_step's _bls_step in each tier): normalized direction, the
// early-exit Armijo ladder (first pass wins), the accepted iterate, and the
// gradient pulled back at it unless the stop test fired.  Returns stop.
//
// Linearized (SOLVER_BLS): the direction's forward evaluation, the ladder
// on the linearized trajectory, and the FK carry: the pull-back's cost pass
// recomputes FK at the accepted candidate, the same floats, and the rung's
// loss is kept.  It is also pallas_step's lean tier, which recomputes that
// loss: the accepted candidate is formed by the rung's own operations, so
// the recompute would give the rung's floats.  SOLVER_BLS_ULTRA: the loss
// recomputed in the cost pass (K3's mode), with (traj, vel) first evaluated
// exactly from alpha, so the linearized drift never builds up, and the new
// alpha rounded once (new_alpha), as XLA contracts it into an FMA on the
// CPU: at large T alpha's O(1e4) coefficients round at the step's size, and
// a second rounding parts the next step start's exact evaluation from the
// linearized iterate whose loss is its Armijo baseline.  SOLVER_BLS_BF16:
// ultra with that evaluation and the direction rounded to bfloat16 (HALF)
// and the Armijo/stop baseline the zero-lr candidate's loss, evaluated like
// a rung; a stop keeps the accepted rung's loss, as in every program.
// EXACT: each rung evaluates its candidate alpha through the basis
// (rung_cost<true>), and the accepted iterate's (traj, vel) are its exact
// evaluation: the accepted rung's, left in traj/vel (its staged candidate
// is the new alpha's floats: both rounded once, as XLA forms them), or,
// when no rung passed, alpha's evaluated anew; unless the stop test fires,
// the cost pass recomputes the loss there.  The carry program alone rounds
// the new alpha twice: once, it moves bench.py's reference scene past the
// strict endpoint gate (PERF.md section 7).
template <int SOLVER, class W>
static __device__ __forceinline__ bool bls_step(const FsParams& p, W& w,
                                                float& loss, float& lr) {
  constexpr bool EXACT = SOLVER == SOLVER_BLS_EXACT;
  constexpr bool HALF = SOLVER == SOLVER_BLS_BF16;
  constexpr bool ULTRA = HALF || SOLVER == SOLVER_BLS_ULTRA;
  constexpr bool CARRY = SOLVER == SOLVER_BLS;
  if constexpr (ULTRA) eval_start<HALF>(w);
  float inv_norm, alpha_norm;
  grad_norms(w, inv_norm, alpha_norm);
  if constexpr (!EXACT) direction<HALF>(p, w, inv_norm);
  float base = loss;
  if constexpr (HALF) base = rung_cost<false, true>(p, w, 0.f, inv_norm);

  bool found = false;
  float lr_best = 0.f, loss_best = base, rung = 1.f;
  for (int k = 0; k < p.n_bls; ++k) {
    const float lr_r = lr * rung;
    const float closs = rung_cost<EXACT>(p, w, lr_r, inv_norm);
    const float required = base - p.bls_alpha * lr_r * alpha_norm;
    if (closs <= required) {  // first pass wins
      found = true;
      lr_best = lr_r;
      loss_best = closs;
      break;
    }
    rung = rung * p.beta_minus;
  }
  const float lr_eff = found ? lr_best : 0.f;
  const float new_lr = found ? lr_best * p.beta_plus : lr * p.lr_fail;
  const bool stop = (base - loss_best) < p.loss_red;

  accept_step<EXACT, !CARRY>(p, w, lr_eff, inv_norm);
  if constexpr (EXACT) {
    if (!found) eval_alpha(w);
  }
  float nloss = loss_best;
  if (!stop) {
    int first;
    if constexpr (CARRY)
      cost_pass(p, w, false, first);
    else
      nloss = cost_pass(p, w, true, first);
    grad_pass(p, w, first);
  }
  loss = nloss;
  lr = new_lr;
  return stop;
}

// One GD inner step of a live lane (pallas_step._gd_step; K1/K2's and
// K4's): the trial (1 - lambda_reg lr) alpha - lr grad, staged as a
// product input; its forward rows into traj/vel; the cost pass with the
// loss; the stop test, which REJECTS the trial; only when it does not fire,
// alpha becomes the trial (recomputed from the untouched alpha and grad:
// the same floats) and the gradient pass runs at it.  No plane beyond
// BLS's: on a reject alpha, grad and ``loss`` are untouched and only
// traj/vel hold the trial's evaluation, which the round's caller restores.
// Returns stop.
template <class W>
static __device__ __forceinline__ bool gd_step(const FsParams& p, W& w,
                                               float& loss, float lr) {
  const float a_fac = 1.f - p.lambda_reg * lr;
  stage_candidate<W, false>(w, a_fac, lr, 1.f);
  eval_staged(w);
  int first;
  const float nloss = cost_pass(p, w, true, first);
  if ((loss - nloss) < p.loss_red) return true;
  accept_trial(w, a_fac, lr);
  grad_pass(p, w, first);
  loss = nloss;
  return false;
}

// One penalty round of a live lane under its current penalties (the lane
// body's round): round-start exact evaluation, loss and gradient; up to n_r
// steps of SOLVER from learning rate lr0; the exact evaluation at the final
// alpha and the constraint check.  Returns whether the constraints hold;
// the round's final loss goes to ``loss`` and each step after which the
// lane is still live adds one to ``inner``.  ``evaluated``: traj and vel
// already hold the exact evaluation of alpha (the previous round's end, in
// K1), the same values the round-start evaluation would give.
//
// The exact evaluation at the end: BLS with the linearized ladder
// re-evaluates from alpha in every program (its linearized iterate
// drifts; the ultra and bf16 tiers carry no evaluation).  The exact
// ladder's carried (traj, vel) are exact already, and so are GD's, so the
// JAX kernel skips the re-evaluation for both; here too, except after GD's
// rejected trial, whose evaluation gd_step left in traj/vel: the carried
// one is rebuilt from the untouched alpha, the same floats bit for bit.
template <int SOLVER, class W>
static __device__ __forceinline__ bool warp_round(const FsParams& p, W& w,
                                                  int n_r, float lr0,
                                                  float& loss, float& inner,
                                                  bool evaluated) {
  if (!evaluated) eval_alpha(w);
  int first;
  loss = cost_pass(p, w, true, first);
  grad_pass(p, w, first);
  if constexpr (SOLVER == SOLVER_GD) {
    bool rejected = false;
    for (int k = 0; k < n_r; ++k) {
      rejected = gd_step(p, w, loss, lr0);
      if (rejected) break;
      inner += 1.f;  // live before the step and after it
    }
    if (rejected) eval_alpha(w);
  } else {
    float lr = lr0;
    for (int k = 0; k < n_r; ++k) {
      if (bls_step<SOLVER>(p, w, loss, lr)) break;
      inner += 1.f;  // live before the step and after it
    }
    if constexpr (SOLVER != SOLVER_BLS_EXACT) eval_alpha(w);
  }
  return constraints_ok(p, w);
}
