// The warp body of the fused kernels K1 and K2 (fused_solve.cu): ONE WARP
// PER LANE.  The 32 threads of a warp share one lane's T timesteps, thread
// i owning t = i and t = i + 32 (T <= 64), so every loop over rungs, steps
// and rounds is per lane and warp-uniform.  No per-lane state lives in
// device memory: a lane's alpha, penalties and scene are read once and its
// alpha and results written once.
//
// Where the state lives.  In registers, each thread's timesteps of traj,
// vel and the obstacle-gradient planes gx, gy (read by every ladder rung or
// written and read within one evaluation).  In per-warp shared memory, the
// planes alpha, grad, dir_t and dir_v (J, T) (each thread touches only its
// own timesteps of them; between an evaluation's passes the direction
// planes hold its FK tangents), one buffer that holds in turn the staged
// input of a basis product (float4 per timestep: one broadcast load gives
// all J joints), the stacked gradient of the pull-back, or the rows of a
// reduction, the lane's obstacle terms (float4 per obstacle: ox, oy,
// q_o = 0.5 + 0.5 |o|^2, 0.8 w_o) and the lane's endpoints.  Per CTA, the
// basis pair transposed: kvT[t][r] = kv[r][t] and kvtT[t2][r] = kvt[r][t2],
// so the 32 output rows a warp computes at once are 32 neighbouring words
// (no bank conflicts), and mix.
//
// Op order.  Every basis-product row is the sequential fmaf chain over t of
// the lane body (lane_body.cuh, which K3-K6 are built from), followed by
// the same mix combine; every sum over t (the cost sums, the gradient norm,
// alpha_norm) and the constraint extrema are the lane body's sequential
// chains, each run by one thread over a row the owners wrote and broadcast
// with __shfl_sync; the blend's first argmax is a shuffle tree, which
// rounds nothing.  Each lane therefore runs the lane body's op sequence
// (its bls_step or gd_step), and K1/K2 give the one-thread-per-lane
// kernels' results bit for bit.  FK and the penalized loss are the lane
// body's own functions.

#pragma once

#include "lane_body.cuh"

#define WB_SLOTS 2                 // timesteps per thread
#define WB_MAX_T (32 * WB_SLOTS)
#ifndef WB_MAX_WARPS
#define WB_MAX_WARPS 16            // warps (lanes in flight) per CTA
#endif
#ifndef WB_MIN_CTAS
#define WB_MIN_CTAS 2              // CTAs of WB_MAX_WARPS per SM: <= 64 regs
#endif
#define WB_ROWS 8                  // reduction rows in the buffer
#define WB_LANE_FLOATS 20          // start, goal, t0, tN, v0, vN (+2 pad)
#define FULL_MASK 0xffffffffu

// The shared-memory plan (floats); mirror of launch_plan in
// ops/fused_solve.py.  A reduction row is padded to a multiple of 4 floats
// so a chain reads it as float4.
__host__ __device__ __forceinline__ int wb_row_stride(int T) {
  return (T + 3) & ~3;
}
__host__ __device__ __forceinline__ size_t wb_basis_floats(int T) {
  return (size_t)4 * T * T + 12;  // kvT, kvtT, mix (padded to 12)
}
__host__ __device__ __forceinline__ size_t wb_warp_floats(int T, int O) {
  return (size_t)4 * NJ * T + (size_t)WB_ROWS * wb_row_stride(T) +
         (size_t)4 * O + WB_LANE_FLOATS;
}
static size_t warp_smem_bytes(const FsParams& p, int warps) {
  return sizeof(float) *
         (wb_basis_floats(p.T) + (size_t)warps * wb_warp_floats(p.T, p.O));
}

// One warp's view of its lane: per-CTA basis, the per-warp planes and
// buffers, and this thread's timesteps in registers.
struct Warp {
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

  // This thread's timestep in slot s: thread i owns t = i and i + 32, so
  // the warp's 32 threads touch 32 neighbouring words of a plane or row.
  __device__ __forceinline__ int tt(int s) const { return lid + 32 * s; }
  // The same, clamped to T - 1 for the slots past T (they compute a copy of
  // t = T - 1 that nothing stores).
  __device__ __forceinline__ int ts(int s) const { return min(tt(s), T - 1); }
  __device__ __forceinline__ bool owns(int s) const { return tt(s) < T; }
};

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

// The warp's next lane from the device queue (lane 0 draws, all receive).
static __device__ __forceinline__ int next_lane(int* queue, int lid) {
  int b = 0;
  if (lid == 0) b = atomicAdd(queue, 1);
  return __shfl_sync(FULL_MASK, b, 0);
}

// Read lane b's alpha (J, T, B), scene and endpoints into the warp's
// shared memory; the penalties into registers.
static __device__ __forceinline__ void load_lane(
    const FsParams& p, Warp& w, size_t b, const float* alpha,
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

static __device__ __forceinline__ void store_alpha(const FsParams& p,
                                                   const Warp& w, size_t b,
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
// for measurement, not bitwise: tools/fused_variants.py) every thread
// takes part in a shuffle tree per row instead.
static __device__ __forceinline__ float chains(const Warp& w, int n) {
  __syncwarp();  // the owners' rows are visible
  float sum = 0.f;
#ifdef WB_TREE_SUMS
  for (int k = 0; k < n; ++k) {
    const float* row = w.buf + k * w.RS;
    float x = (w.lid < w.T ? row[w.lid] : 0.f) +
              (w.lid + 32 < w.T ? row[w.lid + 32] : 0.f);
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

// The first argmax of the cost over t (the value and its first t) from the
// owners' values by a shuffle tree: the larger value wins, a tie goes to
// the smaller t.  For inputs without NaN this is the lane body's sequential
// `t == 0 || cv > cmax` result exactly (a max rounds nothing).
static __device__ __forceinline__ void tree_argmax(const Warp& w,
                                                   const float* cv, float& mx,
                                                   int& first) {
  float m = cv[0];
  int f = w.tt(0);
  if (w.owns(1) && cv[1] > m) {
    m = cv[1];
    f = w.tt(1);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float om = __shfl_xor_sync(FULL_MASK, m, off);
    const int of = __shfl_xor_sync(FULL_MASK, f, off);
    if (om > m || (om == m && of < f)) {
      m = om;
      f = of;
    }
  }
  mx = m;
  first = f;
}

// Write one timestep's value of reduction row k (owners only).
static __device__ __forceinline__ void put_row(const Warp& w, int k, int s,
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
static __device__ __forceinline__ void put_cost_rows(const FsParams& p,
                                                     const Warp& w, int s,
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

// The reduction of the cost rows: the blend's first argmax and, when
// want_loss, the penalized loss (the lane body's cost_total, on every
// thread from the same broadcast values: the result is warp-uniform).
static __device__ __forceinline__ float cost_reduce(const FsParams& p,
                                                    const Warp& w,
                                                    const float* cv,
                                                    bool want_loss,
                                                    int& first) {
  CostAcc a;
  tree_argmax(w, cv, a.cmax, first);
  if (!want_loss) return 0.f;
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

// ---------------------------------------------------------------------------
// Basis products.
// ---------------------------------------------------------------------------

// Stage src (J, T) * scale (per-warp plane, own timesteps) into the buffer
// as float4 per timestep.
static __device__ __forceinline__ void stage_input(const Warp& w,
                                                   const float* src,
                                                   float scale) {
  __syncwarp();
  float4* in = (float4*)w.buf;
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    if (!w.owns(s)) continue;
    const int t = w.tt(s);
    in[t] = make_float4(src[t] * scale, src[w.T + t] * scale,
                        src[2 * w.T + t] * scale, 0.f);
  }
  __syncwarp();
}

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

// (traj, vel) = the exact evaluation of alpha.
static __device__ __forceinline__ void eval_alpha(Warp& w) {
  stage_input(w, w.alpha, 1.f);
  eval_staged(w);
}

// ---------------------------------------------------------------------------
// The fused evaluation: cost pass (A) and gradient passes (B, C).
// ---------------------------------------------------------------------------

// Obstacle field at one end-effector point (the lane body's obstacle_point).
static __device__ __forceinline__ float field(const Warp& w, float ex,
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

// Pass A at the current (traj, vel): FK (its tangents kept for pass B in
// the direction planes, free from here to the next step's direction), the
// obstacle field and its factored gradient into gx/gy, the blend's first
// argmax and, when want_loss, the cost rows and their reduction.
static __device__ __forceinline__ float cost_pass(const FsParams& p, Warp& w,
                                                  bool want_loss, int& first) {
  __syncwarp();  // the buffer's last readers are done
  float cvs[WB_SLOTS];
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    float px[NJ], py[NJ], ex, ey;
    fk_point(p, w.traj[s], px, py, ex, ey);
    if (w.owns(s)) {  // the FK tangents for pass B, in the free dir planes
      const int t = w.tt(s);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        w.dir_t[j * w.T + t] = px[j];
        w.dir_v[j * w.T + t] = py[j];
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
    w.gx[s] = cox - ex * csum;
    w.gy[s] = coy - ey * csum;
    if (want_loss) put_cost_rows(p, w, s, cv, w.traj[s], w.vel[s]);
    cvs[s] = cv;
  }
  return cost_reduce(p, w, cvs, want_loss, first);
}

// Passes B and C: the stacked position/velocity gradient (float4 rows of
// the buffer, positions then velocities), then the pull-back through kvt
// and the mix^T combine, into grad.
static __device__ __forceinline__ void grad_pass(const FsParams& p, Warp& w,
                                                 int first) {
  const int T = w.T;
  const float* start = w.ends;
  const float* goal = w.ends + NJ;
  float4* stack = (float4*)w.buf;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    const int t = w.ts(s);
    const float* tr = w.traj[s];
    const float* ve = w.vel[s];
    float px[NJ], py[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      px[j] = w.dir_t[j * T + t];
      py[j] = w.dir_v[j * T + t];
    }
    const float wt = p.lam_max * (t == first ? 1.f : 0.f) + p.mean_w;
    const float wgx = wt * w.gx[s];
    const float wgy = wt * w.gy[s];
    float jx[NJ], jy[NJ], accx = 0.f, accy = 0.f;
#pragma unroll
    for (int j = NJ - 1; j >= 0; --j) {
      accx = accx + (-py[j]);
      accy = accy + px[j];
      jx[j] = accx;
      jy[j] = accy;
    }
    float gp[NJ], gv[NJ];
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

// ---------------------------------------------------------------------------
// The BLS and GD steps, the constraint check and the round.
// ---------------------------------------------------------------------------

// Loss of one ladder rung at learning rate lr.  Linearized: the candidate
// (traj - lr dir_t, vel - lr dir_v).  EXACT: the candidate alpha
// (1 - lambda_reg lr) alpha - lr (grad inv_norm), in the operand order of
// the accepted update, staged as a product input (float4 per timestep, as
// gd_step stages its trial) and evaluated through kv into the traj/vel
// registers, which the exact ladder does not read (bls_step re-evaluates
// them); then the same cost rows and reduction.
template <bool EXACT>
static __device__ __forceinline__ float rung_cost(const FsParams& p, Warp& w,
                                                  float lr, float inv_norm) {
  const int T = w.T;
  if constexpr (EXACT) {
    const float a_fac = 1.f - p.lambda_reg * lr;
    __syncwarp();  // the buffer's last readers are done
    float4* in = (float4*)w.buf;
#pragma unroll
    for (int s = 0; s < WB_SLOTS; ++s) {
      if (!w.owns(s)) continue;
      const int t = w.tt(s);
      in[t] = make_float4(
          a_fac * w.alpha[t] - lr * (w.grad[t] * inv_norm),
          a_fac * w.alpha[T + t] - lr * (w.grad[T + t] * inv_norm),
          a_fac * w.alpha[2 * T + t] - lr * (w.grad[2 * T + t] * inv_norm),
          0.f);
    }
    __syncwarp();
    eval_staged(w);
  }
  __syncwarp();  // the product's reads of the buffer are done
  float cvs[WB_SLOTS];
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    [[maybe_unused]] const int t = w.ts(s);
    float tr[NJ], ve[NJ], px[NJ], py[NJ], ex, ey;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if constexpr (EXACT) {
        tr[j] = w.traj[s][j];
        ve[j] = w.vel[s][j];
      } else {
        tr[j] = w.traj[s][j] - lr * w.dir_t[j * T + t];
        ve[j] = w.vel[s][j] - lr * w.dir_v[j * T + t];
      }
    }
    fk_point(p, tr, px, py, ex, ey);
    cvs[s] = field(w, ex, ey);
    put_cost_rows(p, w, s, cvs[s], tr, ve);
  }
  int first;
  return cost_reduce(p, w, cvs, true, first);
}

// One BLS inner step of a live lane (the lane body's bls_step<EXACT>):
// normalized direction, the early-exit Armijo ladder (first pass wins), the
// accepted iterate, and the gradient pulled back at it unless the stop test
// fired.  Returns stop.
//
// Linearized (EXACT false): the direction's forward evaluation, the ladder
// on the linearized trajectory, and the FK carry: the pull-back's cost pass
// recomputes FK at the accepted candidate, the same floats, and the rung's
// loss is kept.  EXACT: each rung evaluates its candidate alpha through the
// basis (rung_cost<true>), and the accepted iterate's (traj, vel) are its
// exact evaluation: the accepted rung's, left in the registers (its staged
// candidate is the new alpha's floats), or, when no rung passed, alpha's
// evaluated anew; unless the stop test fires, the cost pass recomputes the
// loss there.
template <bool EXACT>
static __device__ __forceinline__ bool bls_step(const FsParams& p, Warp& w,
                                                float& loss, float& lr) {
  const int T = w.T;
  // Gradient norm: per joint sum_t g^2, then their sum.
  __syncwarp();
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float g = w.grad[j * T + w.ts(s)];
      put_row(w, j, s, g * g);
    }
  float sum = chains(w, NJ);
  float g2 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) g2 = g2 + __shfl_sync(FULL_MASK, sum, j);
  const float inv_norm = 1.0f / sqrtf(g2);
  // Reference quirk: sum over all (J, J) entries of grad^T n_grad.
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    const int t = w.ts(s);
    float gs = w.grad[t];
#pragma unroll
    for (int j = 1; j < NJ; ++j) gs = gs + w.grad[j * T + t];
    put_row(w, 0, s, gs * (gs * inv_norm));
  }
  sum = chains(w, 1);
  const float alpha_norm = __shfl_sync(FULL_MASK, sum, 0);

  // The direction's forward evaluation, hoisted: dir = lambda_reg x + g.
  if constexpr (!EXACT) {
    stage_input(w, w.grad, inv_norm);
    float out[2 * WB_SLOTS][NJ];
    forward_rows(w, out);
#pragma unroll
    for (int s = 0; s < WB_SLOTS; ++s) {
      if (!w.owns(s)) continue;
      const int t = w.tt(s);
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        w.dir_t[i * T + t] = p.lambda_reg * w.traj[s][i] + out[s][i];
        w.dir_v[i * T + t] = p.lambda_reg * w.vel[s][i] + out[WB_SLOTS + s][i];
      }
    }
  }

  bool found = false;
  float lr_best = 0.f, loss_best = loss, rung = 1.f;
  for (int k = 0; k < p.n_bls; ++k) {
    const float lr_r = lr * rung;
    const float closs = rung_cost<EXACT>(p, w, lr_r, inv_norm);
    const float required = loss - p.bls_alpha * lr_r * alpha_norm;
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
  const bool stop = (loss - loss_best) < p.loss_red;

  const float a_fac = 1.f - p.lambda_reg * lr_eff;
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    const int t = w.ts(s);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = j * T + t;
      if (w.owns(s))
        w.alpha[i] = a_fac * w.alpha[i] - lr_eff * (w.grad[i] * inv_norm);
      if constexpr (!EXACT) {
        w.traj[s][j] = w.traj[s][j] - lr_eff * w.dir_t[i];
        w.vel[s][j] = w.vel[s][j] - lr_eff * w.dir_v[i];
      }
    }
  }
  if constexpr (EXACT) {
    if (!found) eval_alpha(w);
  }
  float nloss = loss_best;
  if (!stop) {
    int first;
    if constexpr (EXACT)
      nloss = cost_pass(p, w, true, first);
    else
      cost_pass(p, w, false, first);
    grad_pass(p, w, first);
  }
  loss = nloss;
  lr = new_lr;
  return stop;
}

// The hard-constraint check on the exact (traj, vel): the lane body's
// constraints_ok, its extrema chains run by thread 0 over rows 0..2J-1.
static __device__ __forceinline__ bool constraints_ok(const FsParams& p,
                                                      const Warp& w) {
  const int T = w.T, RS = w.RS;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      put_row(w, j, s, w.traj[s][j]);
      put_row(w, NJ + j, s, w.vel[s][j]);
    }
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

// One GD inner step of a live lane (the lane body's gd_step, same op
// sequence): the trial (1 - lambda_reg lr) alpha - lr grad, staged as a
// product input; its forward rows into traj/vel; the cost pass with the
// loss; the stop test, which REJECTS the trial; only when it does not fire,
// alpha becomes the trial (recomputed from the untouched alpha and grad:
// the same floats) and the gradient pass runs at it.  No plane beyond
// BLS's: on a reject alpha, grad and ``loss`` are untouched and only
// traj/vel hold the trial's evaluation, which the round's caller restores.
// Returns stop.
static __device__ __forceinline__ bool gd_step(const FsParams& p, Warp& w,
                                               float& loss, float lr) {
  const int T = w.T;
  const float a_fac = 1.f - p.lambda_reg * lr;
  __syncwarp();  // the buffer's last readers are done
  float4* in = (float4*)w.buf;
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    if (!w.owns(s)) continue;
    const int t = w.tt(s);
    in[t] = make_float4(a_fac * w.alpha[t] - lr * w.grad[t],
                        a_fac * w.alpha[T + t] - lr * w.grad[T + t],
                        a_fac * w.alpha[2 * T + t] - lr * w.grad[2 * T + t],
                        0.f);
  }
  __syncwarp();
  eval_staged(w);
  int first;
  const float nloss = cost_pass(p, w, true, first);
  if ((loss - nloss) < p.loss_red) return true;
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    if (!w.owns(s)) continue;
    const int t = w.tt(s);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = j * T + t;
      w.alpha[i] = a_fac * w.alpha[i] - lr * w.grad[i];
    }
  }
  grad_pass(p, w, first);
  loss = nloss;
  return false;
}

// The programs of the round body (template argument, never a run-time
// switch): the index ops/fused_solve.py's PROGRAMS gives each.  BLS has one
// per ladder tier.
#define SOLVER_BLS 0
#define SOLVER_GD 1
#define SOLVER_BLS_EXACT 2

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
// re-evaluates from alpha (its linearized carry drifts).  The exact
// ladder's carried (traj, vel) are exact already, and so are GD's, so the
// JAX kernel skips the re-evaluation for both; here too, except after GD's
// rejected trial, whose evaluation gd_step left in traj/vel: the carried
// one is rebuilt from the untouched alpha, the same floats bit for bit.
template <int SOLVER>
static __device__ __forceinline__ bool warp_round(const FsParams& p, Warp& w,
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
      if (bls_step<SOLVER == SOLVER_BLS_EXACT>(p, w, loss, lr)) break;
      inner += 1.f;  // live before the step and after it
    }
    if constexpr (SOLVER == SOLVER_BLS) eval_alpha(w);
  }
  return constraints_ok(p, w);
}
