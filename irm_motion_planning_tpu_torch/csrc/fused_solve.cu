// Fused whole-solve BLS kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel irm_motion_planning_tpu/ops/pallas_step.py:
// fused_solve / _make_solve_kernel(solver="bls", per_round=False) with
// ladder_eval="linearized", the FK carry and the exact end-of-round
// constraint evaluation.  It computes what that kernel computes, lane by
// lane; it is not a block-by-block copy of it.
//
// Design (first, simple version): ONE THREAD PER LANE.  Each thread runs its
// lane's whole penalty-method solve: per round the fused cost/gradient
// evaluation, the inner BLS loop (normalized direction, Armijo ladder on the
// linearized trajectory, first pass wins, gradient pull-back), the exact
// re-evaluation of (traj, vel), the hard-constraint check and the x10
// penalty escalation.  A thread stops its ladder at its lane's first Armijo
// pass, its inner loop once its lane is minimized, and its rounds once its
// lane is fulfilled: per-lane results do not depend on how lanes are
// grouped, so this equals the TPU kernel's whole-tile skips.
//
// What bounds it on this card:
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
// wgmma, TMA and register tiling across lanes are for later versions.
//
// Built with -fmad=false: separate multiplies and adds round as they do in
// the plain PyTorch version; the basis products use explicit fmaf.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define NJ 3
#define MAX_ROUNDS 32
#define ROWS 10

// Mirror of _Params in ops/fused_solve.py (same order, all 4-byte fields).
struct FsParams {
  int T, O, B, rounds, n_bls, masked;
  int sched[MAX_ROUNDS];
  float link[3];
  float mean_jp, inv_std_jp_h, inv_vmax_h, inv_T, inv_std2_T, inv_vmax2_T;
  float lam_max, mean_w, pos_hi, pos_lo, vel_hi;
  float lambda_reg, bls_alpha, beta_plus, beta_minus, lr_fail, lr_start;
  float loss_red, inc, eps_pos, eps_vel, max_jp, min_jp, max_jv;
};

// Per-thread view of one lane.
struct Lane {
  size_t b, B;
  int T, O, BT;
  const float* kv;   // shared (2T, T)
  const float* kvt;  // shared (T, 2T)
  const float* mix;  // shared (J, J)
  const float* ox;   // shared, this lane's column; element o at [o * BT]
  const float* oy;
  const float* q;
  const float* ow8;
  float start[NJ], goal[NJ];
  float lam_sg, lam_jl;
  float *alpha, *grad, *traj, *vel, *dir_t, *dir_v, *gx, *gy;

  __device__ __forceinline__ size_t at(int j, int t) const {
    return ((size_t)j * T + t) * B + b;
  }
  __device__ __forceinline__ size_t at2(int t) const {
    return (size_t)t * B + b;
  }
};

// Forward kinematics at one timestep: tangent terms and end effector.
__device__ __forceinline__ void fk_point(const FsParams& p, const float* a,
                                         float* px, float* py, float& ex,
                                         float& ey) {
  float c = a[0];
  for (int j = 0; j < NJ; ++j) {
    if (j > 0) c = c + a[j];
    float s, co;
    sincosf(c, &s, &co);
    px[j] = p.link[j] * co;
    py[j] = p.link[j] * s;
  }
  ex = px[0];
  ey = py[0];
  for (int j = 1; j < NJ; ++j) {
    ex = ex + px[j];
    ey = ey + py[j];
  }
}

// Running reductions of the scalar cost over the timesteps.
struct CostAcc {
  float cmax, csum;
  int first;
  float psum[NJ], vsum[NJ];
};

__device__ __forceinline__ void cost_init(CostAcc& a) {
  a.cmax = -INFINITY;
  a.csum = 0.f;
  a.first = 0;
  for (int j = 0; j < NJ; ++j) a.psum[j] = a.vsum[j] = 0.f;
}

// Fold one timestep's obstacle cost and masked limit losses into the sums.
__device__ __forceinline__ void cost_add(const FsParams& p, CostAcc& a, int t,
                                         float cv, const float* tr,
                                         const float* ve) {
  if (t == 0 || cv > a.cmax) {  // first argmax wins a tie
    a.cmax = cv;
    a.first = t;
  }
  a.csum = a.csum + cv;
  for (int j = 0; j < NJ; ++j) {
    float zp = (tr[j] - p.mean_jp) * p.inv_std_jp_h;
    float pl = zp * zp;
    float zv = ve[j] * p.inv_vmax_h;
    float vl = zv * zv;
    if (p.masked) {
      if (!(tr[j] > p.pos_hi || tr[j] < p.pos_lo)) pl = 0.f;
      if (!(fabsf(ve[j]) > p.vel_hi)) vl = 0.f;
    }
    a.psum[j] = a.psum[j] + pl;
    a.vsum[j] = a.vsum[j] + vl;
  }
}

// The penalized loss from the sums and the endpoint values.
__device__ __forceinline__ float cost_total(const FsParams& p, const Lane& L,
                                            const CostAcc& a, const float* t0,
                                            const float* tN, const float* v0,
                                            const float* vN) {
  float toc = p.lam_max * a.cmax + p.mean_w * a.csum;
  float sgpc = 0.f, sgvc = 0.f, jpc = 0.f, jvc = 0.f;
  for (int j = 0; j < NJ; ++j) {
    float ds = t0[j] - L.start[j];
    float dg = tN[j] - L.goal[j];
    sgpc = sgpc + 0.5f * (ds * ds + dg * dg);
    sgvc = sgvc + 0.5f * (v0[j] * v0[j] + vN[j] * vN[j]);
    jpc = jpc + a.psum[j] * p.inv_T;
    jvc = jvc + a.vsum[j] * p.inv_T;
  }
  return toc + L.lam_sg * (sgpc + sgvc) + L.lam_jl * (jpc + jvc);
}

// Obstacle field at one end-effector point.
__device__ __forceinline__ float obstacle_point(const Lane& L, float ex,
                                                float ey) {
  float h = 0.5f * (ex * ex + ey * ey);
  float acc = 0.f;
  for (int o = 0; o < L.O; ++o) {
    const int k = o * L.BT;
    float s = (h + L.q[k]) - (L.ox[k] * ex + L.oy[k] * ey);
    acc = acc + L.ow8[k] * (1.0f / s);
  }
  return acc;
}

// Loss of the candidate (traj - lr dir_t, vel - lr dir_v): one ladder rung.
__device__ float rung_cost(const FsParams& p, const Lane& L, float lr) {
  CostAcc a;
  cost_init(a);
  float t0[NJ], tN[NJ], v0[NJ], vN[NJ];
  for (int t = 0; t < L.T; ++t) {
    float tr[NJ], ve[NJ], px[NJ], py[NJ], ex, ey;
    for (int j = 0; j < NJ; ++j) {
      const size_t i = L.at(j, t);
      tr[j] = L.traj[i] - lr * L.dir_t[i];
      ve[j] = L.vel[i] - lr * L.dir_v[i];
    }
    fk_point(p, tr, px, py, ex, ey);
    cost_add(p, a, t, obstacle_point(L, ex, ey), tr, ve);
    if (t == 0)
      for (int j = 0; j < NJ; ++j) t0[j] = tr[j], v0[j] = ve[j];
    if (t == L.T - 1)
      for (int j = 0; j < NJ; ++j) tN[j] = tr[j], vN[j] = ve[j];
  }
  return cost_total(p, L, a, t0, tN, v0, vN);
}

// out = kv @ (src * scale) per joint, mixed: rows < T go to traj planes,
// rows >= T to vel planes.  With ``dir``: out_traj = lambda_reg traj + out
// into dir_t (and likewise dir_v) — the hoisted search direction.
__device__ void forward_planes(const FsParams& p, const Lane& L,
                               const float* src, float scale, bool dir) {
  const int T = L.T, R2 = 2 * T;
  for (int r0 = 0; r0 < R2; r0 += ROWS) {
    float acc[NJ][ROWS];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[j][r] = 0.f;
    for (int t = 0; t < T; ++t) {
      float a[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) a[j] = src[L.at(j, t)] * scale;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = min(r0 + r, R2 - 1);
        const float k = L.kv[row * T + t];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[j][r] = fmaf(k, a[j], acc[j][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = r0 + r;
      if (row >= R2) break;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        float v = acc[0][r] * L.mix[0 * NJ + i];
        v = v + acc[1][r] * L.mix[1 * NJ + i];
        v = v + acc[2][r] * L.mix[2 * NJ + i];
        if (row < T) {
          const size_t k = L.at(i, row);
          if (dir) L.dir_t[k] = p.lambda_reg * L.traj[k] + v;
          else L.traj[k] = v;
        } else {
          const size_t k = L.at(i, row - T);
          if (dir) L.dir_v[k] = p.lambda_reg * L.vel[k] + v;
          else L.vel[k] = v;
        }
      }
    }
  }
}

// Loss (when want_loss) and alpha-gradient at the current (traj, vel), into
// grad.  Uses gx/gy and dir_t/dir_v as scratch for the obstacle gradient and
// the stacked position/velocity gradient.
__device__ float cost_grad_from_traj(const FsParams& p, const Lane& L,
                                     bool want_loss) {
  const int T = L.T;
  CostAcc a;
  cost_init(a);
  float t0[NJ], tN[NJ], v0[NJ], vN[NJ];
  // Pass A: FK, obstacle field and its factored gradient, cost sums.
  for (int t = 0; t < T; ++t) {
    float tr[NJ], ve[NJ], px[NJ], py[NJ], ex, ey;
    for (int j = 0; j < NJ; ++j) {
      tr[j] = L.traj[L.at(j, t)];
      ve[j] = L.vel[L.at(j, t)];
    }
    fk_point(p, tr, px, py, ex, ey);
    float h = 0.5f * (ex * ex + ey * ey);
    float cv = 0.f, csum = 0.f, cox = 0.f, coy = 0.f;
    for (int o = 0; o < L.O; ++o) {
      const int k = o * L.BT;
      float s = (h + L.q[k]) - (L.ox[k] * ex + L.oy[k] * ey);
      float inv = 1.0f / s;
      float winv = L.ow8[k] * inv;
      cv = cv + winv;
      float coef = winv * inv;
      csum = csum + coef;
      cox = cox + coef * L.ox[k];
      coy = coy + coef * L.oy[k];
    }
    L.gx[L.at2(t)] = cox - ex * csum;
    L.gy[L.at2(t)] = coy - ey * csum;
    cost_add(p, a, t, cv, tr, ve);
    if (t == 0)
      for (int j = 0; j < NJ; ++j) t0[j] = tr[j], v0[j] = ve[j];
    if (t == T - 1)
      for (int j = 0; j < NJ; ++j) tN[j] = tr[j], vN[j] = ve[j];
  }
  float loss = want_loss ? cost_total(p, L, a, t0, tN, v0, vN) : 0.f;

  // Pass B: blend weights, Jacobian, limit and start/goal terms.
  for (int t = 0; t < T; ++t) {
    float tr[NJ], ve[NJ], px[NJ], py[NJ], ex, ey;
    for (int j = 0; j < NJ; ++j) {
      tr[j] = L.traj[L.at(j, t)];
      ve[j] = L.vel[L.at(j, t)];
    }
    fk_point(p, tr, px, py, ex, ey);
    const float w = p.lam_max * (t == a.first ? 1.f : 0.f) + p.mean_w;
    const float wgx = w * L.gx[L.at2(t)];
    const float wgy = w * L.gy[L.at2(t)];
    float jx[NJ], jy[NJ], accx = 0.f, accy = 0.f;
    for (int j = NJ - 1; j >= 0; --j) {
      accx = accx + (-py[j]);
      accy = accy + px[j];
      jx[j] = accx;
      jy[j] = accy;
    }
    for (int j = 0; j < NJ; ++j) {
      float toc_g = wgx * jx[j] + wgy * jy[j];
      float sgp = 0.f, sgv = 0.f;
      if (t == 0) {
        sgp = tr[j] - L.start[j];
        sgv = ve[j];
      } else if (t == T - 1) {
        sgp = tr[j] - L.goal[j];
        sgv = ve[j];
      }
      float jp = (tr[j] - p.mean_jp) * p.inv_std2_T;
      float jv = ve[j] * p.inv_vmax2_T;
      if (p.masked) {
        if (!(tr[j] > p.pos_hi || tr[j] < p.pos_lo)) jp = 0.f;
        if (!(fabsf(ve[j]) > p.vel_hi)) jv = 0.f;
      }
      L.dir_t[L.at(j, t)] = (toc_g + L.lam_sg * sgp) + L.lam_jl * jp;
      L.dir_v[L.at(j, t)] = L.lam_sg * sgv + L.lam_jl * jv;
    }
  }

  // Pass C: pull-back kvt @ [g_pos; g_vel] per joint, then the mix^T
  // combine grad_j = sum_i pulled_i mix[j, i].
  const int R2 = 2 * T;
  for (int r0 = 0; r0 < T; r0 += ROWS) {
    float acc[NJ][ROWS];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[j][r] = 0.f;
    for (int t2 = 0; t2 < R2; ++t2) {
      float s[NJ];
#pragma unroll
      for (int i = 0; i < NJ; ++i)
        s[i] = t2 < T ? L.dir_t[L.at(i, t2)] : L.dir_v[L.at(i, t2 - T)];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = min(r0 + r, T - 1);
        const float k = L.kvt[row * R2 + t2];
#pragma unroll
        for (int i = 0; i < NJ; ++i) acc[i][r] = fmaf(k, s[i], acc[i][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = r0 + r;
      if (row >= T) break;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float v = acc[0][r] * L.mix[j * NJ + 0];
        v = v + acc[1][r] * L.mix[j * NJ + 1];
        v = v + acc[2][r] * L.mix[j * NJ + 2];
        L.grad[L.at(j, row)] = v;
      }
    }
  }
  return loss;
}

// One BLS inner step of a live lane.  Returns true when the stop test fired
// (the lane is minimized for the rest of the round).
__device__ bool bls_step(const FsParams& p, const Lane& L, float& loss,
                         float& lr) {
  const int T = L.T;
  float g2 = 0.f;
  for (int j = 0; j < NJ; ++j) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) {
      const float g = L.grad[L.at(j, t)];
      s = s + g * g;
    }
    g2 = g2 + s;
  }
  const float inv_norm = 1.0f / sqrtf(g2);
  // Reference quirk: sum over all (J, J) entries of grad^T n_grad.
  float alpha_norm = 0.f;
  for (int t = 0; t < T; ++t) {
    float gs = L.grad[L.at(0, t)];
    for (int j = 1; j < NJ; ++j) gs = gs + L.grad[L.at(j, t)];
    alpha_norm = alpha_norm + gs * (gs * inv_norm);
  }

  forward_planes(p, L, L.grad, inv_norm, true);

  bool found = false;
  float lr_best = 0.f, loss_best = loss, rung = 1.f;
  for (int k = 0; k < p.n_bls; ++k) {
    const float lr_r = lr * rung;
    const float closs = rung_cost(p, L, lr_r);
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
  for (int j = 0; j < NJ; ++j)
    for (int t = 0; t < T; ++t) {
      const size_t i = L.at(j, t);
      L.alpha[i] = a_fac * L.alpha[i] - lr_eff * (L.grad[i] * inv_norm);
      L.traj[i] = L.traj[i] - lr_eff * L.dir_t[i];
      L.vel[i] = L.vel[i] - lr_eff * L.dir_v[i];
    }
  // The stop test does not reject the step; it keeps the gradient.  The
  // accepted rung's loss is reused (FK carry), so no loss recompute.
  if (!stop) cost_grad_from_traj(p, L, false);
  loss = loss_best;
  lr = new_lr;
  return stop;
}

__device__ bool constraints_ok(const FsParams& p, const Lane& L) {
  const int T = L.T;
  float ps = 0.f, pg = 0.f, vs = 0.f, vg = 0.f;
  float tmax = L.traj[L.at(0, 0)], tmin = tmax;
  float vmax = fabsf(L.vel[L.at(0, 0)]);
  for (int j = 0; j < NJ; ++j) {
    const float d0 = L.traj[L.at(j, 0)] - L.start[j];
    const float dN = L.traj[L.at(j, T - 1)] - L.goal[j];
    ps = ps + d0 * d0;
    pg = pg + dN * dN;
    const float v0 = L.vel[L.at(j, 0)], vN = L.vel[L.at(j, T - 1)];
    vs = vs + v0 * v0;
    vg = vg + vN * vN;
    for (int t = 0; t < T; ++t) {
      const float x = L.traj[L.at(j, t)];
      tmax = fmaxf(tmax, x);
      tmin = fminf(tmin, x);
      vmax = fmaxf(vmax, fabsf(L.vel[L.at(j, t)]));
    }
  }
  const bool pos_ok = sqrtf(ps) < p.eps_pos && sqrtf(pg) < p.eps_pos;
  const bool vel_ok = sqrtf(vs) < p.eps_vel && sqrtf(vg) < p.eps_vel;
  const bool box_ok = tmax <= p.max_jp && tmin >= p.min_jp;
  return pos_ok && vel_ok && box_ok && vmax <= p.max_jv;
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
  const int T = p.T, O = p.O, BT = blockDim.x, tid = threadIdx.x;
  float* s_kv = smem;
  float* s_kvt = s_kv + 2 * T * T;
  float* s_mix = s_kvt + 2 * T * T;
  float* s_obs = s_mix + NJ * NJ;  // ox, oy, q, ow8: (O, BT) each
  for (int i = tid; i < 2 * T * T; i += BT) {
    s_kv[i] = kv[i];
    s_kvt[i] = kvt[i];
  }
  if (tid < NJ * NJ) s_mix[tid] = mix[tid];
  const size_t B = p.B;
  const size_t b = (size_t)blockIdx.x * BT + tid;
  const bool live = b < B;
  for (int o = 0; o < O; ++o) {
    const float x = live ? ox[o * B + b] : 0.f;
    const float y = live ? oy[o * B + b] : 0.f;
    const float w = live ? ow[o * B + b] : 0.f;
    s_obs[(0 * O + o) * BT + tid] = x;
    s_obs[(1 * O + o) * BT + tid] = y;
    s_obs[(2 * O + o) * BT + tid] = 0.5f + 0.5f * (x * x + y * y);
    s_obs[(3 * O + o) * BT + tid] = 0.8f * w;
  }
  __syncthreads();
  if (!live) return;

  Lane L;
  L.b = b;
  L.B = B;
  L.T = T;
  L.O = O;
  L.BT = BT;
  L.kv = s_kv;
  L.kvt = s_kvt;
  L.mix = s_mix;
  L.ox = s_obs + (0 * O) * BT + tid;
  L.oy = s_obs + (1 * O) * BT + tid;
  L.q = s_obs + (2 * O) * BT + tid;
  L.ow8 = s_obs + (3 * O) * BT + tid;
  for (int j = 0; j < NJ; ++j) {
    L.start[j] = start[j * B + b];
    L.goal[j] = goal[j * B + b];
  }
  L.lam_sg = lam_sg0[b];
  L.lam_jl = lam_jl0[b];
  const size_t plane = (size_t)NJ * T * B;
  L.alpha = alpha;
  L.grad = work;
  L.traj = work + plane;
  L.vel = work + 2 * plane;
  L.dir_t = work + 3 * plane;
  L.dir_v = work + 4 * plane;
  L.gx = work + 5 * plane;
  L.gy = L.gx + (size_t)T * B;

  bool fulfilled = false;
  float outer = 0.f, inner = 0.f, floss = INFINITY;
  for (int r = 0; r < p.rounds && !fulfilled; ++r) {
    // Round start: exact evaluation, loss and gradient under this round's
    // penalties.
    forward_planes(p, L, L.alpha, 1.f, false);
    float loss = cost_grad_from_traj(p, L, true);
    float lr = p.lr_start;
    for (int k = 0; k < p.sched[r]; ++k) {
      if (bls_step(p, L, loss, lr)) break;
      inner += 1.f;  // live before the step and after it
    }
    // Exact re-evaluation from the final alpha for the constraint check.
    forward_planes(p, L, L.alpha, 1.f, false);
    fulfilled = constraints_ok(p, L);
    floss = loss;
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

extern "C" int fused_solve_launch(FsParams p, int block_b, const float* kv,
                                  const float* kvt, const float* mix,
                                  const float* lam_sg0, const float* lam_jl0,
                                  const float* start, const float* goal,
                                  const float* ox, const float* oy,
                                  const float* ow, float* alpha,
                                  float* out_loss, float* out_ful,
                                  float* out_outer, float* out_inner,
                                  float* work, void* stream) {
  if (block_b <= 0 || block_b > 1024 || block_b % 32 != 0 || p.B <= 0 ||
      p.rounds > MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)4 * p.T * p.T + NJ * NJ + (size_t)4 * p.O * block_b);
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

extern "C" const char* fused_solve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
