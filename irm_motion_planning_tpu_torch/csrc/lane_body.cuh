// The lane body of the per-step kernels K3-K6 (step_kernels.cu): one thread
// runs one lane (one scene), with the lane's state planes in device memory,
// lanes trailing ((J, T, B): neighbouring threads read neighbouring
// addresses), and the basis pair, mix and the block's obstacle terms in
// shared memory.  A step or an evaluation is the same op sequence in every
// per-step kernel, as pallas_step's _Body serves the TPU kernels.  The fused
// kernels K1/K2 (fused_solve.cu) are built from the warp body
// (warp_body.cuh), which runs this body's op sequence (bls_step and gd_step)
// one warp per lane and takes FsParams, fk_point and cost_total from here.
//
// Built with -fmad=false: separate multiplies and adds round as they do in
// the plain PyTorch version; the basis products use explicit fmaf.  Every
// function here is static or inline: each kernel source gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define NJ 3
#define MAX_ROUNDS 32
#define ROWS 10

// Mirror of _Params in ops/fused_solve.py (same order, all 4-byte fields;
// fused_params_layout in fused_solve.cu reports its size and the offset of
// its last field, which the loader checks against the mirror).  gd_lr[r]:
// GD's learning rate of round r (K1 with the GD solver).
struct FsParams {
  int T, O, B, rounds, n_bls, masked;
  int sched[MAX_ROUNDS];
  float link[3];
  float mean_jp, inv_std_jp_h, inv_vmax_h, inv_T, inv_std2_T, inv_vmax2_T;
  float lam_max, mean_w, pos_hi, pos_lo, vel_hi;
  float lambda_reg, bls_alpha, beta_plus, beta_minus, lr_fail, lr_start;
  float loss_red, inc, eps_pos, eps_vel, max_jp, min_jp, max_jv;
  float gd_lr[MAX_ROUNDS];
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

// Loss of one ladder rung.  Linearized: the candidate (traj - lr dir_t,
// vel - lr dir_v).  EXACT: the candidate's exact evaluation, already in
// (traj, vel) of ``L`` (lr unused).
template <bool EXACT>
static __device__ float rung_cost(const FsParams& p, const Lane& L, float lr) {
  CostAcc a;
  cost_init(a);
  float t0[NJ], tN[NJ], v0[NJ], vN[NJ];
  for (int t = 0; t < L.T; ++t) {
    float tr[NJ], ve[NJ], px[NJ], py[NJ], ex, ey;
    for (int j = 0; j < NJ; ++j) {
      const size_t i = L.at(j, t);
      if constexpr (EXACT) {
        tr[j] = L.traj[i];
        ve[j] = L.vel[i];
      } else {
        tr[j] = L.traj[i] - lr * L.dir_t[i];
        ve[j] = L.vel[i] - lr * L.dir_v[i];
      }
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
static __device__ void forward_planes(const FsParams& p, const Lane& L,
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

// Pass A of the fused evaluation at the current (traj, vel): FK, obstacle
// field and its factored gradient into gx/gy, cost sums.  Returns the loss
// (when want_loss, else 0) and the blend's first argmax in ``first``.
__device__ __forceinline__ float cost_pass(const FsParams& p, const Lane& L,
                                           bool want_loss, int& first) {
  const int T = L.T;
  CostAcc a;
  cost_init(a);
  float t0[NJ], tN[NJ], v0[NJ], vN[NJ];
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
  first = a.first;
  return want_loss ? cost_total(p, L, a, t0, tN, v0, vN) : 0.f;
}

// Passes B and C: the stacked position/velocity gradient at the current
// (traj, vel) into dir_t/dir_v (scratch), from gx/gy and the blend's first
// argmax of pass A; then the pull-back kvt @ [g_pos; g_vel] per joint and
// the mix^T combine grad_j = sum_i pulled_i mix[j, i], into grad.
__device__ __forceinline__ void grad_pass(const FsParams& p, const Lane& L,
                                          int first) {
  const int T = L.T;
  // Pass B: blend weights, Jacobian, limit and start/goal terms.
  for (int t = 0; t < T; ++t) {
    float tr[NJ], ve[NJ], px[NJ], py[NJ], ex, ey;
    for (int j = 0; j < NJ; ++j) {
      tr[j] = L.traj[L.at(j, t)];
      ve[j] = L.vel[L.at(j, t)];
    }
    fk_point(p, tr, px, py, ex, ey);
    const float w = p.lam_max * (t == first ? 1.f : 0.f) + p.mean_w;
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

  // Pass C: pull-back and mix^T combine.
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
}

// Loss (when want_loss) and alpha-gradient at the current (traj, vel), into
// grad.  Uses gx/gy and dir_t/dir_v as scratch for the obstacle gradient and
// the stacked position/velocity gradient.
static __device__ float cost_grad_from_traj(const FsParams& p, const Lane& L,
                                            bool want_loss) {
  int first;
  const float loss = cost_pass(p, L, want_loss, first);
  grad_pass(p, L, first);
  return loss;
}

// One BLS inner step of a live lane (pallas_step._bls_step): normalized
// direction, the early-exit Armijo ladder (first pass wins) against the
// carried loss, the accepted iterate, and the gradient pulled back at it.
// Updates alpha, traj and vel in place (each thread touches only its own
// lane's column) and returns true when the stop test fired (the lane is
// minimized for the rest of the round); the stop test does not reject the
// step and keeps the gradient.  Without the FK carry of K1/K2
// (warp_body.cuh): the loss is recomputed at the accepted iterate with the
// gradient.
//
// Linearized (EXACT false): the direction's forward evaluation into
// dir_t/dir_v and the ladder on the linearized trajectory.  EXACT: each
// rung's candidate alpha (1 - lambda_reg lr) alpha - lr (grad inv_norm), in
// the operand order of the accepted update, goes into ``trial`` ((J, T, B)
// scratch) and its exact evaluation into dir_t/dir_v, which this tier does
// not use otherwise; the accepted iterate's (traj, vel) are the accepted
// rung's evaluation (the same floats as the new alpha's), or, when no rung
// passed, alpha's evaluated anew.
template <bool EXACT>
static __device__ bool bls_step(const FsParams& p, const Lane& L, float* trial,
                                float& loss, float& lr) {
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

  if constexpr (!EXACT) forward_planes(p, L, L.grad, inv_norm, true);

  bool found = false;
  float lr_best = 0.f, loss_best = loss, rung = 1.f;
  for (int k = 0; k < p.n_bls; ++k) {
    const float lr_r = lr * rung;
    float closs;
    if constexpr (EXACT) {
      const float a_fac = 1.f - p.lambda_reg * lr_r;
      for (int j = 0; j < NJ; ++j)
        for (int t = 0; t < T; ++t) {
          const size_t i = L.at(j, t);
          trial[i] = a_fac * L.alpha[i] - lr_r * (L.grad[i] * inv_norm);
        }
      Lane E = L;  // the rung's evaluation lives in the direction planes
      E.traj = L.dir_t;
      E.vel = L.dir_v;
      forward_planes(p, E, trial, 1.f, false);
      closs = rung_cost<true>(p, E, lr_r);
    } else {
      closs = rung_cost<false>(p, L, lr_r);
    }
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
      if constexpr (EXACT) {
        if (found) {
          L.traj[i] = L.dir_t[i];
          L.vel[i] = L.dir_v[i];
        }
      } else {
        L.traj[i] = L.traj[i] - lr_eff * L.dir_t[i];
        L.vel[i] = L.vel[i] - lr_eff * L.dir_v[i];
      }
    }
  if constexpr (EXACT) {
    if (!found) forward_planes(p, L, L.alpha, 1.f, false);
  }
  loss = stop ? loss_best : cost_grad_from_traj(p, L, true);
  lr = new_lr;
  return stop;
}

// One GD inner step of a live lane (pallas_step._gd_step): the trial
// (1 - lambda_reg lr) alpha - lr grad into ``trial`` ((J, T, B) scratch),
// its exact evaluation into dir_t/dir_v and its loss; the stop test REJECTS
// the trial, so the state planes (alpha, grad, traj, vel) and ``loss``
// change only when it does not fire.  Returns stop.
static __device__ bool gd_step(const FsParams& p, const Lane& L, float* trial,
                               float& loss, float lr) {
  const int T = L.T;
  const float a_fac = 1.f - p.lambda_reg * lr;
  for (int j = 0; j < NJ; ++j)
    for (int t = 0; t < T; ++t) {
      const size_t i = L.at(j, t);
      trial[i] = a_fac * L.alpha[i] - lr * L.grad[i];
    }
  Lane E = L;  // the trial's evaluation lives in the direction planes
  E.traj = L.dir_t;
  E.vel = L.dir_v;
  forward_planes(p, E, trial, 1.f, false);
  int first;
  const float nloss = cost_pass(p, E, true, first);
  if ((loss - nloss) < p.loss_red) return true;
  for (int j = 0; j < NJ; ++j)
    for (int t = 0; t < T; ++t) {
      const size_t i = L.at(j, t);
      L.alpha[i] = trial[i];
      L.traj[i] = E.traj[i];
      L.vel[i] = E.vel[i];
    }
  grad_pass(p, L, first);  // overwrites dir_t/dir_v, copied out above
  loss = nloss;
  return false;
}

static __device__ bool constraints_ok(const FsParams& p, const Lane& L) {
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

// Stage the basis pair, mix and this block's obstacle terms (ox, oy, q_o =
// 0.5 + 0.5 |o|^2 and 0.8 w_o, (O, BT) each) in shared memory.  Every
// thread of the block takes part; lanes past B stage zeros.
static __device__ void stage_block(const FsParams& p,
                                   const float* __restrict__ kv,
                                   const float* __restrict__ kvt,
                                   const float* __restrict__ mix,
                                   const float* __restrict__ ox,
                                   const float* __restrict__ oy,
                                   const float* __restrict__ ow, float* smem) {
  const int T = p.T, O = p.O, BT = blockDim.x, tid = threadIdx.x;
  float* s_kv = smem;
  float* s_kvt = s_kv + 2 * T * T;
  float* s_mix = s_kvt + 2 * T * T;
  float* s_obs = s_mix + NJ * NJ;
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
}

// This thread's view of lane b: the staged shared memory, the lane's
// endpoints and penalties, alpha and the workspace planes.
static __device__ Lane bind_lane(const FsParams& p, float* smem, size_t b,
                                 const float* __restrict__ start,
                                 const float* __restrict__ goal, float lam_sg,
                                 float lam_jl, float* alpha, float* work) {
  const int T = p.T, O = p.O, BT = blockDim.x, tid = threadIdx.x;
  const size_t B = p.B;
  float* s_obs = smem + 4 * T * T + NJ * NJ;
  Lane L;
  L.b = b;
  L.B = B;
  L.T = T;
  L.O = O;
  L.BT = BT;
  L.kv = smem;
  L.kvt = smem + 2 * T * T;
  L.mix = smem + 4 * T * T;
  L.ox = s_obs + (0 * O) * BT + tid;
  L.oy = s_obs + (1 * O) * BT + tid;
  L.q = s_obs + (2 * O) * BT + tid;
  L.ow8 = s_obs + (3 * O) * BT + tid;
  for (int j = 0; j < NJ; ++j) {
    L.start[j] = start[j * B + b];
    L.goal[j] = goal[j * B + b];
  }
  L.lam_sg = lam_sg;
  L.lam_jl = lam_jl;
  const size_t plane = (size_t)NJ * T * B;
  L.alpha = alpha;
  L.grad = work;
  L.traj = work + plane;
  L.vel = work + 2 * plane;
  L.dir_t = work + 3 * plane;
  L.dir_v = work + 4 * plane;
  L.gx = work + 5 * plane;
  L.gy = L.gx + (size_t)T * B;
  return L;
}

// Dynamic shared memory of a kernel that stages with stage_block: the basis
// pair, mix and four obstacle planes of the block's lanes.
static size_t smem_bytes(const FsParams& p, int block_b) {
  return sizeof(float) *
         ((size_t)4 * p.T * p.T + NJ * NJ + (size_t)4 * p.O * block_b);
}

static bool bad_launch(const FsParams& p, int block_b) {
  return block_b <= 0 || block_b > 1024 || block_b % 32 != 0 || p.B <= 0 ||
         p.rounds > MAX_ROUNDS;
}
