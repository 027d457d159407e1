// The per-lane arithmetic that every kernel body shares: the parameter
// block, forward kinematics at one timestep and the penalized loss from a
// lane's cost sums.  The kernels run them from the warp body
// (warp_body.cuh: K1/K2 in fused_solve.cu and fused_tiers.cu, K3/K4/K5 in
// step_kernels.cu), one warp per lane; each is the plain PyTorch version's
// op sequence (ops/fused_solve.py: fk_ee, scalar_cost).
//
// Built with -fmad=false: separate multiplies and adds round as they do in
// the plain PyTorch version; the basis products use explicit fmaf.  Every
// function here is static or inline: each kernel source gets its own copy.
//
// NJ, the arm's joint count J, is a compile-time constant: ops/_build.py
// builds one library per J (-DNJ=<J>), 1 <= J <= 15 (a reduction's 2 J + 1
// cost rows are chained by the first threads of a warp).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#ifndef NJ
#define NJ 3
#endif
#define MAX_ROUNDS 32

static_assert(NJ >= 1 && NJ <= 15, "the kernels take 1 <= J <= 15 joints");

// Mirror of _Params in ops/fused_solve.py (same order, all 4-byte fields;
// fused_params_layout in fused_solve.cu reports its size and the offset of
// its last field, which the loader checks against the mirror).  gd_lr[r]:
// GD's learning rate of round r (K1 with the GD solver).
struct FsParams {
  int T, O, B, rounds, n_bls, masked;
  int sched[MAX_ROUNDS];
  float link[NJ];
  float mean_jp, inv_std_jp_h, inv_vmax_h, inv_T, inv_std2_T, inv_vmax2_T;
  float lam_max, mean_w, pos_hi, pos_lo, vel_hi;
  float lambda_reg, bls_alpha, beta_plus, beta_minus, lr_fail, lr_start;
  float loss_red, inc, eps_pos, eps_vel, max_jp, min_jp, max_jv;
  float gd_lr[MAX_ROUNDS];
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

// A lane's cost sums over the timesteps: the obstacle cost's first argmax
// value and sum, and the masked limit losses per joint.
struct CostAcc {
  float cmax, csum;
  int first;
  float psum[NJ], vsum[NJ];
};

// The penalized loss from the sums, the lane's endpoints (start, goal), its
// penalties and the evaluated endpoint values.
__device__ __forceinline__ float cost_total(const FsParams& p,
                                            const CostAcc& a,
                                            const float* start,
                                            const float* goal, float lam_sg,
                                            float lam_jl, const float* t0,
                                            const float* tN, const float* v0,
                                            const float* vN) {
  float toc = p.lam_max * a.cmax + p.mean_w * a.csum;
  float sgpc = 0.f, sgvc = 0.f, jpc = 0.f, jvc = 0.f;
  for (int j = 0; j < NJ; ++j) {
    float ds = t0[j] - start[j];
    float dg = tN[j] - goal[j];
    sgpc = sgpc + 0.5f * (ds * ds + dg * dg);
    sgvc = sgvc + 0.5f * (v0[j] * v0[j] + vN[j] * vN[j]);
    jpc = jpc + a.psum[j] * p.inv_T;
    jvc = jvc + a.vsum[j] * p.inv_T;
  }
  return toc + lam_sg * (sgpc + sgvc) + lam_jl * (jpc + jvc);
}
