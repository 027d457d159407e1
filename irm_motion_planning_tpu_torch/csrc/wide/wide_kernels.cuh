// K1 (wide_solve_kernel) and K2 (wide_round_kernel) for J >= 16, shared by
// the sources that instantiate them: wide_solve.cu (the programs bls, gd
// and bls_exact, the launch entry points, K7 alone), wide_tiers.cu (the
// linearized ladder's tiers ultra and bf16) and wide_reach.cu (the float32
// programs in the reach layouts), compiled in parallel.  They are
// csrc/fused_kernels.cuh's kernels on the body of wide_body.cuh: the
// resident body (BODY 0) one warp per lane, each warp drawing lanes from
// the queue on its own; the streamed ones a tile of lanes per CTA in
// lockstep.

#pragma once

#include "wide_body.cuh"

template <int SOLVER, int BODY>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, 1)
wide_solve_kernel(const WParams p, int lanes, const float* __restrict__ kv,
                  const float* __restrict__ kvt,
                  const float* __restrict__ mix,
                  const float* __restrict__ lam_sg0,
                  const float* __restrict__ lam_jl0,
                  const float* __restrict__ start,
                  const float* __restrict__ goal,
                  const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ ow, float* alpha, float* out_loss,
                  float* out_ful, float* out_outer, float* out_inner,
                  int* queue) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  auto w = bind_body<SOLVER, BODY>(p, smem, p.T, p.O, lanes, kv, kvt, mix);
  if constexpr (BODY != WB_BODY_RESIDENT) {
    for (int b0 = next_tile(w, queue); b0 < p.B; b0 = next_tile(w, queue)) {
      const int b = b0 + w.lane;
      const bool valid = w.sub == 0 && b < p.B;
      if (valid)
        load_lane(p, w, b, alpha, start, goal, ox, oy, ow, lam_sg0[b],
                  lam_jl0[b]);
      bool fulfilled = false;
      float outer = 0.f, inner = 0.f, floss = INFINITY;
      for (int r = 0; r < p.rounds; ++r) {
        const bool live = valid && !fulfilled;
        if (!__syncthreads_or(live)) break;
        const float lr0 = SOLVER == SOLVER_GD ? p.gd_lr[r] : p.lr_start;
        const bool ok = ls_round<SOLVER>(p, w, p.sched[r], lr0, floss, inner,
                                         r > 0, live);
        if (live) {
          fulfilled = ok;
          if (!ok) {
            outer += 1.f;
            w.lam_sg = w.lam_sg * p.inc;
            w.lam_jl = w.lam_jl * p.inc;
          }
        }
      }
      if (valid) {
        store_alpha(p, w, b, alpha);
        if (w.lid == 0) {
          out_loss[b] = floss;
          out_ful[b] = fulfilled ? 1.f : 0.f;
          out_outer[b] = outer;
          out_inner[b] = inner;
        }
      }
    }
  } else {
    for (int b = next_lane(queue, w.lid); b < p.B;
         b = next_lane(queue, w.lid)) {
      load_lane(p, w, b, alpha, start, goal, ox, oy, ow, lam_sg0[b],
                lam_jl0[b]);
      bool fulfilled = false;
      float outer = 0.f, inner = 0.f, floss = INFINITY;
      for (int r = 0; r < p.rounds && !fulfilled; ++r) {
        const float lr0 = SOLVER == SOLVER_GD ? p.gd_lr[r] : p.lr_start;
        fulfilled = ls_round<SOLVER>(p, w, p.sched[r], lr0, floss, inner,
                                     r > 0, true);
        if (!fulfilled) {
          outer += 1.f;
          w.lam_sg = w.lam_sg * p.inc;
          w.lam_jl = w.lam_jl * p.inc;
        }
      }
      store_alpha(p, w, b, alpha);
      if (w.lid == 0) {
        out_loss[b] = floss;
        out_ful[b] = fulfilled ? 1.f : 0.f;
        out_outer[b] = outer;
        out_inner[b] = inner;
      }
    }
  }
}

template <int SOLVER, int BODY>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, 1)
wide_round_kernel(const WParams p, int lanes, int n_r,
                  const float* __restrict__ kv, const float* __restrict__ kvt,
                  const float* __restrict__ mix,
                  const float* __restrict__ lam_sg,
                  const float* __restrict__ lam_jl,
                  const float* __restrict__ ful,
                  const float* __restrict__ lr0,
                  const float* __restrict__ start,
                  const float* __restrict__ goal,
                  const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ ow, float* alpha, float* out_loss,
                  float* out_ok, float* out_inner, int* queue) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  auto w = bind_body<SOLVER, BODY>(p, smem, p.T, p.O, lanes, kv, kvt, mix);
  if constexpr (BODY != WB_BODY_RESIDENT) {
    for (int b0 = next_tile(w, queue); b0 < p.B; b0 = next_tile(w, queue)) {
      const int b = b0 + w.lane;
      const bool valid = w.sub == 0 && b < p.B;
      const bool pass = valid && ful[b] > 0.5f;
      if (pass && w.lid == 0) {
        out_loss[b] = 0.f;
        out_ok[b] = 1.f;
        out_inner[b] = 0.f;
      }
      const bool live = valid && !pass;
      if (live)
        load_lane(p, w, b, alpha, start, goal, ox, oy, ow, lam_sg[b],
                  lam_jl[b]);
      float loss = 0.f, inner = 0.f;
      const bool ok = ls_round<SOLVER>(p, w, n_r, live ? lr0[b] : 0.f, loss,
                                       inner, false, live);
      if (live) {
        store_alpha(p, w, b, alpha);
        if (w.lid == 0) {
          out_loss[b] = loss;
          out_ok[b] = ok ? 1.f : 0.f;
          out_inner[b] = inner;
        }
      }
    }
  } else {
    for (int b = next_lane(queue, w.lid); b < p.B;
         b = next_lane(queue, w.lid)) {
      if (ful[b] > 0.5f) {
        if (w.lid == 0) {
          out_loss[b] = 0.f;
          out_ok[b] = 1.f;
          out_inner[b] = 0.f;
        }
        continue;
      }
      load_lane(p, w, b, alpha, start, goal, ox, oy, ow, lam_sg[b],
                lam_jl[b]);
      float loss = 0.f, inner = 0.f;
      const bool ok =
          ls_round<SOLVER>(p, w, n_r, lr0[b], loss, inner, false, true);
      store_alpha(p, w, b, alpha);
      if (w.lid == 0) {
        out_loss[b] = loss;
        out_ok[b] = ok ? 1.f : 0.f;
        out_inner[b] = inner;
      }
    }
  }
}

// K1's (which = 0) or K2's (which = 1) instantiation of ``solver`` in the
// body ``body``, nullptr for another value: wide_tiers.cu holds the tier
// programs', wide_reach.cu the reach body's.
const void* wide_tier_kernel(int which, int solver, int body);
const void* wide_reach_kernel(int which, int solver);

template <int SOLVER, int BODY>
static const void* wide_kernel_of(int which) {
  return which == 0 ? (const void*)wide_solve_kernel<SOLVER, BODY>
                    : (const void*)wide_round_kernel<SOLVER, BODY>;
}
