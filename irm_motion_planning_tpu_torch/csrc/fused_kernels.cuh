// The kernel templates of K1 (fused_solve_kernel) and K2
// (fused_round_kernel), shared by the three sources that instantiate them:
// fused_solve.cu (the programs bls, gd and bls_exact, and the launch entry
// points), fused_tiers.cu (the linearized ladder's kernel tiers ultra
// and bf16) and fused_reach.cu (the float32 programs in the reach layouts),
// which nvcc compiles in parallel.  Each instantiation lives in one source
// only.  step_kernels.cu binds K4's warps with bind_body (the GD program's
// body).

#pragma once

#include "warp_body.cuh"

// The warp's view of its lane in the body BODY (WB_BODY_*): the resident
// body stages the basis pair kv/kvt in shared memory; the streamed bodies
// read kv/kvt, which are then the transposed, padded pair (see SWarp), from
// device memory, for a tile of ``lanes`` lanes (blockDim.x / 32 / lanes
// warps per lane), in the program's lane layout (stream_layout): SWarp's,
// the half-width one (HWarp) for the bf16 tier's program, or a reach
// layout.
template <int SOLVER, int BODY>
static __device__ __forceinline__ auto bind_body(float* smem, int T, int O,
                                                 int lanes, const float* kv,
                                                 const float* kvt,
                                                 const float* mix) {
  constexpr int LY = stream_layout(SOLVER, BODY);
  if constexpr (BODY && LY == WB_LY_HALF) {
    return bind_hwarp(smem, T, O, lanes, kv, kvt, mix);
  } else if constexpr (BODY) {
    return bind_swarp<LY>(smem, T, O, lanes, kv, kvt, mix);
  } else {
    stage_cta(T, kv, kvt, mix, smem);
    return bind_warp(smem, T, O);
  }
}

// K1: the whole solve for every lane; alpha is updated in place.  ``lanes``:
// lanes per CTA (the resident body: one per warp; the streamed bodies: a
// tile of ``lanes`` lanes in lockstep, each drawn with its tile from the
// queue).
template <int SOLVER, int TT, int OO, int BODY>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, BODY ? 1 : WB_MIN_CTAS)
fused_solve_kernel(FsParams p, int lanes, const float* __restrict__ kv,
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
  const int T = TT ? TT : p.T, O = TT ? OO : p.O;
  auto w = bind_body<SOLVER, BODY>(smem, T, O, lanes, kv, kvt, mix);
  if constexpr (BODY) {
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
        fulfilled = warp_round<SOLVER>(p, w, p.sched[r], lr0, floss, inner,
                                       r > 0);
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

// One round for every lane; alpha is updated in place.  A lane that comes
// in fulfilled passes through: alpha unchanged, no steps, loss 0 and ok 1
// (the caller masks both with the round-start flag); in the streamed body
// it is masked in its tile.
template <int SOLVER, int TT, int OO, int BODY>
__global__ void __launch_bounds__(32 * WB_MAX_WARPS, BODY ? 1 : WB_MIN_CTAS)
fused_round_kernel(FsParams p, int lanes, int n_r,
                   const float* __restrict__ kv,
                   const float* __restrict__ kvt,
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
  const int T = TT ? TT : p.T, O = TT ? OO : p.O;
  auto w = bind_body<SOLVER, BODY>(smem, T, O, lanes, kv, kvt, mix);
  if constexpr (BODY) {
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
      float loss, inner = 0.f;
      const bool ok =
          warp_round<SOLVER>(p, w, n_r, lr0[b], loss, inner, false);
      store_alpha(p, w, b, alpha);
      if (w.lid == 0) {
        out_loss[b] = loss;
        out_ok[b] = ok ? 1.f : 0.f;
        out_inner[b] = inner;
      }
    }
  }
}

// K1's (which = 0) or K2's (which = 1) instantiation of a kernel tier's
// program (SOLVER_BLS_ULTRA, SOLVER_BLS_BF16) in the body
// ``streamed`` (resident: the generic instantiation); nullptr for another
// program.  Defined in fused_tiers.cu.
const void* tier_kernel_for(int which, int solver, bool streamed);
// K1's or K2's instantiation of a float32 program (SOLVER_BLS, SOLVER_GD,
// SOLVER_BLS_EXACT, SOLVER_BLS_ULTRA) in the reach body; nullptr for
// another program.  Defined in fused_reach.cu.
const void* reach_kernel_for(int which, int solver);
