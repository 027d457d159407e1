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
// a basis product (WB_JS floats per timestep, the J joints padded to whole
// float4: one broadcast load gives four joints), the stacked gradient of
// the pull-back, or the rows of a reduction, the lane's obstacle terms
// (float4 per obstacle: ox, oy, q_o = 0.5 + 0.5 |o|^2, 0.8 w_o) and the
// lane's endpoints.  Per CTA, the basis pair transposed: kvT[t][r] =
// kv[r][t] and kvtT[t2][r] = kvt[r][t2], so the 32 output rows a warp
// computes at once are 32 neighbouring words (no bank conflicts), and mix.
//
// The streamed body (struct SWarp, any T >= 32), for the T whose basis
// pair (16 T^2 bytes) does not fit in shared memory beside the lane state.
// The basis stays in device memory (in L2: 640 KB at T = 200), transposed
// and cut into row blocks by the wrapper, and a CTA runs a TILE of L
// lanes, one warp per lane, in lockstep: the loops over rounds, steps and
// (exact ladder) rungs are CTA-uniform, each taking the most trips any live
// lane of the tile needs, and a lane that is done (fulfilled, stopped, past
// its passing rung, or past the batch's end) is masked: it arrives at every
// barrier and computes and writes nothing.  The call sites of the basis
// products are fixed by the program, so every warp reaches the same
// products in the same order, and each product is K7 (k7_product): ONE
// product for the whole tile, (rows x T) times (T x J L), whose basis
// tiles come into shared memory once per CTA (a ring of WB_K7_STAGES
// stages filled by TMA bulk copies from a producer warp, mbarrier
// full/empty signals; the ring lives in the CTA's room beside the tile's
// gx/gy planes, which no lane holds across a product).  The CTA has
// WB_STREAM_WARPS warps: the tile's lanes' (at most 15), helpers, and the
// producer last; every warp but the producer computes the products, each
// thread a register block of WB_K7_ROWS rows x WB_K7_LANES lanes x J
// accumulators (one lane alone: WB_K7_SOLO_ROWS rows), so each basis word
// read from shared memory feeds every lane of its block.  traj, vel, gx and gy live in shared-memory planes;
// everything else is laid out as in the resident body.  This replaces
// pallas_step's _Body._streamed_matmul (stream_rb > 0), which streams row
// blocks of the basis through double-buffered VMEM once per tile of lanes.
// A lane's elementwise passes run on its own warp.
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
// The reach layouts (SWarpT<WB_LY_REACH_*>, the body of launch_plan's
// "reach" plan), for the float32 programs past the T where SWarp's layout
// leaves no room for one lane: SWarp's view with pass B recomputing the FK
// tangents from (traj, vel), as HWarp does (the same floats: FK is
// fk_point's op sequence on the same planes, built without contraction),
// instead of keeping them in the direction planes.  GD and the exact
// ladder, which use the direction planes for nothing else, drop them
// (WB_LY_REACH_NODIR: alpha, grad, traj and vel, 24 bytes per timestep
// less at J = 3: one lane per CTA up to T = 2,636 at 11 obstacles).  The
// linearized ladder's programs keep them for the direction and put the
// tile's gx/gy planes there instead, which are free from a step's accepted
// update to its next direction (WB_LY_REACH_GXDIR: the room holds the K7
// ring alone, 8 bytes per timestep less: up to T = 2,156).  Every op is
// SWarp's, so a lane's floats do not depend on the layout.
//
// Op order.  Every basis-product row is one sequential fmaf chain over t,
// followed by the mix combine; in the streamed body each (row, lane) output
// is one thread's whole chain over t across the ring's tiles, taken in t
// order (no split over t), and K6 (step_kernels.cu) computes the same
// chains as a tiled product.  Every sum over t (the cost sums, the gradient
// norm, alpha_norm) and the constraint extrema are sequential chains, each
// run by one thread over a row the owners wrote and broadcast with
// __shfl_sync; the blend's first argmax is a shuffle tree, which rounds
// nothing.  Each lane therefore runs one op sequence (its bls_step or
// gd_step) in either body, and its floats do not depend on which kernel
// runs its steps (K1/K2, or the per-step K3, K4 and K5), streamed or
// resident.  FK and the penalized loss come from lane_body.cuh.

#pragma once

#include <cuda_bf16.h>

#include "lane_body.cuh"

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

// The bodies (a kernel's template argument; launch_plan's PLANS index):
// the resident one, the streamed one and the streamed one in its reach
// layout.
#define WB_BODY_RESIDENT 0
#define WB_BODY_STREAMED 1
#define WB_BODY_REACH 2
// The lane layouts of the streamed bodies: SWarp's, HWarp's (the bf16
// tier's program), and the reach layouts: without direction planes (GD,
// the exact ladder) and with gx/gy in them (the linearized ladder).
#define WB_LY_STREAMED 0
#define WB_LY_HALF 1
#define WB_LY_REACH_NODIR 2
#define WB_LY_REACH_GXDIR 3

// The layouts follow the joint count NJ (lane_body.cuh); the numbers in
// the comments are J = 3's.  Mirrored by launch_plan in ops/fused_solve.py.
#define WB_SLOTS 2                 // timesteps per thread (resident body)
#define WB_MAX_T (32 * WB_SLOTS)
#ifndef WB_MAX_WARPS
#define WB_MAX_WARPS 16            // warps (lanes in flight) per CTA
#endif
#ifndef WB_MIN_CTAS
#if NJ <= 3
#define WB_MIN_CTAS 2              // CTAs of WB_MAX_WARPS per SM: <= 64 regs
#else
#define WB_MIN_CTAS 1              // J > 3: one CTA per SM fits, <= 128 regs
#endif
#endif
#define WB_JS ((NJ + 3) & ~3)      // floats per timestep of a staged input (4)
#define WB_J4 (WB_JS / 4)          // float4 per timestep of a staged input (1)
// Reduction rows in the buffer: the 2 J + 1 cost rows, and room for the
// stacked gradient (2 T timesteps of WB_JS floats): 8.
#define WB_ROWS (2 * NJ + 1 > 2 * WB_JS ? 2 * NJ + 1 : 2 * WB_JS)
// start, goal, t0, tN, v0, vN (6 J) and two pad slots, to 16 bytes (20)
#define WB_LANE_FLOATS ((6 * NJ + 2 + 3) & ~3)
#define WB_MIX_FLOATS ((NJ * NJ + 3) & ~3)  // mix (J x J), to 16 bytes (12)
#define WB_OUTCOME (6 * NJ)        // K4: a lane's step outcome (ends' pad)
#define WB_K7_ON (6 * NJ + 1)      // K7: the lane takes the product (ends' pad)
#define WB_CTL_FLOATS 20           // full[2], empty[2] mbarriers, tile base
#define WB_CTA_FLOATS (WB_MIX_FLOATS + WB_CTL_FLOATS)  // streamed: mix, control (32)
#define WB_SMEM_MAX 232448         // shared memory a CTA may take (bytes)
#define WB_STREAM_WARPS 16         // warps of a streamed CTA (the last: K7's producer)
#define WB_K7_STAGES 2             // the K7 ring's stages
#define WB_K7_LANES 2              // lanes in a K7 thread's register block
#if NJ <= 4
#define WB_K7_ROWS 4               // rows in a K7 thread's register block
#else
#define WB_K7_ROWS 2               // J > 4: 2 x 2 x J accumulators
#endif
#define WB_K7_SOLO_ROWS 2          // the same where one lane fills the CTA
#define WB_RING_CAP 16384          // the most floats of the K7 ring
#define FULL_MASK 0xffffffffu

// Phase-ablated builds, for timing only (benchmarks/epilogue.py): each
// flag removes one phase of the resident body's BLS step, so the kernel
// gives WRONG results by design, as the JAX kernel's _ABLATE values did
// (pallas_step.py:94).  The default build defines none of them.
//   WB_ABLATE_LADDER1      the Armijo ladder capped at one rung (bls_step)
//   WB_ABLATE_DIR_FORWARD  no forward of the direction: the normalized
//                          gradient stands for its traj and vel (direction)
//   WB_ABLATE_FK           no FK in the rungs: the candidate's first joint
//                          stands for the end effector (rung_point)
//   WB_ABLATE_OBSFIELD     no obstacle field in the rungs: ex + ey stands
//                          for the obstacle cost (rung_point)
//   WB_ABLATE_PULLBACK     no end-of-step cost and gradient pass: the rung's
//                          loss and the stale gradient carry on (bls_step)
// A build with any of them holds the resident linearized program alone
// (fused_solve.cu, WB_ABLATED).
// WB_CARRY_FUSED: the linearized carry program's accepted alpha rounded
// once (new_alpha<true>), as every other program rounds it and JAX's
// kernel does, at every J but 3; at J = 3 it is rounded twice (bls_step
// says why; fused_solve.carry_rounds_once is the plain versions' rule).
// WB_CARRY_ONE_ROUNDING, a build for measurement (tools/fused_variants.py
// --quality; ROADMAP queue 3 #1), rounds it once at J = 3 too.
#if defined(WB_CARRY_ONE_ROUNDING) || NJ != 3
#define WB_CARRY_FUSED true
#else
#define WB_CARRY_FUSED false
#endif

#if defined(WB_ABLATE_LADDER1) || defined(WB_ABLATE_DIR_FORWARD) || \
    defined(WB_ABLATE_FK) || defined(WB_ABLATE_OBSFIELD) ||           \
    defined(WB_ABLATE_PULLBACK)
#define WB_ABLATED 1
#endif

// The specialised instantiation of the resident body's kernels (K1, K2,
// K4): the bench's T and obstacle slots.  Other shapes run the generic one
// (TT = OO = 0: T and O read at run time), with the same op sequence and
// results.
#define WB_SPEC_T 50
#define WB_SPEC_O 11

static inline bool specialised(const FsParams& p) {
#if NJ == 3
  return p.T == WB_SPEC_T && p.O == WB_SPEC_O;
#else
  return false;  // the specialised instantiations are J = 3's only
#endif
}

// The mix combine of one product row's J chains a[0..J-1]: out_i = sum_j
// a_j mix[j, i] (forward, TRANS false) or sum_j a_j mix[i, j] (pull-back,
// TRANS true), summed in order of j.
template <bool TRANS>
static __device__ __forceinline__ float mixed(const float* mix, int i,
                                              const float* a) {
  float v = a[0] * mix[TRANS ? i * NJ : i];
#pragma unroll
  for (int j = 1; j < NJ; ++j)
    v = v + a[j] * mix[TRANS ? i * NJ + j : j * NJ + i];
  return v;
}

// A staged product input: timestep t's J values (float4 loads; the pad
// joints are zero) and the store of J values with the pad.
static __device__ __forceinline__ void load_staged(const float4* in, int t,
                                                   float* a) {
#pragma unroll
  for (int q = 0; q < WB_J4; ++q) {
    const float4 v = in[t * WB_J4 + q];
    a[4 * q] = v.x;
    a[4 * q + 1] = v.y;
    a[4 * q + 2] = v.z;
    a[4 * q + 3] = v.w;
  }
}
static __device__ __forceinline__ void store_staged(float4* in, int t,
                                                    const float* c) {
#pragma unroll
  for (int q = 0; q < WB_J4; ++q) {
    const int j = 4 * q;
    in[t * WB_J4 + q] =
        make_float4(c[j], j + 1 < NJ ? c[j + 1] : 0.f,
                    j + 2 < NJ ? c[j + 2] : 0.f, j + 3 < NJ ? c[j + 3] : 0.f);
  }
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
// The lane layout of a program (SOLVER_*) in a streamed body (WB_BODY_*).
__host__ __device__ constexpr int stream_layout(int solver, int body) {
  return body == WB_BODY_REACH
             ? (solver == SOLVER_GD || solver == SOLVER_BLS_EXACT
                    ? WB_LY_REACH_NODIR
                    : WB_LY_REACH_GXDIR)
             : (solver == SOLVER_BLS_BF16 ? WB_LY_HALF : WB_LY_STREAMED);
}
// A streamed lane's region.  SWarp's (and WB_LY_REACH_GXDIR's): the
// planes alpha, grad, dir_t, dir_v, traj and vel (6 J T, padded to 4
// floats), the buffer, the obstacle terms and the endpoints; its gx/gy
// planes (2 T) sit in the CTA's gx/gy room beside the other lanes' (the K7
// ring's room), or, in WB_LY_REACH_GXDIR, in its direction planes.
// HWarp's: alpha, grad (J, T) and the ladder planes (4 J T bfloat16 = 2 J T
// floats); WB_LY_REACH_NODIR's: alpha, grad, traj and vel (4 J T); then
// the buffer, obstacles and endpoints.
__host__ __device__ __forceinline__ size_t lane_floats(int layout, int T,
                                                       int O) {
  const size_t planes =
      layout == WB_LY_HALF || layout == WB_LY_REACH_NODIR
          ? (size_t)4 * NJ * T
          : (size_t)((6 * NJ * T + 3) & ~3);
  return planes + (size_t)WB_ROWS * wb_row_stride(T) + (size_t)4 * O +
         WB_LANE_FLOATS;
}
// The K7 geometry (mirror of k7_geometry in ops/fused_solve.py).  A CTA of
// the streamed plan runs a tile of L lanes (at most WB_STREAM_WARPS - 1),
// one warp each; its other warps help with the products, and its last
// warp is the ring's producer.  The consumers' 32 (WB_STREAM_WARPS - 1)
// threads split each product into lane blocks of WB_K7_LANES lanes and,
// within a block, rows: each thread computes k7_rows consecutive rows for
// every lane of its block (WB_K7_SOLO_ROWS for one lane alone: its
// products take several passes, and fewer rows a pass leave fewer
// threads idle in the last).
__host__ __device__ __forceinline__ int k7_lane_blocks(int L) {
  return (L + WB_K7_LANES - 1) / WB_K7_LANES;
}
__host__ __device__ __forceinline__ int k7_rows(int L) {
  return L == 1 ? WB_K7_SOLO_ROWS : WB_K7_ROWS;
}
// The rows of one pass (a row block of the basis in device memory): what a
// lane block's threads cover, at most the rows (padded to a multiple of 4).
__host__ __device__ __forceinline__ int k7_row_block(int rows, int L) {
  const int per =
      k7_rows(L) * (32 * (WB_STREAM_WARPS - 1) / k7_lane_blocks(L));
  const int need = (rows + 3) & ~3;
  return per < need ? per : need;
}
// The CTA's room (floats, a multiple of 4): the tile's gx/gy planes, which
// no lane holds across a product, and the K7 ring, which takes the whole
// room during a product: the shared memory the lanes leave, at most
// WB_RING_CAP floats, at least the planes (the ring alone in
// WB_LY_REACH_GXDIR, whose gx/gy sit in the direction planes).
__host__ __device__ __forceinline__ size_t ws_room_floats(int T, int O, int L,
                                                          int layout) {
  const size_t used = WB_CTA_FLOATS + (size_t)L * lane_floats(layout, T, O);
  const size_t left = WB_SMEM_MAX / 4 > used ? WB_SMEM_MAX / 4 - used : 0;
  const size_t room = (left < WB_RING_CAP ? left : WB_RING_CAP) & ~(size_t)3;
  if (layout == WB_LY_REACH_GXDIR) return room;
  const size_t planes = ((size_t)2 * T * L + 3) & ~(size_t)3;
  return room > planes ? room : planes;
}
// The dynamic shared memory of a CTA of ``lanes`` lanes in the body
// ``streamed`` (any streamed body: the lane layout ``layout``).
static size_t warp_smem_bytes(const FsParams& p, int lanes, bool streamed,
                              int layout) {
  if (streamed)
    return sizeof(float) *
           (WB_CTA_FLOATS + ws_room_floats(p.T, p.O, lanes, layout) +
            (size_t)lanes * lane_floats(layout, p.T, p.O));
  return sizeof(float) *
         (wb_basis_floats(p.T) + (size_t)lanes * wb_warp_floats(p.T, p.O));
}

// One warp's view of its lane in the resident body: per-CTA basis, the
// per-warp planes and buffers, and this thread's timesteps in registers.
struct Warp {
  static constexpr int G = WB_SLOTS;  // timesteps per thread
  const float* kvT;   // (T, 2T)
  const float* kvtT;  // (2T, T)
  const float* mix;   // (J, J)
  float *alpha, *grad, *dir_t, *dir_v;  // (J, T), [j * T + t]
  float* buf;         // WB_ROWS rows of RS, or 2T staged timesteps
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

// What every view of the streamed bodies shares: the tile (L lanes, W warps,
// this warp's lane; ``sub`` 0 for a lane's own warp, 1 for a helper or the
// producer, whose view is lane 0's), the CTA's control block (the K7 ring's
// mbarriers, the tile's first lane) and the room.
struct Tile {
  int L, W, lane, sub;
  unsigned long long* full;   // WB_K7_STAGES mbarriers: a stage is loaded
  unsigned long long* empty;  // WB_K7_STAGES mbarriers: a stage is read
  int* base;                  // the tile's first lane
  float* room;                // the tile's gx/gy planes; the K7 ring
  size_t room_floats;         // ws_room_floats
  size_t stride;              // floats between two lanes' regions
  unsigned seq;               // ring stages used so far (every thread)
};

// The streamed body's view: the transposed basis pair in device memory,
// and every plane (traj, vel, gx, gy too) in shared memory.  Thread i owns
// t = i + 32 g for the G = ceil(T / 32) groups g.  LY: its lane layout
// (WB_LY_STREAMED, or a reach layout: no direction planes in
// WB_LY_REACH_NODIR, dir_t/dir_v null; gx/gy in the direction planes in
// WB_LY_REACH_GXDIR).
template <int LY>
struct SWarpT : Tile {
  const float* kvT;   // device memory: kv transposed, in row blocks (K7)
  const float* kvtT;  // device memory: kvt transposed, in row blocks
  const float* mix;   // shared (J, J)
  float *alpha, *grad, *dir_t, *dir_v;  // (J, T), [j * T + t]
  float *traj, *vel;  // (J, T)
  float *gx, *gy;     // (T,), in the room
  float* buf;         // WB_ROWS rows of RS, or 2T staged timesteps
  float4* obs;        // (O,)
  float* ends;        // as Warp's
  int T, O, RS, lid, G;
  float lam_sg, lam_jl;
  // Pass A keeps its FK tangents for pass B in the direction planes (the
  // streamed layout); the reach layouts recompute them in pass B.
  static constexpr bool kKeepsFk = LY == WB_LY_STREAMED;

  __device__ __forceinline__ int tt(int g) const { return lid + 32 * g; }
  __device__ __forceinline__ int ts(int g) const { return min(tt(g), T - 1); }
  __device__ __forceinline__ bool owns(int g) const { return tt(g) < T; }
  // Lane l's view of the tile's planes (the K7 sinks write through it).
  __device__ __forceinline__ SWarpT at(int l) const {
    SWarpT v = *this;
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
    if constexpr (LY == WB_LY_REACH_GXDIR) {
      v.gx = v.dir_t;
      v.gy = v.dir_v;
    } else {
      v.gx += (ptrdiff_t)(l - lane) * 2 * T;
      v.gy = v.gx + T;
    }
    v.lane = l;
    return v;
  }
};
using SWarp = SWarpT<WB_LY_STREAMED>;

// The half-width streamed body's view (the bf16 tier's program): SWarp's,
// with the ladder planes traj_h, vel_h, dir_th, dir_vh (J, T) bfloat16 in
// the room where traj and vel (J, T) float32 sit at the round start and
// end.  ``half``: the iterate is the accepted linearized one, formed per
// timestep as traj_h - lr_acc dir_th (load_point); otherwise traj/vel.
struct HWarp : Tile {
  const float* kvT;   // device memory, as SWarp's
  const float* kvtT;
  const float* mix;   // shared (J, J)
  float *alpha, *grad;  // (J, T)
  float *gx, *gy;       // (T,), in the room
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
  __device__ __forceinline__ HWarp at(int l) const {
    HWarp v = *this;
    const ptrdiff_t d = (ptrdiff_t)(l - lane) * (ptrdiff_t)stride;
    v.alpha += d;
    v.grad += d;
    v.traj += d;
    v.vel += d;
    v.traj_h += 2 * d;
    v.vel_h += 2 * d;
    v.dir_th += 2 * d;
    v.dir_vh += 2 * d;
    v.buf += d;
    v.ends += d;
    v.gx += (ptrdiff_t)(l - lane) * 2 * T;
    v.gy = v.gx + T;
    v.lane = l;
    return v;
  }
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
  for (int i = threadIdx.x; i < NJ * NJ; i += blockDim.x)
    smem[2 * n + i] = mix[i];
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
// Wait for the phase of parity ``parity`` to complete (a fresh barrier
// counts the phase before its first as complete, parity 1).  A protocol
// fault traps after some seconds instead of holding the card.
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
// One bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, counted on ``bar``.
static __device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                                 unsigned bytes,
                                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The streamed bodies' CTA pieces (mix, the control block, the room) and
// this warp's lane (warp i < lanes runs lane i).  Stages mix, initializes
// the ring's mbarriers; one __syncthreads.
template <class SW>
static __device__ float* bind_tile(SW& w, float* smem, int T, int O,
                                   int lanes, int layout, const float* kvT_dev,
                                   const float* kvtT_dev,
                                   const float* __restrict__ mix) {
  const int W = blockDim.x >> 5, wid = threadIdx.x >> 5;
  w.L = lanes;
  w.W = W;
  w.sub = wid < lanes ? 0 : 1;
  w.lane = wid < lanes ? wid : 0;
  w.full = (unsigned long long*)(smem + WB_MIX_FLOATS);
  w.empty = w.full + WB_K7_STAGES;
  w.base = (int*)(w.empty + WB_K7_STAGES);
  w.room = smem + WB_CTA_FLOATS;
  w.room_floats = ws_room_floats(T, O, lanes, layout);
  w.seq = 0;
  for (int i = threadIdx.x; i < NJ * NJ; i += blockDim.x) smem[i] = mix[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < WB_K7_STAGES; ++i) {
      mbar_init(w.full + i, 1);
      mbar_init(w.empty + i, W - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  w.T = T;
  w.O = O;
  w.RS = wb_row_stride(T);
  w.lid = threadIdx.x & 31;
  w.G = (T + 31) >> 5;
  w.kvT = kvT_dev;
  w.kvtT = kvtT_dev;
  w.mix = smem;
  w.gx = w.room + (size_t)w.lane * 2 * T;
  w.gy = w.gx + T;
  return w.room + w.room_floats;
}

// Bind this warp's view of its lane in the streamed body of layout LY
// (lane regions after the room, each lane_floats).
template <int LY = WB_LY_STREAMED>
static __device__ SWarpT<LY> bind_swarp(float* smem, int T, int O, int lanes,
                                        const float* kvT_dev,
                                        const float* kvtT_dev,
                                        const float* __restrict__ mix) {
  SWarpT<LY> w;
  float* regions =
      bind_tile(w, smem, T, O, lanes, LY, kvT_dev, kvtT_dev, mix);
  w.stride = lane_floats(LY, T, O);
  float* mine = regions + (size_t)w.lane * w.stride;
  const int plane = NJ * T;
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
    w.buf = mine + ((6 * plane + 3) & ~3);
  }
  if constexpr (LY == WB_LY_REACH_GXDIR) {
    w.gx = w.dir_t;
    w.gy = w.dir_v;
  }
  w.obs = (float4*)(w.buf + WB_ROWS * w.RS);
  w.ends = (float*)(w.obs + w.O);
  return w;
}

// Bind this warp's half-width view (the layout WB_LY_HALF).
static __device__ HWarp bind_hwarp(float* smem, int T, int O, int lanes,
                                   const float* kvT_dev, const float* kvtT_dev,
                                   const float* __restrict__ mix) {
  HWarp w;
  float* regions =
      bind_tile(w, smem, T, O, lanes, WB_LY_HALF, kvT_dev, kvtT_dev, mix);
  w.stride = lane_floats(WB_LY_HALF, T, O);
  float* mine = regions + (size_t)w.lane * w.stride;
  const int plane = NJ * T;
  w.alpha = mine;
  w.grad = mine + plane;
  float* ladder = mine + 2 * plane;
  w.traj = ladder;
  w.vel = ladder + plane;
  w.traj_h = (__nv_bfloat16*)ladder;
  w.vel_h = w.traj_h + plane;
  w.dir_th = w.vel_h + plane;
  w.dir_vh = w.dir_th + plane;
  w.buf = ladder + 2 * plane;
  w.obs = (float4*)(w.buf + WB_ROWS * w.RS);
  w.ends = (float*)(w.obs + w.O);
  w.lr_acc = 0.f;
  w.half = false;
  return w;
}

// The tile's first lane, drawn from the device queue by the CTA (all
// threads receive it).
template <class SW>
static __device__ __forceinline__ int next_tile(const SW& w, int* queue) {
  __syncthreads();  // the previous tile's readers of the base are done
  if (threadIdx.x == 0) *w.base = atomicAdd(queue, w.L);
  __syncthreads();
  return *w.base;
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

// Each of the first n threads runs the sequential chain over row ``lid``:
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
// NaN this is the sequential `t == 0 || cv > cmax` scan's result
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

// The masked limit losses of one timestep (scalar_cost's terms).
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

// The penalized loss from the cost rows (cost_total, on every thread from
// the same broadcast values: the result is warp-uniform).
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
  const float* e = w.ends;
  return cost_total(p, a, e, e + NJ, w.lam_sg, w.lam_jl, e + 2 * NJ,
                    e + 3 * NJ, e + 4 * NJ, e + 5 * NJ);
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
// vel): the plain constraints_ok's, its extrema chains run by thread 0.
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
// as a product input (store_staged).
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
    float c[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) c[j] = src[j * w.T + t] * scale;
    store_staged(in, t, c);
  }
  __syncwarp();
}

// Stage the candidate alpha (1 - lambda_reg lr) alpha - lr (grad scale) of
// the own timesteps into the buffer as a product input (store_staged),
// rounded once (fmaf, as XLA contracts it on the CPU): the exact
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
    store_staged(in, t, c);
  }
  __syncwarp();
}

// Obstacle field at one end-effector point.
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
#ifdef WB_ABLATE_FK
  const float ex = tr[0], ey = ve[0];  // timing only (pallas_step.py:794)
#else
  float px[NJ], py[NJ], ex, ey;
  fk_point(p, tr, px, py, ex, ey);
#endif
#ifdef WB_ABLATE_OBSFIELD
  const float cv = ex + ey;  // timing only (pallas_step.py:800)
#else
  const float cv = field(w, ex, ey);
#endif
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
    float a[WB_JS];
    load_staged(in, t, a);
    const float* k = w.kvT + t * R2;
#pragma unroll
    for (int r = 0; r < 2 * WB_SLOTS; ++r) {
      const float kk = k[row[r]];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] = fmaf(kk, a[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2 * WB_SLOTS; ++r)
#pragma unroll
    for (int i = 0; i < NJ; ++i) out[r][i] = mixed<false>(w.mix, i, acc[r]);
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
#ifdef WB_ABLATE_DIR_FORWARD
  // Timing only (pallas_step.py:755): the normalized gradient stands for
  // the direction's traj and vel rows.
  float out[2 * WB_SLOTS][NJ];
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s)
#pragma unroll
    for (int i = 0; i < NJ; ++i)
      out[s][i] = out[WB_SLOTS + s][i] = w.grad[i * T + w.ts(s)] * inv_norm;
#else
  stage_input(w, w.grad, inv_norm);
  float out[2 * WB_SLOTS][NJ];
  forward_rows(w, out);
#endif
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
// (fmaf) when FUSED: every program, and the linearized ladder's carry
// program at every J but 3 (WB_CARRY_FUSED; bls_step says why).
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

// Passes B and C: the stacked position/velocity gradient (staged rows of
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
      store_staged(stack, t, gp);
      store_staged(stack, T + t, gv);
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
    float g[WB_JS];
    load_staged(stack, t2, g);
    const float* k = w.kvtT + t2 * T;
#pragma unroll
    for (int s = 0; s < WB_SLOTS; ++s) {
      const float kk = k[row[s]];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[s][j] = fmaf(kk, g[j], acc[s][j]);
    }
  }
#pragma unroll
  for (int s = 0; s < WB_SLOTS; ++s) {
    if (!w.owns(s)) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      w.grad[j * T + row[s]] = mixed<true>(w.mix, j, acc[s]);
  }
}

// Loss of one ladder rung at learning rate lr.  Linearized: the candidate
// (traj - lr dir_t, vel - lr dir_v); BASE: the zero-lr candidate (traj,
// vel) itself (the bf16 tier's baseline).  EXACT: the candidate alpha
// (1 - lambda_reg lr) alpha - lr (grad inv_norm), in the operand order of
// the accepted update, staged as a product input (as gd_step stages its
// trial) and evaluated through kv into the traj/vel
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
// The streamed bodies and K7, their basis product.
// ---------------------------------------------------------------------------

// Whether a lane of block b (lanes b LB ..) takes the product.
template <class SW>
static __device__ __forceinline__ bool k7_block_on(const SW& w, int b,
                                                   int LB) {
  bool on = false;
  for (int i = 0; i < LB && b * LB + i < w.L; ++i)
    on = on || w.at(b * LB + i).ends[WB_K7_ON] != 0.f;
  return on;
}

// K7: rows [0, rows) of M @ in for every lane of the tile that takes the
// product (``on``: this warp's lane does), with M (rows, n_t) given
// transposed in device memory in row blocks of R = k7_row_block(rows, L)
// rows (MT[(blk n_t + t) R + r] = M[blk R + r][t], the rows zero-padded to
// a whole block: fused_solve.streamed_basis) and each lane's input in its
// buffer, n_t staged timesteps (store_staged).  Every thread of the CTA
// calls it, at the same call sites in the same order; it does nothing when
// no lane of the tile takes the product.
//
// The ring: the room holds WB_K7_STAGES stages of st = room / (stages R)
// timesteps of a row block, taken block by block in t order, each stage one
// TMA bulk copy issued by the producer warp (the CTA's last) once every
// consumer warp has released the stage's slot (empty mbarrier); the
// consumers wait for its bytes (full mbarrier).  Consumer thread c takes
// lane block c / (R / RT) and the RT = k7_rows(L) consecutive rows
// RT (c mod R / RT) of each row block, for the block's lanes (a lane past
// the tile reads its block's first lane's input and keeps nothing; a block
// whose lanes all sit the product out computes nothing).  Each timestep RT
// floats of the stage and the staged timestep of each lane's input: each
// output one sequential fmaf chain over t per joint (the resident body's,
// bit for bit), handed to sink(view of the lane, r, acc) (acc: its J
// chains) for the lanes that take the product.
template <int RT, int LB, class SW, class Sink>
static __device__ __forceinline__ void k7_run(SW& w, const float* MT,
                                              int rows, int n_t, Sink& sink) {
  constexpr int S = WB_K7_STAGES;
  const int L = w.L, C = w.W - 1;
  const int R = k7_row_block(rows, L), st = (int)(w.room_floats / (S * R));
  const int nblk = (rows + R - 1) / R, ntile = (n_t + st - 1) / st;
  const int uses = nblk * ntile;
  if ((int)(threadIdx.x >> 5) == C) {  // the producer
    if (w.lid == 0) {
      for (int u = 0; u < uses; ++u) {
        const unsigned g = w.seq + (unsigned)u, slot = g % S;
        mbar_wait(w.empty + slot, ((g / S) & 1u) ^ 1u);
        const int blk = u / ntile, t0 = (u - blk * ntile) * st;
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
  // A lane block none of whose lanes takes the product computes nothing.
  const bool act = lb < k7_lane_blocks(L) && k7_block_on(w, lb, LB);
  const int l0 = act ? lb * LB : 0;
  const ptrdiff_t lane4 = (ptrdiff_t)(w.stride / 4);  // float4 per region
  const float4* in[LB];
#pragma unroll
  for (int i = 0; i < LB; ++i)
    in[i] = (const float4*)w.buf +
            (ptrdiff_t)((l0 + i < L ? l0 + i : l0) - w.lane) * lane4;
  float acc[RT][LB][NJ];
  for (int u = 0; u < uses; ++u) {
    const int blk = u / ntile, tile = u - blk * ntile;
    const unsigned g = w.seq + (unsigned)u, slot = g % S;
    if (tile == 0) {
#pragma unroll
      for (int h = 0; h < RT; ++h)
#pragma unroll
        for (int i = 0; i < LB; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[h][i][j] = 0.f;
    }
    mbar_wait(w.full + slot, (g / S) & 1u);
    const int t0 = tile * st, nt = min(st, n_t - t0);
    if (act && blk * R + q < rows) {
      const float* stg = w.room + (size_t)slot * R * st + q;
#pragma unroll 4
      for (int k = 0; k < nt; ++k) {
        float kk[RT];
        if constexpr (RT == 4) {
          const float4 k4 = *(const float4*)(stg + (size_t)k * R);
          kk[0] = k4.x;
          kk[1] = k4.y;
          kk[2] = k4.z;
          kk[3] = k4.w;
        } else {
          const float2 k2 = *(const float2*)(stg + (size_t)k * R);
          kk[0] = k2.x;
          kk[1] = k2.y;
        }
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          float a[WB_JS];
          load_staged(in[i], t0 + k, a);
#pragma unroll
          for (int h = 0; h < RT; ++h)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              acc[h][i][j] = fmaf(kk[h], a[j], acc[h][i][j]);
        }
      }
    }
    __syncwarp();
    if (w.lid == 0) mbar_arrive(w.empty + slot);
    if (tile == ntile - 1 && act) {
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        if (l0 + i >= L) break;
        const SW v = w.at(l0 + i);
        if (v.ends[WB_K7_ON] == 0.f) continue;
#pragma unroll
        for (int h = 0; h < RT; ++h) {
          const int r = blk * R + q + h;
          if (r < rows) sink(v, r, acc[h][i]);
        }
      }
    }
  }
}

template <class SW, class Sink>
static __device__ void k7_product(SW& w, const float* MT, int rows, int n_t,
                                  bool on, Sink sink) {
  if (w.sub == 0 && w.lid == 0) w.ends[WB_K7_ON] = on ? 1.f : 0.f;
  // The room's planes were last written through the generic proxy; the
  // ring's bulk copies write it through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (!__syncthreads_or(on)) return;  // the inputs and flags are visible
  const int L = w.L;
  if (L == 1)
    k7_run<WB_K7_SOLO_ROWS, 1>(w, MT, rows, n_t, sink);
  else
    k7_run<WB_K7_ROWS, WB_K7_LANES>(w, MT, rows, n_t, sink);
  const int R = k7_row_block(rows, L);
  const int st = (int)(w.room_floats / (WB_K7_STAGES * R));
  w.seq += (unsigned)(((rows + R - 1) / R) * ((n_t + st - 1) / st));
  __syncthreads();  // the sinks' rows are visible; the room is free again
}

// (traj, vel) = the staged input through kv, into the traj/vel planes of
// the lanes that take it.
template <int LY>
static __device__ __forceinline__ void eval_staged(SWarpT<LY>& w, bool on) {
  const int T = w.T;
  k7_product(w, w.kvT, 2 * T, T, on,
             [&](const SWarpT<LY>& v, int r, const float* a) {
               if (r >= 2 * T) return;
               float* out = r < T ? v.traj + r : v.vel + (r - T);
#pragma unroll
               for (int i = 0; i < NJ; ++i)
                 out[i * T] = mixed<false>(v.mix, i, a);
             });
}

// The search direction (the resident direction's, through K7; the bf16
// tier's program runs the half-width body instead).
template <bool HALF, int LY>
static __device__ __forceinline__ void direction(const FsParams& p,
                                                 SWarpT<LY>& w,
                                                 float inv_norm, bool on) {
  static_assert(!HALF, "the bf16 tier streams through HWarp");
  static_assert(LY != WB_LY_REACH_NODIR, "a layout without direction planes");
  const int T = w.T;
  if (on) stage_input(w, w.grad, inv_norm);
  k7_product(w, w.kvT, 2 * T, T, on,
             [&](const SWarpT<LY>& v, int r, const float* a) {
               if (r >= 2 * T) return;
               const bool pos = r < T;
               const int t = pos ? r : r - T;
               const float* x = pos ? v.traj : v.vel;
               float* d = pos ? v.dir_t : v.dir_v;
#pragma unroll
               for (int i = 0; i < NJ; ++i)
                 d[i * T + t] = p.lambda_reg * x[i * T + t] +
                                mixed<false>(v.mix, i, a);
             });
}

// (traj, vel) = the exact evaluation of alpha, for the lanes that take it.
template <class SW>
static __device__ __forceinline__ void eval_alpha(SW& w, bool on) {
  if (on) stage_input(w, w.alpha, 1.f);
  eval_staged(w, on);
}

// The ultra tier's step start (the resident eval_start's).
template <bool HALF, int LY>
static __device__ __forceinline__ void eval_start(SWarpT<LY>& w, bool on) {
  static_assert(!HALF, "the bf16 tier streams through HWarp");
  eval_alpha(w, on);
}

// The accepted BLS step (the resident accept_step's, on the planes).
template <bool EXACT, bool FUSED, int LY>
static __device__ __forceinline__ void accept_step(const FsParams& p,
                                                   SWarpT<LY>& w,
                                                   float lr_eff,
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
template <int LY>
static __device__ __forceinline__ void load_point(const SWarpT<LY>& w, int t,
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

// Passes B and C (the resident grad_pass's; pass C through K7 over kvt) for
// the lanes that take them.
template <class SW>
static __device__ __forceinline__ void grad_pass(const FsParams& p, SW& w,
                                                 int first, bool on) {
  const int T = w.T;
  if (on) {
    float4* stack = (float4*)w.buf;
    __syncwarp();
    for (int g = 0; g < w.G; ++g) {
      if (!w.owns(g)) continue;
      const int t = w.tt(g);
      float tr[NJ], ve[NJ], gp[NJ], gv[NJ];
      load_point(w, t, tr, ve);
      stacked_grad(p, w, t, first, tr, ve, w.gx[t], w.gy[t], gp, gv);
      store_staged(stack, t, gp);
      store_staged(stack, T + t, gv);
    }
  }
  k7_product(w, w.kvtT, T, 2 * T, on,
             [&](const SW& v, int r, const float* a) {
               if (r >= T) return;
#pragma unroll
               for (int j = 0; j < NJ; ++j)
                 v.grad[j * T + r] = mixed<true>(v.mix, j, a);
             });
}

// Loss of one ladder rung (the resident rung_cost's; the exact candidate's
// evaluation goes into the traj/vel planes, a product: ``on``, this lane
// takes it, and every warp of the tile calls the exact rung).
template <bool EXACT, bool BASE = false, int LY>
static __device__ __forceinline__ float rung_cost(const FsParams& p,
                                                  SWarpT<LY>& w, float lr,
                                                  float inv_norm,
                                                  bool on = true) {
  static_assert(!BASE, "the bf16 tier streams through HWarp");
  const int T = w.T;
  if constexpr (EXACT) {
    if (on) stage_candidate<SWarpT<LY>, true>(
        w, 1.f - p.lambda_reg * lr, lr, inv_norm);
    eval_staged(w, on);
    if (!on) return 0.f;
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
static __device__ __forceinline__ void eval_staged(HWarp& w, bool on) {
  const int T = w.T;
  k7_product(w, w.kvT, 2 * T, T, on,
             [&](const HWarp& v, int r, const float* a) {
               if (r >= 2 * T) return;
               float* out = r < T ? v.traj + r : v.vel + (r - T);
#pragma unroll
               for (int i = 0; i < NJ; ++i)
                 out[i * T] = mixed<false>(v.mix, i, a);
             });
  if (on) w.half = false;
}

// The step start: the exact evaluation of alpha, rounded to bfloat16, into
// traj_h/vel_h.
template <bool HALF>
static __device__ __forceinline__ void eval_start(HWarp& w, bool on) {
  static_assert(HALF, "HWarp runs the bf16 tier only");
  const int T = w.T;
  if (on) stage_input(w, w.alpha, 1.f);
  k7_product(w, w.kvT, 2 * T, T, on,
             [&](const HWarp& v, int r, const float* a) {
               if (r >= 2 * T) return;
               __nv_bfloat16* out = r < T ? v.traj_h + r : v.vel_h + (r - T);
#pragma unroll
               for (int i = 0; i < NJ; ++i)
                 out[i * T] =
                     __float2bfloat16_rn(mixed<false>(v.mix, i, a));
             });
}

// The search direction (the resident direction<true>'s), into dir_th/dir_vh.
template <bool HALF>
static __device__ __forceinline__ void direction(const FsParams& p, HWarp& w,
                                                 float inv_norm, bool on) {
  static_assert(HALF, "HWarp runs the bf16 tier only");
  const int T = w.T;
  const float lam = bf16_round(p.lambda_reg);
  if (on) stage_input(w, w.grad, inv_norm);
  k7_product(w, w.kvT, 2 * T, T, on,
             [&](const HWarp& v, int r, const float* a) {
               if (r >= 2 * T) return;
               const bool pos = r < T;
               const int t = pos ? r : r - T;
               const __nv_bfloat16* x = pos ? v.traj_h : v.vel_h;
               __nv_bfloat16* d = pos ? v.dir_th : v.dir_vh;
#pragma unroll
               for (int i = 0; i < NJ; ++i)
                 d[i * T + t] = __float2bfloat16_rn(
                     lam * __bfloat162float(x[i * T + t]) +
                     mixed<false>(v.mix, i, a));
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
// The BLS and GD steps and the round of the resident body (W = Warp); the
// streamed bodies run them in lockstep (below).
// ---------------------------------------------------------------------------

// (traj, vel) = the exact evaluation of alpha.
static __device__ __forceinline__ void eval_alpha(Warp& w) {
  stage_input(w, w.alpha, 1.f);
  eval_staged(w);
}

// One BLS inner step of a live lane (pallas_step's _bls_step in each tier;
// K1/K2's steps and K3's, step_kernels.cu): normalized direction, the
// early-exit Armijo ladder (first pass wins), the accepted iterate, and the
// gradient pulled back at it unless the stop test fired.  Returns stop.
//
// Linearized (SOLVER_BLS): the direction's forward evaluation, the ladder
// on the linearized trajectory, and the FK carry: the pull-back's cost pass
// recomputes FK at the accepted candidate, the same floats, and the rung's
// loss is kept.  It is also pallas_step's lean tier and its per-step
// kernel bls_inner_step (K3), which recompute that loss: the accepted
// candidate is formed by the rung's own operations, so the recompute would
// give the rung's floats (tests/test_torch_step.py holds the plain versions
// to it).  SOLVER_BLS_ULTRA: the loss
// recomputed in the cost pass, with (traj, vel) first evaluated
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
// the new alpha twice, at J = 3 only (WB_CARRY_FUSED): once, it moves
// bench.py's reference scene, a 3-link arm, past the strict endpoint gate
// (PERF.md section 7); at every other J it rounds it once, as JAX's kernel.
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
#ifdef WB_ABLATE_LADDER1
  for (int k = 0; k < 1; ++k) {  // timing only (pallas_step.py:736)
#else
  for (int k = 0; k < p.n_bls; ++k) {
#endif
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

  accept_step<EXACT, !CARRY || WB_CARRY_FUSED>(p, w, lr_eff, inv_norm);
  if constexpr (EXACT) {
    if (!found) eval_alpha(w);
  }
  float nloss = loss_best;
#ifndef WB_ABLATE_PULLBACK  // timing only (pallas_step.py:908)
  if (!stop) {
    int first;
    if constexpr (CARRY)
      cost_pass(p, w, false, first);
    else
      nloss = cost_pass(p, w, true, first);
    grad_pass(p, w, first);
  }
#endif
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

// One penalty round of a live lane under its current penalties
// (pallas_step's run_inner): round-start exact evaluation, loss and
// gradient; up to n_r steps of SOLVER from learning rate lr0; the exact
// evaluation at the final alpha and the constraint check.  Returns whether the constraints hold;
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

// ---------------------------------------------------------------------------
// The streamed bodies' steps and round, in lockstep over the CTA's tile.
// ---------------------------------------------------------------------------
//
// The resident bls_step, gd_step and warp_round, op for op, for a tile of
// lanes in lockstep: ``live`` says whether this warp's lane takes part (a
// lane that is done, and every warp but a lane's first, does not).  Every
// warp reaches every basis product (an evaluation, a direction, a
// pull-back) at the same call site, with ``on`` saying whether its lane
// takes it; the pieces without a product run under the lane's own flag.
// The loops take the most trips any live lane of the tile needs
// (__syncthreads_or), and a lane leaves them as the resident body's break
// would.

template <int SOLVER, class SW>
static __device__ __forceinline__ bool ls_bls_step(const FsParams& p, SW& w,
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
    // Each rung evaluates its candidate through the basis: the tile's
    // lanes climb the ladder together until each has its first pass.
    bool want = live;
    for (int k = 0; k < p.n_bls; ++k) {
      if (!__syncthreads_or(want)) break;
      const float lr_r = lr * rung;
      const float closs = rung_cost<true>(p, w, lr_r, inv_norm, want);
      if (want) {
        const float required = base - p.bls_alpha * lr_r * alpha_norm;
        if (closs <= required) {  // first pass wins
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
      if (closs <= required) {  // first pass wins
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

  if (live)
    accept_step<EXACT, !CARRY || WB_CARRY_FUSED>(p, w, lr_eff, inv_norm);
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

template <class SW>
static __device__ __forceinline__ bool ls_gd_step(const FsParams& p, SW& w,
                                                  float& loss, float lr,
                                                  bool live) {
  const float a_fac = 1.f - p.lambda_reg * lr;
  if (live) stage_candidate<SW, false>(w, a_fac, lr, 1.f);
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

// The round (warp_round's), for the tile; returns whether this lane's
// constraints hold (false for a lane that does not take part).
template <int SOLVER, class SW>
static __device__ __forceinline__ bool ls_round(const FsParams& p, SW& w,
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
      if (!__syncthreads_or(go)) break;
      const bool stop = ls_gd_step(p, w, loss, lr0, go);
      if (go) {
        if (stop) {
          rejected = true;
          go = false;
        } else {
          inner += 1.f;  // live before the step and after it
        }
      }
    }
    eval_alpha(w, rejected);
  } else {
    float lr = lr0;
    bool go = live;
    for (int k = 0; k < n_r; ++k) {
      if (!__syncthreads_or(go)) break;
      const bool stop = ls_bls_step<SOLVER>(p, w, loss, lr, go);
      if (go) {
        if (stop)
          go = false;
        else
          inner += 1.f;  // live before the step and after it
      }
    }
    if constexpr (SOLVER != SOLVER_BLS_EXACT) eval_alpha(w, live);
  }
  return live && constraints_ok(p, w);
}
