// K1 — fused move-grid score + per-row top-R, for Hopper (sm_90a).
//
// What it replaces.  In the JAX reference the per-step rescore of the
// device-resident search (cruise_control_tpu/analyzer/tpu_optimizer.py,
// `full_rescore` in `_cached_scan_fn`) scores the K x D move grid with
// `ops/grid.py: move_grid_scores` and ranks every row with `_grid_top_r`
// (lax.top_k / approx_max_k).  XLA fuses the broadcast grid into the
// consuming top-k, so [K, D] never reaches memory.  Eager PyTorch does no
// such fusion: the plain chain materializes [K, D, R] and [K, S, D]
// temporaries (131 MB each at K = 8192, D = 1000).  This kernel is that
// fusion written by hand.
//
// What it computes.  For source row k and destination pool index j:
//     score(k, j) = src_term[k] + (f_dst_new(k, j) - f_dst_old(j))
// where the move is feasible (dest valid and dest_ok and rcount headroom,
// src != dest, no duplicate in the S slots of `row`/`origin_row`, no rack
// clash with `other_racks`, capacity holds over all resources on the
// capacity-estimate load, not excluded, lead_ok when the replica leads),
// +inf otherwise; then the R smallest (score, j) pairs of each row,
// ascending, ties to the lowest j (+inf entries included) — the order of
// XLA's top_k and of a stable sort.  f_dst_new is ops/cost.py:broker_cost
// inlined, with its terms added in the same order as the plain torch path
// (built with --fmad=false, so the two agree to the bit).
//
// What bounds it on this card.  Per (k, j) the feasibility test costs
// 3S + 12 operations and, for feasible cells, the inlined cost 71 more;
// each destination column's two leader-count cost terms cost 12 for each
// leader delta, 0 and 1, once a launch.  Inputs and outputs are O(K + D)
// — about 1.4 MB at K = 8192, D = 1000 — against ~0.7 G operations, so
// operations bound it: ~10 us a step at 67 TFLOP/s f32 (ops/grid.py:
// grid_top_r_ops counts the function's least work).
// At the mid-scale step 90 % of the cells are feasible, and a feasible
// cell is a long dependent chain of IEEE divisions (each a reciprocal, its
// Newton steps and a range check) and adds without FMA contraction.  So
// the instructions a cell issues, and how well the warps in flight hide
// their latency, set the time.  The first design held its 21 constants and
// 8 padded slots in registers (116 a thread) and staged the D columns
// (100 KB at D = 1000) in every block of 8 warps: 2 blocks, 16 warps an
// SM, 0.19 ms a step.
//
// What the design does about it.
// - 32 warps an SM: one block of 32 warps an SM, built for 64 registers a
//   thread (__launch_bounds__(1024, 1)), over one staged table.  Of the
//   three ways to more warps in flight, only this one was built: variant
//   builds of this source with 16 and 24 warps a block, each with the
//   constants in registers or in shared memory, all ran slower than 32
//   warps with the constants in registers, although they spill less or
//   not at all.  Streaming the columns through a ring of bulk
//   asynchronous copies (cp.async.bulk + mbarrier) and splitting them
//   over a cluster's distributed shared memory were not built or
//   measured: they shrink the staged table, while the registers a thread
//   cap the warps.  The ring stays the open item of the row-list form,
//   which still stages all D columns in every block.
// - Fewer instructions and registers a cell (csrc/grid_cell.cuh): an
//   instance per slot count and capacity loads; the destinations staged
//   as rows of an odd stride, so every field is an immediate offset from
//   one base (the first structure-of-arrays layout spent an IMAD, and at
//   64 registers a spill reload, on each field's runtime offset); the
//   leader-count terms precomputed per column for a delta of 0 and 1 (two
//   of a cell's eight divisions); the constants in registers, which
//   measured faster than reading them from shared memory.
// - One persistent wave: at most #SM x the resident blocks an SM
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked by
//   grid_top_r_attrs) blocks, each staging the table once and walking
//   rows.
// - A row runs on W warps (a power of two; ops/grid.py:
//   grid_top_r_geometry picks it): W = 1 when the rows outnumber the
//   card's warps (the full grid), more for a short row list, so that a
//   few stale rows spread over the card instead of waiting on one warp
//   each.  The 32·W lanes of a row split its D destinations, each keeps a
//   sorted top-8 of (score, j) in registers, a warp-shuffle merge of the
//   32 lists gives each warp's top-R, and for W > 1 the group's first
//   warp merges the W lists through shared memory.  Every comparison is
//   on (score, j) with j explicit, so the order in which columns are
//   visited does not change the result.
// - A block with no row returns before it stages anything, as does every
//   block of a launch whose gate is shut.
// The per-cell body lives in csrc/grid_cell.cuh, which K17
// (csrc/grid_patch.cu) compiles too.  [K, D] never reaches device memory;
// only the [K, R] result is written.
//
// The incremental rescore (tpu_optimizer.py:1056-1073 `full_rescore` and
// :1134-1144, the patch's part (b)).  With `incremental_rescore=True` the
// step keeps each row's top-R as destination terms, dt = score - src_term,
// in a carry; K1 then runs twice a step, each gated on the device carry
// (csrc/step_common.cuh: gate_open): over every row when the step rescores
// in full, and over the first n (<= RB) rows of a row list (K16's stale
// rows) when it patches.  Both write dt and pool indices into the carry at
// the row's own index.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_cell.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_grid;

constexpr int WARPS = 32;              // warps a block
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// sorted insert of (s, j) into a lane's running top-8
__device__ __forceinline__ void insert(float* ts, int* ti, float s, int j) {
  if (!before(s, j, ts[TOPR - 1], ti[TOPR - 1])) return;
  ts[TOPR - 1] = s;
  ti[TOPR - 1] = j;
#pragma unroll
  for (int q = TOPR - 1; q > 0; --q) {
    if (before(ts[q], ti[q], ts[q - 1], ti[q - 1])) {
      const float s_ = ts[q];
      ts[q] = ts[q - 1];
      ts[q - 1] = s_;
      const int i_ = ti[q];
      ti[q] = ti[q - 1];
      ti[q - 1] = i_;
    }
  }
}

// The warp's R smallest of its 32 lists: R rounds of a butterfly argmin
// over the list heads, the owning lane popping its head; lane q < R gets
// the q-th.  Real entries have unique j, so one lane pops each; lists that
// ran out hold (+inf, INT32_MAX) sentinels, which rank after every real
// entry.
__device__ __forceinline__ void warp_merge(float* ts, int* ti, int R,
                                           int lane, float& my_s,
                                           int& my_i) {
  my_s = INFINITY;
  my_i = -1;
  for (int q = 0; q < R; ++q) {
    float bs = ts[0];
    int bi = ti[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == q) {
      my_s = bs;
      my_i = bi;
    }
    if (ti[0] == bi) {
#pragma unroll
      for (int t = 0; t < TOPR - 1; ++t) {
        ts[t] = ts[t + 1];
        ti[t] = ti[t + 1];
      }
      ts[TOPR - 1] = INFINITY;
      ti[TOPR - 1] = INT32_MAX;
    }
  }
}

__device__ __forceinline__ void clear(float* ts, int* ti) {
#pragma unroll
  for (int q = 0; q < TOPR; ++q) {
    ts[q] = INFINITY;
    ti[q] = INT32_MAX;
  }
}

// `rows`: null = row n is source row n (n < K); else row n is rows[n],
// for n < min(K, *n_rows) (K is then the list's length).  `gate`: null =
// always run; else only when cc_state::gate_open(gate, want).  `dest_terms`:
// write score - src_term (the carry's destination terms), not the score.
// `W`: warps a row (a power of two dividing WARPS).
template <int NS, int CAP>
__global__ void __launch_bounds__(THREADS, 1)
grid_top_r_kernel(const float* __restrict__ src_f,
                  const int* __restrict__ src_i,
                  const float* __restrict__ dst_f,
                  const int* __restrict__ dst_i,
                  const float* __restrict__ consts, int K, int D, int S,
                  int R, int W, float* __restrict__ out_s,
                  int* __restrict__ out_i, const int* __restrict__ rows,
                  const int* __restrict__ n_rows, const int* gate, int want,
                  int dest_terms) {
  if (gate != nullptr && !cc_state::gate_open(gate, want)) return;
  const int n_end = rows != nullptr ? min(K, *n_rows) : K;
  const int groups = WARPS / W;
  if ((int)blockIdx.x * groups >= n_end) return;
  extern __shared__ float st[];                       // [D][CST]
  __shared__ float cand_s[WARPS * TOPR];              // W > 1: each warp's
  __shared__ int cand_i[WARPS * TOPR];                // top-R
  stage_dests(dst_f, dst_i, nullptr, D, consts, st);
  float c[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) c[q] = consts[q];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / W, wg = warp % W;
  for (int base = blockIdx.x * groups; base < n_end;
       base += gridDim.x * groups) {
    const int n = base + group;
    const bool live = n < n_end;                      // warp-uniform
    const int k = live ? (rows != nullptr ? rows[n] : n) : 0;
    float my_s = INFINITY, src_term = 0.0f;
    int my_i = -1;
    float ts[TOPR];
    int ti[TOPR];
    if (live) {
      SrcRow<NS, CAP> r;
      load_src_row(src_f, src_i, k, S, r);
      src_term = r.src_term;
      clear(ts, ti);
      for (int j = wg * 32 + lane; j < D; j += 32 * W) {
        insert(ts, ti, cell_score(r, st, j, c), j);
      }
      warp_merge(ts, ti, R, lane, my_s, my_i);
    }
    if (W > 1) {
      // the group's W lists of R, merged by its first warp (each lane
      // takes at most W·R / 32 <= 8 of them, so none is dropped)
      if (live && lane < R) {
        cand_s[warp * TOPR + lane] = my_s;
        cand_i[warp * TOPR + lane] = my_i;
      }
      __syncthreads();
      if (live && wg == 0) {
        clear(ts, ti);
        for (int e = lane; e < W * R; e += 32) {
          const int at = (warp + e / R) * TOPR + e % R;
          insert(ts, ti, cand_s[at], cand_i[at]);
        }
        warp_merge(ts, ti, R, lane, my_s, my_i);
      }
      __syncthreads();
    }
    if (live && wg == 0 && lane < R) {
      out_s[(size_t)k * R + lane] = dest_terms ? my_s - src_term : my_s;
      out_i[(size_t)k * R + lane] = my_i;
    }
  }
}

size_t smem_bytes(int D) { return (size_t)CST * D * sizeof(float); }

}  // namespace

extern "C" {

// Packed-layout constants, so the Python wrapper can check that its
// packing matches this build: {SF, DF, DI, NC, TOPR, MAX_S, WARPS, CST}.
void grid_top_r_layout(int* out) {
  out[0] = SF;
  out[1] = DF;
  out[2] = DI;
  out[3] = NC;
  out[4] = TOPR;
  out[5] = MAX_S;
  out[6] = WARPS;
  out[7] = CST;
}

// The instance of (S, has_cap)'s resources at D destinations: {registers
// a thread, local (spilled) bytes a thread, static shared bytes, dynamic
// shared bytes, resident blocks an SM}.  Returns the CUDA error code.
int grid_top_r_attrs(int S, int has_cap, int D, int* out) {
  if (S < 1 || S > MAX_S || D < 1) return (int)cudaErrorInvalidValue;
  return with_cell_instance(S, has_cap, [&](auto ns, auto cap) -> int {
    const void* fn = (const void*)
        grid_top_r_kernel<decltype(ns)::value, decltype(cap)::value>;
    const size_t smem = smem_bytes(D);
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes a;
    if ((e = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = (int)smem;
    out[4] = per_sm;
    return 0;
  });
}

// Launches K1 on `stream`: `grid` blocks of WARPS warps, W warps a row;
// returns the CUDA error code (0 = launched).  `rows` / `n_rows` (both or
// neither) restrict it to a row list, K its length; `gate` (or null) and
// `want` gate it on the step loop's carry; `dest_terms` writes
// score - src_term.
int grid_top_r_launch(const float* src_f, const int* src_i,
                      const float* dst_f, const int* dst_i,
                      const float* consts, int K, int D, int S, int R,
                      int has_cap, int W, int grid, float* out_s,
                      int* out_i, const int* rows, const int* n_rows,
                      const int* gate, int want, int dest_terms,
                      void* stream) {
  if (K <= 0 || D <= 0 || S < 1 || S > MAX_S || R < 1 || R > TOPR ||
      R > D || grid < 1 || W < 1 || W > WARPS || (W & (W - 1)) != 0 ||
      (rows == nullptr) != (n_rows == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return with_cell_instance(S, has_cap, [&](auto ns, auto cap) -> int {
    constexpr int NS = decltype(ns)::value, CAP = decltype(cap)::value;
    const size_t smem = smem_bytes(D);
    cudaError_t e = cudaFuncSetAttribute(
        grid_top_r_kernel<NS, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    grid_top_r_kernel<NS, CAP><<<grid, THREADS, smem,
                                 (cudaStream_t)stream>>>(
        src_f, src_i, dst_f, dst_i, consts, K, D, S, R, W, out_s, out_i,
        rows, n_rows, gate, want, dest_terms);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
