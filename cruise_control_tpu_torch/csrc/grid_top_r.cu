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
// (built with --fmad=false, so the two agree to the bit in practice).
//
// What bounds it.  Per (k, j) the feasibility test costs 3S + 12
// operations and, for feasible cells, the inlined cost 83 more (4-6 of
// them IEEE divisions) — ~96 a cell at the mid-scale step, not the ~150
// first estimated; inputs and outputs are O(K + D) — about 1.4 MB at
// K = 8192, D = 1000 — against ~0.8 G operations.  So it is bound by
// operations, not bytes: at 67 TFLOP/s f32 the floor is ~12 us a step at
// that shape (ops/grid.py: grid_top_r_ops counts it from this source).
//
// What the design does about it.  Each block stages the D destination
// columns in shared memory once (structure of arrays, ~100 B per
// destination; the wrapper caps D so it fits), then its warps walk source
// rows: the 32 lanes of a warp split the row's D destinations, each keeps
// a sorted top-8 of (score, j) in registers, and a warp-shuffle merge of
// the 32 lists finishes the row.  Cost arithmetic runs only for cells that
// pass the cheap integer feasibility test first.  [K, D] never reaches
// device memory; only the [K, R] result is written.  The per-cell body
// lives in csrc/grid_cell.cuh, which K17 (csrc/grid_patch.cu) compiles too.
//
// The incremental rescore (tpu_optimizer.py:1056-1073 `full_rescore` and
// :1134-1144, the patch's part (b)).  With `incremental_rescore=True` the
// step keeps each row's top-R as destination terms, dt = score - src_term,
// in a carry; K1 then runs twice a step, each gated on the device carry
// (csrc/step_common.cuh: gate_open): over every row when the step rescores
// in full, and over the first n (<= RB) rows of a row list (K16's stale
// rows) when it patches.  A gated launch whose gate is shut returns before
// it stages anything; both write dt and pool indices into the carry at the
// row's own index.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_cell.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_grid;

constexpr int WARPS = 8;   // warps (source rows in flight) per block

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// `rows`: null = row n is source row n (n < K); else row n is rows[n],
// for n < min(K, *n_rows) (K is then the list's length).  `gate`: null =
// always run; else only when cc_state::gate_open(gate, want).  `dest_terms`:
// write score - src_term (the carry's destination terms), not the score.
__global__ void __launch_bounds__(WARPS * 32)
grid_top_r_kernel(const float* __restrict__ src_f,
                  const int* __restrict__ src_i,
                  const float* __restrict__ dst_f,
                  const int* __restrict__ dst_i,
                  const float* __restrict__ consts, int K, int D, int S,
                  int R, int has_cap, float* __restrict__ out_s,
                  int* __restrict__ out_i, const int* __restrict__ rows,
                  const int* __restrict__ n_rows, const int* gate, int want,
                  int dest_terms) {
  if (gate != nullptr && !cc_state::gate_open(gate, want)) return;
  extern __shared__ float smem[];
  float* sf = smem;                                   // [DF][D]
  int* si = reinterpret_cast<int*>(smem + DF * D);    // [DI][D]
  stage_dests(dst_f, dst_i, nullptr, D, sf, si);
  float c[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) c[q] = consts[q];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_end = rows != nullptr ? min(K, *n_rows) : K;
  for (int n = blockIdx.x * WARPS + warp; n < n_end;
       n += gridDim.x * WARPS) {
    const int k = rows != nullptr ? rows[n] : n;
    SrcRow r;
    load_src_row(src_f, src_i, k, S, r);

    float ts[TOPR];
    int ti[TOPR];
#pragma unroll
    for (int q = 0; q < TOPR; ++q) {
      ts[q] = INFINITY;
      ti[q] = INT32_MAX;
    }

    for (int j = lane; j < D; j += 32) {
      const float score = cell_score(r, sf, si, D, j, c, has_cap);
      // sorted insert into this lane's running top-8 (j rises per lane)
      if (before(score, j, ts[TOPR - 1], ti[TOPR - 1])) {
        ts[TOPR - 1] = score;
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
    }

    // warp merge: R rounds of a butterfly argmin over the 32 list heads;
    // the owning lane pops its head (real j are unique across lanes, and
    // R <= D guarantees every pop is a real entry, never a sentinel)
    float my_s = INFINITY;
    int my_i = -1;
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
    if (lane < R) {
      out_s[(size_t)k * R + lane] = dest_terms ? my_s - r.src_term : my_s;
      out_i[(size_t)k * R + lane] = my_i;
    }
  }
}

}  // namespace

extern "C" {

// Packed-layout constants, so the Python wrapper can check that its
// packing matches this build: {SF, DF, DI, NC, TOPR, MAX_S, WARPS}.
void grid_top_r_layout(int* out) {
  out[0] = SF;
  out[1] = DF;
  out[2] = DI;
  out[3] = NC;
  out[4] = TOPR;
  out[5] = MAX_S;
  out[6] = WARPS;
}

// Launches K1 on `stream`; returns the CUDA error code (0 = launched).
// `rows` / `n_rows` (both or neither) restrict it to a row list, K its
// length; `gate` (or null) and `want` gate it on the step loop's carry;
// `dest_terms` writes score - src_term.
int grid_top_r_launch(const float* src_f, const int* src_i,
                      const float* dst_f, const int* dst_i,
                      const float* consts, int K, int D, int S, int R,
                      int has_cap, int grid, float* out_s, int* out_i,
                      const int* rows, const int* n_rows, const int* gate,
                      int want, int dest_terms, void* stream) {
  if (K <= 0 || D <= 0 || S < 1 || S > MAX_S || R < 1 || R > TOPR ||
      R > D || grid < 1 || (rows == nullptr) != (n_rows == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(DF + DI) * D * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      grid_top_r_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  grid_top_r_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      src_f, src_i, dst_f, dst_i, consts, K, D, S, R, has_cap, out_s, out_i,
      rows, n_rows, gate, want, dest_terms);
  return (int)cudaGetLastError();
}

}  // extern "C"
