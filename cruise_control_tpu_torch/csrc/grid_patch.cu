// K17 — the incremental rescore's patch of the stale destination columns
// and the exact top-R merge, for Hopper (sm_90a).
//
// What it replaces.  Part (a) of the reference's `patch_rescore`,
// cruise_control_tpu/analyzer/tpu_optimizer.py:1096-1127: the [K, CB] move
// grid over the CB stale destination columns (K16's list `cidx`, pool
// indices, -1 = not stale: +inf), each as a destination term
// `g - src_term`; every row's stored top-R `dt` / `bd` (the carry) with
// the entries whose destination broker the step before touched set to
// +inf (their fresh values are among the columns); and the exact
// `lax.top_k(-merged, R)` of each row's R + CB concatenation, written back
// into the carry.  It runs only on an active step that patches (the
// carry's FRESH flag is 0, csrc/step_common.cuh: gate_open); on any other
// it returns at once.  Its plain twin is analyzer/rescore_kernels.py:
// grid_patch_plain.
//
// Order and ties.  `top_k` of the negated values ranks them in the floats'
// total order — -0.0 before +0.0 — with ties to the lower position of the
// concatenation: the stored entries 0..R-1 first, then the columns R..R+CB-1
// in list order.  This kernel keys (total-order bits, position) the same.
// A +inf entry keeps its stored pool index, or -1 for a column that is
// not stale, as the reference's do.
//
// Rounding.  The cell's score is K1's body (csrc/grid_cell.cuh), and the
// destination columns are K2's packed rows gathered by `cidx`: the same
// operations as the plain twin's grid over `dest_pool[cidx]`, built
// without FMA contraction, so equal bit for bit; the term is then one
// subtraction, as the twin's.
//
// What bounds it.  Per row it reads K2's packed source row (~80 B) and its
// stored R entries, and writes them back; per column one packed row
// (~100 B): ~1.2 MB at K = 8192, CB = 128, R = 8.  It does ~92
// operations a feasible cell (K1's count, ops/grid.py: grid_top_r_ops)
// over at most K·CB = 1 M cells: ~0.1 G operations, ~1.5 us at 67 TFLOP/s
// f32 — operations bound it, by a little, when every column is stale.
//
// What the design does about it.  K1's first shape: each block stages the
// CB gathered columns in shared memory once (grid_cell.cuh: stage_dests,
// ~15 KB at CB = 128), then a warp per row: lane 0 seeds its running top-8
// with the row's stored entries, the 32 lanes split the columns, and a
// warp-shuffle merge of the 32 lists keeps R.  The cell is K1's, compiled
// for the cluster's slot count and capacity loads (grid_cell.cuh:
// with_cell_instance).  Blocks are of 8 warps, not K1's 32, and there is
// a block per 8 rows, not one persistent wave: the staged table is small
// (CB columns, ~15 KB, not K1's D columns, ~116 KB), so restaging it in
// each block costs little.  The registers a thread, not the table, cap
// the blocks an SM (grid_patch_attrs reports them); launched as one wave
// of that many blocks instead, K17 measured no faster (PERF.md §6,
// tools/time_kernels.py on two trees in turns).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_cell.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_grid;

constexpr int WARPS = 8;   // warps (rows in flight) per block

// the floats' total order as unsigned keys: -0.0 below +0.0, +inf above
// every finite value
__device__ __forceinline__ unsigned tot32(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool before(unsigned a, int pa, unsigned b,
                                       int pb) {
  return a < b || (a == b && pa < pb);
}

// sorted insert of (key, pos, value) into a lane's running top-8
__device__ __forceinline__ void insert(unsigned* tk, int* tp, float* tv,
                                       unsigned k, int p, float v) {
  if (!before(k, p, tk[TOPR - 1], tp[TOPR - 1])) return;
  tk[TOPR - 1] = k;
  tp[TOPR - 1] = p;
  tv[TOPR - 1] = v;
#pragma unroll
  for (int q = TOPR - 1; q > 0; --q) {
    if (before(tk[q], tp[q], tk[q - 1], tp[q - 1])) {
      const unsigned k_ = tk[q];
      tk[q] = tk[q - 1];
      tk[q - 1] = k_;
      const int p_ = tp[q];
      tp[q] = tp[q - 1];
      tp[q - 1] = p_;
      const float v_ = tv[q];
      tv[q] = tv[q - 1];
      tv[q - 1] = v_;
    }
  }
}

template <int NS, int CAP>
__global__ void __launch_bounds__(WARPS * 32)
grid_patch_kernel(const float* __restrict__ src_f,
                  const int* __restrict__ src_i,
                  const float* __restrict__ dst_f,
                  const int* __restrict__ dst_i,
                  const float* __restrict__ consts,
                  const int* __restrict__ cidx,
                  const int* __restrict__ dest_pool,
                  const uint8_t* __restrict__ tb, int K, int CB, int S,
                  int R, float* __restrict__ dt,
                  int* __restrict__ bd, const int* state) {
  if (!cc_state::gate_open(state, 0)) return;
  extern __shared__ float st[];                        // [CB][CST]
  int* scol = reinterpret_cast<int*>(st + CST * CB);   // [CB]
  stage_dests(dst_f, dst_i, cidx, CB, consts, st);
  for (int x = threadIdx.x; x < CB; x += blockDim.x) scol[x] = cidx[x];
  float c[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) c[q] = consts[q];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = blockIdx.x * WARPS + warp; k < K; k += gridDim.x * WARPS) {
    SrcRow<NS, CAP> r;
    load_src_row(src_f, src_i, k, S, r);
    unsigned tk[TOPR];
    int tp[TOPR];
    float tv[TOPR];
#pragma unroll
    for (int q = 0; q < TOPR; ++q) {
      tk[q] = ~0u;
      tp[q] = INT32_MAX;
      tv[q] = INFINITY;
    }
    if (lane == 0) {
      // the stored entries, +inf where the destination broker was touched
      for (int q = 0; q < R; ++q) {
        float v = dt[(size_t)k * R + q];
        const int b = bd[(size_t)k * R + q];
        const int bid = dest_pool[max(b, 0)];
        if (tb[max(bid, 0)]) v = INFINITY;
        insert(tk, tp, tv, tot32(v), q, v);
      }
    }
    for (int x = lane; x < CB; x += 32) {
      const float v = cell_score(r, st, x, c) - r.src_term;
      insert(tk, tp, tv, tot32(v), R + x, v);
    }

    // warp merge: R rounds of a butterfly argmin over the 32 list heads;
    // positions are unique, so exactly one lane pops, and R <= R + CB
    // guarantees every pop is a real entry
    float my_v = INFINITY;
    int my_p = -1;
    for (int q = 0; q < R; ++q) {
      unsigned bk = tk[0];
      int bp = tp[0];
      float bv = tv[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned ok = __shfl_xor_sync(0xffffffffu, bk, off);
        const int op = __shfl_xor_sync(0xffffffffu, bp, off);
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        if (before(ok, op, bk, bp)) {
          bk = ok;
          bp = op;
          bv = ov;
        }
      }
      if (lane == q) {
        my_v = bv;
        my_p = bp;
      }
      if (tp[0] == bp) {
#pragma unroll
        for (int t = 0; t < TOPR - 1; ++t) {
          tk[t] = tk[t + 1];
          tp[t] = tp[t + 1];
          tv[t] = tv[t + 1];
        }
        tk[TOPR - 1] = ~0u;
        tp[TOPR - 1] = INT32_MAX;
        tv[TOPR - 1] = INFINITY;
      }
    }
    // every lane reads the stored index it keeps before any lane writes
    int my_b = 0;
    if (lane < R) {
      my_b = my_p < R ? bd[(size_t)k * R + my_p] : scol[my_p - R];
    }
    __syncwarp();
    if (lane < R) {
      dt[(size_t)k * R + lane] = my_v;
      bd[(size_t)k * R + lane] = my_b;
    }
  }
}

// the CB staged columns and their pool indices
size_t grid_patch_smem(int CB) {
  return (size_t)(CST + 1) * CB * sizeof(float);
}

}  // namespace

extern "C" {

// {SF, DF, DI, NC, TOPR, WARPS}: the wrapper checks its packing and its
// launch against them.
void grid_patch_layout(int* out) {
  out[0] = SF;
  out[1] = DF;
  out[2] = DI;
  out[3] = NC;
  out[4] = TOPR;
  out[5] = WARPS;
}

// The instance of (S, has_cap)'s resources over CB columns: {registers a
// thread, local (spilled) bytes a thread, static shared bytes, dynamic
// shared bytes, resident blocks an SM}.  Returns the CUDA error code.
int grid_patch_attrs(int S, int has_cap, int CB, int* out) {
  if (S < 1 || S > MAX_S || CB < 1) return (int)cudaErrorInvalidValue;
  return with_cell_instance(S, has_cap, [&](auto ns, auto cap) -> int {
    const void* fn = (const void*)
        grid_patch_kernel<decltype(ns)::value, decltype(cap)::value>;
    const size_t smem = grid_patch_smem(CB);
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes a;
    if ((e = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      WARPS * 32, smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = (int)smem;
    out[4] = per_sm;
    return 0;
  });
}

// Launches K17 on `stream`; `dt` / `bd` [K, R] are the carry, updated in
// place; `state` the step loop's carry (the gate).  Returns the CUDA error
// code (0 = launched).
int grid_patch_launch(const float* src_f, const int* src_i,
                      const float* dst_f, const int* dst_i,
                      const float* consts, const int* cidx,
                      const int* dest_pool, const uint8_t* tb, int K, int D,
                      int CB, int S, int R, int has_cap, int B, int grid,
                      float* dt, int* bd, const int* state, void* stream) {
  if (K < 1 || D < 1 || CB < 1 || CB > D || S < 1 || S > MAX_S || R < 1 ||
      R > TOPR || R > D || B < 1 || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = grid_patch_smem(CB);
  return with_cell_instance(S, has_cap, [&](auto ns, auto cap) -> int {
    constexpr int NS = decltype(ns)::value, CAP = decltype(cap)::value;
    cudaError_t e = cudaFuncSetAttribute(
        grid_patch_kernel<NS, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    grid_patch_kernel<NS, CAP><<<grid, WARPS * 32, smem,
                                 (cudaStream_t)stream>>>(
        src_f, src_i, dst_f, dst_i, consts, cidx, dest_pool, tb, K, CB, S, R,
        dt, bd, state);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
