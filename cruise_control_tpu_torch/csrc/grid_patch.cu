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
// Its contract: `cidx` as K16 writes it — the n = n_cols[0] stale columns
// first, then -1 — with n read on the card (K16's count, clamped to CB).
// K17 stages and scores only cidx[0, n).  A -1 column's entry is (+inf,
// position R + x), and in `top_k`'s order it ranks after every stored
// entry (positions 0..R-1) of the same value, so at most the first R of
// them can be kept: they enter as (+inf, R + n + y), y < min(R, CB - n),
// with no cell computed — exact even where a stored value is a NaN.
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
// stored R entries, and writes them back; per stale column one packed row
// (~100 B): ~1.2 MB at K = 8192, R = 8 — bytes, ~0.4 us at 3.35 TB/s.  It
// does ~92 operations a feasible cell (K1's count, ops/grid.py:
// grid_top_r_ops) over K·n cells: ~33 M operations at n = 44, ~0.5 us at
// 67 TFLOP/s f32.  Its real limit is latency: a stored entry's test is a
// chain of three dependent loads (bd, dest_pool, tb), and the merge's
// rounds depend on each other.
//
// What the design does about it.  One wave of the blocks the card holds
// at once (the wrapper sizes the grid from grid_patch_attrs), two rows a
// warp, a half-warp a row, row pairs strided over the wave: a step that
// does not patch pays for one small grid, and at K = 8 192 each half-warp
// has one row, so the rows' load chains all run side by side.  Each block
// stages the n stale columns and the constants in shared memory once
// (grid_cell.cuh: stage_dests), and whether each pool index's broker was
// touched, so a stored entry's test is one global load and one shared
// read.  Then per row: lane q < R seeds its running top-8 with stored
// entry q, lane y < min(R, CB - n) with the y-th -1 column, the 16 lanes
// split the n columns, and R rounds of warp reductions
// (`__reduce_min_sync` over the heads' keys, then over the positions of
// the heads that hold the least key, each half's in turn with the other
// half giving the identity) pop the row's least (key, position); the
// value is the key's inverse, so no value is carried.  The lists and the
// merge are unrolled over TOPR, so they stay in registers.  The cell is
// K1's, compiled for the cluster's slot count and capacity loads
// (grid_cell.cuh: with_cell_instance).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_cell.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_grid;

constexpr int WARPS = 8;   // warps per block
constexpr int LANES = 16;  // lanes a row: a warp holds two rows
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned EMPTY_KEY = ~0u;

// the floats' total order as unsigned keys: -0.0 below +0.0, +inf above
// every finite value; from_tot32 is its inverse, bit for bit
__device__ __forceinline__ unsigned tot32(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_tot32(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ bool before(unsigned a, int pa, unsigned b,
                                       int pb) {
  return a < b || (a == b && pa < pb);
}

// sorted insert of (key, pos) into a lane's running top-8 (a lane holding
// more drops its worst: an entry in the row's top R is in its lane's)
__device__ __forceinline__ void insert(unsigned* tk, int* tp, unsigned k,
                                       int p) {
  if (!before(k, p, tk[TOPR - 1], tp[TOPR - 1])) return;
  tk[TOPR - 1] = k;
  tp[TOPR - 1] = p;
#pragma unroll
  for (int q = TOPR - 1; q > 0; --q) {
    if (before(tk[q], tp[q], tk[q - 1], tp[q - 1])) {
      const unsigned k_ = tk[q];
      tk[q] = tk[q - 1];
      tk[q - 1] = k_;
      const int p_ = tp[q];
      tp[q] = tp[q - 1];
      tp[q - 1] = p_;
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
                  const int* __restrict__ n_cols,
                  const int* __restrict__ dest_pool,
                  const uint8_t* __restrict__ tb, int K, int D, int CB,
                  int S, int R, float* __restrict__ dt,
                  int* __restrict__ bd, const int* state) {
  if (!cc_state::gate_open(state, 0)) return;
  if (blockIdx.x == 0) CC_STAMP(0);
  // [CB][CST] columns, [NC] constants, then [D] bytes: whether the broker
  // of each pool index was touched, as the twin tests a stored entry
  extern __shared__ float st[];
  float* c = st + CST * CB;
  uint8_t* touched = reinterpret_cast<uint8_t*>(c + NC);
  const int n = min(max(n_cols[0], 0), CB);
  stage_dests(dst_f, dst_i, cidx, n, consts, st);
  for (int q = threadIdx.x; q < NC; q += blockDim.x) c[q] = consts[q];
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    touched[j] = tb[max(dest_pool[j], 0)];
  }
  __syncthreads();
  if (blockIdx.x == 0) CC_STAMP(1);

  const int lane = threadIdx.x & 31;
  const int half = lane >> 4, hl = lane & (LANES - 1);
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_inf = min(R, CB - n);      // the -1 columns that can rank
  // two rows a warp, a half-warp each; both halves run every round
  for (int k0 = 2 * warp; k0 < K; k0 += 2 * gridDim.x * WARPS) {
    const int k = k0 + half;
    const bool on = k < K;
    const bool stamp = blockIdx.x == 0 && k0 == 0;
    // the source row's loads first (row k0 < K stands in for a half
    // without a row), then the stored entries': all in flight together
    SrcRow<NS, CAP> r;
    load_src_row(src_f, src_i, on ? k : k0, S, r);
    unsigned tk[TOPR];
    int tp[TOPR];
#pragma unroll
    for (int q = 0; q < TOPR; ++q) {
      tk[q] = EMPTY_KEY;
      tp[q] = INT32_MAX;
    }
    // stored entry `hl`, +inf where its destination broker was touched
    if (on && hl < R) {
      float v = dt[(size_t)k * R + hl];
      if (touched[max(bd[(size_t)k * R + hl], 0)]) v = INFINITY;
      tk[0] = tot32(v);
      tp[0] = hl;
    }
    // the first -1 columns, +inf at their positions
    if (on && hl < n_inf) insert(tk, tp, tot32(INFINITY), R + n + hl);
    if (stamp) CC_STAMP(2);
    if (on) {
      for (int x = hl; x < n; x += LANES) {
        insert(tk, tp, tot32(cell_score(r, st, x, c) - r.src_term), R + x);
      }
    }
    if (stamp) CC_STAMP(3);

    // merge: R rounds, each popping a half's least (key, position) head;
    // positions are unique and a row has at least R entries, so each
    // round pops exactly one real entry.  The reductions span the warp,
    // the other half contributing the identity.
    unsigned my_k = EMPTY_KEY;
    int my_p = 0;
#pragma unroll
    for (int q = 0; q < TOPR; ++q) {
      if (q < R) {
        const unsigned k_lo = __reduce_min_sync(FULL, half ? EMPTY_KEY
                                                           : tk[0]);
        const unsigned k_hi = __reduce_min_sync(FULL, half ? tk[0]
                                                           : EMPTY_KEY);
        const unsigned mk = half ? k_hi : k_lo;
        const int cand = tk[0] == mk ? tp[0] : INT32_MAX;
        const int p_lo = __reduce_min_sync(FULL, half ? INT32_MAX : cand);
        const int p_hi = __reduce_min_sync(FULL, half ? cand : INT32_MAX);
        const int mp = half ? p_hi : p_lo;
        if (hl == q) {
          my_k = mk;
          my_p = mp;
        }
        if (tk[0] == mk && tp[0] == mp) {
#pragma unroll
          for (int t = 0; t < TOPR - 1; ++t) {
            tk[t] = tk[t + 1];
            tp[t] = tp[t + 1];
          }
          tk[TOPR - 1] = EMPTY_KEY;
          tp[TOPR - 1] = INT32_MAX;
        }
      }
    }
    // every lane reads the stored index it keeps before any lane writes
    int my_b = 0;
    if (on && hl < R) {
      my_b = my_p < R ? bd[(size_t)k * R + my_p] : cidx[my_p - R];
    }
    __syncwarp();
    if (on && hl < R) {
      dt[(size_t)k * R + hl] = from_tot32(my_k);
      bd[(size_t)k * R + hl] = my_b;
    }
    if (stamp) CC_STAMP(4);
  }
}

// the CB staged columns, the constants and the D touched flags
size_t grid_patch_smem(int CB, int D) {
  return ((size_t)CST * CB + NC) * sizeof(float) + (size_t)D;
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

// The instance of (S, has_cap)'s resources over CB columns of a pool of D:
// {registers a thread, local (spilled) bytes a thread, static shared
// bytes, dynamic shared bytes, resident blocks an SM}.  Returns the CUDA
// error code.
int grid_patch_attrs(int S, int has_cap, int CB, int D, int* out) {
  if (S < 1 || S > MAX_S || CB < 1 || D < CB) {
    return (int)cudaErrorInvalidValue;
  }
  return with_cell_instance(S, has_cap, [&](auto ns, auto cap) -> int {
    const void* fn = (const void*)
        grid_patch_kernel<decltype(ns)::value, decltype(cap)::value>;
    const size_t smem = grid_patch_smem(CB, D);
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

// Launches K17 on `stream` over `grid` blocks; `dt` / `bd` [K, R] are the
// carry, updated in place; `cidx` [CB] holds its n_cols[0] stale columns
// first, then -1 (K16's list and count); `state` the step loop's carry
// (the gate).  Returns the CUDA error code (0 = launched).
int grid_patch_launch(const float* src_f, const int* src_i,
                      const float* dst_f, const int* dst_i,
                      const float* consts, const int* cidx,
                      const int* n_cols, const int* dest_pool,
                      const uint8_t* tb, int K, int D,
                      int CB, int S, int R, int has_cap, int B, int grid,
                      float* dt, int* bd, const int* state, void* stream) {
  if (K < 1 || D < 1 || CB < 1 || CB > D || S < 1 || S > MAX_S || R < 1 ||
      R > TOPR || R > D || B < 1 || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = grid_patch_smem(CB, D);
  return with_cell_instance(S, has_cap, [&](auto ns, auto cap) -> int {
    constexpr int NS = decltype(ns)::value, CAP = decltype(cap)::value;
    cudaError_t e = cudaFuncSetAttribute(
        grid_patch_kernel<NS, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    grid_patch_kernel<NS, CAP><<<grid, WARPS * 32, smem,
                                 (cudaStream_t)stream>>>(
        src_f, src_i, dst_f, dst_i, consts, cidx, n_cols, dest_pool, tb, K,
        D, CB, S, R, dt, bd, state);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
