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
// device memory; only the [K, R] result is written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NR = 4;      // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int NW_OUT = 2;
constexpr int TOPR = 8;    // DESTS_PER_SOURCE
constexpr int MAX_S = 8;   // widest replica-slot axis the kernel takes
constexpr int WARPS = 8;   // warps (source rows in flight) per block

// packed column layouts — ops/grid.py builds the same
constexpr int SF = 2 * NR + 4;   // src_f: move_load, cmove_load, l_delta,
                                 //        lnwin_delta, pot_delta, src_term
constexpr int DF = 4 * NR + 6;   // dst_f: capc, cap_lim, load, cload, lnwin,
                                 //        pot, lcount, c_rc, c_rc_b, f_old
constexpr int DI = 3;            // dst_i: broker, rack, flags
constexpr int NC = 3 * NR + 9;   // consts (see ops/grid.py: grid_consts)

// dst_f column offsets
constexpr int F_CAPC = 0, F_LIM = NR, F_LOAD = 2 * NR, F_CLOAD = 3 * NR;
constexpr int F_LNWIN = 4 * NR, F_POT = 4 * NR + 1, F_LCOUNT = 4 * NR + 2;
constexpr int F_CRC = 4 * NR + 3, F_CRCB = 4 * NR + 4, F_FOLD = 4 * NR + 5;
// consts offsets
constexpr int C_ULO = 0, C_UUP = NR, C_THR = 2 * NR;
constexpr int C_AVG_LC = 3 * NR, C_LC_UP = 3 * NR + 1, C_LC_LO = 3 * NR + 2;
constexpr int C_LNW_UP = 3 * NR + 3, C_W_VAR = 3 * NR + 4;
constexpr int C_W_BOUND = 3 * NR + 5, C_W_LC = 3 * NR + 6;
constexpr int C_W_LNW = 3 * NR + 7, C_W_POT = 3 * NR + 8;

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

__global__ void __launch_bounds__(WARPS * 32)
grid_top_r_kernel(const float* __restrict__ src_f,
                  const int* __restrict__ src_i,
                  const float* __restrict__ dst_f,
                  const int* __restrict__ dst_i,
                  const float* __restrict__ consts, int K, int D, int S,
                  int R, int has_cap, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* sf = smem;                                   // [DF][D]
  int* si = reinterpret_cast<int*>(smem + DF * D);    // [DI][D]
  for (int x = threadIdx.x; x < D * DF; x += blockDim.x) {
    sf[(x % DF) * D + x / DF] = dst_f[x];
  }
  for (int x = threadIdx.x; x < D * DI; x += blockDim.x) {
    si[(x % DI) * D + x / DI] = dst_i[x];
  }
  float c[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) c[q] = consts[q];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int SI = 3 * S + 2;
  for (int k = blockIdx.x * WARPS + warp; k < K; k += gridDim.x * WARPS) {
    const float* rf = src_f + (size_t)k * SF;
    const int* ri = src_i + (size_t)k * SI;
    float mv[NR], cmv[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      mv[r] = rf[r];
      cmv[r] = rf[NR + r];
    }
    const float l_delta = rf[2 * NR];
    const float lnwin_delta = rf[2 * NR + 1];
    const float pot_delta = rf[2 * NR + 2];
    const float src_term = rf[2 * NR + 3];
    // slots past S pad with -1, which never equals a broker id or a rack
    int row[MAX_S], orig[MAX_S], orack[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      row[s] = s < S ? ri[s] : -1;
      orig[s] = s < S ? ri[S + s] : -1;
      orack[s] = s < S ? ri[2 * S + s] : -1;
    }
    const int src = ri[3 * S];
    const int rflags = ri[3 * S + 1];
    const bool leader_now = (rflags & 1) != 0;
    const bool row_ok = (rflags & 2) != 0;   // slot exists, not excluded

    float ts[TOPR];
    int ti[TOPR];
#pragma unroll
    for (int q = 0; q < TOPR; ++q) {
      ts[q] = INFINITY;
      ti[q] = INT32_MAX;
    }

    for (int j = lane; j < D; j += 32) {
      float score = INFINITY;
      const int dc = si[j];
      const int dflags = si[2 * D + j];
      bool ok = row_ok && (dflags & 1) && src != dc &&
                (!leader_now || (dflags & 2));
      if (ok) {
        const int drack = si[D + j];
#pragma unroll
        for (int s = 0; s < MAX_S; ++s) {
          ok = ok && row[s] != dc && orig[s] != dc && orack[s] != drack;
        }
      }
      float la[NR], cla[NR];
      if (ok) {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          la[r] = sf[(F_LOAD + r) * D + j] + mv[r];
          cla[r] = has_cap ? sf[(F_CLOAD + r) * D + j] + cmv[r] : la[r];
          ok = ok && cla[r] <= sf[(F_LIM + r) * D + j];
        }
      }
      if (ok) {
        float capc[NR], u[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          capc[r] = sf[(F_CAPC + r) * D + j];
          u[r] = la[r] / capc[r];
        }
        float v = u[0] * u[0];
        float b = relu(u[0] - c[C_UUP]) + relu(c[C_ULO] - u[0]);
        float cu = has_cap ? cla[0] / capc[0] : u[0];
        float o = relu(cu - c[C_THR]);
#pragma unroll
        for (int r = 1; r < NR; ++r) {
          v = v + u[r] * u[r];
          b = b + (relu(u[r] - c[C_UUP + r]) + relu(c[C_ULO + r] - u[r]));
          cu = has_cap ? cla[r] / capc[r] : u[r];
          o = o + relu(cu - c[C_THR + r]);
        }
        const float c_var = v * c[C_W_VAR];
        const float c_bound = b * c[C_W_BOUND];
        const float c_cap = o * 1000.0f;
        const float lc = sf[F_LCOUNT * D + j] + l_delta;
        const float t_lc = lc / c[C_AVG_LC] - 1.0f;
        const float c_lc = t_lc * t_lc * c[C_W_LC];
        const float c_lc_b =
            (relu(lc - c[C_LC_UP]) + relu(c[C_LC_LO] - lc)) / c[C_AVG_LC] *
            c[C_W_BOUND];
        const float lnw = (sf[F_LNWIN * D + j] + lnwin_delta) / capc[NW_IN];
        const float c_lnw = lnw * lnw * c[C_W_LNW];
        const float c_lnw_b = relu(lnw - c[C_LNW_UP]) * c[C_W_BOUND];
        const float pot_u = (sf[F_POT * D + j] + pot_delta) / capc[NW_OUT];
        const float c_pot = relu(pot_u - c[C_THR + NW_OUT]) * c[C_W_POT];
        const float f_new = c_var + c_bound + c_cap + sf[F_CRC * D + j] +
                            c_lc + sf[F_CRCB * D + j] + c_lc_b + c_lnw +
                            c_lnw_b + c_pot;
        score = src_term + (f_new - sf[F_FOLD * D + j]);
      }
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
    for (int r = 0; r < R; ++r) {
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
      if (lane == r) {
        my_s = bs;
        my_i = bi;
      }
      if (ti[0] == bi) {
#pragma unroll
        for (int q = 0; q < TOPR - 1; ++q) {
          ts[q] = ts[q + 1];
          ti[q] = ti[q + 1];
        }
        ts[TOPR - 1] = INFINITY;
        ti[TOPR - 1] = INT32_MAX;
      }
    }
    if (lane < R) {
      out_s[(size_t)k * R + lane] = my_s;
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
int grid_top_r_launch(const float* src_f, const int* src_i,
                      const float* dst_f, const int* dst_i,
                      const float* consts, int K, int D, int S, int R,
                      int has_cap, int grid, float* out_s, int* out_i,
                      void* stream) {
  if (K <= 0 || D <= 0 || S < 1 || S > MAX_S || R < 1 || R > TOPR ||
      R > D || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(DF + DI) * D * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      grid_top_r_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  grid_top_r_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      src_f, src_i, dst_f, dst_i, consts, K, D, S, R, has_cap, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
