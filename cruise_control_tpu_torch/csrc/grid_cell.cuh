// The move grid's per-cell body and its packed layouts, shared by K1
// (csrc/grid_top_r.cu: every pool destination of a row, or of a list of
// rows) and K17 (csrc/grid_patch.cu: a row's stale destination columns):
// one copy of the feasibility test and the inlined destination cost, so
// both compile the same arithmetic, operation for operation, and equal the
// plain twin (ops/grid.py: move_grid_scores) bit for bit (built without
// FMA contraction).  The layouts are K2's (csrc/grid_terms.cu writes them,
// ops/grid.py declares the same).

#ifndef CRUISE_CONTROL_GRID_CELL_CUH_
#define CRUISE_CONTROL_GRID_CELL_CUH_

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cc_grid {

constexpr int NR = 4;      // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int NW_OUT = 2;
constexpr int TOPR = 8;    // DESTS_PER_SOURCE
constexpr int MAX_S = 8;   // widest replica-slot axis the kernels take

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

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

// One source row of K2's packed tables, in registers.
struct SrcRow {
  float mv[NR], cmv[NR];
  float l_delta, lnwin_delta, pot_delta, src_term;
  // slots past S pad with -1, which never equals a broker id or a rack
  int row[MAX_S], orig[MAX_S], orack[MAX_S];
  int src;
  bool leader_now;
  bool row_ok;   // slot exists, not excluded
};

__device__ __forceinline__ void load_src_row(const float* src_f,
                                             const int* src_i, int k, int S,
                                             SrcRow& r) {
  const int SI = 3 * S + 2;
  const float* rf = src_f + (size_t)k * SF;
  const int* ri = src_i + (size_t)k * SI;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    r.mv[q] = rf[q];
    r.cmv[q] = rf[NR + q];
  }
  r.l_delta = rf[2 * NR];
  r.lnwin_delta = rf[2 * NR + 1];
  r.pot_delta = rf[2 * NR + 2];
  r.src_term = rf[2 * NR + 3];
#pragma unroll
  for (int s = 0; s < MAX_S; ++s) {
    r.row[s] = s < S ? ri[s] : -1;
    r.orig[s] = s < S ? ri[S + s] : -1;
    r.orack[s] = s < S ? ri[2 * S + s] : -1;
  }
  r.src = ri[3 * S];
  const int rflags = ri[3 * S + 1];
  r.leader_now = (rflags & 1) != 0;
  r.row_ok = (rflags & 2) != 0;
}

// The destination columns in shared memory, structure of arrays: `sf`
// [DF][n], `si` [DI][n].  Column x holds pool destination cols[x] (x
// itself when `cols` is null); a column whose entry is -1 gets flags 0,
// so every cell in it is infeasible (+inf), as a -1 pool entry is.
__device__ __forceinline__ void stage_dests(const float* dst_f,
                                            const int* dst_i, const int* cols,
                                            int n, float* sf, int* si) {
  for (int x = threadIdx.x; x < n * DF; x += blockDim.x) {
    const int col = x / DF, q = x % DF;
    const int j = cols ? cols[col] : col;
    sf[q * n + col] = j >= 0 ? dst_f[(size_t)j * DF + q] : 0.0f;
  }
  for (int x = threadIdx.x; x < n * DI; x += blockDim.x) {
    const int col = x / DI, q = x % DI;
    const int j = cols ? cols[col] : col;
    si[q * n + col] = j >= 0 ? dst_i[(size_t)j * DI + q] : 0;
  }
}

// score(k, j) = src_term + (f_dst_new - f_dst_old) of moving row `r` to
// staged column j (of n), +inf where infeasible: the feasibility test
// first (dest valid and dest_ok and rcount headroom, src != dest, no
// duplicate replica or offline origin, no rack clash, capacity on the
// capacity-estimate load, lead_ok when the replica leads), then
// ops/cost.py: broker_cost inlined, its terms added in the plain path's
// order.
__device__ __forceinline__ float cell_score(const SrcRow& r, const float* sf,
                                            const int* si, int n, int j,
                                            const float* c, int has_cap) {
  float score = INFINITY;
  const int dc = si[j];
  const int dflags = si[2 * n + j];
  bool ok = r.row_ok && (dflags & 1) && r.src != dc &&
            (!r.leader_now || (dflags & 2));
  if (ok) {
    const int drack = si[n + j];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      ok = ok && r.row[s] != dc && r.orig[s] != dc && r.orack[s] != drack;
    }
  }
  float la[NR], cla[NR];
  if (ok) {
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      la[q] = sf[(F_LOAD + q) * n + j] + r.mv[q];
      cla[q] = has_cap ? sf[(F_CLOAD + q) * n + j] + r.cmv[q] : la[q];
      ok = ok && cla[q] <= sf[(F_LIM + q) * n + j];
    }
  }
  if (ok) {
    float capc[NR], u[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      capc[q] = sf[(F_CAPC + q) * n + j];
      u[q] = la[q] / capc[q];
    }
    float v = u[0] * u[0];
    float b = relu(u[0] - c[C_UUP]) + relu(c[C_ULO] - u[0]);
    float cu = has_cap ? cla[0] / capc[0] : u[0];
    float o = relu(cu - c[C_THR]);
#pragma unroll
    for (int q = 1; q < NR; ++q) {
      v = v + u[q] * u[q];
      b = b + (relu(u[q] - c[C_UUP + q]) + relu(c[C_ULO + q] - u[q]));
      cu = has_cap ? cla[q] / capc[q] : u[q];
      o = o + relu(cu - c[C_THR + q]);
    }
    const float c_var = v * c[C_W_VAR];
    const float c_bound = b * c[C_W_BOUND];
    const float c_cap = o * 1000.0f;
    const float lc = sf[F_LCOUNT * n + j] + r.l_delta;
    const float t_lc = lc / c[C_AVG_LC] - 1.0f;
    const float c_lc = t_lc * t_lc * c[C_W_LC];
    const float c_lc_b =
        (relu(lc - c[C_LC_UP]) + relu(c[C_LC_LO] - lc)) / c[C_AVG_LC] *
        c[C_W_BOUND];
    const float lnw = (sf[F_LNWIN * n + j] + r.lnwin_delta) / capc[NW_IN];
    const float c_lnw = lnw * lnw * c[C_W_LNW];
    const float c_lnw_b = relu(lnw - c[C_LNW_UP]) * c[C_W_BOUND];
    const float pot_u = (sf[F_POT * n + j] + r.pot_delta) / capc[NW_OUT];
    const float c_pot = relu(pot_u - c[C_THR + NW_OUT]) * c[C_W_POT];
    const float f_new = c_var + c_bound + c_cap + sf[F_CRC * n + j] + c_lc +
                        sf[F_CRCB * n + j] + c_lc_b + c_lnw + c_lnw_b + c_pot;
    score = r.src_term + (f_new - sf[F_FOLD * n + j]);
  }
  return score;
}

}  // namespace cc_grid

#endif  // CRUISE_CONTROL_GRID_CELL_CUH_
