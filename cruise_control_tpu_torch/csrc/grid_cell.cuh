// The move grid's per-cell body and its packed layouts, shared by K1
// (csrc/grid_top_r.cu: every pool destination of a row, or of a list of
// rows) and K17 (csrc/grid_patch.cu: a row's stale destination columns):
// one copy of the feasibility test and the inlined destination cost, so
// both compile the same arithmetic, operation for operation, and equal the
// plain twin (ops/grid.py: move_grid_scores) bit for bit (built without
// FMA contraction).  The packed layouts are K2's (csrc/grid_terms.cu
// writes them, ops/grid.py declares the same).
//
// Instances.  The cell is compiled for a fixed number of replica slots NS
// and for whether capacity loads apart from the mean loads are on (CAP):
// one instance each of NS = 1, 2, 3, 4 and 8 (slot_instance) with and
// without CAP.  A cluster of replication factor S runs the smallest
// instance that holds S, its slots past S padded with -1, which never
// equals a broker id or a rack: at S = 3 that is 9 registers and 9
// compares a cell where one instance of 8 took 24 of each, and without
// CAP the capacity-load registers and selects are gone.
//
// The staged destinations.  Every kernel that computes cells first copies
// the destination columns it visits into shared memory, one row of CST
// words a column (stage_dests): K2's DF floats, four leader-count terms and
// K2's DI ints.  CST is odd, so 32 lanes on 32 consecutive columns read 32
// banks, and every field is an immediate offset from the column's base.
// A source row's leader delta is exactly 0 or 1 (it leads or not), so a
// column's leader count after the move takes one of two values; its two
// cost terms (the count's deviation and its bound) are computed at staging
// for both, with the same operations in the same order as the cell would,
// which takes two of a cell's eight divisions out of the grid.

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

// The slots of the instance that runs a cluster of S replica slots (S in
// 1..MAX_S); ops/grid.py: slot_instance is the same map.
__host__ __device__ constexpr int slot_instance(int S) {
  return S <= 4 ? S : MAX_S;
}

template <int V>
struct IntC {
  static constexpr int value = V;
};

// f(IntC<NS>{}, IntC<CAP>{}) for the instance of S slots and capacity
// loads on or off: the host side of every kernel compiled once per
// instance.
template <class F>
auto with_cell_instance(int S, int has_cap, F&& f) {
  auto on_cap = [&](auto ns) {
    return has_cap ? f(ns, IntC<1>{}) : f(ns, IntC<0>{});
  };
  switch (slot_instance(S)) {
    case 1: return on_cap(IntC<1>{});
    case 2: return on_cap(IntC<2>{});
    case 3: return on_cap(IntC<3>{});
    case 4: return on_cap(IntC<4>{});
    default: return on_cap(IntC<MAX_S>{});
  }
}

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
// the staged row: dst_f's columns, the leader-count terms for a delta of
// 0 and of 1 (c_lc, c_lc_b), dst_i's columns; CST words, odd
constexpr int T_LC = DF, T_LCB = DF + 2;
constexpr int T_BROKER = DF + 4, T_RACK = DF + 5, T_FLAGS = DF + 6;
constexpr int CST = DF + 7;
static_assert(CST % 2 == 1, "a staged row's stride must be odd");
// consts offsets
constexpr int C_ULO = 0, C_UUP = NR, C_THR = 2 * NR;
constexpr int C_AVG_LC = 3 * NR, C_LC_UP = 3 * NR + 1, C_LC_LO = 3 * NR + 2;
constexpr int C_LNW_UP = 3 * NR + 3, C_W_VAR = 3 * NR + 4;
constexpr int C_W_BOUND = 3 * NR + 5, C_W_LC = 3 * NR + 6;
constexpr int C_W_LNW = 3 * NR + 7, C_W_POT = 3 * NR + 8;

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

// One source row of K2's packed tables, in registers, for an instance of
// NS slots (capacity loads kept only when CAP).
template <int NS, int CAP>
struct SrcRow {
  float mv[NR], cmv[CAP ? NR : 1];
  float lnwin_delta, pot_delta, src_term;
  // slots past S pad with -1, which never equals a broker id or a rack
  int row[NS], orig[NS], orack[NS];
  int src;
  bool leader_now;
  bool row_ok;   // slot exists, not excluded
};

// Row k of the tables of a cluster of S <= NS slots (its src_i rows are
// 3·S + 2 wide).  Its leader delta (src_f column 2·NR) is leader_now.
template <int NS, int CAP>
__device__ __forceinline__ void load_src_row(const float* src_f,
                                             const int* src_i, int k, int S,
                                             SrcRow<NS, CAP>& r) {
  const int SI = 3 * S + 2;
  const float* rf = src_f + (size_t)k * SF;
  const int* ri = src_i + (size_t)k * SI;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    r.mv[q] = rf[q];
    if (CAP) r.cmv[q] = rf[NR + q];
  }
  r.lnwin_delta = rf[2 * NR + 1];
  r.pot_delta = rf[2 * NR + 2];
  r.src_term = rf[2 * NR + 3];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    r.row[s] = s < S ? ri[s] : -1;
    r.orig[s] = s < S ? ri[S + s] : -1;
    r.orack[s] = s < S ? ri[2 * S + s] : -1;
  }
  r.src = ri[3 * S];
  const int rflags = ri[3 * S + 1];
  r.leader_now = (rflags & 1) != 0;
  r.row_ok = (rflags & 2) != 0;
}

// The destination columns into shared memory `st`, CST words a column
// (every thread of the block calls it; a barrier must follow).  Column x
// holds pool destination cols[x] (x itself when `cols` is null); a column
// whose entry is -1 gets flags 0, so every cell in it is infeasible (+inf),
// as a -1 pool entry is.  `consts` (global) gives the leader-count terms'
// constants.
__device__ __forceinline__ void stage_dests(const float* dst_f,
                                            const int* dst_i, const int* cols,
                                            int n, const float* consts,
                                            float* st) {
  for (int x = threadIdx.x; x < n * DF; x += blockDim.x) {
    const int col = x / DF, q = x % DF;
    const int j = cols ? cols[col] : col;
    st[col * CST + q] = j >= 0 ? dst_f[(size_t)j * DF + q] : 0.0f;
  }
  for (int x = threadIdx.x; x < n * DI; x += blockDim.x) {
    const int col = x / DI, q = x % DI;
    const int j = cols ? cols[col] : col;
    st[col * CST + T_BROKER + q] =
        __int_as_float(j >= 0 ? dst_i[(size_t)j * DI + q] : 0);
  }
  const float avg = consts[C_AVG_LC], up = consts[C_LC_UP];
  const float lo = consts[C_LC_LO], w_lc = consts[C_W_LC];
  const float w_bound = consts[C_W_BOUND];
  for (int x = threadIdx.x; x < 2 * n; x += blockDim.x) {
    const int col = x >> 1, l = x & 1;
    const int j = cols ? cols[col] : col;
    const float lcount = j >= 0 ? dst_f[(size_t)j * DF + F_LCOUNT] : 0.0f;
    const float lc = lcount + (l ? 1.0f : 0.0f);
    const float t_lc = lc / avg - 1.0f;
    st[col * CST + T_LC + l] = t_lc * t_lc * w_lc;
    st[col * CST + T_LCB + l] =
        (relu(lc - up) + relu(lo - lc)) / avg * w_bound;
  }
}

// score(k, j) = src_term + (f_dst_new - f_dst_old) of moving row `r` to
// staged column j, +inf where infeasible: the feasibility test first
// (dest valid and dest_ok and rcount headroom, src != dest, no duplicate
// replica or offline origin, no rack clash, capacity on the
// capacity-estimate load, lead_ok when the replica leads), then
// ops/cost.py: broker_cost inlined, its terms added in the plain path's
// order.  `c` holds the NC constants.
template <int NS, int CAP>
__device__ __forceinline__ float cell_score(const SrcRow<NS, CAP>& r,
                                            const float* st, int j,
                                            const float* c) {
  const float* d = st + j * CST;
  float score = INFINITY;
  const int dc = __float_as_int(d[T_BROKER]);
  const int dflags = __float_as_int(d[T_FLAGS]);
  bool ok = r.row_ok && (dflags & 1) && r.src != dc &&
            (!r.leader_now || (dflags & 2));
  if (ok) {
    const int drack = __float_as_int(d[T_RACK]);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      ok = ok && r.row[s] != dc && r.orig[s] != dc && r.orack[s] != drack;
    }
  }
  float la[NR], cla[NR];
  if (ok) {
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      la[q] = d[F_LOAD + q] + r.mv[q];
      cla[q] = CAP ? d[F_CLOAD + q] + r.cmv[CAP ? q : 0] : la[q];
      ok = ok && cla[q] <= d[F_LIM + q];
    }
  }
  if (ok) {
    float capc[NR], u[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      capc[q] = d[F_CAPC + q];
      u[q] = la[q] / capc[q];
    }
    float v = u[0] * u[0];
    float b = relu(u[0] - c[C_UUP]) + relu(c[C_ULO] - u[0]);
    float cu = CAP ? cla[0] / capc[0] : u[0];
    float o = relu(cu - c[C_THR]);
#pragma unroll
    for (int q = 1; q < NR; ++q) {
      v = v + u[q] * u[q];
      b = b + (relu(u[q] - c[C_UUP + q]) + relu(c[C_ULO + q] - u[q]));
      cu = CAP ? cla[q] / capc[q] : u[q];
      o = o + relu(cu - c[C_THR + q]);
    }
    const float c_var = v * c[C_W_VAR];
    const float c_bound = b * c[C_W_BOUND];
    const float c_cap = o * 1000.0f;
    const int l = r.leader_now ? 1 : 0;
    const float c_lc = d[T_LC + l];
    const float c_lc_b = d[T_LCB + l];
    const float lnw = (d[F_LNWIN] + r.lnwin_delta) / capc[NW_IN];
    const float c_lnw = lnw * lnw * c[C_W_LNW];
    const float c_lnw_b = relu(lnw - c[C_LNW_UP]) * c[C_W_BOUND];
    const float pot_u = (d[F_POT] + r.pot_delta) / capc[NW_OUT];
    const float c_pot = relu(pot_u - c[C_THR + NW_OUT]) * c[C_W_POT];
    const float f_new = c_var + c_bound + c_cap + d[F_CRC] + c_lc +
                        d[F_CRCB] + c_lc_b + c_lnw + c_lnw_b + c_pot;
    score = r.src_term + (f_new - d[F_FOLD]);
  }
  return score;
}

}  // namespace cc_grid

#endif  // CRUISE_CONTROL_GRID_CELL_CUH_
