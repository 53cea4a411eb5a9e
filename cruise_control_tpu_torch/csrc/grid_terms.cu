// K2 — the move grid's per-source and per-destination terms, written
// straight into K1's packed input tables, for Hopper (sm_90a).
//
// What it replaces.  In the JAX reference every step's rescore starts with
// cruise_control_tpu/ops/grid.py:54 `move_grid_terms` (a row gather of the
// packed partition table, `gather_pload` :39, the slot broker, the
// rack-violation scan over the S replica slots, the source broker's cost
// before and after the move through ops/cost.py `broker_cost`, friction
// and the evacuation / rack-fix bonuses) and the per-destination gathers
// and `f_dst_old` that `move_grid_scores` (:140) broadcasts; XLA fuses all
// of it into the grid.  The eager port ran it as ~120 small torch ops a
// step plus ~40 more that packed the result into K1's layout
// (ops/grid.py `_pack_sources`, `_pack_dests`).  This kernel is that whole
// chain: it writes src_f[k] and src_i[k] for each source row k and
// dst_f[j] and dst_i[j] for each destination j, in exactly the layout
// csrc/grid_top_r.cu reads.  It also writes every broker's cost as it
// stands into `bcost` (the reference's f_old of any broker), which K6
// reads later in the step in place of its own two costs before the move.
//
// Rounding.  `broker_cost` (csrc/broker_cost.cuh, shared with K6, K14 and
// K15) adds its terms in the fixed order of ops/cost.py (`rsum` over
// resources, then the ten terms left to right), every constant is the f32
// value torch computes with, divisions are IEEE and the build disables FMA
// contraction, so each output equals its plain twin's bit for bit.
//
// What bounds it.  Per source row it gathers one partition row (S slot
// brokers, S offline origins, S must-move flags, the 2R+1 or 4R+1 f32
// load row), S broker racks and the source broker's aggregates (~100 B),
// and writes 4(2R+4) + 4(3S+2) bytes; per destination ~60 B in and
// 4(4R+6) + 12 B out; per broker of the table ~60 B in, 4 B out.  About
// 190 operations per source row (two broker_cost evaluations), ~105 a
// destination, ~85 a broker: at K = 8 192, D = B = 1 000 it moves ~1.3 MB
// for ~1.8 M operations, so bytes bound it (~0.4 us at 3.35 TB/s).  The
// gathers are random 4-byte reads, three dependent levels deep (the row
// id, then the partition row, then its brokers), and each of a row's ~12
// IEEE divisions a cost is a branch region of its own, so in practice the
// latency of one row's chain, not bandwidth, sets its time.
//
// What the design does about it.
// - The card is filled: a source row takes a lane pair, a destination or
//   a broker a lane, 64 lanes a block — (2K + D + B) / 64 blocks, 288 at
//   1000b/20k — so every SM holds two or three blocks.
// - A source row's two costs run side by side: both lanes of its pair
//   gather the same words (one request), lane 0 computes the cost before
//   the move and lane 1 after it — the same instructions on selected
//   inputs, so the pair never diverges — and one shuffle swaps them.
// - Per-row state lives in registers (csrc/row_gather.cuh: the kernel is
//   compiled per slot instance and capacity-load width, every loop
//   unrolls), and every gather of a level is issued before any arithmetic
//   reads it.  The parent's stores went to pointers that might alias its
//   inputs, so each load waited for the store before it; here every
//   store comes after every load.
// - Stores are coalesced: a block stages its rows' packed words in shared
//   memory and writes its contiguous slice of each table, lane by lane,
//   after one barrier (a row's 12 + 3S + 2 words are 48 B or more apart).
// - Source rows, destinations and brokers never share a block, so each
//   block runs one body.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "broker_cost.cuh"
#include "grid_cell.cuh"
#include "row_gather.cuh"

namespace {

using namespace cc_cost;

constexpr int THREADS = 64;
constexpr int SRC_ROWS = THREADS / 2;   // a source row takes a lane pair

// K1's packed layouts (csrc/grid_top_r.cu, ops/grid.py)
constexpr int SF = 2 * NR + 4;
constexpr int DF = 4 * NR + 6;
constexpr int DI = 3;
// the staging buffers hold the wider of a source and a destination row
constexpr int STAGE_F = (SF > DF ? SF : DF) * THREADS;
constexpr int STAGE_I = (3 * MAX_S + 2) * THREADS;

// move_grid_terms for source row (p, ks), packed as _pack_sources lays it
// out into sf[SF] and si[3S + 2], on a lane pair: lane e = 0 computes the
// source broker's cost before the move, e = 1 after it, they swap the two
// costs, and lane 0 stages the floats, lane 1 the ints
template <int NS, bool CAP>
__device__ __forceinline__ void source_row(const Model& m, const float* c,
                                           const float* t, int p, int ks,
                                           int S, int e, unsigned pair,
                                           float* sf, int* si) {
  // level 1: the partition row
  PartRow<NS, CAP> pr;
  pr.gather(m, p, S);
  const int ks_c = ks < 0 ? 0 : (ks > S - 1 ? S - 1 : ks);
  const bool must = m.must_move[(size_t)p * S + ks_c] != 0;
  // level 2: the slots' racks and the source broker
  const int src = pr.at(ks);
  int rk[NS];
  pr.racks(m, rk);
  BrokerRow<CAP> b;
  b.gather(m, src < 0 ? 0 : src);

  const bool leader_now = pr.lslot == ks;
  const bool slot_exists = src != -1;
  int my_rack = rk[0];
#pragma unroll
  for (int s = 1; s < NS; ++s) my_rack = ks == s ? rk[s] : my_rack;
  bool rack_viol = false;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    rack_viol = rack_viol ||
                (s < ks && pr.row[s] != -1 && rk[s] == my_rack);
  }
  float mv[NR], cmv[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    mv[r] = leader_now ? pr.pl[r] : pr.pl[NR + r];
    cmv[r] = CAP ? (leader_now ? pr.pl[2 * NR + 1 + r]
                               : pr.pl[3 * NR + 1 + r])
                 : mv[r];
  }
  const bool excl_p = pr.pl[2 * NR] > 0.5f;
  const bool excluded = excl_p && !must;
  const float l_delta = leader_now ? 1.0f : 0.0f;
  const float lnwin_delta = leader_now ? pr.pl[NW_IN] : 0.0f;
  const float pot_delta = pr.pl[NW_OUT];

  // this lane's cost: before the move (e = 0) or after it (e = 1)
  const bool after = e != 0;
  float ld[NR], cl[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    ld[r] = after ? b.load[r] - mv[r] : b.load[r];
    cl[r] = after ? b.cload[r] - cmv[r] : b.cload[r];
  }
  const float f = broker_cost(
      c, t, b.cap, ld, after ? b.lnwin - lnwin_delta : b.lnwin,
      after ? b.pot - pot_delta : b.pot, after ? b.rc - 1.0f : b.rc,
      after ? b.lc - l_delta : b.lc, CAP ? cl : nullptr);
  const float f_other = __shfl_xor_sync(pair, f, 1);
  const float f_old = after ? f_other : f;
  const float f_new = after ? f : f_other;
  const float friction = mv[DISK] / t[T_AVG_DISK] * t[T_W_MOVE];
  const float evac = must ? EVAC_BONUS : 0.0f;
  const float rack_fix = rack_viol ? RACK_FIX_BONUS : 0.0f;

  if (!after) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      sf[r] = mv[r];
      sf[NR + r] = cmv[r];
    }
    sf[2 * NR] = l_delta;
    sf[2 * NR + 1] = lnwin_delta;
    sf[2 * NR + 2] = pot_delta;
    sf[2 * NR + 3] = (f_new - f_old) + friction + evac + rack_fix;
  } else {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < S) {
        si[s] = pr.row[s];
        si[S + s] = pr.orig[s];
        si[2 * S + s] = (pr.row[s] != -1 && s != ks) ? rk[s] : -1;
      }
    }
    si[3 * S] = src;
    si[3 * S + 1] =
        (leader_now ? 1 : 0) | ((slot_exists && !excluded) ? 2 : 0);
  }
}

// _dest_columns + _pack_dests for destination pool entry d
template <bool CAP>
__device__ __forceinline__ void dest_row(const Model& m, const float* c,
                                         const float* t, int d, float* df,
                                         int* di) {
  const int dc = d < 0 ? 0 : d;
  BrokerRow<CAP> b;
  b.gather(m, dc);
  const int rack = m.rack[dc];
  const bool dok = m.dest_ok[dc] != 0;
  const bool lok = m.lead_ok[dc] != 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    df[r] = fmaxf(b.cap[r], 1e-9f);
    df[NR + r] = b.cap[r] * c[C_THR + r] + 1e-6f;
    df[2 * NR + r] = b.load[r];
    df[3 * NR + r] = b.cload[r];
  }
  const float rc1 = b.rc + 1.0f;
  float c_rc, c_rc_b;
  rcount_terms(c, t, rc1, &c_rc, &c_rc_b);
  df[4 * NR] = b.lnwin;
  df[4 * NR + 1] = b.pot;
  df[4 * NR + 2] = b.lc;
  df[4 * NR + 3] = c_rc;
  df[4 * NR + 4] = c_rc_b;
  df[4 * NR + 5] = b.cost(c, t);
  const bool static_ok = d >= 0 && dok && rc1 <= t[T_MAX_REPL];
  di[0] = dc;
  di[1] = rack;
  di[2] = (static_ok ? 1 : 0) | (lok ? 2 : 0);
}

// Blocks [0, src_blocks) take 32 source rows each (a lane pair a row),
// the next dst_blocks 64 pool entries each, the rest 64 brokers each; a
// block stages its rows and writes its slice coalesced.
template <int NS, bool CAP>
__global__ void __launch_bounds__(THREADS)
grid_terms_rows_kernel(Model m, const int* __restrict__ kp,
                       const int* __restrict__ ks,
                       const int* __restrict__ dest_pool,
                       const float* __restrict__ consts,
                       const float* __restrict__ tconsts, int K, int D,
                       int B, int S, int src_blocks, int dst_blocks,
                       float* __restrict__ src_f, int* __restrict__ src_i,
                       float* __restrict__ dst_f, int* __restrict__ dst_i,
                       float* __restrict__ bcost) {
  __shared__ float stage_f[STAGE_F];
  __shared__ int stage_i[STAGE_I];
  const int blk = blockIdx.x;
  const int lr = threadIdx.x;
  float c[NC], t[NT];
#pragma unroll
  for (int q = 0; q < NC; ++q) c[q] = consts[q];
#pragma unroll
  for (int q = 0; q < NT; ++q) t[q] = tconsts[q];
  if (blk < src_blocks) {
    const int x0 = blk * SRC_ROWS;
    const int n = min(SRC_ROWS, K - x0);
    const int SI = 3 * S + 2;
    const int r = lr >> 1;
    if (r < n) {
      const unsigned pair = 3u << ((lr & 31) & ~1);
      source_row<NS, CAP>(m, c, t, kp[x0 + r], ks[x0 + r], S, lr & 1, pair,
                          stage_f + r * SF, stage_i + r * SI);
    }
    __syncthreads();
    float* gf = src_f + (size_t)x0 * SF;
    for (int i = lr; i < n * SF; i += THREADS) gf[i] = stage_f[i];
    int* gi = src_i + (size_t)x0 * SI;
    for (int i = lr; i < n * SI; i += THREADS) gi[i] = stage_i[i];
  } else if (blk < src_blocks + dst_blocks) {
    const int x0 = (blk - src_blocks) * THREADS;
    const int n = min(THREADS, D - x0);
    if (lr < n) {
      dest_row<CAP>(m, c, t, dest_pool[x0 + lr], stage_f + lr * DF,
                    stage_i + lr * DI);
    }
    __syncthreads();
    float* gf = dst_f + (size_t)x0 * DF;
    for (int i = lr; i < n * DF; i += THREADS) gf[i] = stage_f[i];
    int* gi = dst_i + (size_t)x0 * DI;
    for (int i = lr; i < n * DI; i += THREADS) gi[i] = stage_i[i];
  } else {
    // the brokers' costs as they stand (K6 reads them as f_old)
    const int x = (blk - src_blocks - dst_blocks) * THREADS + lr;
    if (x < B) {
      BrokerRow<CAP> b;
      b.gather(m, x);
      bcost[x] = b.cost(c, t);
    }
  }
}

template <int NS, bool CAP>
const void* instance() {
  return (const void*)grid_terms_rows_kernel<NS, CAP>;
}

}  // namespace

extern "C" {

// {SF, DF, DI, NC, NT, MAX_S}: the wrapper checks its packing against it.
void grid_terms_layout(int* out) {
  out[0] = SF;
  out[1] = DF;
  out[2] = DI;
  out[3] = NC;
  out[4] = NT;
  out[5] = MAX_S;
}

// The instance for S slots and partition-table width W: {registers, local
// bytes, static shared bytes, dynamic shared bytes, blocks an SM}.
int grid_terms_attrs(int S, int W, int* out) {
  if (S < 1 || S > MAX_S || (W != 2 * NR + 1 && W != 4 * NR + 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* fn = cc_grid::with_cell_instance(
      S, W == 4 * NR + 1, [](auto ns, auto cap) {
        return instance<decltype(ns)::value, decltype(cap)::value == 1>();
      });
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = 0;
  out[4] = per_sm;
  return 0;
}

// Launches K2 on `stream`; returns the CUDA error code (0 = launched).
// Capacity loads are on exactly when W = 4R + 1, and then `cload` is the
// brokers' capacity loads.  It also writes each of the B brokers' cost as
// it stands into bcost[B].
int grid_terms_launch(const int* assignment, const int* leader_slot,
                      const int* offline_origin, const uint8_t* must_move,
                      const float* pload, const int* rack,
                      const uint8_t* dest_ok, const uint8_t* lead_ok,
                      const float* capacity, const float* load,
                      const float* cload, const float* leader_nwin,
                      const float* pot_nwout, const float* rcount,
                      const float* lcount, const int* kp, const int* ks,
                      const int* dest_pool, const float* consts,
                      const float* tconsts, int K, int D, int B, int S,
                      int W, float* src_f, int* src_i, float* dst_f,
                      int* dst_i, float* bcost, void* stream) {
  const bool cap = W == 4 * NR + 1;
  if (K < 0 || D < 0 || B < 1 || bcost == nullptr || S < 1 || S > MAX_S ||
      (W != 2 * NR + 1 && !cap) || cap != (cload != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Model m{assignment, leader_slot, offline_origin, must_move, pload, rack,
          dest_ok,    lead_ok,     capacity,       load,      cload, leader_nwin,
          pot_nwout,  rcount,      lcount};
  const int src_blocks = (K + SRC_ROWS - 1) / SRC_ROWS;
  const int dst_blocks = (D + THREADS - 1) / THREADS;
  const int grid = src_blocks + dst_blocks + (B + THREADS - 1) / THREADS;
  cc_grid::with_cell_instance(S, cap, [&](auto ns, auto c) {
    grid_terms_rows_kernel<decltype(ns)::value, decltype(c)::value == 1>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            m, kp, ks, dest_pool, consts, tconsts, K, D, B, S, src_blocks,
            dst_blocks, src_f, src_i, dst_f, dst_i, bcost);
    return 0;
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
