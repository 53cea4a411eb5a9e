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
// chain: one thread per source row k writes src_f[k] and src_i[k], one
// thread per destination j writes dst_f[j] and dst_i[j], in exactly the
// layout csrc/grid_top_r.cu reads.
//
// Rounding.  `broker_cost` (csrc/broker_cost.cuh, shared with K6) adds its
// terms in the fixed order of ops/cost.py (`rsum` over resources, then the
// ten terms left to right), every constant is the f32 value torch computes
// with, divisions are IEEE and the build disables FMA contraction, so each
// output should equal its plain twin's bit for bit.
//
// What bounds it.  Per source row it gathers one partition row (S slot
// brokers, S offline origins, S must-move flags, the 2R+1 or 4R+1 f32
// load row), S broker racks and the source broker's aggregates (~100 B),
// and writes 4(2R+4) + 4(3S+2) bytes; per destination ~60 B in and
// 4(4R+6) + 12 B out.  About 150 operations per source row (two
// broker_cost evaluations): at K = 8 192, D = 1 000 it moves ~1.5 MB for
// ~1.3 M operations, so bytes bound it (~0.5 us at 3.35 TB/s).  The
// gathers are random 4-byte reads, so in practice latency, not
// bandwidth, sets its time.
//
// What the design does about it.  One thread per output row, no shared
// state and no synchronisation: every gather of a row is issued back to
// back, and the K + D threads in flight overlap their latencies.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "broker_cost.cuh"

namespace {

using namespace cc_cost;

constexpr int THREADS = 256;

// K1's packed layouts (csrc/grid_top_r.cu, ops/grid.py)
constexpr int SF = 2 * NR + 4;
constexpr int DF = 4 * NR + 6;
constexpr int DI = 3;

// move_grid_terms for source row k, packed as _pack_sources lays it out
__device__ void source_row(const Model& m, const float* c, const float* t,
                           int p, int ks, int S, int W, float* sf, int* si) {
  const int* row = m.assignment + (size_t)p * S;
  const int* orig = m.offline_origin + (size_t)p * S;
  const float* pl = m.pload + (size_t)p * W;
  int slot_rack[MAX_S];
  for (int s = 0; s < S; ++s) {
    const int b = row[s];
    slot_rack[s] = b != -1 ? m.rack[b < 0 ? 0 : b] : -1;
  }
  const int src = row[ks];
  const int src_c = src < 0 ? 0 : src;
  const bool leader_now = m.leader_slot[p] == ks;
  const bool slot_exists = src != -1;
  const int my_rack = slot_rack[ks];
  bool rack_viol = false;
  for (int s = 0; s < ks; ++s) {
    rack_viol = rack_viol || (row[s] != -1 && slot_rack[s] == my_rack);
  }
  const bool has_pcap = W > 2 * NR + 1;
  float mv[NR], cmv[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    mv[r] = leader_now ? pl[r] : pl[NR + r];
    cmv[r] = has_pcap ? (leader_now ? pl[2 * NR + 1 + r]
                                    : pl[3 * NR + 1 + r])
                      : mv[r];
  }
  const bool excl_p = pl[2 * NR] > 0.5f;
  const int ks_c = ks < 0 ? 0 : (ks > S - 1 ? S - 1 : ks);
  const bool must = m.must_move[(size_t)p * S + ks_c] != 0;
  const bool excluded = excl_p && !must;
  const float l_delta = leader_now ? 1.0f : 0.0f;
  const float lnwin_delta = leader_now ? pl[NW_IN] : 0.0f;
  const float pot_delta = pl[NW_OUT];

  const float* cap = m.capacity + (size_t)src_c * NR;
  const float* ld = m.load + (size_t)src_c * NR;
  const float* cl = m.cload ? m.cload + (size_t)src_c * NR : nullptr;
  const float f_old =
      broker_cost(c, t, cap, ld, m.leader_nwin[src_c], m.pot_nwout[src_c],
                  m.rcount[src_c], m.lcount[src_c], cl);
  float ld_new[NR], cl_new[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    ld_new[r] = ld[r] - mv[r];
    cl_new[r] = cl ? cl[r] - cmv[r] : 0.0f;
  }
  const float f_new = broker_cost(
      c, t, cap, ld_new, m.leader_nwin[src_c] - lnwin_delta,
      m.pot_nwout[src_c] - pot_delta, m.rcount[src_c] - 1.0f,
      m.lcount[src_c] - l_delta, cl ? cl_new : nullptr);
  const float friction = mv[DISK] / t[T_AVG_DISK] * t[T_W_MOVE];
  const float evac = must ? EVAC_BONUS : 0.0f;
  const float rack_fix = rack_viol ? RACK_FIX_BONUS : 0.0f;

#pragma unroll
  for (int r = 0; r < NR; ++r) {
    sf[r] = mv[r];
    sf[NR + r] = cmv[r];
  }
  sf[2 * NR] = l_delta;
  sf[2 * NR + 1] = lnwin_delta;
  sf[2 * NR + 2] = pot_delta;
  sf[2 * NR + 3] = (f_new - f_old) + friction + evac + rack_fix;
  for (int s = 0; s < S; ++s) {
    si[s] = row[s];
    si[S + s] = orig[s];
    si[2 * S + s] = (row[s] != -1 && s != ks) ? slot_rack[s] : -1;
  }
  si[3 * S] = src;
  si[3 * S + 1] = (leader_now ? 1 : 0) | ((slot_exists && !excluded) ? 2 : 0);
}

// _dest_columns + _pack_dests for destination pool entry d
__device__ void dest_row(const Model& m, const float* c, const float* t,
                         int d, float* df, int* di) {
  const int dc = d < 0 ? 0 : d;
  const float* cap = m.capacity + (size_t)dc * NR;
  const float* ld = m.load + (size_t)dc * NR;
  const float* cl = m.cload ? m.cload + (size_t)dc * NR : ld;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    df[r] = fmaxf(cap[r], 1e-9f);
    df[NR + r] = cap[r] * c[C_THR + r] + 1e-6f;
    df[2 * NR + r] = ld[r];
    df[3 * NR + r] = cl[r];
  }
  const float rc1 = m.rcount[dc] + 1.0f;
  float c_rc, c_rc_b;
  rcount_terms(c, t, rc1, &c_rc, &c_rc_b);
  df[4 * NR] = m.leader_nwin[dc];
  df[4 * NR + 1] = m.pot_nwout[dc];
  df[4 * NR + 2] = m.lcount[dc];
  df[4 * NR + 3] = c_rc;
  df[4 * NR + 4] = c_rc_b;
  df[4 * NR + 5] = broker_cost(c, t, cap, ld, m.leader_nwin[dc],
                               m.pot_nwout[dc], m.rcount[dc], m.lcount[dc],
                               m.cload ? cl : nullptr);
  const bool static_ok = d >= 0 && m.dest_ok[dc] && rc1 <= t[T_MAX_REPL];
  di[0] = dc;
  di[1] = m.rack[dc];
  di[2] = (static_ok ? 1 : 0) | (m.lead_ok[dc] ? 2 : 0);
}

__global__ void __launch_bounds__(THREADS)
grid_terms_kernel(Model m, const int* __restrict__ kp,
                  const int* __restrict__ ks,
                  const int* __restrict__ dest_pool,
                  const float* __restrict__ consts,
                  const float* __restrict__ tconsts, int K, int D, int S,
                  int W, float* __restrict__ src_f, int* __restrict__ src_i,
                  float* __restrict__ dst_f, int* __restrict__ dst_i) {
  float c[NC], t[NT];
#pragma unroll
  for (int q = 0; q < NC; ++q) c[q] = consts[q];
#pragma unroll
  for (int q = 0; q < NT; ++q) t[q] = tconsts[q];
  const int SI = 3 * S + 2;
  for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < K + D;
       x += gridDim.x * blockDim.x) {
    if (x < K) {
      source_row(m, c, t, kp[x], ks[x], S, W, src_f + (size_t)x * SF,
                 src_i + (size_t)x * SI);
    } else {
      const int j = x - K;
      dest_row(m, c, t, dest_pool[j], dst_f + (size_t)j * DF,
               dst_i + (size_t)j * DI);
    }
  }
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

// Launches K2 on `stream`; returns the CUDA error code (0 = launched).
int grid_terms_launch(const int* assignment, const int* leader_slot,
                      const int* offline_origin, const uint8_t* must_move,
                      const float* pload, const int* rack,
                      const uint8_t* dest_ok, const uint8_t* lead_ok,
                      const float* capacity, const float* load,
                      const float* cload, const float* leader_nwin,
                      const float* pot_nwout, const float* rcount,
                      const float* lcount, const int* kp, const int* ks,
                      const int* dest_pool, const float* consts,
                      const float* tconsts, int K, int D, int S, int W,
                      int grid, float* src_f, int* src_i, float* dst_f,
                      int* dst_i, void* stream) {
  if (K < 0 || D < 0 || K + D == 0 || S < 1 || S > MAX_S || grid < 1 ||
      (W != 2 * NR + 1 && W != 4 * NR + 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Model m{assignment, leader_slot, offline_origin, must_move, pload, rack,
          dest_ok,    lead_ok,     capacity,       load,      cload, leader_nwin,
          pot_nwout,  rcount,      lcount};
  grid_terms_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      m, kp, ks, dest_pool, consts, tconsts, K, D, S, W, src_f, src_i, dst_f,
      dst_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
