// The gathers K2 (csrc/grid_terms.cu) and K6 (csrc/score_candidates.cu)
// issue for a row before any arithmetic reads them, into registers: a
// partition's row (its S slot brokers, offline origins, leader slot and
// packed load row), the slots' racks, and one broker's tables.  Each is
// compiled for a slot instance NS (1, 2, 3, 4 or 8; slots past S are
// padded with -1, which never equals a broker id or a rack) and for
// capacity loads on or off (CAP), so every loop unrolls and nothing goes
// to local memory; each gather's loads are independent, so a warp issues
// them back to back and waits once.

#ifndef CRUISE_CONTROL_ROW_GATHER_CUH_
#define CRUISE_CONTROL_ROW_GATHER_CUH_

#include <cuda_runtime.h>
#include <stdint.h>

#include "broker_cost.cuh"

namespace cc_cost {

// Partition p's row: slots, offline origins, leader slot, load row
// (lead | fol | excluded [| leadc | folc])
template <int NS, bool CAP>
struct PartRow {
  static constexpr int W = CAP ? 4 * NR + 1 : 2 * NR + 1;
  int row[NS], orig[NS];
  int lslot;
  float pl[W];

  __device__ __forceinline__ void gather(const Model& m, int p, int S) {
    const size_t pS = (size_t)p * S;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      row[s] = s < S ? m.assignment[pS + s] : -1;
      orig[s] = s < S ? m.offline_origin[pS + s] : -1;
    }
    lslot = m.leader_slot[p];
#pragma unroll
    for (int i = 0; i < W; ++i) pl[i] = m.pload[(size_t)p * W + i];
  }

  // row[s] for a slot s in [0, S) without indexing the array by a
  // runtime value (which would put it in local memory)
  __device__ __forceinline__ int at(int s) const {
    int b = row[0];
#pragma unroll
    for (int q = 1; q < NS; ++q) b = s == q ? row[q] : b;
    return b;
  }

  // each slot's rack, -1 for an empty slot
  __device__ __forceinline__ void racks(const Model& m, int* rk) const {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      rk[s] = row[s] != -1 ? m.rack[row[s] < 0 ? 0 : row[s]] : -1;
    }
  }
};

// One broker's tables; without capacity loads `cload` is the mean load
// (what the capacity test reads then)
template <bool CAP>
struct BrokerRow {
  float cap[NR], load[NR], cload[NR];
  float lnwin, pot, rc, lc;

  __device__ __forceinline__ void gather(const Model& m, int b) {
    const size_t o = (size_t)b * NR;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      cap[r] = m.capacity[o + r];
      load[r] = m.load[o + r];
      cload[r] = CAP ? m.cload[o + r] : load[r];
    }
    lnwin = m.leader_nwin[b];
    pot = m.pot_nwout[b];
    rc = m.rcount[b];
    lc = m.lcount[b];
  }

  // its cost as it stands (ops/cost.py: broker_cost)
  __device__ __forceinline__ float cost(const float* c,
                                        const float* t) const {
    return broker_cost(c, t, cap, load, lnwin, pot, rc, lc,
                       CAP ? cload : nullptr);
  }
};

}  // namespace cc_cost

#endif  // CRUISE_CONTROL_ROW_GATHER_CUH_
