// K6's per-candidate body: the exact cost delta and feasibility of one
// replica move or leadership transfer (analyzer/score_kernel.py:
// _score_candidates, the reference's tpu_optimizer.py:513).  Shared by K6
// (csrc/score_candidates.cu), which scores a list of candidates, and K14
// (csrc/score_columnar.cu), which scores the columnar round's flat grid
// without materializing its columns: one copy, so both compile the same
// arithmetic, operation for operation, and equal the plain twin bit for
// bit (built without FMA contraction).

#ifndef CRUISE_CONTROL_SCORE_COMMON_CUH_
#define CRUISE_CONTROL_SCORE_COMMON_CUH_

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "broker_cost.cuh"

namespace cc_score {

using namespace cc_cost;

constexpr int KIND_LEADERSHIP = 1;   // analyzer/score_kernel.py

__device__ void score_one(const Model& m, const float* c, const float* t,
                          int kind, int cp, int cs, int cd, int S, int W,
                          float* out_delta, uint8_t* out_feasible) {
  const bool is_lead = kind == KIND_LEADERSHIP;
  const int* row = m.assignment + (size_t)cp * S;
  const int* orig = m.offline_origin + (size_t)cp * S;
  const float* pl = m.pload + (size_t)cp * W;
  const bool has_cap = W > 2 * NR + 1;
  const int lslot = m.leader_slot[cp];
  const int slot_broker = row[cs];
  const int leader_broker = row[lslot];
  const int src = is_lead ? leader_broker : slot_broker;
  const int dst = is_lead ? slot_broker : cd;
  const int dst_c = dst < 0 ? 0 : dst;
  const int src_c = src < 0 ? 0 : src;
  const bool leader_now = lslot == cs;

  int slot_rack[MAX_S];
  for (int s = 0; s < S; ++s) {
    const int b = row[s];
    slot_rack[s] = b != -1 ? m.rack[b < 0 ? 0 : b] : -1;
  }
  const int my_rack = slot_rack[cs];
  bool rack_viol_here = false;
  bool dup = false;
  bool rack_clash = false;
  const int cand_rack = m.rack[dst_c];
  for (int s = 0; s < S; ++s) {
    const bool occupied = row[s] != -1;
    rack_viol_here = rack_viol_here ||
                     (s < cs && slot_rack[s] == my_rack && occupied);
    dup = dup || row[s] == dst || orig[s] == dst;
    const int other = (occupied && s != cs) ? slot_rack[s] : -1;
    rack_clash = rack_clash || other == cand_rack;
  }

  // move and capacity-estimate deltas (delta_load, cdelta_load)
  float delta_load[NR], cdelta_load[NR], move_load[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float lead = pl[r], fol = pl[NR + r];
    move_load[r] = leader_now ? lead : fol;
    delta_load[r] = is_lead ? lead - fol : move_load[r];
    if (has_cap) {
      const float leadc = pl[2 * NR + 1 + r], folc = pl[3 * NR + 1 + r];
      cdelta_load[r] = is_lead ? leadc - folc : (leader_now ? leadc : folc);
    } else {
      cdelta_load[r] = delta_load[r];
    }
  }
  const float* b_cload = has_cap ? m.cload : m.load;

  // ---- feasibility (fused hard-goal mask) -------------------------------
  const bool slot_exists = slot_broker != -1;
  const float* dcap = m.capacity + (size_t)dst_c * NR;
  float dst_cload_after[NR];
  bool cap_ok = true;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    dst_cload_after[r] = b_cload[(size_t)dst_c * NR + r] + cdelta_load[r];
    cap_ok = cap_ok &&
             dst_cload_after[r] <= dcap[r] * c[C_THR + r] + 1e-6f;
  }
  const bool rcount_ok = m.rcount[dst_c] + 1.0f <= t[T_MAX_REPL];
  const int cs_c = cs < 0 ? 0 : (cs > S - 1 ? S - 1 : cs);
  const int cp_c = cp < 0 ? 0 : cp;
  const bool excl_cp = pl[2 * NR] > 0.5f;
  const bool excluded = excl_cp && !m.must_move[(size_t)cp_c * S + cs_c];
  const bool must_move_here = m.must_move[(size_t)cp * S + cs_c] != 0;
  const bool dst_lead_ok = m.lead_ok[dst_c] != 0;
  const bool move_ok = dst >= 0 && src != dst && slot_exists &&
                       m.dest_ok[dst_c] && !dup && !rack_clash && cap_ok &&
                       rcount_ok && !excluded &&
                       (!leader_now || dst_lead_ok);
  const bool lead_feasible = slot_exists && !leader_now && dst_lead_ok &&
                             !must_move_here && !excl_cp && cap_ok;
  const bool feasible = is_lead ? lead_feasible : move_ok;

  // ---- cost delta -------------------------------------------------------
  const bool lead_or_now = is_lead || leader_now;
  const float l_delta = lead_or_now ? 1.0f : 0.0f;
  const float r_delta = is_lead ? 0.0f : 1.0f;
  const float lnwin_delta = lead_or_now ? pl[NW_IN] : 0.0f;
  const float pot_delta = is_lead ? 0.0f : pl[NW_OUT];

  const float* scap = m.capacity + (size_t)src_c * NR;
  const float* sld = m.load + (size_t)src_c * NR;
  const float* scl = has_cap ? m.cload + (size_t)src_c * NR : nullptr;
  const float* dld = m.load + (size_t)dst_c * NR;
  const float* dcl = has_cap ? m.cload + (size_t)dst_c * NR : nullptr;
  float s_new[NR], sc_new[NR], d_new[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    s_new[r] = sld[r] - delta_load[r];
    sc_new[r] = has_cap ? scl[r] - cdelta_load[r] : 0.0f;
    d_new[r] = dld[r] + delta_load[r];
  }
  const float f_src_old =
      broker_cost(c, t, scap, sld, m.leader_nwin[src_c], m.pot_nwout[src_c],
                  m.rcount[src_c], m.lcount[src_c], scl);
  const float f_src_new = broker_cost(
      c, t, scap, s_new, m.leader_nwin[src_c] - lnwin_delta,
      m.pot_nwout[src_c] - pot_delta, m.rcount[src_c] - r_delta,
      m.lcount[src_c] - l_delta, has_cap ? sc_new : nullptr);
  const float f_dst_old =
      broker_cost(c, t, dcap, dld, m.leader_nwin[dst_c], m.pot_nwout[dst_c],
                  m.rcount[dst_c], m.lcount[dst_c], dcl);
  const float f_dst_new = broker_cost(
      c, t, dcap, d_new, m.leader_nwin[dst_c] + lnwin_delta,
      m.pot_nwout[dst_c] + pot_delta, m.rcount[dst_c] + r_delta,
      m.lcount[dst_c] + l_delta, has_cap ? dst_cload_after : nullptr);
  float delta = (f_src_new - f_src_old) + (f_dst_new - f_dst_old);
  const float friction =
      (is_lead ? 0.0f : move_load[DISK] / t[T_AVG_DISK]) * t[T_W_MOVE];
  const float evac = (must_move_here && !is_lead) ? EVAC_BONUS : 0.0f;
  const float rack_fix = (rack_viol_here && !is_lead) ? RACK_FIX_BONUS : 0.0f;
  delta = delta + friction;
  delta = delta + evac;
  delta = delta + rack_fix;
  *out_delta = feasible ? delta : INFINITY;
  *out_feasible = feasible ? 1 : 0;
}

}  // namespace cc_score

#endif  // CRUISE_CONTROL_SCORE_COMMON_CUH_
