// The per-candidate body of K6 (csrc/score_candidates.cu) and K14
// (csrc/score_columnar.cu, which scores the columnar round's flat grid
// without materializing its columns): the exact cost delta and feasibility
// of one replica move or leadership transfer (analyzer/score_kernel.py:
// _score_candidates, the reference's tpu_optimizer.py:513), operation for
// operation, so both equal the plain twin bit for bit (built without FMA
// contraction).  One copy, in four parts: the candidate's shared state
// (`Candidate::gather`, its loads, then `derive`), one endpoint's cost
// change (`Candidate::part`, e = 0 the source broker, e = 1 the
// destination) and the fused mask and delta from the two parts
// (`Candidate::finish`).  K6 runs a candidate's parts on a lane pair, an
// endpoint a lane; K14 runs both on one thread (`score_one`).  Both add
// the source's part before the destination's, as the plain twin does.

#ifndef CRUISE_CONTROL_SCORE_COMMON_CUH_
#define CRUISE_CONTROL_SCORE_COMMON_CUH_

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "broker_cost.cuh"
#include "row_gather.cuh"

namespace cc_score {

using namespace cc_cost;

constexpr int KIND_LEADERSHIP = 1;   // analyzer/score_kernel.py

// A candidate's state that both of its endpoints read, in registers
// (csrc/row_gather.cuh: compiled per slot instance NS and capacity-load
// width CAP, every loop unrolls).
template <int NS, bool CAP>
struct Candidate {
  PartRow<NS, CAP> pr;
  bool is_lead, leader_now, must_excl, must_move_here;
  bool rack_viol_here, dup, rack_clash, dst_dest_ok, dst_lead_ok;
  int slot_broker, src, dst, cand_rack;
  int rk[NS];
  float delta_load[NR], cdelta_load[NR], move_load[NR];

  // Level 1 the partition row, level 2 its slots' racks and the
  // destination's rack and flags, each level's loads issued together; a
  // caller gathers its endpoints' brokers (BrokerRow) next, before
  // `derive` reads any of it.  The source and destination clamp at 0, the
  // slot at [0, S-1], an empty slot's rack is -1, as in the plain twin.
  __device__ __forceinline__ void gather(const Model& m, int kind, int cp,
                                         int cs, int cd, int S) {
    is_lead = kind == KIND_LEADERSHIP;
    pr.gather(m, cp, S);
    const int cs_c = cs < 0 ? 0 : (cs > S - 1 ? S - 1 : cs);
    const int cp_c = cp < 0 ? 0 : cp;
    must_excl = m.must_move[(size_t)cp_c * S + cs_c] != 0;
    must_move_here = m.must_move[(size_t)cp * S + cs_c] != 0;

    slot_broker = pr.at(cs);
    const int leader_broker = pr.at(pr.lslot);
    src = is_lead ? leader_broker : slot_broker;
    dst = is_lead ? slot_broker : cd;
    const int dst_c = dst < 0 ? 0 : dst;
    pr.racks(m, rk);
    cand_rack = m.rack[dst_c];
    dst_dest_ok = m.dest_ok[dst_c] != 0;
    dst_lead_ok = m.lead_ok[dst_c] != 0;
  }

  // the hard-goal scans over the slots and the move's load deltas
  __device__ __forceinline__ void derive(int cs, int S) {
    leader_now = pr.lslot == cs;
    int my_rack = rk[0];
#pragma unroll
    for (int s = 1; s < NS; ++s) my_rack = cs == s ? rk[s] : my_rack;
    rack_viol_here = false;
    dup = false;
    rack_clash = false;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < S) {
        const bool occupied = pr.row[s] != -1;
        rack_viol_here = rack_viol_here ||
                         (s < cs && rk[s] == my_rack && occupied);
        dup = dup || pr.row[s] == dst || pr.orig[s] == dst;
        const int other = (occupied && s != cs) ? rk[s] : -1;
        rack_clash = rack_clash || other == cand_rack;
      }
    }

    // move and capacity-estimate deltas (delta_load, cdelta_load)
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float lead = pr.pl[r], fol = pr.pl[NR + r];
      move_load[r] = leader_now ? lead : fol;
      delta_load[r] = is_lead ? lead - fol : move_load[r];
      if (CAP) {
        const float leadc = pr.pl[2 * NR + 1 + r];
        const float folc = pr.pl[3 * NR + 1 + r];
        cdelta_load[r] = is_lead ? leadc - folc
                                 : (leader_now ? leadc : folc);
      } else {
        cdelta_load[r] = delta_load[r];
      }
    }
  }

  // the broker of endpoint e (0 the source, 1 the destination), clamped
  __device__ __forceinline__ int broker(int e) const {
    const int b = e != 0 ? dst : src;
    return b < 0 ? 0 : b;
  }

  // Endpoint e's cost change f_new - f_old, x its broker's tables and
  // f_old its cost as it stands; *tests gets the capacity test (bit 0) and
  // the replica-count test (bit 1) of x as the destination, which only the
  // destination's call means.  The same instructions for either e, on
  // selected inputs, so a lane pair running both never diverges.
  __device__ __forceinline__ float part(const float* c, const float* t,
                                        const BrokerRow<CAP>& x, float f_old,
                                        int e, int* tests) const {
    const bool dst_side = e != 0;
    float dst_cload_after[NR];
    bool cap_ok = true;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      dst_cload_after[r] = x.cload[r] + cdelta_load[r];
      cap_ok = cap_ok &&
               dst_cload_after[r] <= x.cap[r] * c[C_THR + r] + 1e-6f;
    }
    const bool rcount_ok = x.rc + 1.0f <= t[T_MAX_REPL];
    *tests = (cap_ok ? 1 : 0) | (rcount_ok ? 2 : 0);

    const bool lead_or_now = is_lead || leader_now;
    const float l_delta = lead_or_now ? 1.0f : 0.0f;
    const float r_delta = is_lead ? 0.0f : 1.0f;
    const float lnwin_delta = lead_or_now ? pr.pl[NW_IN] : 0.0f;
    const float pot_delta = is_lead ? 0.0f : pr.pl[NW_OUT];
    float ld_new[NR], cl_new[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float s_new = x.load[r] - delta_load[r];
      const float sc_new = CAP ? x.cload[r] - cdelta_load[r] : 0.0f;
      const float d_new = x.load[r] + delta_load[r];
      ld_new[r] = dst_side ? d_new : s_new;
      cl_new[r] = dst_side ? dst_cload_after[r] : sc_new;
    }
    const float lnwin_new =
        dst_side ? x.lnwin + lnwin_delta : x.lnwin - lnwin_delta;
    const float pot_new = dst_side ? x.pot + pot_delta : x.pot - pot_delta;
    const float rc_new = dst_side ? x.rc + r_delta : x.rc - r_delta;
    const float lc_new = dst_side ? x.lc + l_delta : x.lc - l_delta;
    const float f_new = broker_cost(c, t, x.cap, ld_new, lnwin_new, pot_new,
                                    rc_new, lc_new, CAP ? cl_new : nullptr);
    return f_new - f_old;
  }

  // the fused hard-goal mask and the cost delta (+inf where infeasible)
  // from the source's and the destination's parts and the destination's
  // tests
  __device__ __forceinline__ void finish(const float* t, float src_part,
                                         float dst_part, int dst_tests,
                                         float* out_delta,
                                         uint8_t* out_feasible) const {
    const bool dcap_ok = (dst_tests & 1) != 0;
    const bool drc_ok = (dst_tests & 2) != 0;
    const bool slot_exists = slot_broker != -1;
    const bool excl_cp = pr.pl[2 * NR] > 0.5f;
    const bool excluded = excl_cp && !must_excl;
    const bool move_ok = dst >= 0 && src != dst && slot_exists &&
                         dst_dest_ok && !dup && !rack_clash && dcap_ok &&
                         drc_ok && !excluded && (!leader_now || dst_lead_ok);
    const bool lead_feasible = slot_exists && !leader_now && dst_lead_ok &&
                               !must_move_here && !excl_cp && dcap_ok;
    const bool feasible = is_lead ? lead_feasible : move_ok;

    float delta = src_part + dst_part;
    const float friction =
        (is_lead ? 0.0f : move_load[DISK] / t[T_AVG_DISK]) * t[T_W_MOVE];
    const float evac = (must_move_here && !is_lead) ? EVAC_BONUS : 0.0f;
    const float rack_fix =
        (rack_viol_here && !is_lead) ? RACK_FIX_BONUS : 0.0f;
    delta = delta + friction;
    delta = delta + evac;
    delta = delta + rack_fix;
    *out_delta = feasible ? delta : INFINITY;
    *out_feasible = feasible ? 1 : 0;
  }
};

// One candidate on one thread: both endpoints' brokers gathered, each's
// cost as it stands computed, the source's part, then the destination's
template <int NS, bool CAP>
__device__ __forceinline__ void score_one(const Model& m, const float* c,
                                          const float* t, int kind, int cp,
                                          int cs, int cd, int S,
                                          float* out_delta,
                                          uint8_t* out_feasible) {
  Candidate<NS, CAP> k;
  k.gather(m, kind, cp, cs, cd, S);
  BrokerRow<CAP> xs, xd;
  xs.gather(m, k.broker(0));
  xd.gather(m, k.broker(1));
  k.derive(cs, S);
  int src_tests, dst_tests;
  const float src_part = k.part(c, t, xs, xs.cost(c, t), 0, &src_tests);
  const float dst_part = k.part(c, t, xd, xd.cost(c, t), 1, &dst_tests);
  k.finish(t, src_part, dst_part, dst_tests, out_delta, out_feasible);
}

}  // namespace cc_score

#endif  // CRUISE_CONTROL_SCORE_COMMON_CUH_
