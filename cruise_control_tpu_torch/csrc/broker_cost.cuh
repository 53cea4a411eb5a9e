// The fused soft-goal broker cost (ops/cost.py: broker_cost), shared by the
// kernels that score candidate actions: K2 (csrc/grid_terms.cu) and K6
// (csrc/score_candidates.cu).  One copy, so the two cannot drift apart.
//
// Rounding.  `broker_cost` adds its terms in the fixed order of ops/cost.py
// (`rsum` over resources, then the ten terms left to right), every constant
// is the f32 value torch computes with, divisions are IEEE and the kernels
// are built without FMA contraction, so each result equals the plain torch
// cost bit for bit.
//
// The constants come in two f32 blocks the wrappers build once per search:
// K1's block (ops/grid.py: grid_consts, offsets C_*) and K2's extra block
// (ops/grid.py: terms_consts, offsets T_*).

#ifndef CRUISE_CONTROL_BROKER_COST_CUH_
#define CRUISE_CONTROL_BROKER_COST_CUH_

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cc_cost {

constexpr int NR = 4;        // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int NW_OUT = 2;
constexpr int DISK = 3;
constexpr int MAX_S = 8;     // widest replica-slot axis (as K1)

// K1's constant block offsets (ops/grid.py: grid_consts)
constexpr int NC = 3 * NR + 9;
constexpr int C_ULO = 0, C_UUP = NR, C_THR = 2 * NR;
constexpr int C_AVG_LC = 3 * NR, C_LC_UP = 3 * NR + 1, C_LC_LO = 3 * NR + 2;
constexpr int C_LNW_UP = 3 * NR + 3, C_W_VAR = 3 * NR + 4;
constexpr int C_W_BOUND = 3 * NR + 5, C_W_LC = 3 * NR + 6;
constexpr int C_W_LNW = 3 * NR + 7, C_W_POT = 3 * NR + 8;
// K2's extra constants (ops/grid.py: terms_consts)
constexpr int NT = 7;
constexpr int T_AVG_RC = 0, T_RC_UP = 1, T_RC_LO = 2, T_W_COUNT = 3;
constexpr int T_MAX_REPL = 4, T_AVG_DISK = 5, T_W_MOVE = 6;

constexpr float EVAC_BONUS = -1e6f;      // ops/cost.py
constexpr float RACK_FIX_BONUS = -1e4f;

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

// ops/cost.py: rcount_terms
__device__ __forceinline__ void rcount_terms(const float* c, const float* t,
                                             float rc, float* c_rc,
                                             float* c_rc_b) {
  const float t_rc = rc / t[T_AVG_RC] - 1.0f;
  *c_rc = t_rc * t_rc * t[T_W_COUNT];
  *c_rc_b = (relu(rc - t[T_RC_UP]) + relu(t[T_RC_LO] - rc)) / t[T_AVG_RC] *
            c[C_W_BOUND];
}

// ops/cost.py: broker_cost, term for term and in the same order; `cload`
// is null when percentile capacity loads are off
__device__ float broker_cost(const float* c, const float* t,
                             const float* cap_in, const float* load,
                             float lnwin, float pot, float rc, float lc,
                             const float* cload) {
  float cap[NR], u[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    cap[r] = fmaxf(cap_in[r], 1e-9f);
    u[r] = load[r] / cap[r];
  }
  float v = u[0] * u[0];
  float b = relu(u[0] - c[C_UUP]) + relu(c[C_ULO] - u[0]);
  float o = relu((cload ? cload[0] / cap[0] : u[0]) - c[C_THR]);
#pragma unroll
  for (int r = 1; r < NR; ++r) {
    v = v + u[r] * u[r];
    b = b + (relu(u[r] - c[C_UUP + r]) + relu(c[C_ULO + r] - u[r]));
    o = o + relu((cload ? cload[r] / cap[r] : u[r]) - c[C_THR + r]);
  }
  const float c_var = v * c[C_W_VAR];
  const float c_bound = b * c[C_W_BOUND];
  const float c_cap = o * 1000.0f;
  float c_rc, c_rc_b;
  rcount_terms(c, t, rc, &c_rc, &c_rc_b);
  const float t_lc = lc / c[C_AVG_LC] - 1.0f;
  const float c_lc = t_lc * t_lc * c[C_W_LC];
  const float c_lc_b = (relu(lc - c[C_LC_UP]) + relu(c[C_LC_LO] - lc)) /
                       c[C_AVG_LC] * c[C_W_BOUND];
  const float lnw = lnwin / cap[NW_IN];
  const float c_lnw = lnw * lnw * c[C_W_LNW];
  const float c_lnw_b = relu(lnw - c[C_LNW_UP]) * c[C_W_BOUND];
  const float pot_u = pot / cap[NW_OUT];
  const float c_pot = relu(pot_u - c[C_THR + NW_OUT]) * c[C_W_POT];
  return c_var + c_bound + c_cap + c_rc + c_lc + c_rc_b + c_lc_b + c_lnw +
         c_lnw_b + c_pot;
}

// The model tables both scoring kernels read (DeviceModel fields)
struct Model {
  const int* assignment;       // [P, S]
  const int* leader_slot;      // [P]
  const int* offline_origin;   // [P, S]
  const uint8_t* must_move;    // [P, S]
  const float* pload;          // [P, W]: lead | fol | excluded [| leadc | folc]
  const int* rack;             // [B]
  const uint8_t* dest_ok;      // [B]
  const uint8_t* lead_ok;      // [B]
  const float* capacity;       // [B, R]
  const float* load;           // [B, R]
  const float* cload;          // [B, R] or null
  const float* leader_nwin;    // [B]
  const float* pot_nwout;      // [B]
  const float* rcount;         // [B]
  const float* lcount;         // [B]
};

}  // namespace cc_cost

#endif  // CRUISE_CONTROL_BROKER_COST_CUH_
