// K6 — exact cost delta and feasibility of columnar candidate actions,
// for Hopper (sm_90a).
//
// What it replaces.  cruise_control_tpu/analyzer/tpu_optimizer.py:513
// `_score_candidates`: for N candidates, each a replica move (kind 0: the
// replica in slot cs of partition cp to broker cd) or a leadership
// transfer (kind 1: leadership of cp to the replica in slot cs), the fused
// hard-goal mask (slot exists, destination allowed, no duplicate replica
// or offline origin, no rack clash with the other replicas, capacity under
// the threshold over every resource, replica-count headroom, exclusion,
// leadership eligibility) and the exact change of the global soft-goal
// cost: the source broker's cost after minus before plus the
// destination's, through ops/cost.py `broker_cost`, plus the move-size
// friction and the evacuation / rack-fix bonuses.  The search runs it
// every step over the L leadership candidates (L = 8 192 at 1000b/20k).
// The per-candidate body lives in csrc/score_common.cuh, which K14
// (csrc/score_columnar.cu) compiles too.  The eager port ran it as ~410
// small torch ops a step.  This kernel is the whole function: one thread
// per candidate writes delta[n] (+inf where infeasible) and feasible[n].
//
// Rounding.  Every operation is the plain twin's, in its order:
// `broker_cost` comes from csrc/broker_cost.cuh (shared with K2), the
// capacity test is `load + delta <= capacity * threshold + 1e-6` per
// resource, friction is divided by avg_disk_cap and then multiplied by
// w_move_size, and the bonuses are added in order.  Clamped indices copy
// the plain twin: the source and destination clamp at 0, the slot at
// [0, S-1], an empty slot's rack is -1.  Built without FMA contraction,
// the result equals the plain twin's bit for bit.
//
// What bounds it.  Per candidate it reads its three ids (12 B), one
// partition row (S slots, S offline origins, S must-move flags, the leader
// slot, the 2R+1 or 4R+1 f32 load row), S broker racks and the two
// endpoint brokers' tables (~70 B each), and writes 5 B; it does four
// broker costs (~85 operations each) and ~60 more.  At N = 8 192 that is
// ~1.5 MB against ~3.3 M operations: bytes bound it (~0.5 us at 3.35
// TB/s).  The gathers are random and dependent (the row, then its
// brokers), so latency, not bandwidth, sets its time.
//
// What the design does about it.  One thread per candidate, no shared
// state and no synchronisation; the N threads in flight overlap their
// gather latencies.
//
// The incremental rescore (tpu_optimizer.py:1063-1066 and :1145-1150, the
// patch's part (c)).  With `incremental_rescore=True` the step keeps the
// leadership scores in a carry and K6 runs twice a step, each gated on the
// device carry (csrc/step_common.cuh: gate_open): over the whole pool when
// the step rescores in full, and over the first n (<= LB) entries of an
// index list (K16's stale entries) when it patches, each written at its
// own index.  A launch whose gate is shut returns at once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_common.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_cost;
using cc_score::score_one;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
score_candidates_kernel(Model m, const int* __restrict__ kind,
                        const int* __restrict__ cp,
                        const int* __restrict__ cs,
                        const int* __restrict__ cd,
                        const float* __restrict__ consts,
                        const float* __restrict__ tconsts, int N, int S,
                        int W, float* __restrict__ delta,
                        uint8_t* __restrict__ feasible,
                        const int* __restrict__ rows,
                        const int* __restrict__ n_rows, const int* gate,
                        int want) {
  if (gate != nullptr && !cc_state::gate_open(gate, want)) return;
  float c[NC], t[NT];
#pragma unroll
  for (int q = 0; q < NC; ++q) c[q] = consts[q];
#pragma unroll
  for (int q = 0; q < NT; ++q) t[q] = tconsts[q];
  const int n_end = rows != nullptr ? min(N, *n_rows) : N;
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < n_end;
       n += gridDim.x * blockDim.x) {
    const int i = rows != nullptr ? rows[n] : n;
    uint8_t ok;
    score_one(m, c, t, kind[i], cp[i], cs[i], cd[i], S, W, delta + i, &ok);
    if (feasible != nullptr) feasible[i] = ok;
  }
}

}  // namespace

extern "C" {

// {NC, NT, MAX_S}: the wrapper checks its constant blocks against it.
void score_candidates_layout(int* out) {
  out[0] = NC;
  out[1] = NT;
  out[2] = MAX_S;
}

// Launches K6 on `stream`; returns the CUDA error code (0 = launched).
// `rows` / `n_rows` (both or neither) restrict it to the first
// min(N, *n_rows) entries of an index list, N its length; `gate` (or null)
// and `want` gate it on the step loop's carry; a null `feasible` is not
// written.
int score_candidates_launch(const int* assignment, const int* leader_slot,
                            const int* offline_origin,
                            const uint8_t* must_move, const float* pload,
                            const int* rack, const uint8_t* dest_ok,
                            const uint8_t* lead_ok, const float* capacity,
                            const float* load, const float* cload,
                            const float* leader_nwin, const float* pot_nwout,
                            const float* rcount, const float* lcount,
                            const int* kind, const int* cp, const int* cs,
                            const int* cd, const float* consts,
                            const float* tconsts, int N, int S, int W,
                            float* delta, uint8_t* feasible, const int* rows,
                            const int* n_rows, const int* gate, int want,
                            void* stream) {
  if (N < 1 || S < 1 || S > MAX_S ||
      (rows == nullptr) != (n_rows == nullptr) ||
      (W != 2 * NR + 1 && W != 4 * NR + 1) ||
      ((W == 4 * NR + 1) != (cload != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Model m{assignment, leader_slot, offline_origin, must_move, pload, rack,
          dest_ok,    lead_ok,     capacity,       load,      cload, leader_nwin,
          pot_nwout,  rcount,      lcount};
  const int grid = (N + THREADS - 1) / THREADS;
  score_candidates_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      m, kind, cp, cs, cd, consts, tconsts, N, S, W, delta, feasible, rows,
      n_rows, gate, want);
  return (int)cudaGetLastError();
}

}  // extern "C"
