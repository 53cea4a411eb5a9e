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
// The eager port ran it as ~410 small torch ops a step.  This kernel is
// the whole function: a lane pair per candidate writes delta[n] (+inf
// where infeasible) and feasible[n].
//
// Rounding.  Every operation is the plain twin's, in its order (the body
// is csrc/score_common.cuh's `Candidate`, which K14 runs on one thread,
// split here over two lanes): `broker_cost` comes from
// csrc/broker_cost.cuh (shared with K2), the capacity test is `load +
// delta <= capacity * threshold + 1e-6` per resource, friction is divided
// by avg_disk_cap and then multiplied by w_move_size, and the bonuses are
// added in order.  A cost read from K2's table (`bcost`) is the same
// function of the same broker tables, so it has the same bits.  Clamped
// indices copy the plain twin: the source and destination clamp at 0, the
// slot at [0, S-1], an empty slot's rack is -1.  Built without FMA
// contraction, the result equals the plain twin's bit for bit.
//
// What bounds it.  Per candidate it reads its three ids (12 B), one
// partition row (S slots, S offline origins, S must-move flags, the leader
// slot, the 2R+1 or 4R+1 f32 load row), S broker racks and the two
// endpoint brokers' tables (~70 B each) and each one's cost from K2's
// table, and writes 5 B; it does two broker costs (~85 operations each,
// the costs after the move) and ~60 more.  At N = 8 192 that is ~1.5 MB
// against ~1.9 M operations: bytes bound it
// (~0.5 us at 3.35 TB/s).  The gathers are random and dependent (the
// ids, then the partition row, then its brokers), and each cost's ~12
// IEEE divisions are branch regions of their own, so the latency of one
// candidate's chain, not bandwidth, sets its time.
//
// What the design does about it.
// - The card is filled: a candidate takes a lane pair, 32 candidates a
//   block of 64 lanes, N / 32 blocks (256 at 1000b/20k).
// - Its two endpoints run side by side: both lanes gather the partition
//   row (one request), lane 0 then the source broker and lane 1 the
//   destination — the same instructions on selected inputs, so the pair
//   never diverges — and each computes its broker's cost after the move;
//   one shuffle hands lane 0 the destination's cost change and capacity
//   and count tests, and lane 0 writes the result.
// - The costs before the move come from K2's table (`bcost`, written by
//   K2 on the same model earlier in the step or round, with no commit
//   between): one cost a lane, not four a candidate.
// - Per-candidate state lives in registers (csrc/row_gather.cuh: the
//   kernel is compiled per slot instance and capacity-load width, every
//   loop unrolls), and every gather of a level is issued before any
//   arithmetic reads it; the parent's slot loops ran to the runtime S and
//   reloaded a slot and its rack an iteration.
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

#include "broker_cost.cuh"
#include "grid_cell.cuh"
#include "row_gather.cuh"
#include "score_common.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_cost;
using cc_score::Candidate;

constexpr int THREADS = 64;
constexpr int PER_BLOCK = THREADS / 2;   // a candidate takes a lane pair

template <int NS, bool CAP>
__global__ void __launch_bounds__(THREADS)
score_candidates_rows_kernel(Model m, const int* __restrict__ kind,
                             const int* __restrict__ cp,
                             const int* __restrict__ cs,
                             const int* __restrict__ cd,
                             const float* __restrict__ consts,
                             const float* __restrict__ tconsts, int N, int S,
                             float* __restrict__ delta,
                             uint8_t* __restrict__ feasible,
                             const int* __restrict__ rows,
                             const int* __restrict__ n_rows, const int* gate,
                             int want, const float* __restrict__ bcost) {
  if (gate != nullptr && !cc_state::gate_open(gate, want)) return;
  const int n_end = rows != nullptr ? min(N, *n_rows) : N;
  // a lane pair a candidate
  const int n = blockIdx.x * PER_BLOCK + (threadIdx.x >> 1);
  if (n >= n_end) return;
  const unsigned pair = 3u << ((threadIdx.x & 31) & ~1);
  const int i = rows != nullptr ? rows[n] : n;
  float c[NC], t[NT];
#pragma unroll
  for (int q = 0; q < NC; ++q) c[q] = consts[q];
#pragma unroll
  for (int q = 0; q < NT; ++q) t[q] = tconsts[q];
  // csrc/score_common.cuh's body on a lane pair: both lanes gather the
  // candidate, lane e = 0 its source broker and e = 1 its destination,
  // each reads its broker's cost before the move from `bcost` and computes
  // its cost change; lane 1 hands lane 0 its part and tests, and lane 0
  // writes the result
  const int e = threadIdx.x & 1;
  const int ci = cs[i];
  Candidate<NS, CAP> k;
  k.gather(m, kind[i], cp[i], ci, cd[i], S);
  const int b = k.broker(e);
  BrokerRow<CAP> x;
  x.gather(m, b);
  const float f_old = bcost[b];
  k.derive(ci, S);
  int tests;
  const float part = k.part(c, t, x, f_old, e, &tests);
  const float dst_part = __shfl_xor_sync(pair, part, 1);
  const int dst_tests = __shfl_xor_sync(pair, tests, 1);
  if (e != 0) return;
  float d;
  uint8_t ok;
  k.finish(t, part, dst_part, dst_tests, &d, &ok);
  delta[i] = d;
  if (feasible != nullptr) feasible[i] = ok;
}

template <int NS, bool CAP>
const void* instance() {
  return (const void*)score_candidates_rows_kernel<NS, CAP>;
}

}  // namespace

extern "C" {

// {NC, NT, MAX_S}: the wrapper checks its constant blocks against it.
void score_candidates_layout(int* out) {
  out[0] = NC;
  out[1] = NT;
  out[2] = MAX_S;
}

// The instance for S slots and partition-table width W: {registers, local
// bytes, static shared bytes, dynamic shared bytes, blocks an SM}.
int score_candidates_attrs(int S, int W, int* out) {
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

// Launches K6 on `stream`; returns the CUDA error code (0 = launched).
// `rows` / `n_rows` (both or neither) restrict it to the first
// min(N, *n_rows) entries of an index list, N its length; `gate` (or null)
// and `want` gate it on the step loop's carry; a null `feasible` is not
// written; `bcost` is each broker's cost as it stands, K2's table on the
// same model, read in place of the two costs before the move.
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
                            const float* bcost, void* stream) {
  if (N < 1 || S < 1 || S > MAX_S || bcost == nullptr ||
      (rows == nullptr) != (n_rows == nullptr) ||
      (W != 2 * NR + 1 && W != 4 * NR + 1) ||
      ((W == 4 * NR + 1) != (cload != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Model m{assignment, leader_slot, offline_origin, must_move, pload, rack,
          dest_ok,    lead_ok,     capacity,       load,      cload, leader_nwin,
          pot_nwout,  rcount,      lcount};
  const int grid = (N + PER_BLOCK - 1) / PER_BLOCK;
  cc_grid::with_cell_instance(S, W == 4 * NR + 1, [&](auto ns, auto c) {
    score_candidates_rows_kernel<decltype(ns)::value,
                                 decltype(c)::value == 1>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            m, kind, cp, cs, cd, consts, tconsts, N, S, delta, feasible,
            rows, n_rows, gate, want, bcost);
    return 0;
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
