// K14 — the columnar score-only round's flat key, its candidates' negated
// scores, for Hopper (sm_90a).
//
// What it replaces.  cruise_control_tpu/analyzer/tpu_optimizer.py:720
// `_build_round_candidates` (the K×D move grid flattened — `repeat(kp, D)`,
// `repeat(ks, D)`, `tile(dest_pool, K)` — then every P·S leadership
// transfer appended) and :513 `_score_candidates` over all of them, as
// :2902 `columnar_topk` calls it before its top-k, and the negation of
// that top-k's input, `lax.top_k(-scores)` (:2905, :2956).  Flat index
// i < K·D is
// the move of pool row i / D to destination dest_pool[i % D]; any other i
// is the leadership transfer of partition (i - K·D) / S to its slot
// (i - K·D) % S.  The plain twins (analyzer/round_kernels.py:
// score_columnar_plain, then round_keys_plain) materialize those four
// columns, call `_score_candidates` and negate; this kernel derives each
// candidate from its index, never writes the columns (4 × 33 MB at
// 1000b/20k) and stores each score negated, so the round needs no second
// pass over the 33 MB of scores to make its key (K13's first entry point
// makes only the grid form's).
//
// Rounding.  Each candidate is scored by csrc/score_common.cuh: score_one
// (K6 runs the same body on a lane pair), the plain twin's operations in
// its order, built without FMA contraction: -key[i] equals
// the plain twin's score bit for bit, +inf where the candidate is
// infeasible; negation flips the sign bit only.
//
// What bounds it.  N = K·D + P·S = 8 252 000 candidates at 1000b/20k.
// Per candidate four broker costs (~85 operations each) and ~60 more:
// ~3.3 G f32 operations, ~0.05 ms at 67 TFLOP/s, against 33 MB written
// (~0.01 ms at 3.35 TB/s): operations bound it.  The model reads are
// gathers that mostly hit L2 (K = 8 192 source rows, B = 1 000 brokers).
//
// What the design does about it.  One thread per flat index, no shared
// state and no synchronisation; neighbouring threads of a move row share
// its partition row and source broker (cached), and neighbouring
// leadership indices walk the partition table in order.  The kernel is
// compiled per slot instance and capacity-load width (csrc/grid_cell.cuh:
// with_cell_instance), so a candidate's row and its two brokers are
// gathered into registers (csrc/row_gather.cuh) before any arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_cell.cuh"
#include "score_common.cuh"

namespace {

using namespace cc_cost;
using cc_score::KIND_LEADERSHIP;
using cc_score::score_one;

constexpr int THREADS = 256;
constexpr int KIND_MOVE = 0;

template <int NS, bool CAP>
__global__ void __launch_bounds__(THREADS)
score_columnar_kernel(Model m, const int* __restrict__ kp,
                      const int* __restrict__ ks,
                      const int* __restrict__ dest_pool,
                      const float* __restrict__ consts,
                      const float* __restrict__ tconsts, long long KD, int D,
                      long long N, int S, float* __restrict__ key) {
  float c[NC], t[NT];
#pragma unroll
  for (int q = 0; q < NC; ++q) c[q] = consts[q];
#pragma unroll
  for (int q = 0; q < NT; ++q) t[q] = tconsts[q];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < N; i += (long long)gridDim.x * blockDim.x) {
    int kind, cp, cs, cd;
    if (i < KD) {
      const long long row = i / D;
      kind = KIND_MOVE;
      cp = kp[row];
      cs = ks[row];
      cd = dest_pool[i % D];
    } else {
      const long long j = i - KD;
      kind = KIND_LEADERSHIP;
      cp = (int)(j / S);
      cs = (int)(j % S);
      cd = 0;
    }
    float delta;
    uint8_t feasible;
    score_one<NS, CAP>(m, c, t, kind, cp, cs, cd, S, &delta, &feasible);
    key[i] = -delta;
  }
}

}  // namespace

extern "C" {

// {NC, NT, MAX_S}: the wrapper checks its constant blocks against it.
void score_columnar_layout(int* out) {
  out[0] = NC;
  out[1] = NT;
  out[2] = MAX_S;
}

// Launches K14 on `stream`: key[i] = -score of the i-th of the
// N = K·D + P·S flat candidates; returns the CUDA error code (0 =
// launched).
int score_columnar_launch(const int* assignment, const int* leader_slot,
                          const int* offline_origin,
                          const uint8_t* must_move, const float* pload,
                          const int* rack, const uint8_t* dest_ok,
                          const uint8_t* lead_ok, const float* capacity,
                          const float* load, const float* cload,
                          const float* leader_nwin, const float* pot_nwout,
                          const float* rcount, const float* lcount,
                          const int* kp, const int* ks,
                          const int* dest_pool, const float* consts,
                          const float* tconsts, int K, int D, int P, int S,
                          int W, float* key, void* stream) {
  if (K < 0 || D < 1 || P < 0 || S < 1 || S > MAX_S ||
      (W != 2 * NR + 1 && W != 4 * NR + 1) ||
      ((W == 4 * NR + 1) != (cload != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long KD = (long long)K * D;
  const long long N = KD + (long long)P * S;
  if (N < 1) return (int)cudaErrorInvalidValue;
  Model m{assignment, leader_slot, offline_origin, must_move, pload, rack,
          dest_ok,    lead_ok,     capacity,       load,      cload, leader_nwin,
          pot_nwout,  rcount,      lcount};
  const long long blocks = (N + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
  cc_grid::with_cell_instance(S, W == 4 * NR + 1, [&](auto ns, auto c) {
    score_columnar_kernel<decltype(ns)::value, decltype(c)::value == 1>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            m, kp, ks, dest_pool, consts, tconsts, KD, D, N, S, key);
    return 0;
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
