// K16 — the incremental rescore's stale sets and decision, for Hopper
// (sm_90a).
//
// What it replaces.  The head of the reference's incremental rescore,
// cruise_control_tpu/analyzer/tpu_optimizer.py:1075-1095 (with :1157 and
// the `argsort`s of :1098, :1130 and :1146): from the step before's
// commits — the brokers `tb` [B] and partitions `tpm` [P] it touched (K8
// marks them) — the stale pool rows `row_stale[k] = tpm[kp[k]]`, the stale
// destination columns `col_stale[j] = dest_pool[j] >= 0 && tb[dest_pool[j]]`
// and the stale leadership entries `l_stale[i] = tpm[lp[i]] |
// tb[leader broker of lp[i]] | tb[broker in slot lsl[i]]`; the overflow
// test of their counts against the budgets RB, CB, LB; the step's decision
// `fresh = repool | overflow | since_full >= refresh_steps`; the carry's
// N_OVF, SINCE_FULL, FRESH and N_PATCH; and the index lists the patch
// reads, each the first RB / CB / LB of `argsort(~stale)` (stable: stale
// indices ascending, then the others ascending), the column list as pool
// indices with -1 where the column is not stale.  It reads REPOOL, which K10
// set this step (K10 has already cleared NEED_POOL).  An inactive step
// (past the loop's end) writes nothing.  Its plain twin is
// analyzer/rescore_kernels.py: stale_sets_plain.
//
// What bounds it.  It reads K + D + L pool entries and, per leadership
// entry, two assignment words and a leader slot (~24 B), plus the marks
// they index: ~0.3 MB at K = L = 8 192, D = 1 000 — bytes (~0.1 us at
// 3.35 TB/s).  Its real limit is its chain of block barriers: one counting
// pass, then a block-wide scan per 1 024-entry chunk of each list (~18
// chunks at that size).
//
// What the design does about it.  One block of 1 024 threads: a counting
// pass (warp shuffles, then shared atomics) gives the three counts and the
// decision; then each list is compacted in stable order by a block-wide
// prefix count per chunk (csrc/step_common.cuh: block_count_before, K7's
// too) — position `before` for a stale entry and `n_stale + (i - before)`
// for the others, `before` the stale entries ahead of it — written where
// the position is under the budget.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct In {
  const int* assignment;     // [P, S]
  const int* leader_slot;    // [P]
  const int* kp;             // [K]
  const int* dest_pool;      // [D]
  const int* lp;             // [L]
  const int* lsl;            // [L]
  const uint8_t* tb;         // [B]
  const uint8_t* tpm;        // [P]
  int S;
};

// entry i of list `which` (0 rows, 1 columns, 2 leadership) is stale
__device__ __forceinline__ bool stale(const In& in, int which, int i) {
  if (which == 0) return in.tpm[in.kp[i]] != 0;
  if (which == 1) {
    const int d = in.dest_pool[i];
    return d >= 0 && in.tb[d] != 0;
  }
  const int p = in.lp[i];
  const int* row = in.assignment + (size_t)p * in.S;
  const int lb = max(row[in.leader_slot[p]], 0);
  const int sb = max(row[in.lsl[i]], 0);
  return in.tpm[p] != 0 || in.tb[lb] != 0 || in.tb[sb] != 0;
}

__global__ void __launch_bounds__(THREADS)
stale_sets_kernel(In in, int K, int D, int L, int RB, int CB, int LB,
                  int refresh, int* state, int* ridx, int* cidx, int* lidx,
                  int* nstale) {
  __shared__ int s_count[3];
  __shared__ int s_warp[WARPS];
  const int tid = threadIdx.x, nt = blockDim.x;
  if (!state[cc_state::ACTIVE]) return;
  if (tid < 3) s_count[tid] = 0;
  __syncthreads();

  // ---- the three counts ----------------------------------------------------
  const int len[3] = {K, D, L};
  for (int w = 0; w < 3; ++w) {
    int c = 0;
    for (int i = tid; i < len[w]; i += nt) c += stale(in, w, i) ? 1 : 0;
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(FULL, c, o);
    if ((tid & 31) == 0) atomicAdd(&s_count[w], c);
  }
  __syncthreads();
  const int n[3] = {s_count[0], s_count[1], s_count[2]};

  // ---- the decision, into the carry ----------------------------------------
  if (tid == 0) {
    using namespace cc_state;
    const bool repool = state[REPOOL] != 0;
    const bool overflow = n[0] > RB || n[1] > CB || n[2] > LB;
    const int since = state[SINCE_FULL];
    const bool fresh =
        repool || overflow || (refresh > 0 && since >= refresh);
    state[N_OVF] += overflow && !repool ? 1 : 0;
    state[SINCE_FULL] = fresh ? 0 : since + 1;
    state[FRESH] = fresh ? 1 : 0;
    state[N_PATCH] += fresh ? 0 : 1;
    nstale[0] = n[0];
    nstale[1] = n[1];
    nstale[2] = n[2];
  }

  // ---- each list in argsort(~stale)'s stable order, to its budget ----------
  int* const out[3] = {ridx, cidx, lidx};
  const int budget[3] = {RB, CB, LB};
  for (int w = 0; w < 3; ++w) {
    int base = 0;   // stale entries in earlier chunks (the same everywhere)
    for (int c0 = 0; c0 < len[w]; c0 += nt) {
      const int i = c0 + tid;
      const bool f = i < len[w] && stale(in, w, i);
      int tot;
      // stale entries ahead of i
      const int before = base + cc_step::block_count_before(f, s_warp, &tot);
      if (i < len[w]) {
        const int pos = f ? before : n[w] + (i - before);
        if (pos < budget[w]) out[w][pos] = (w == 1 && !f) ? -1 : i;
      }
      base += tot;
    }
  }
}

}  // namespace

extern "C" {

// Launches K16 on `stream` (one block); `state` is the step loop's carry,
// `nstale` an int32 [3] of the three stale counts.  Budgets must be in
// [1, list length].  Returns the CUDA error code.
int stale_sets_launch(const int* assignment, const int* leader_slot,
                      const int* kp, const int* dest_pool, const int* lp,
                      const int* lsl, const uint8_t* tb, const uint8_t* tpm,
                      int* state, int K, int D, int L, int S, int RB, int CB,
                      int LB, int refresh, int* ridx, int* cidx, int* lidx,
                      int* nstale, void* stream) {
  if (K < 1 || D < 1 || L < 1 || S < 1 || RB < 1 || RB > K || CB < 1 ||
      CB > D || LB < 1 || LB > L) {
    return (int)cudaErrorInvalidValue;
  }
  In in{assignment, leader_slot, kp, dest_pool, lp, lsl, tb, tpm, S};
  stale_sets_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      in, K, D, L, RB, CB, LB, refresh, state, ridx, cidx, lidx, nstale);
  return (int)cudaGetLastError();
}

}  // extern "C"
