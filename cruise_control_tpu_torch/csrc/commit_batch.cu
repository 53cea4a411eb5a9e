// K8 — the search step's commit: the step's batch in score order, written
// out and applied to the device model, for Hopper (sm_90a).
//
// What it replaces.  The end of the reference's step,
// cruise_control_tpu/analyzer/tpu_optimizer.py:1335-1391: the merge of the
// budgeted cohort's rows with the auction's winners (`take`, `win_score`,
// `win_dst`), the stable `sort_key_val` (:1342) of the merged scores that
// keeps the M best as the step's commits in score order (`order`,
// `sel_ok`, `take_f`), the compacted `dynamic_update_slice` of their
// (kind, partition, slot, destination) rows into the call's output at the
// running offset, the touched-partition mark `tpp`, and :751
// `_apply_batch_on_device`: the gated ± segment sums of every committed
// action's load, leader NW-in, potential NW-out, replica and leader counts
// (and percentile capacity load) over its source and destination brokers,
// and the drop-mode scatters into `assignment`, `leader_slot` and
// `must_move`.  The eager port ran it as ~160 small torch ops a step.
// This kernel is all of it, in one launch.  It updates the model in place
// (the step loop owns static copies of the mutable tensors).
//
// The loop's carry.  The kernel reads the running offset `count` from the
// step loop's device carry (csrc/step_common.cuh: cc_state) and commits
// nothing unless the carry says the step is active.  Its one-thread tail
// is the reference's meta and loop bookkeeping (:1368-1378, :1394-1395,
// `cond_fn` :1400): the step's commits and its three diagnostic counts
// into `counts[:, t]`, `done |= c == 0 && since_pool == 0`, the
// `since_pool` update, `count += c`, `t += 1`, and the next step's
// `active` and `need_pool`.  So a captured chunk of steps runs without a
// host read: steps past the end of the search do nothing.
//
// Exactness.  The plain twin (analyzer/commit_kernels.py:
// _apply_batch_on_device) sums through ops/segment.py: each column of
// cat([-contrib, contrib]) is scaled by 2^(60 - e), e = frexp-exponent of
// the column's exact max |v| over all 2C rows (rows of uncommitted actions
// are gated to zero and count) plus ceil(log2 2C), rounded half to even
// to int64, summed, and scaled back once; the f32 result is then added to
// the stored f32 aggregate.  The kernel does the same operations: integer
// atomics are exact and order free, so the result equals the plain twin's
// bit for bit.  The commit order uses the 64-bit key (order-preserving
// score bits, row), so -0.0 and +0.0 tie and ties go to the lowest row, as
// in the stable sort.
//
// What bounds it.  It reads the C candidate rows (~40 B each) and their
// partitions' load rows, and reads and writes the broker aggregates
// (B·(2R+4)·4 B each way) and the committed actions' placement entries:
// ~0.1 MB at C = 1 024, B = 1 000 — bound by bytes (~0.03 us at 3.35
// TB/s).  Its real limit is its chain of dependent phases: the sort of C
// keys (55 bitonic stages at C = 1 024), the column maxima, the sums, the
// aggregate update and the scatters, each needing the last.
//
// What the design does about it.  One block of 1 024 threads runs the
// chain with block barriers; the sort keys and commit flags sit in shared
// memory (in a global scratch the wrapper allocates when C is too large),
// the per-broker int64 sums in a global scratch the kernel zeroes itself.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_step;

constexpr int THREADS = 1024;
constexpr int NR = 4;              // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int NW_OUT = 2;
constexpr int MAX_COL = 2 * NR + 4;
constexpr int KIND_MOVE = 0, KIND_LEADERSHIP = 1;
constexpr unsigned long long PAD = ~0ull;

struct Rows {
  const uint8_t* acc;          // [C] cohort rows (K4)
  const uint8_t* take_d;       // [C] auction winners (K5)
  const float* win_score_d;    // [C]
  const long long* win_dst_d;  // [C]
  const float* cand_score;     // [C, R]
  int R;
  const int* d0;               // [C]
  const uint8_t* is_move;      // [C]
  const int* cand_p;           // [C]
  const int* cand_s;           // [C]
  const long long* cand_src;   // [C]
};

struct Model {
  int* assignment;             // [P, S]
  int* leader_slot;            // [P]
  uint8_t* must_move;          // [P, S]
  const float* pload;          // [P, W]
  float* load;                 // [B, R]
  float* leader_nwin;          // [B]
  float* pot_nwout;            // [B]
  float* rcount;               // [B]
  float* lcount;               // [B]
  float* cload;                // [B, R] or null
};

// the merged destination of row i (cohort rows take their best one)
__device__ __forceinline__ long long win_dst(const Rows& c, int i) {
  return c.acc[i] ? (long long)c.d0[i] : c.win_dst_d[i];
}

// row i's gated aggregate contributions, in column order: load [R],
// leader NW-in, potential NW-out, replica count, leader count, capacity
// load [R] (with percentile capacity loads)
__device__ void contributions(const Rows& c, const Model& m, int i, int W,
                              bool taken, float* v) {
  const int p = c.cand_p[i];
  const bool is_move = c.is_move[i] != 0;
  const bool leader_now = m.leader_slot[p] == c.cand_s[i];
  const bool mv_follower = is_move && !leader_now;
  const float gate = taken ? 1.0f : 0.0f;
  const float* pl = m.pload + (size_t)p * W;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float lead = pl[r], fol = pl[NR + r];
    v[r] = (is_move ? (leader_now ? lead : fol) : lead - fol) * gate;
  }
  v[NR] = (mv_follower ? 0.0f : pl[NW_IN]) * gate;
  v[NR + 1] = (is_move ? pl[NW_OUT] : 0.0f) * gate;
  v[NR + 2] = (is_move ? 1.0f : 0.0f) * gate;
  v[NR + 3] = (mv_follower ? 0.0f : 1.0f) * gate;
  if (m.cload != nullptr) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float leadc = pl[2 * NR + 1 + r], folc = pl[3 * NR + 1 + r];
      v[NR + 4 + r] =
          (is_move ? (leader_now ? leadc : folc) : leadc - folc) * gate;
    }
  }
}

__device__ __forceinline__ float* column(const Model& m, int b, int col) {
  if (col < NR) return m.load + (size_t)b * NR + col;
  if (col == NR) return m.leader_nwin + b;
  if (col == NR + 1) return m.pot_nwout + b;
  if (col == NR + 2) return m.rcount + b;
  if (col == NR + 3) return m.lcount + b;
  return m.cload + (size_t)b * NR + (col - NR - 4);
}

struct Loop {
  int* state;                  // [NSTATE] the step loop's carry
  int* counts;                 // [4, T] commits and diagnostics a step
  const uint8_t* improving;    // [C] rows that improve (K7)
  int T;                       // steps a call
  int repool;                  // repool_steps
  int slot_limit;              // the slot budget less one step's commits
};

__global__ void __launch_bounds__(THREADS)
commit_batch_kernel(Rows c, Model m, int C, int n2, int M_step, int B,
                    int S, int W, float* __restrict__ out, int slots,
                    Loop lp, uint8_t* __restrict__ tpp,
                    long long* __restrict__ sums, int* __restrict__ c_step,
                    void* gws) {
  extern __shared__ unsigned long long sws[];
  unsigned long long* key = gws ? (unsigned long long*)gws : sws;  // [n2]
  uint8_t* take_f = (uint8_t*)(key + n2);                          // [C]
  __shared__ unsigned colmax[MAX_COL];
  __shared__ double scale[MAX_COL];
  __shared__ int s_count, s_improving, s_cohort, s_auction;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ncol = m.cload != nullptr ? MAX_COL : NR + 4;
  if (!lp.state[cc_state::ACTIVE]) {
    if (tid == 0) *c_step = 0;
    return;
  }
  const int count = lp.state[cc_state::COUNT];

  // ---- merge the cohort and the auction; key the merged scores ----------
  for (int x = tid; x < B * ncol; x += nt) sums[x] = 0;
  for (int x = tid; x < n2; x += nt) {
    unsigned long long k = PAD;
    if (x < C) {
      const bool take = c.acc[x] || c.take_d[x];
      const float ws = c.acc[x] ? c.cand_score[(size_t)x * c.R]
                                : c.win_score_d[x];
      k = ((unsigned long long)ord32(take ? ws : INFINITY) << 32) |
          (unsigned)x;
      take_f[x] = 0;
    }
    key[x] = k;
  }
  if (tid < MAX_COL) colmax[tid] = 0u;
  if (tid == 0) {
    s_count = 0;
    s_improving = 0;
    s_cohort = 0;
    s_auction = 0;
  }
  __syncthreads();
  // the step's diagnostics (the reference's meta rows 1-3)
  for (int x = tid; x < C; x += nt) {
    if (lp.improving[x]) atomicAdd(&s_improving, 1);
    if (c.acc[x]) {
      atomicAdd(&s_cohort, 1);
    } else if (c.take_d[x]) {
      atomicAdd(&s_auction, 1);
    }
  }

  // ---- the M best in score order: output rows, commit flags, count ------
  bitonic_sort(key, n2);
  for (int k = tid; k < M_step; k += nt) {
    const int i = (int)(key[k] & 0xffffffffu);
    const bool ok = isfinite(from_ord32((unsigned)(key[k] >> 32)));
    take_f[i] = ok ? 1 : 0;
    if (ok) atomicAdd(&s_count, 1);
    float* o = out + count + k;
    o[0] = c.is_move[i] ? (float)KIND_MOVE : (float)KIND_LEADERSHIP;
    o[slots] = (float)c.cand_p[i];
    o[2 * slots] = (float)c.cand_s[i];
    o[3 * slots] = (float)win_dst(c, i);
  }
  __syncthreads();

  // ---- exact column maxima of the gated contributions -------------------
  for (int i = tid; i < C; i += nt) {
    const bool taken = take_f[i] != 0;
    if (taken) tpp[max(c.cand_p[i], 0)] = 1;
    float v[MAX_COL];
    contributions(c, m, i, W, taken, v);
    for (int col = 0; col < ncol; ++col) {
      atomicMax(&colmax[col], __float_as_uint(fabsf(v[col])));
    }
  }
  __syncthreads();
  if (tid < ncol) scale[tid] = fixed_scale(__uint_as_float(colmax[tid]), 2 * C);
  __syncthreads();

  // ---- the ± segment sums over source and destination brokers -----------
  for (int i = tid; i < C; i += nt) {
    if (!take_f[i]) continue;
    float v[MAX_COL];
    contributions(c, m, i, W, true, v);
    const long long src = max(c.cand_src[i], 0ll);
    const long long dst = max(win_dst(c, i), 0ll);
    for (int col = 0; col < ncol; ++col) {
      const long long q = __double2ll_rn((double)v[col] * scale[col]);
      atomicAdd((unsigned long long*)&sums[src * ncol + col],
                (unsigned long long)(-q));
      atomicAdd((unsigned long long*)&sums[dst * ncol + col],
                (unsigned long long)q);
    }
  }
  __syncthreads();

  // ---- aggregates += sums (every broker, as the plain twin adds) --------
  for (int x = tid; x < B * ncol; x += nt) {
    const int b = x / ncol, col = x % ncol;
    float* a = column(m, b, col);
    *a = *a + __double2float_rn((double)sums[x] / scale[col]);
  }
  // ---- placement: the committed moves and leadership transfers ----------
  for (int i = tid; i < C; i += nt) {
    if (!take_f[i]) continue;
    const int p = c.cand_p[i], s = c.cand_s[i];
    if (c.is_move[i]) {
      m.assignment[(size_t)p * S + s] = (int)win_dst(c, i);
      m.must_move[(size_t)p * S + s] = 0;
    } else {
      m.leader_slot[p] = s;
    }
  }
  if (tid == 0) {
    // ---- the loop's carry: meta, done, since_pool, count, t, next step -
    using namespace cc_state;
    int* st = lp.state;
    const int cs = s_count, t = st[STEP];
    *c_step = cs;
    lp.counts[t] = cs;
    lp.counts[lp.T + t] = s_improving;
    lp.counts[2 * lp.T + t] = s_cohort;
    lp.counts[3 * lp.T + t] = s_auction;
    const int done = st[DONE] | (cs == 0 && st[SINCE_POOL] == 0 ? 1 : 0);
    const int since = cs == 0 ? lp.repool : st[SINCE_POOL] + 1;
    const int total = count + cs;
    st[DONE] = done;
    st[SINCE_POOL] = since;
    st[COUNT] = total;
    st[STEP] = t + 1;
    st[ACTIVE] = !done && t + 1 < lp.T && total <= lp.slot_limit ? 1 : 0;
    st[NEED_POOL] = since >= lp.repool ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Bytes of the sort keys and commit flags for C rows: shared memory when
// they fit, else the wrapper passes a device scratch as `gws`.
long long commit_batch_workspace_bytes(int C) {
  long long n2 = 1;
  while (n2 < C) n2 <<= 1;
  return n2 * 8 + C;
}

// Launches K8 on `stream` (one block); `sums` is a [B, ncol] int64 scratch.
// `state` is the step loop's carry (the write offset is its count),
// `counts` its [4, T] meta; `slot_limit + M_step <= slots` keeps every
// active step's rows inside `out`.  Returns the CUDA error code.
int commit_batch_launch(const uint8_t* acc, const uint8_t* take_d,
                        const float* win_score_d, const long long* win_dst_d,
                        const float* cand_score, int R, const int* d0,
                        const uint8_t* is_move, const int* cand_p,
                        const int* cand_s, const long long* cand_src, int C,
                        int n2, int M_step, int* assignment, int* leader_slot,
                        uint8_t* must_move, const float* pload, float* load,
                        float* leader_nwin, float* pot_nwout, float* rcount,
                        float* lcount, float* cload, int B, int S, int W,
                        float* out, int slots, int* state, int* counts,
                        const uint8_t* improving, int T, int repool,
                        int slot_limit, uint8_t* tpp, long long* sums,
                        int* c_step, void* gws, void* stream) {
  if (C < 1 || R < 1 || n2 < C || (n2 & (n2 - 1)) != 0 || M_step < 0 ||
      M_step > C || B < 1 || S < 1 || T < 1 || repool < 1 ||
      slot_limit < 0 || slot_limit + M_step > slots ||
      W != (cload != nullptr ? 4 * NR + 1 : 2 * NR + 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Rows c{acc, take_d, win_score_d, win_dst_d, cand_score, R, d0, is_move,
         cand_p, cand_s, cand_src};
  Model m{assignment, leader_slot, must_move, pload, load, leader_nwin,
          pot_nwout, rcount, lcount, cload};
  Loop lp{state, counts, improving, T, repool, slot_limit};
  const int smem = gws == nullptr ? (int)commit_batch_workspace_bytes(C) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      commit_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  commit_batch_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      c, m, C, n2, M_step, B, S, W, out, slots, lp, tpp, sums, c_step, gws);
  return (int)cudaGetLastError();
}

}  // extern "C"
