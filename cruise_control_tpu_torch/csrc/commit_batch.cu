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
// `active` (`t < min(T, t_cap)`: the call's step cap rides the carry) and
// `need_pool`.  So a captured chunk of steps runs without a host read:
// steps past the end of the search do nothing.
//
// The incremental rescore's marks (`incremental_rescore=True`; :1380-1388).
// Given `tb` [B], `tpm` [P] and `marks` [3, M], an active step marks the
// source and destination brokers (`tb`) and the partitions (`tpm`) of its
// commits, for the next step's stale sets (K16) and patch (K17).  The
// marks hold this step's commits only: this kernel first clears the ones
// the step before set, read back from the lists it kept in `marks`
// (partition, source, destination of each of its M commit slots, -1 where
// none), so no step clears a [P] table.  An inactive step marks and clears
// nothing; the step loop resets the tables and lists once a call.
//
// Exactness.  The plain twin (analyzer/commit_kernels.py:
// _apply_batch_on_device) sums through ops/segment.py: each column of
// cat([-contrib, contrib]) is scaled by 2^(60 - e), e = frexp-exponent of
// the column's exact max |v| over all 2C rows (rows of uncommitted actions
// are gated to zero and count) plus ceil(log2 2C), rounded half to even
// to int64, summed, and scaled back once; the f32 result is then added to
// the stored f32 aggregate.  The kernel does the same operations: integer
// atomics are exact and order free, so the result equals the plain twin's
// bit for bit.  A broker no commit touches gets `a + 0.0f`, which changes
// a -0.0 into +0.0 and nothing else: the kernel reads every aggregate and
// writes the ones that change.  An uncommitted row still reaches the
// column maxima (its load times 0 is ±0, or NaN from a non-finite load),
// so every row's load row is read.  The commit order uses the 64-bit key
// (order-preserving score bits, row), so -0.0 and +0.0 tie and ties go to
// the lowest row, as in the stable sort.
//
// What bounds it.  It reads the C candidate rows (~40 B each) and their
// partitions' load rows, every broker aggregate, and writes the touched
// brokers' aggregates, the output rows and the committed actions'
// placement entries: ~0.1 MB at C = 1 024, B = 1 000 — bound by bytes
// (~0.04 us at 3.35 TB/s).  Its real limit is its chain of dependent
// phases on one SM.  The first design took 25 us on an H100 at
// 1000b/20k: a bitonic sort of all C keys (55 barrier stages at C =
// 1 024), 8-12 contended shared atomicMax a row for the column maxima,
// and every broker's int64 sums zeroed, read and divided each step.
//
// What the design does about it.  One block of 1 024 threads.  Only the
// rows with a merged score below +inf need ordering — the taken rows, a
// few dozen a step — and the rows keyed +inf follow them in row order, so
// a block count compacts the first into a short list (sorted on
// block_sort.cuh: warp sorts in registers, a merge level a barrier) and
// the second into a row list; a position reads its row from one or the
// other.  The column maxima reduce in each warp (`__reduce_max_sync`)
// before one shared atomicMax a warp and column, and the step's counts
// likewise.  The sums touch only the commits' brokers: the first commit
// to mark a broker in a shared bitmap zeroes its int64 sums, then every
// commit adds its fixed-point contributions with global atomics; the last
// pass adds each marked broker's sums (scaled back by the power-of-two
// scale's exact inverse) and only renormalises the others, a thread's
// loads of two brokers issued before its stores.  The keys, row list,
// commit flags and bitmap sit in shared memory (22 KB at C = 1 024, B =
// 1 000), or in a global scratch the wrapper allocates when they do not
// fit.  What did not pay (PERF.md §6): sums in shared memory
// (slower 64-bit atomics at a few dozen commits), the column maxima folded
// into other phases, L1 prefetches, eight lanes a row — every row's load
// row is read through one SM's L1, ~3.5 us wherever it goes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sort.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_step;
using cc_sort::u64;

constexpr int THREADS = 1024;
constexpr int NR = 4;              // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int NW_OUT = 2;
constexpr int MAX_COL = 2 * NR + 4;
constexpr int KIND_MOVE = 0, KIND_LEADERSHIP = 1;
constexpr u64 PAD = ~0ull;
constexpr unsigned FULL = 0xffffffffu;

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

// broker b's aggregate in column `col` (a constant once unrolled)
__device__ __forceinline__ float* agg(const Model& m, int b, int col) {
  if (col < NR) return m.load + (size_t)b * NR + col;
  if (col == NR) return m.leader_nwin + b;
  if (col == NR + 1) return m.pot_nwout + b;
  if (col == NR + 2) return m.rcount + b;
  if (col == NR + 3) return m.lcount + b;
  return m.cload + (size_t)b * NR + (col - NR - 4);
}

struct Marks {
  uint8_t* tb;                 // [B] brokers this step's commits touched
  uint8_t* tpm;                // [P] partitions they moved
  int* list;                   // [3, M]: partition, source, destination
};

struct Loop {
  int* state;                  // [NSTATE] the step loop's carry
  int* counts;                 // [4, T] commits and diagnostics a step
  const uint8_t* improving;    // [C] rows that improve (K7)
  int T;                       // steps a call
  int repool;                  // repool_steps
  int slot_limit;              // the slot budget less one step's commits
};

// Shared memory a block's workspace may take (the rest of the 227 KB
// holds its static arrays)
constexpr long long SMEM_MAX = 232448 - 1024;

// the workspace's layout for C rows over B brokers: the keys and the
// sort's second buffer (n2 each, n2 a power of two >= max(C, 32)), the
// +inf rows' list [C], the touched brokers' bitmap and the commit flags
struct Layout {
  long long n2, tmp, grow, bits, take, bytes;
};

__host__ __device__ inline Layout layout(int C, int B) {
  Layout l;
  l.n2 = 32;
  while (l.n2 < C) l.n2 <<= 1;
  l.tmp = 8 * l.n2;
  l.grow = 16 * l.n2;
  l.bits = l.grow + 4ll * C;
  l.take = l.bits + 4ll * ((B + 31) / 32);
  l.bytes = l.take + C;
  return l;
}

__global__ void __launch_bounds__(THREADS)
commit_batch_kernel(Rows c, Model m, int C, int M_step, int B, int S,
                    int W, float* __restrict__ out, int slots, Loop lp,
                    uint8_t* __restrict__ tpp, Marks mk,
                    long long* __restrict__ sums, int* __restrict__ c_step,
                    void* gws) {
  extern __shared__ u64 sws[];
  const Layout ly = layout(C, B);
  unsigned char* ws = gws ? (unsigned char*)gws : (unsigned char*)sws;
  u64* key = (u64*)ws;                             // [n2]
  u64* tmp = (u64*)(ws + ly.tmp);                  // [n2]
  int* grow = (int*)(ws + ly.grow);                // [C]
  unsigned* bits = (unsigned*)(ws + ly.bits);      // [(B + 31) / 32]
  uint8_t* take_f = ws + ly.take;                  // [C]
  __shared__ unsigned colmax[MAX_COL];
  __shared__ double scale[MAX_COL], inv[MAX_COL];
  __shared__ float scf[MAX_COL];
  __shared__ int warp_tot[THREADS / 32];
  // the step's commits, improving rows, cohort rows, auction rows, and
  // the keys below +inf
  __shared__ int s_cnt[5];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int ncol = m.cload != nullptr ? MAX_COL : NR + 4;
  if (!lp.state[cc_state::ACTIVE]) {
    if (tid == 0) *c_step = 0;
    return;
  }
  const int count = lp.state[cc_state::COUNT];
  CC_STAMP(0);

  // ---- the step before's marks cleared (its lists; -1 = no commit) ------
  if (mk.tb != nullptr) {
    for (int k = tid; k < M_step; k += nt) {
      const int p = mk.list[k];
      if (p < 0) continue;
      mk.tpm[p] = 0;
      mk.tb[mk.list[M_step + k]] = 0;
      mk.tb[mk.list[2 * M_step + k]] = 0;
    }
  }
  for (int x = tid; x < (B + 31) / 32; x += nt) bits[x] = 0u;
  if (tid < MAX_COL) colmax[tid] = 0u;
  if (tid < 5) s_cnt[tid] = 0;

  // ---- merge the cohort and the auction: the rows keyed below or above
  // +inf to the key list, the rows keyed +inf to the row list, each in
  // row order; the step's diagnostics (the reference's meta rows 1-3) ----
  const unsigned kinf = ord32(INFINITY);
  int n_f = 0;                           // keys listed so far
  for (int c0 = 0; c0 < C; c0 += nt) {   // every thread, chunk by chunk
    const int i = c0 + tid;
    unsigned ku = kinf;
    int imp = 0, coh = 0, auc = 0;
    if (i < C) {
      const bool a = c.acc[i] != 0, d = c.take_d[i] != 0;
      ku = ord32(a || d ? (a ? c.cand_score[(size_t)i * c.R]
                             : c.win_score_d[i])
                        : INFINITY);
      take_f[i] = 0;
      imp = lp.improving[i] != 0;
      coh = a;
      auc = !a && d;
    }
    const int less = __reduce_add_sync(FULL, (int)(ku < kinf));
    imp = __reduce_add_sync(FULL, imp);
    coh = __reduce_add_sync(FULL, coh);
    auc = __reduce_add_sync(FULL, auc);
    int tot;
    const bool listed = ku != kinf;
    // (its barriers also order the counters' zeroing before the adds)
    const int before = n_f + block_count_before(listed, warp_tot, &tot);
    if (lane == 0) {
      if (imp) atomicAdd(&s_cnt[1], imp);
      if (coh) atomicAdd(&s_cnt[2], coh);
      if (auc) atomicAdd(&s_cnt[3], auc);
      if (less) atomicAdd(&s_cnt[4], less);
    }
    if (i < C) {
      if (listed) {
        key[before] = ((u64)ku << 32) | (unsigned)i;
      } else {
        grow[i - before] = i;
      }
    }
    n_f += tot;
  }
  int n2f = 32;
  while (n2f < n_f) n2f <<= 1;
  for (int x = n_f + tid; x < n2f; x += nt) key[x] = PAD;
  __syncthreads();
  CC_STAMP(1);

  // ---- the listed keys in order: the rows keyed below +inf, then (after
  // the +inf rows) the ones above ----------------------------------------
  const u64* sorted = cc_sort::block_sort(key, tmp, n2f, n2f);
  CC_STAMP(2);

  // ---- the M best in score order: output rows, commit flags, the
  // commits' brokers (their sums zeroed, their bits set) and marks -------
  const int n_less = s_cnt[4], n_inf = C - n_f;
  int n_ok = 0;
  for (int k = tid; k < M_step; k += nt) {
    int i;
    bool ok = false;
    if (k >= n_less && k < n_less + n_inf) {
      i = grow[k - n_less];
    } else {
      const u64 kk = sorted[k < n_less ? k : k - n_inf];
      i = (int)(kk & 0xffffffffu);
      ok = isfinite(from_ord32((unsigned)(kk >> 32)));
    }
    take_f[i] = ok ? 1 : 0;
    n_ok += ok;
    const int sb = (int)max(c.cand_src[i], 0ll);
    const int db = (int)max(win_dst(c, i), 0ll);
    if (ok) {
      tpp[max(c.cand_p[i], 0)] = 1;
      // the first commit to touch a broker zeroes its sums
      const unsigned ms = 1u << (sb & 31), md = 1u << (db & 31);
      if (!(atomicOr(&bits[sb >> 5], ms) & ms)) {
        for (int col = 0; col < ncol; ++col) sums[(size_t)sb * ncol + col] = 0;
      }
      if (!(atomicOr(&bits[db >> 5], md) & md)) {
        for (int col = 0; col < ncol; ++col) sums[(size_t)db * ncol + col] = 0;
      }
    }
    if (mk.tb != nullptr) {
      // this step's marks (cleared above, a barrier before) and its lists
      const int p = ok ? max(c.cand_p[i], 0) : -1;
      mk.list[k] = p;
      mk.list[M_step + k] = sb;
      mk.list[2 * M_step + k] = db;
      if (ok) {
        mk.tpm[p] = 1;
        mk.tb[sb] = 1;
        mk.tb[db] = 1;
      }
    }
    float* o = out + count + k;
    o[0] = c.is_move[i] ? (float)KIND_MOVE : (float)KIND_LEADERSHIP;
    o[slots] = (float)c.cand_p[i];
    o[2 * slots] = (float)c.cand_s[i];
    o[3 * slots] = (float)win_dst(c, i);
  }
  n_ok = __reduce_add_sync(FULL, n_ok);
  if (lane == 0 && n_ok) atomicAdd(&s_cnt[0], n_ok);
  __syncthreads();
  CC_STAMP(3);

  // ---- exact column maxima of the gated contributions: each warp's
  // maximum, then one shared atomic a warp and column --------------------
  for (int c0 = 0; c0 < C; c0 += nt) {
    const int i = c0 + tid;
    float v[MAX_COL];
#pragma unroll
    for (int col = 0; col < MAX_COL; ++col) v[col] = 0.0f;
    if (i < C) contributions(c, m, i, W, take_f[i] != 0, v);
#pragma unroll
    for (int col = 0; col < MAX_COL; ++col) {
      if (col >= ncol) break;
      const unsigned r =
          __reduce_max_sync(FULL, __float_as_uint(fabsf(v[col])));
      if (lane == 0 && r != 0u) atomicMax(&colmax[col], r);
    }
  }
  __syncthreads();
  if (tid < ncol) {
    const double sc = fixed_scale(__uint_as_float(colmax[tid]), 2 * C);
    scale[tid] = sc;
    inv[tid] = 1.0 / sc;               // exact: sc is a power of two
    scf[tid] = fixed_scale_f(sc);
  }
  __syncthreads();
  CC_STAMP(4);

  // ---- the ± segment sums over the commits' brokers ---------------------
  for (int i = tid; i < C; i += nt) {
    if (!take_f[i]) continue;
    float v[MAX_COL];
    contributions(c, m, i, W, true, v);
    const long long src = max(c.cand_src[i], 0ll);
    const long long dst = max(win_dst(c, i), 0ll);
    for (int col = 0; col < ncol; ++col) {
      const long long q = fixed_q(v[col], scf[col], scale[col]);
      atomicAdd((unsigned long long*)&sums[src * ncol + col],
                (unsigned long long)(-q));
      atomicAdd((unsigned long long*)&sums[dst * ncol + col],
                (unsigned long long)q);
    }
  }
  __syncthreads();
  CC_STAMP(5);

  // ---- aggregates += sums: a touched broker adds its sums (scaled back
  // by the exact inverse of the column's power-of-two scale), every other
  // adds 0.0f, as the plain twin adds a zero sum to it; stored only where
  // the bits change.  Two brokers a thread at a time, every load issued
  // before the stores --------------------------------------------------
  for (int b0 = tid; b0 < B; b0 += 2 * nt) {
    float old[2][MAX_COL];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + h * nt;
#pragma unroll
      for (int col = 0; col < MAX_COL; ++col) {
        old[h][col] = (b < B && col < ncol) ? *agg(m, b, col) : 0.0f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + h * nt;
      if (b >= B) continue;
      const bool t = (bits[b >> 5] >> (b & 31)) & 1u;
#pragma unroll
      for (int col = 0; col < MAX_COL; ++col) {
        if (col >= ncol) continue;
        const float add =
            t ? __double2float_rn((double)sums[(size_t)b * ncol + col] *
                                  inv[col])
              : 0.0f;
        const float now = old[h][col] + add;
        if (__float_as_uint(now) != __float_as_uint(old[h][col])) {
          *agg(m, b, col) = now;
        }
      }
    }
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
    const int cs = s_cnt[0], t = st[STEP];
    *c_step = cs;
    lp.counts[t] = cs;
    lp.counts[lp.T + t] = s_cnt[1];
    lp.counts[2 * lp.T + t] = s_cnt[2];
    lp.counts[3 * lp.T + t] = s_cnt[3];
    const int done = st[DONE] | (cs == 0 && st[SINCE_POOL] == 0 ? 1 : 0);
    const int since = cs == 0 ? lp.repool : st[SINCE_POOL] + 1;
    const int total = count + cs;
    st[DONE] = done;
    st[SINCE_POOL] = since;
    st[COUNT] = total;
    st[STEP] = t + 1;
    const int t_end = min(lp.T, st[T_CAP]);
    st[ACTIVE] = !done && t + 1 < t_end && total <= lp.slot_limit ? 1 : 0;
    st[NEED_POOL] = since >= lp.repool ? 1 : 0;
  }
  CC_STAMP_SYNC(6);
}

}  // namespace

extern "C" {

// Bytes of device scratch the wrapper passes as `gws` for C rows over B
// brokers: 0 where the workspace (the keys and the sort's second buffer,
// the +inf rows' list, the touched brokers' bitmap, the commit flags) fits
// in shared memory.
long long commit_batch_scratch_bytes(int C, int B) {
  const long long bytes = layout(C, B).bytes;
  return bytes <= SMEM_MAX ? 0 : bytes;
}

// Launches K8 on `stream` (one block); `sums` is a [B, ncol] int64 scratch
// (the kernel zeroes the touched brokers' rows itself).  `state` is the
// step loop's carry (the write offset is its count), `counts` its [4, T]
// meta; `slot_limit + M_step <= slots` keeps every active step's rows
// inside `out`.  `tb`, `tpm` and `marks` ([3, M_step] int32) are the
// incremental rescore's marks, all given or all null.  `gws` is null or
// commit_batch_scratch_bytes(C, B) of device scratch.  Returns the CUDA
// error code.
int commit_batch_launch(const uint8_t* acc, const uint8_t* take_d,
                        const float* win_score_d, const long long* win_dst_d,
                        const float* cand_score, int R, const int* d0,
                        const uint8_t* is_move, const int* cand_p,
                        const int* cand_s, const long long* cand_src, int C,
                        int M_step, int* assignment, int* leader_slot,
                        uint8_t* must_move, const float* pload, float* load,
                        float* leader_nwin, float* pot_nwout, float* rcount,
                        float* lcount, float* cload, int B, int S, int W,
                        float* out, int slots, int* state, int* counts,
                        const uint8_t* improving, int T, int repool,
                        int slot_limit, uint8_t* tpp, uint8_t* tb,
                        uint8_t* tpm, int* marks, long long* sums,
                        int* c_step, void* gws, void* stream) {
  if (C < 1 || R < 1 || M_step < 0 || M_step > C || B < 1 || S < 1 ||
      T < 1 || repool < 1 ||
      slot_limit < 0 || slot_limit + M_step > slots ||
      (tb == nullptr) != (tpm == nullptr) ||
      (tb == nullptr) != (marks == nullptr) ||
      W != (cload != nullptr ? 4 * NR + 1 : 2 * NR + 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Rows c{acc, take_d, win_score_d, win_dst_d, cand_score, R, d0, is_move,
         cand_p, cand_s, cand_src};
  Model m{assignment, leader_slot, must_move, pload, load, leader_nwin,
          pot_nwout, rcount, lcount, cload};
  Loop lp{state, counts, improving, T, repool, slot_limit};
  Marks mk{tb, tpm, marks};
  const long long bytes = layout(C, B).bytes;
  if (gws == nullptr && bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int smem = gws == nullptr ? (int)bytes : 0;
  cudaError_t e = cudaFuncSetAttribute(
      commit_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  commit_batch_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      c, m, C, M_step, B, S, W, out, slots, lp, tpp, mk, sums, c_step, gws);
  return (int)cudaGetLastError();
}

}  // extern "C"
