// K3 — per-source-broker reductions of a step, for Hopper (sm_90a).
//
// What it replaces.  cruise_control_tpu/analyzer/tpu_optimizer.py:2357
// `_reduce_leadership_per_src` (the best leadership transfer per current
// leader broker over the L leadership candidates: a scatter-min of the
// score, then a scatter-min of the lowest row that reaches it) and :2381
// `_topq_rows_per_src` (Q sequential passes of the same pair of
// scatter-mins over the K move rows' best scores, each knocking its chosen
// rows out for the next), with the two gathers the step makes for them
// (:1162, :1181): each row's source broker, the broker in its slot, and its
// best score, the row's top destination term re-added to its source term.
// XLA runs them as a dozen fused scatters.
//
// How ties and order come out right.  The q-th pass of the reference picks
// each broker's q-th finite row in (score, row) order, so the Q picks of a
// broker are the Q smallest of its rows' keys (ord32(score), row): ord32
// maps an f32 to an unsigned int in the float order, -0.0 keyed as +0.0
// (the zeros tie, as under `<=`), so ties fall to the lowest row as the
// scatter-min of the row index does.  A key is 64 bits: ord32(score) << 32
// | row << 1 | whether the score is -0.0, the last bit never deciding an
// order (rows differ above it) but keeping each zero's sign.  The score
// the reference writes for a pick is its scatter-min over the broker's
// rows still in play, -0.0 below +0.0: so a pick that scores a zero is
// written -0.0 when its own row or any later row of the broker's zero run
// holds -0.0 (a suffix OR over the run: the run's last -0.0 row, looked
// for once a broker, only when one of its picks scores a zero, and only
// in the kernel's incremental form: the default form's row scores are
// never -0.0), as the plain twin (analyzer/step_kernels.py:
// per_src_top_plain) writes it.  The row scores are made with
// __fadd_rn / __fsub_rn, torch's rounding, so `row_best` is the plain
// inputs' to the bit.  The leadership keys are (ord32(score), candidate)
// and its pick a 64-bit min: the same in any order.
//
// What bounds it.  It reads each of the L candidates' lp, score, leader
// slot and leader's placement word (16 B) and each of the K rows' 8-byte
// slot, one placement word, source term and top destination term (20 B),
// writes each row's broker (4 B), reads each broker's winning
// candidate's lsl and destination word and writes its transfer (24 B),
// and writes Q·8 B per broker: ~0.38 MB at L = K = 8 192, B = 1 000,
// Q = 4 — bound by bytes (~0.11 us at 3.35 TB/s).  Its real limits are
// latency and one SM's share of the card: the gathers touch a 32-byte
// sector for each 4-byte word (a row three, a candidate two: ~1.4 MB of
// sectors), and the step's rows and candidates cluster by broker — about
// half of a warp's 32 consecutive rows share one — so per-broker atomics
// collide.  Done in one block it took 29-30 us on an H100, as 1 + Q
// passes of shared atomicMins and as a counting sort alike: the rows'
// loads and counts alone 10.7 us through one SM's L2 port, a
// thread-a-broker pick 12-16 (phase stamps, PERF.md §6).
//
// What the design does about it.  One cooperative launch of G blocks
// (one a 1 024 rows and candidates, at most one an SM).  Phase A, every
// block: each thread gathers one row (its slot, placement word, source
// and destination terms: broker, key, `sb` and `row_best` out) or one
// candidate (its leader's broker), so the gathers spread over G SMs, and
// writes them in order to a scratch.  One grid barrier.  Phase B, every
// block again, each on a contiguous range of brokers, reading the whole
// compact, L2-resident scratch and keeping its range's items: the first
// G/2 blocks the rows — a counting sort by broker in shared memory
// (counts, one block scan, a scatter), then each broker's Q smallest keys
// in one pass over its segment (a thread a broker, the keys in a sorted
// register list; a warp a broker of more than WIDE rows, its lanes' lists
// merged by warp minima) — the other blocks the leadership: each leader
// broker's smallest key, then its transfer written out.  So no SM does
// more than its range's share of the per-broker work.  The shared atomics
// go by runs: lanes whose broker equals their left neighbour's join its
// run, and the run's head makes the one atomic (a count, a reservation of
// places, or a minimum after a segmented shuffle reduction).  Keys and
// counts live in shared memory where a block's fit (at K = 8 192 always),
// else in the global scratch (B up to MAX_B).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cc_step;
typedef unsigned long long u64;

constexpr int THREADS = 1024;
constexpr int CH = 8;            // items a thread loads at once in phase B
constexpr int WIDE = 16;         // a broker of more rows is picked by a warp
constexpr int MAX_B = 50000;     // brokers K3 takes: a rows block's counts
                                 // stay in shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 NONE = ~0ull;

struct Args {
  const long long* slot;         // [K] flat (partition · S + slot)
  const float* src_term;         // [K], stride lds
  int lds;
  const float* vals;             // [K, R]: column 0 read
  int R;
  int dest_terms;                // vals holds score - src_term
  int K;
  const int* lp;                 // [L]
  const int* lsl;                // [L]
  const float* ls;               // [L]
  int L;
  const int* assignment;         // [P, S]
  const int* leader_slot;        // [P]
  int S, B, Q;
  float* bl_score;               // [B]
  int* bl_p;
  int* bl_s;
  int* bl_dst;
  int* rows;                     // [Q, B]
  float* scores;                 // [Q, B]
  int* sb;                       // [K] out
  float* row_best;               // [K] out, or null
  u64* gkey;                     // [K] scratch: the rows' keys in row order
  int* glb;                      // [L] scratch: the candidates' brokers
  u64* rkey;                     // [Gr, K] the rows' keys by broker, or null
  u64* lkey;                     // [Gl, Rl] the leadership keys, or null
  int Gr, Rr;                    // blocks taking the rows, brokers each
  int Rl;                        // brokers a leadership block takes
};

// The most brokers of R with more than WIDE of K rows
__host__ __device__ inline int max_wide(int K, int R) {
  const int w = K / (WIDE + 1) + 1;
  return w < R ? w : R;
}

// Shared bytes of a rows block (the counts of its R brokers and its wide
// brokers, and with `keys` the keys by broker after them, 8-aligned) and
// of a leadership block (the keys of its R brokers)
__host__ __device__ inline long long rows_counts_bytes(int K, int R) {
  return (4LL * (R + 1) + 4LL * max_wide(K, R) + 7) / 8 * 8;
}
__host__ __device__ inline long long rows_smem(int K, int R, bool keys) {
  return rows_counts_bytes(K, R) + (keys ? 8LL * K : 0);
}
__host__ __device__ inline long long lead_smem(int R) { return 8LL * R; }

__device__ __forceinline__ u64 lead_key(float x, int i) {
  return ((u64)ord32(x) << 32) | (unsigned int)i;
}

// A row's key: (ord32(score), row) with the sign of a zero score below
__device__ __forceinline__ u64 row_key(float x, int i) {
  const unsigned int nz = __float_as_uint(x) == 0x80000000u ? 1u : 0u;
  return ((u64)ord32(x) << 32) | ((unsigned int)i << 1) | nz;
}

constexpr unsigned int ZERO_ORD = 0x80000000u;  // ord32(±0.0)

// Whether the pick k needs the broker's other rows to know its sign: it
// scores a zero and its own row holds +0.0
__device__ __forceinline__ bool zero_pick(u64 k) {
  return k != NONE && (unsigned int)(k >> 32) == ZERO_ORD && !(k & 1);
}

// The largest row among key[lo], key[lo + step], ... (below hi) whose
// score is -0.0, or -1: a zero pick of a lower row is written -0.0 (that
// row is still in play).  Out of line: only a broker with a zero pick
// calls it, once.
__device__ __noinline__ int last_neg_zero(const u64* key, int lo, int hi,
                                          int step) {
  int row = -1;
  for (int j = lo; j < hi; j += step) {
    const u64 x = key[j];
    if ((unsigned int)(x >> 32) == ZERO_ORD && (x & 1)) {
      row = max(row, (int)((unsigned int)x >> 1));
    }
  }
  return row;
}

// The picked key k as the q-th row and score of broker b.  The reference
// writes the minimum of the broker's rows still in play: -0.0 when the
// pick scores a zero and its own row or a later row of the broker's zero
// run holds -0.0 (`neg`, looked for only for a zero pick).
__device__ __forceinline__ void put_pick(int* rows, float* scores, int K,
                                         int B, int q, int b, u64 k,
                                         bool neg) {
  const size_t o = (size_t)q * B + b;
  rows[o] = k == NONE ? K : (int)((unsigned int)k >> 1);
  scores[o] = k == NONE ? INFINITY
              : ((k & 1) || neg) ? -0.0f
                                 : from_ord32((unsigned int)(k >> 32));
}

// Runs: the lanes of a warp with `v` whose item's broker b equals their
// left neighbour's continue its run (consecutive rows and candidates
// cluster by broker); every lane of the warp calls these.  → the lane
// heading this lane's run.
__device__ __forceinline__ int run_head(int b, bool v, unsigned* heads) {
  const int lane = threadIdx.x & 31;
  const int pb = __shfl_up_sync(FULL, b, 1);
  const unsigned valid = __ballot_sync(FULL, v);
  const bool head =
      v && (lane == 0 || !((valid >> (lane - 1)) & 1u) || pb != b);
  *heads = __ballot_sync(FULL, head);
  const unsigned upto = lane == 31 ? FULL : (2u << lane) - 1u;
  return 31 - __clz(*heads & upto);
}

// The run's count added to cnt[b] by its head; → this lane's place
// (cnt[b] before the run plus its lanes before this one), -1 without v
__device__ __forceinline__ int run_add(int* cnt, int b, bool v,
                                       bool want) {
  const int lane = threadIdx.x & 31;
  unsigned heads;
  const int h = run_head(b, v, &heads);
  const unsigned valid = __ballot_sync(FULL, v);
  // the run of a head ends at the next head or lane without v
  const unsigned stop = (heads | ~valid) & ~((2u << lane) - 1u);
  const int len = (lane == 31 || stop == 0) ? 32 - lane
                                            : __ffs(stop) - 1 - lane;
  int base = 0;
  if (v && h == lane) {
    if (want) {
      base = atomicAdd(&cnt[b], len);
    } else {
      atomicAdd(&cnt[b], len);
    }
  }
  if (!want) return -1;
  base = __shfl_sync(FULL, base, v ? h : lane);
  return v ? base + lane - h : -1;
}

// The smallest key of each run made one atomicMin by its head
__device__ __forceinline__ void run_min(u64* key, int b, u64 k, bool v) {
  const int lane = threadIdx.x & 31;
  unsigned heads;
  const int h = run_head(b, v, &heads);
  u64 m = v ? k : NONE;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 o = __shfl_down_sync(FULL, m, d);
    const int oh = __shfl_down_sync(FULL, h, d);
    if (lane + d < 32 && oh == h && o < m) m = o;
  }
  if (v && h == lane) atomicMin(&key[b], m);
}

// In-place exclusive prefix sum of v[0, n) by the whole block; `tot` is a
// shared scratch of 32 ints.  Ends on a barrier.
__device__ void block_excl_scan(int* v, int n, int* tot) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = (n + nt - 1) / nt;
  const int lo = min(n, tid * c), hi = min(n, lo + c);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += v[i];
  int incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < (nt >> 5) ? tot[lane] : 0;
    int x = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += u;
    }
    tot[lane] = x - t;
  }
  __syncthreads();
  int run = tot[warp] + incl - s;
  for (int i = lo; i < hi; ++i) {
    const int x = v[i];
    v[i] = run;
    run += x;
  }
  __syncthreads();
}

// Keeps top[0..N) the N smallest keys seen above `last`, ascending
template <int N>
__device__ __forceinline__ void keep(u64 (&top)[N], u64 k, u64 last) {
  if (k > last && k < top[N - 1]) {
#pragma unroll
    for (int s = N - 1; s > 0; --s) {
      top[s] = k < top[s - 1] ? top[s - 1] : (k < top[s] ? k : top[s]);
    }
    top[0] = k < top[0] ? k : top[0];
  }
}

// top[0..N): the N smallest of key[lo], key[lo + step], ... (below hi)
// above `last`, one pass, the loads four at a time
template <int N>
__device__ __forceinline__ void smallest(const u64* key, int lo, int hi,
                                         int step, u64 last, u64 (&top)[N]) {
#pragma unroll
  for (int s = 0; s < N; ++s) top[s] = NONE;
  for (int j = lo; j < hi; j += 4 * step) {
    u64 k[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      k[t] = j + t * step < hi ? key[j + t * step] : NONE;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) keep(top, k[t], last);
  }
}

// The Q smallest keys of each broker b0 + l, l < nb, its segment
// [end[l - 1], end[l]), in passes of N: a thread a broker, a warp (lanes'
// lists merged by warp minima) a broker of more than WIDE rows
template <int N, bool SIGN>
__device__ __forceinline__ void pick(const Args& a, const u64* key,
                                     const int* end, int b0, int nb,
                                     int* wide, int* n_wide) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int l = tid; l < nb; l += nt) {
    const int lo = l ? end[l - 1] : 0, hi = end[l];
    if (hi - lo > WIDE) {
      wide[atomicAdd(n_wide, 1)] = l;
      continue;
    }
    u64 last = 0;
    int zneg = -2;                     // -2: not looked for yet
    for (int q0 = 0; q0 < a.Q; q0 += N) {
      u64 top[N];
      smallest(key, lo, hi, 1, last, top);
#pragma unroll
      for (int t = 0; t < N; ++t) {
        if (q0 + t >= a.Q) continue;
        bool neg = false;
        if (SIGN && zero_pick(top[t])) {
          if (zneg == -2) zneg = last_neg_zero(key, lo, hi, 1);
          neg = (int)((unsigned int)top[t] >> 1) < zneg;
        }
        put_pick(a.rows, a.scores, a.K, a.B, q0 + t, b0 + l, top[t], neg);
      }
      last = top[N - 1];
    }
  }
  __syncthreads();
  for (int w = warp; w < *n_wide; w += nt >> 5) {
    const int l = wide[w];
    const int lo = l ? end[l - 1] : 0, hi = end[l];
    u64 last = 0;
    int zneg = -2;                     // -2: not looked for yet
    for (int q0 = 0; q0 < a.Q; q0 += N) {
      u64 top[N];
      smallest(key, lo + lane, hi, 32, last, top);
      for (int t = 0; t < N; ++t) {
        // the warp's smallest head; its lane (keys are distinct) pops it
        u64 m = top[0];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          const u64 o = __shfl_xor_sync(FULL, m, d);
          m = o < m ? o : m;
        }
        if (m != NONE && top[0] == m) {
#pragma unroll
          for (int s = 0; s < N - 1; ++s) top[s] = top[s + 1];
          top[N - 1] = NONE;
        }
        // (m is the warp's: the branch is the warp's too)
        bool neg = false;
        if (SIGN && zero_pick(m)) {
          if (zneg == -2) {
            zneg = __reduce_max_sync(FULL,
                                     last_neg_zero(key, lo + lane, hi, 32));
          }
          neg = (int)((unsigned int)m >> 1) < zneg;
        }
        if (lane == 0 && q0 + t < a.Q) {
          put_pick(a.rows, a.scores, a.K, a.B, q0 + t, b0 + l, m, neg);
        }
        last = m;
      }
    }
  }
}

// Phase A: row t's broker and key, or candidate t - K's leader broker;
// one item a thread, every block
__device__ __forceinline__ void gather(const Args a) {
  const int n = a.K + a.L;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x) {
    if (t < a.K) {
      const long long sl = a.slot[t];
      const float st = a.src_term[(size_t)t * a.lds];
      const float v0 = a.vals[(size_t)t * a.R];
      const int br = a.assignment[sl];
      const float best = a.dest_terms ? __fadd_rn(st, v0)
                                      : __fadd_rn(st, __fsub_rn(v0, st));
      a.sb[t] = br < 0 ? 0 : br;
      a.gkey[t] = isfinite(best) ? row_key(best, t) : NONE;
      if (a.row_best != nullptr) a.row_best[t] = best;
    } else {
      const int i = t - a.K;
      const int p = a.lp[i];
      const int lb = a.assignment[(size_t)p * a.S + a.leader_slot[p]];
      a.glb[i] = lb < 0 ? 0 : lb;
    }
  }
}

// Phase B, rows block g: the top-Q move rows of each source broker in
// [g·Rr, (g + 1)·Rr), from every gathered key
template <bool SIGNS>
__device__ __forceinline__ void top_rows(const Args a, int g,
                                         unsigned char* smem) {
  __shared__ int tot[32];
  __shared__ int n_wide;
  const int b0 = g * a.Rr;
  const int nb = min(a.B - b0, a.Rr);
  int* end = (int*)smem;                          // [nb + 1]
  int* wide = end + a.Rr + 1;                     // [max_wide(K, Rr)]
  u64* key = a.rkey != nullptr                    // [K]
                 ? a.rkey + (size_t)g * a.K
                 : (u64*)(smem + rows_counts_bytes(a.K, a.Rr));
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l = tid; l <= nb; l += nt) end[l] = 0;
  if (tid == 0) n_wide = 0;
  __syncthreads();
  // ---- count each broker's finite rows
  for (int i0 = 0; i0 < a.K; i0 += nt * CH) {
    u64 k[CH];
    int l[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int i = i0 + j * nt + tid;
      k[j] = i < a.K ? a.gkey[i] : NONE;
      l[j] = (i < a.K ? a.sb[i] : 0) - b0;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      run_add(end, l[j], k[j] != NONE && l[j] >= 0 && l[j] < nb, false);
    }
  }
  __syncthreads();
  if (g == 0) CC_STAMP(3);
  // ---- each broker's segment start; end[nb] is the range's count
  block_excl_scan(end, nb + 1, tot);
  if (g == 0) CC_STAMP(4);
  // ---- scatter the keys; end[l] moves from l's start to its end
  for (int i0 = 0; i0 < a.K; i0 += nt * CH) {
    u64 k[CH];
    int l[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int i = i0 + j * nt + tid;
      k[j] = i < a.K ? a.gkey[i] : NONE;
      l[j] = (i < a.K ? a.sb[i] : 0) - b0;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int pos =
          run_add(end, l[j], k[j] != NONE && l[j] >= 0 && l[j] < nb, true);
      if (pos >= 0) key[pos] = k[j];
    }
  }
  __syncthreads();
  if (g == 0) CC_STAMP(5);
  // ---- each broker's Q smallest keys (keys are distinct; every key is
  // above 0)
  if (a.Q <= 4) {
    pick<4, SIGNS>(a, key, end, b0, nb, wide, &n_wide);
  } else {
    pick<8, SIGNS>(a, key, end, b0, nb, wide, &n_wide);
  }
  if (g == 0) CC_STAMP_SYNC(6);
}

// Phase B, leadership block g: the best leadership transfer of each
// current leader broker in [g·Rl, (g + 1)·Rl), from every candidate
__device__ __forceinline__ void top_lead(const Args a, int g,
                                         unsigned char* smem) {
  const int b0 = g * a.Rl;
  const int nb = min(a.B - b0, a.Rl);
  u64* lkey = a.lkey != nullptr ? a.lkey + (size_t)g * a.Rl
                                : (u64*)smem;   // [nb]
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l = tid; l < nb; l += nt) lkey[l] = NONE;
  __syncthreads();
  for (int i0 = 0; i0 < a.L; i0 += nt * CH) {
    float sc[CH];
    int l[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int i = i0 + j * nt + tid;
      sc[j] = i < a.L ? a.ls[i] : 0.0f;
      l[j] = (i < a.L ? a.glb[i] : 0) - b0;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int i = i0 + j * nt + tid;
      run_min(lkey, l[j], lead_key(sc[j], i),
              i < a.L && l[j] >= 0 && l[j] < nb);
    }
  }
  __syncthreads();
  if (g == 0) CC_STAMP(8);
  constexpr int BO = 4;   // brokers a thread writes out at once
  for (int l0 = tid; l0 < nb; l0 += nt * BO) {
    int r[BO], p[BO], s[BO];
    float sc[BO];
#pragma unroll
    for (int j = 0; j < BO; ++j) {
      const int l = l0 + j * nt;
      const u64 k = l < nb ? lkey[l] : NONE;
      r[j] = k == NONE ? a.L : (int)(k & 0xffffffffu);
      const int rc = r[j] < a.L ? r[j] : a.L - 1;
      p[j] = a.lp[rc];
      s[j] = a.lsl[rc];
      sc[j] = a.ls[rc];
    }
#pragma unroll
    for (int j = 0; j < BO; ++j) {
      const int l = l0 + j * nt;
      if (l >= nb) continue;
      const int b = b0 + l;
      const int d = a.assignment[(size_t)p[j] * a.S + s[j]];
      a.bl_score[b] = r[j] < a.L ? sc[j] : INFINITY;
      a.bl_p[b] = p[j];
      a.bl_s[b] = s[j];
      a.bl_dst[b] = d < 0 ? 0 : d;
    }
  }
  if (g == 0) CC_STAMP_SYNC(9);
}

// SIGNS: the rows' scores may hold -0.0 (the incremental form, `dest_terms`:
// src + dt is -0.0 where both terms are; the default form's src + (v - src)
// never is), so a zero pick looks for the sign the reference writes
template <bool SIGNS>
__global__ void __launch_bounds__(THREADS) per_src_top_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.x == 0) CC_STAMP(0);
  gather(a);
  if (blockIdx.x == 0) CC_STAMP_SYNC(1);
  cg::this_grid().sync();
  const int g = blockIdx.x;
  if (g < a.Gr) {
    if (g == 0) CC_STAMP(2);
    if (g * a.Rr < a.B) top_rows<SIGNS>(a, g, smem);
  } else {
    if (g == a.Gr) CC_STAMP(7);
    if ((g - a.Gr) * a.Rl < a.B) top_lead(a, g - a.Gr, smem);
  }
}

// A launch's shape: G blocks, the first Gr of them the rows of Rr brokers
// each, the rest the leadership of Rl each; its keys in shared memory
// where a block's arrays fit; smem < 0 when the card cannot be asked or a
// rows block's counts do not fit (past MAX_B)
struct Plan {
  int G, Gr, Rr, Rl;
  bool rows_keys_shared, lead_keys_shared;
  long long smem;
};

Plan plan_for(int K, int L, int B) {
  Plan pl{0, 0, 0, 0, false, false, -1};
  int dev = 0, limit = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return pl;
  }
  // a block of 1 024 threads at up to 64 registers fills an SM's
  // registers: one block an SM
  long long G = ((long long)K + L + THREADS - 1) / THREADS;
  pl.G = (int)(G < 2 ? 2 : (G > sms ? sms : G));
  pl.Gr = pl.G / 2;
  pl.Rr = (B + pl.Gr - 1) / pl.Gr;
  pl.Rl = (B + (pl.G - pl.Gr) - 1) / (pl.G - pl.Gr);
  // the kernel's static shared memory (tot, n_wide) comes out of the same
  // budget
  const long long room = limit - 256;
  if (rows_smem(K, pl.Rr, false) > room) return pl;
  pl.rows_keys_shared = rows_smem(K, pl.Rr, true) <= room;
  pl.lead_keys_shared = lead_smem(pl.Rl) <= room;
  const long long r = rows_smem(K, pl.Rr, pl.rows_keys_shared);
  const long long l = pl.lead_keys_shared ? lead_smem(pl.Rl) : 0;
  pl.smem = r > l ? r : l;
  return pl;
}

long long scratch_for(int K, int L, const Plan& pl) {
  return 8LL * K + (4LL * L + 7) / 8 * 8 +
         (pl.rows_keys_shared ? 0 : 8LL * pl.Gr * K) +
         (pl.lead_keys_shared ? 0 : 8LL * (pl.G - pl.Gr) * pl.Rl);
}

}  // namespace

extern "C" {

// Bytes of device scratch K3 needs at (K, L, B); -1 when the card cannot
// be asked or B is past MAX_B.
long long per_src_top_scratch_bytes(int K, int L, int B) {
  if (B > MAX_B) return -1;
  const Plan pl = plan_for(K, L, B);
  return pl.smem < 0 ? -1 : scratch_for(K, L, pl);
}

// Launches K3 on `stream`: one cooperative launch of a block a 1 024 rows
// and candidates, at least 2 and at most one an SM.  `scratch` is
// per_src_top_scratch_bytes(K, L, B) bytes of device memory; `row_best`
// may be null.  Returns the CUDA error code.
int per_src_top_launch(const int* lp, const int* lsl, const float* ls, int L,
                       const int* assignment, const int* leader_slot, int S,
                       const long long* slot, const float* src_term, int lds,
                       const float* vals, int R, int dest_terms, int K,
                       int B, int Q, float* bl_score, int* bl_p, int* bl_s,
                       int* bl_dst, int* rows, float* scores, int* sb,
                       float* row_best, void* scratch, void* stream) {
  if (L < 1 || K < 0 || B < 1 || B > MAX_B || Q < 0 || S < 1 || lds < 1 ||
      R < 1 || K > 0x7fffffff / 2 || L > 0x7fffffff - K ||
      scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan pl = plan_for(K, L, B);
  if (pl.smem < 0) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args) = dest_terms ? per_src_top_kernel<true>
                                    : per_src_top_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, THREADS, (size_t)pl.smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  unsigned char* w = (unsigned char*)scratch;
  Args a{slot, src_term, lds, vals, R, dest_terms, K, lp, lsl, ls, L,
         assignment, leader_slot, S, B, Q, bl_score, bl_p, bl_s, bl_dst,
         rows, scores, sb, row_best, nullptr, nullptr, nullptr, nullptr,
         pl.Gr, pl.Rr, pl.Rl};
  a.gkey = (u64*)w;
  w += 8LL * K;
  a.glb = (int*)w;
  w += (4LL * L + 7) / 8 * 8;
  if (!pl.rows_keys_shared) {
    a.rkey = (u64*)w;
    w += 8LL * pl.Gr * K;
  }
  if (!pl.lead_keys_shared) a.lkey = (u64*)w;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)pl.G);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)pl.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The built kernel's resources at (K, L, B) (ops/kernels.py: ATTR_KEYS):
// the default form's.
int per_src_top_attrs(int K, int L, int B, int* out) {
  void (*kernel)(Args) = per_src_top_kernel<false>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const Plan pl = plan_for(K, L, B);
  if (pl.smem < 0) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, THREADS, (size_t)pl.smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)pl.smem;
  out[4] = blocks;
  return 0;
}

}  // extern "C"
