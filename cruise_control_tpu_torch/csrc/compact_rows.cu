// K7 — the search step's compaction to its best C candidate rows, and the
// cohort's inputs for them, for Hopper (sm_90a).
//
// What it replaces.  The body of the reference's step,
// cruise_control_tpu/analyzer/tpu_optimizer.py:1202-1309: the stable
// `sort_key_val` (:1206) of the NROW = (Q+1)·B row keys — the Q best move
// rows of every source broker, then each broker's best leadership transfer
// — kept to its first C rows; the gathers that resolve each kept row into
// its R alternates' scores and destinations, its source broker, partition
// and slot; `leader_now_q` (:1238) and the budget vector `move_vec`; the
// partition representatives (`order_pc` :1293, `rep`: the lowest row of
// each partition) and the one-row-per-partition filter (`fminp` :1305).
// The eager port ran it as ~110 small torch ops a step.  This kernel is
// all of it, in one launch (analyzer/compact_kernel.py: _compact_rows is
// its plain twin).
//
// Order and ties.  Rows are ranked by the 64-bit key (order-preserving
// bits of the f32 score, row index): -0.0 keyed as +0.0, as the stable
// sort compares them, and ties to the lowest row — the stable sort's
// order.  `rep` ranks (partition, row) keys the same way, so each row's
// representative is the lowest row of its partition, as the stable
// argsort gives it.
//
// How it selects.  A single block, whatever NROW is: a radix select over
// the score keys' high 32 bits (four passes of 256-bin histograms) finds
// the C-th smallest score T; one pass in row order then gathers every row
// below T and the lowest-index rows at T (a block-wide prefix count) —
// exactly C rows — and a bitonic sort of those C keys orders them.
// Shared memory holds the C keys (8 KB at C = 1 024), not the NROW ones,
// so NROW = 50 000 at 10 000 brokers runs in the same block.
//
// What bounds it.  It reads the NROW scores (4 B each) five times (four
// histogram passes and the gather: the later passes hit the cache), and
// per kept row one row of the [K, R] scores and pool indices, R pool
// entries and one partition's load row; it writes ~100 B a kept row: at
// NROW = 5 000, C = 1 024, R = 8 about 0.2 MB — bound by bytes (~0.06 us
// at 3.35 TB/s).  Its real limit is its chain of block barriers: the four
// histogram passes, ~NROW/1 024 gather chunks and two bitonic sorts of C
// keys (55 stages each at C = 1 024).
//
// What the design does about it.  One block of 1 024 threads runs the
// whole chain with block barriers, no second launch and no global
// round trip; the selected keys, histograms and warp counts live in
// shared memory (the keys in a global scratch the wrapper allocates when
// C is too large for it).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_step;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int NR = 4;          // resources (common/resources.py)
constexpr int NW_OUT = 2;
constexpr int BINS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long PAD = ~0ull;

struct In {
  const float* q_scores;   // [Q·B]
  const int* q_rows;       // [Q·B]
  const float* bl_score;   // [B]
  const int* bl_p;         // [B]
  const int* bl_s;         // [B]
  const int* bl_dst;       // [B]
  const float* src_term;   // [K], stride st_ld
  int st_ld;
  const float* vals;       // [K, R]
  const int* best_d;       // [K, R]
  const int* dest_pool;    // [D]
  const int* kp;           // [K]
  const int* ks;           // [K]
  const int* sb;           // [K]
  const int* leader_slot;  // [P]
  const float* pload;      // [P, W]
  int dest_terms;          // vals holds score - src_term (the carry's dt)
};

struct Out {
  uint8_t* is_move;        // [C]
  float* cand_score;       // [C, R]
  int* cand_dst;           // [C, R]
  long long* cand_src;     // [C]
  int* cand_p;             // [C]
  int* cand_s;             // [C]
  float* move_vec;         // [C, NB]
  uint8_t* qual;           // [C]
  long long* rep;          // [C]
  uint8_t* improving;      // [C]
  int* d0;                 // [C]
};

__device__ __forceinline__ unsigned row_key(const In& in, int QB, int i) {
  return ord32(i < QB ? in.q_scores[i] : in.bl_score[i - QB]);
}

// the reference's gathers for kept row k (row crow of the NROW keys)
__device__ void resolve_row(const In& in, const Out& out, int k, int crow,
                            int QB, int B, int K, int R, int W, int NB,
                            float tol) {
  const bool is_move = crow < QB;
  const int qrow = is_move ? crow : QB - 1;
  const int rq = in.q_rows[qrow];
  const bool valid = rq < K;
  const int mr = rq < 0 ? 0 : (rq > K - 1 ? K - 1 : rq);
  const int lr = crow - QB;
  const int lrow = lr < 0 ? 0 : (lr > B - 1 ? B - 1 : lr);
  const float st = in.src_term[(size_t)mr * in.st_ld];
  float best = INFINITY;
  int d_first = 0;
  for (int r = 0; r < R; ++r) {
    float sc;
    int dd;
    if (is_move) {
      const float v = in.vals[(size_t)mr * R + r];
      sc = valid ? (in.dest_terms ? st + v : st + (v - st)) : INFINITY;
      const int bd = in.best_d[(size_t)mr * R + r];
      dd = bd >= 0 ? in.dest_pool[bd] : -1;
    } else {
      sc = r == 0 ? in.bl_score[lrow] : INFINITY;
      dd = in.bl_dst[lrow];
    }
    if (r == 0) {
      best = sc;
      d_first = dd;
    }
    out.cand_score[(size_t)k * R + r] = sc;
    out.cand_dst[(size_t)k * R + r] = dd;
  }
  const int p = is_move ? in.kp[mr] : in.bl_p[lrow];
  const int s = is_move ? in.ks[mr] : in.bl_s[lrow];
  const bool leader_now = in.leader_slot[p] == s;
  const bool lead_move = leader_now && is_move;
  const float* pl = in.pload + (size_t)p * W;
  float* mv = out.move_vec + (size_t)k * NB;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    mv[r] = is_move ? (lead_move ? pl[r] : pl[NR + r]) : 0.0f;
  }
  mv[NR] = is_move ? 1.0f : 0.0f;
  mv[NR + 1] = is_move ? pl[NW_OUT] : 0.0f;
  if (NB > NR + 2) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      mv[NR + 2 + r] =
          is_move ? (lead_move ? pl[2 * NR + 1 + r] : pl[3 * NR + 1 + r])
                  : 0.0f;
    }
  }
  const bool improving = best < tol;
  out.is_move[k] = is_move ? 1 : 0;
  out.cand_src[k] = is_move ? (long long)in.sb[mr] : (long long)lrow;
  out.cand_p[k] = p;
  out.cand_s[k] = s;
  out.improving[k] = improving ? 1 : 0;
  // qualified & improving; the one-row-per-partition filter comes later
  out.qual[k] = (is_move && !leader_now && valid && improving) ? 1 : 0;
  out.d0[k] = d_first < 0 ? 0 : d_first;
}

__global__ void __launch_bounds__(THREADS)
compact_rows_kernel(In in, Out out, int W, int NB, int Q, int B, int K,
                    int R, int C, int n2, float tol,
                    unsigned long long* gkeys) {
  extern __shared__ unsigned long long skeys[];
  unsigned long long* key = gkeys ? gkeys : skeys;     // [n2]
  __shared__ int hist[BINS];
  __shared__ int warp_tot[WARPS];
  __shared__ unsigned s_prefix, s_mask;
  __shared__ int s_need, s_count;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int QB = Q * B, NROW = QB + B;

  // ---- radix select: T = the C-th smallest score key; need = how many
  // rows keyed T are kept (the lowest-index ones) ------------------------
  if (tid == 0) {
    s_prefix = 0u;
    s_mask = 0u;
    s_need = C;
  }
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int x = tid; x < BINS; x += nt) hist[x] = 0;
    __syncthreads();
    const unsigned prefix = s_prefix, mask = s_mask;
    for (int i = tid; i < NROW; i += nt) {
      const unsigned h = row_key(in, QB, i);
      if ((h & mask) == prefix) atomicAdd(&hist[(h >> shift) & 255u], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int need = s_need, d = 0;
      for (; d < BINS - 1 && hist[d] < need; ++d) need -= hist[d];
      s_need = need;
      s_prefix = prefix | ((unsigned)d << shift);
      s_mask = mask | (255u << shift);
    }
    __syncthreads();
  }

  // ---- gather exactly C keys: every row below T, the first `need` at T --
  const unsigned T = s_prefix;
  const int need = s_need;
  if (tid == 0) s_count = 0;
  __syncthreads();
  int base = 0;   // rows keyed T in earlier chunks (the same in every thread)
  for (int c0 = 0; c0 < NROW; c0 += nt) {
    const int i = c0 + tid;
    const unsigned h = i < NROW ? row_key(in, QB, i) : 0u;
    const bool eq = i < NROW && h == T;
    int tot;
    const int rank = base + block_count_before(eq, warp_tot, &tot);
    if (i < NROW && (h < T || (eq && rank < need))) {
      key[atomicAdd(&s_count, 1)] = ((unsigned long long)h << 32) | (unsigned)i;
    }
    base += tot;
  }
  __syncthreads();
  for (int x = C + tid; x < n2; x += nt) key[x] = PAD;
  __syncthreads();
  bitonic_sort(key, n2);

  // ---- resolve the kept rows in score order; key them by partition ------
  for (int k = tid; k < C; k += nt) {
    const int crow = (int)(key[k] & 0xffffffffu);
    resolve_row(in, out, k, crow, QB, B, K, R, W, NB, tol);
    key[k] = ((unsigned long long)(unsigned)out.cand_p[k] << 32) | (unsigned)k;
  }
  __syncthreads();
  bitonic_sort(key, n2);

  // ---- rep: the lowest row of each partition (its first sorted key) -----
  for (int j = tid; j < C; j += nt) {
    const unsigned long long kj = key[j];
    const unsigned long long p = kj >> 32;
    int lo = 0, hi = j;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((key[mid] >> 32) < p) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out.rep[kj & 0xffffffffu] = (long long)(key[lo] & 0xffffffffu);
  }
  __syncthreads();

  // ---- one qualified row per partition, the best (lowest) first ---------
  int* fmin = (int*)key;                               // [C]
  for (int k = tid; k < C; k += nt) fmin[k] = C;
  __syncthreads();
  for (int k = tid; k < C; k += nt) {
    if (out.qual[k]) atomicMin(&fmin[out.rep[k]], k);
  }
  __syncthreads();
  for (int k = tid; k < C; k += nt) {
    if (out.qual[k] && fmin[out.rep[k]] != k) out.qual[k] = 0;
  }
}

}  // namespace

extern "C" {

// Launches K7 on `stream` (one block); `keys` is an [n2] u64 scratch in
// device memory, or null to keep the keys in shared memory.  `dest_terms`:
// `vals` holds the incremental rescore's destination terms, so a row's
// scores are src_term + vals (else src_term + (vals - src_term)).  Returns
// the CUDA error code.
int compact_rows_launch(const float* q_scores, const int* q_rows,
                        const float* bl_score, const int* bl_p,
                        const int* bl_s, const int* bl_dst,
                        const float* src_term, int st_ld, const float* vals,
                        const int* best_d, const int* dest_pool,
                        const int* kp, const int* ks, const int* sb,
                        const int* leader_slot, const float* pload, int W,
                        int NB, int Q, int B, int K, int R, int C, int n2,
                        float tol, int dest_terms, uint8_t* is_move,
                        float* cand_score,
                        int* cand_dst, long long* cand_src, int* cand_p,
                        int* cand_s, float* move_vec, uint8_t* qual,
                        long long* rep, uint8_t* improving, int* d0,
                        unsigned long long* keys, void* stream) {
  const long long nrow = (long long)(Q + 1) * B;
  if (Q < 1 || B < 1 || K < 1 || R < 1 || C < 1 || C > nrow ||
      nrow > 0x7fffffffLL || n2 < C || (n2 & (n2 - 1)) != 0 || st_ld < 1 ||
      (NB != NR + 2 && NB != 2 * NR + 2) ||
      W != (NB == NR + 2 ? 2 * NR + 1 : 4 * NR + 1)) {
    return (int)cudaErrorInvalidValue;
  }
  In in{q_scores, q_rows, bl_score, bl_p, bl_s, bl_dst, src_term, st_ld,
        vals, best_d, dest_pool, kp, ks, sb, leader_slot, pload,
        dest_terms};
  Out out{is_move, cand_score, cand_dst, cand_src, cand_p, cand_s,
          move_vec, qual, rep, improving, d0};
  const int smem = keys == nullptr ? n2 * (int)sizeof(unsigned long long) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      compact_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  compact_rows_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      in, out, W, NB, Q, B, K, R, C, n2, tol, keys);
  return (int)cudaGetLastError();
}

}  // extern "C"
