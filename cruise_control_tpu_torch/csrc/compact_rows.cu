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
// order.  `rep` is the lowest kept row of each partition, as the stable
// argsort of the partitions gives it.
//
// What bounds it.  It reads the NROW scores (4 B each) once, and per kept
// row one row of the [K, R] scores and pool indices, R pool entries and
// one partition's load row; it writes ~100 B a kept row: at NROW = 5 000,
// C = 1 024, R = 8 about 0.2 MB — bound by bytes (~0.06 us at 3.35 TB/s).
// Its real limit is its chain of dependent phases in one block, each a
// barrier.
//
// What the design does about it: few barriers, no serial walk.  One block
// of 1 024 threads, each thread a run of L = ceil(NROW / 1 024) rows.
// - Selection: a radix select over the 32-bit score keys in three passes
//   of 11, 11 and 10 bits (2 048-bin shared histograms, one shared atomic
//   for the lanes of a warp that share a digit, via __match_any_sync).
//   Each pass's digit is found by a block scan of the bins (two a
//   thread), not by one thread walking them.  Up to L = 8 (NROW <= 8 192)
//   a thread's keys stay in registers from the first pass to the gather;
//   above it (50 000 keys at 10 000 brokers) every pass reads them again.
// - Gather: exactly C keys, every row below the C-th key T and the lowest
//   rows at T: one block scan of each thread's count of rows at T gives
//   the ties' ranks in row order; each warp reserves its slots with one
//   atomic.
// - Order: block_sort.cuh (warp sorts in registers, then merge levels of
//   one barrier each) sorts the C (score key, row) keys: 6 barriers at
//   C = 1 024, not a 55-stage bitonic sort.
// - rep without a sort: a shared hash table keyed by partition holds each
//   partition's lowest kept row (a 64-bit atomicMin on (p, k)) and its
//   lowest qualified row (atomicMin), so both come from one probe.
// 19 barriers a launch at C = 1 024, against ~130 before.  Shared memory
// holds 40 B a kept row (keys, the sort's second buffer, the hash table),
// not the NROW keys: 40 KB at C = 1 024; above C = 4 096 it lies in a
// device scratch the wrapper allocates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sort.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_step;
using cc_sort::u64;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int NR = 4;          // resources (common/resources.py)
constexpr int NW_OUT = 2;
constexpr int BINS = 2048;     // 11-bit digits: two bins a thread
constexpr int KPT = 8;         // keys a thread keeps in registers
constexpr int RCH = 8;         // alternates a kept row loads at once
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 PAD = ~0ull;
constexpr u64 EMPTY = ~0ull;   // a free hash slot
static_assert(BINS == 2 * THREADS, "two bins a thread");
static_assert(RCH % 4 == 0, "alternates move four at a time");

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

// the reference's gathers for kept row k (row crow of the NROW keys);
// returns the row's partition.  Each level of dependent loads is issued
// whole before any store (a store could alias an input for the compiler,
// which would keep every later load behind it): the row's pool index;
// the pool row's terms, ids and alternates; the partition's leader slot
// and load row and the alternates' destinations; then the stores.
// With `vec4` (R a multiple of 4 up to RCH, every [., R] table 16-byte
// aligned) a row's alternates move as float4 / int4: a quarter of the
// memory instructions, each touching the same sectors.
__device__ int resolve_row(const In& in, const Out& out, int k, int crow,
                           int QB, int B, int K, int R, int W, int NB,
                           float tol, bool vec4) {
  const bool is_move = crow < QB;
  const int lr = crow - QB;
  const int lrow = lr < 0 ? 0 : (lr > B - 1 ? B - 1 : lr);
  const int rq = in.q_rows[is_move ? crow : QB - 1];
  const float bl_score = in.bl_score[lrow];
  const int bl_p = in.bl_p[lrow], bl_s = in.bl_s[lrow];
  const int bl_dst = in.bl_dst[lrow];
  const bool valid = rq < K;
  const int mr = rq < 0 ? 0 : (rq > K - 1 ? K - 1 : rq);
  const float st = in.src_term[(size_t)mr * in.st_ld];
  const int kp = in.kp[mr], ks = in.ks[mr], sbm = in.sb[mr];
  float v[RCH];
  int bd[RCH];
  if (vec4) {
    const float4* v4 =
        reinterpret_cast<const float4*>(in.vals + (size_t)mr * R);
    const int4* b4 =
        reinterpret_cast<const int4*>(in.best_d + (size_t)mr * R);
#pragma unroll
    for (int q = 0; q < RCH / 4; ++q) {
      const float4 fv =
          4 * q < R ? v4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int4 iv = 4 * q < R ? b4[q] : make_int4(-1, -1, -1, -1);
      v[4 * q] = fv.x;
      v[4 * q + 1] = fv.y;
      v[4 * q + 2] = fv.z;
      v[4 * q + 3] = fv.w;
      bd[4 * q] = iv.x;
      bd[4 * q + 1] = iv.y;
      bd[4 * q + 2] = iv.z;
      bd[4 * q + 3] = iv.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < RCH; ++j) {
      v[j] = j < R ? in.vals[(size_t)mr * R + j] : 0.0f;
      bd[j] = j < R ? in.best_d[(size_t)mr * R + j] : -1;
    }
  }
  const int p = is_move ? kp : bl_p;
  const int s = is_move ? ks : bl_s;
  const bool leader_now = in.leader_slot[p] == s;
  const bool lead_move = leader_now && is_move;
  // the budget vector's sources in the partition's load row
  const float* pl = in.pload + (size_t)p * W;
  const int base = lead_move ? 0 : NR;
  const int cbase = lead_move ? 2 * NR + 1 : 3 * NR + 1;
  float mvl[NR], mvc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    mvl[r] = pl[base + r];
    mvc[r] = NB > NR + 2 ? pl[cbase + r] : 0.0f;
  }
  const float nw_out = pl[NW_OUT];
  int dd[RCH];
#pragma unroll
  for (int j = 0; j < RCH; ++j) dd[j] = bd[j] >= 0 ? in.dest_pool[bd[j]] : -1;

  // the alternates: the first RCH from registers, the rest (R > RCH) as
  // they come
  const float best = is_move ? (valid ? (in.dest_terms ? st + v[0]
                                                       : st + (v[0] - st))
                                      : INFINITY)
                             : bl_score;
  const int d_first = is_move ? dd[0] : bl_dst;
  if (vec4) {
    float sc[RCH];
    int dst[RCH];
#pragma unroll
    for (int j = 0; j < RCH; ++j) {
      if (is_move) {
        sc[j] = valid ? (in.dest_terms ? st + v[j] : st + (v[j] - st))
                      : INFINITY;
        dst[j] = dd[j];
      } else {
        sc[j] = j == 0 ? bl_score : INFINITY;
        dst[j] = bl_dst;
      }
    }
    float4* s4 = reinterpret_cast<float4*>(out.cand_score + (size_t)k * R);
    int4* d4 = reinterpret_cast<int4*>(out.cand_dst + (size_t)k * R);
#pragma unroll
    for (int q = 0; q < RCH / 4; ++q) {
      if (4 * q < R) {
        s4[q] = make_float4(sc[4 * q], sc[4 * q + 1], sc[4 * q + 2],
                            sc[4 * q + 3]);
        d4[q] = make_int4(dst[4 * q], dst[4 * q + 1], dst[4 * q + 2],
                          dst[4 * q + 3]);
      }
    }
  }
  for (int r = 0; r < (vec4 ? 0 : R); ++r) {
    float vr = 0.0f;
    int dr = -1;
    if (r < RCH) {
#pragma unroll
      for (int j = 0; j < RCH; ++j) {
        if (j == r) {
          vr = v[j];
          dr = dd[j];
        }
      }
    } else {
      vr = in.vals[(size_t)mr * R + r];
      const int b = in.best_d[(size_t)mr * R + r];
      dr = b >= 0 ? in.dest_pool[b] : -1;
    }
    float sc;
    int dst;
    if (is_move) {
      sc = valid ? (in.dest_terms ? st + vr : st + (vr - st)) : INFINITY;
      dst = dr;
    } else {
      sc = r == 0 ? bl_score : INFINITY;
      dst = bl_dst;
    }
    out.cand_score[(size_t)k * R + r] = sc;
    out.cand_dst[(size_t)k * R + r] = dst;
  }
  float* mv = out.move_vec + (size_t)k * NB;
#pragma unroll
  for (int r = 0; r < NR; ++r) mv[r] = is_move ? mvl[r] : 0.0f;
  mv[NR] = is_move ? 1.0f : 0.0f;
  mv[NR + 1] = is_move ? nw_out : 0.0f;
  if (NB > NR + 2) {
#pragma unroll
    for (int r = 0; r < NR; ++r) mv[NR + 2 + r] = is_move ? mvc[r] : 0.0f;
  }
  const bool improving = best < tol;
  out.is_move[k] = is_move ? 1 : 0;
  out.cand_src[k] = is_move ? (long long)sbm : (long long)lrow;
  out.cand_p[k] = p;
  out.cand_s[k] = s;
  out.improving[k] = improving ? 1 : 0;
  // qualified & improving; the one-row-per-partition filter comes later
  out.qual[k] = (is_move && !leader_now && valid && improving) ? 1 : 0;
  out.d0[k] = d_first < 0 ? 0 : d_first;
  return p;
}

// The first slot of p's probe path in a hash table of 2^bits slots.
__device__ __forceinline__ unsigned probe_start(int p, int bits) {
  return ((unsigned)p * 2654435761u) >> (32 - bits);
}

// Enters (p, k) into the hash table hk of 2^bits slots (entries
// p << 32 | k, EMPTY where free): claims the first free slot on p's probe
// path or, where p has its slot already, keeps the lower k.  Returns the
// slot.
__device__ int hash_insert(u64* hk, int bits, int p, int k) {
  const unsigned mask = (1u << bits) - 1u;
  const u64 mine = ((u64)(unsigned)p << 32) | (unsigned)k;
  for (unsigned h = probe_start(p, bits);; h = (h + 1u) & mask) {
    const u64 old = atomicCAS(&hk[h], EMPTY, mine);
    if (old == EMPTY) return (int)h;
    if ((unsigned)(old >> 32) == (unsigned)p) {
      atomicMin(&hk[h], mine);
      return (int)h;
    }
  }
}

// p's slot in the hash table (p was entered).
__device__ int hash_find(const u64* hk, int bits, int p) {
  const unsigned mask = (1u << bits) - 1u;
  unsigned h = probe_start(p, bits);
  while (hk[h] == EMPTY || (unsigned)(hk[h] >> 32) != (unsigned)p) {
    h = (h + 1u) & mask;
  }
  return (int)h;
}

// The inclusive sum of x over the warp's lanes up to this one.
__device__ __forceinline__ int warp_incl(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += u;
  }
  return x;
}

// The sum of x over the block's threads before this one, given each
// thread's warp-inclusive sum `incl`; `wtot` is a shared scratch of WARPS
// ints.  Every thread calls it; one barrier (the caller must put another
// before wtot is written again).
__device__ __forceinline__ int block_before(int x, int incl, int* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  const int w = warp_incl(lane < (int)(blockDim.x >> 5) ? wtot[lane] : 0);
  const int wb = __shfl_sync(FULL, w, warp > 0 ? warp - 1 : 0);
  return (warp > 0 ? wb : 0) + incl - x;
}

// REG: each thread's L <= KPT keys stay in registers from the first
// selection pass to the gather; else each pass reads them from global
// memory again.
template <bool REG>
__global__ void __launch_bounds__(THREADS)
compact_rows_kernel(In in, Out out, int W, int NB, int Q, int B, int K,
                    int R, int C, int n, int L, float tol, bool vec4,
                    u64* scratch) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ int hist[2][BINS];
  __shared__ int wtot[WARPS];
  __shared__ unsigned s_prefix[2];
  __shared__ int s_need[2], s_count;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int QB = Q * B, NROW = QB + B;
  CC_STAMP(0);
  // the kept keys [n], the sort's second buffer [n], and the partitions'
  // hash table: [2n] entries (p << 32 | lowest kept row), [2n] lowest
  // qualified row
  u64* key = scratch != nullptr ? scratch : smem;
  u64* tmp = key + n;
  u64* hk = tmp + n;
  int* hq = (int*)(hk + 2 * n);
  int bits = 1;
  while ((1 << bits) < 2 * n) ++bits;

  // the thread's rows [lo, lo + L), in row order as the threads are
  const int lo = tid * L;
  unsigned kr[REG ? KPT : 1];
  if constexpr (REG) {
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      kr[j] = j < L && lo + j < NROW ? row_key(in, QB, lo + j) : 0u;
    }
  }
  // f(j, valid, key) for each of the thread's slots, in row order, with
  // the same trip count in every thread (the warp intrinsics inside f)
  auto each = [&](auto&& f) {
    if constexpr (REG) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) f(j, j < L && lo + j < NROW, kr[j]);
    } else {
      for (int j = 0; j < L; ++j) {
        const bool v = lo + j < NROW;
        f(j, v, v ? row_key(in, QB, lo + j) : 0u);
      }
    }
  };
  for (int x = tid; x < 2 * BINS; x += nt) (&hist[0][0])[x] = 0;
  for (int x = tid; x < 2 * n; x += nt) {
    hk[x] = EMPTY;
    hq[x] = C;
  }
  if (tid == 0) {
    s_prefix[0] = 0u;
    s_need[0] = C;
    s_count = 0;
  }
  __syncthreads();

  // ---- radix select over 11, 11 and 10 bits: T = the C-th smallest key;
  // need = how many rows keyed T are kept (the lowest-index ones) --------
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
    const unsigned dmask = pass == 2 ? 1023u : 2047u;
    const unsigned hmask =
        pass == 0 ? 0u : (pass == 1 ? 0xffe00000u : 0xfffffc00u);
    const unsigned prefix = s_prefix[pass & 1];
    const int need = s_need[pass & 1];
    int* h = hist[pass & 1];
    if (pass == 1) {
      for (int x = tid; x < BINS; x += nt) hist[0][x] = 0;
    }
    // the keys under the decided prefix, by digit: one shared atomic for
    // the lanes of a warp that share a digit
    each([&](int, bool v, unsigned k) {
      const bool under = v && (k & hmask) == prefix;
      const unsigned bin = under ? (k >> shift) & dmask : 0xffffffffu;
      const unsigned peers = __match_any_sync(FULL, bin);
      if (under && __ffs((int)peers) - 1 == lane) {
        atomicAdd(&h[bin], __popc(peers));
      }
    });
    __syncthreads();
    // the digit: the bin where the count of keys below it reaches need
    // (two bins a thread, a block scan)
    const int c0 = h[2 * tid], c1 = h[2 * tid + 1];
    const int before = block_before(c0 + c1, warp_incl(c0 + c1), wtot);
    if (before < need && need <= before + c0 + c1) {
      const bool first = need <= before + c0;
      const unsigned d = 2u * tid + (first ? 0u : 1u);
      s_prefix[(pass + 1) & 1] = prefix | (d << shift);
      s_need[(pass + 1) & 1] = need - before - (first ? 0 : c0);
    }
    __syncthreads();
    CC_STAMP(1 + pass);
  }

  // ---- gather exactly C keys: every row below T, the first `need` at T
  // (their ranks in row order from a block scan of each thread's count)
  const unsigned T = s_prefix[1];
  const int need = s_need[1];
  int n_eq = 0;
  each([&](int, bool v, unsigned k) { n_eq += v && k == T; });
  const int eq_before = block_before(n_eq, warp_incl(n_eq), wtot);
  int kept = 0;
  {
    int e = eq_before;
    each([&](int, bool v, unsigned k) {
      kept += v && (k < T || (k == T && e < need));
      e += v && k == T;
    });
  }
  // each warp reserves its slots with one atomic: slots in no fixed
  // order, the sort orders them
  const int kincl = warp_incl(kept);
  int base = 0;
  if (lane == 31) base = atomicAdd(&s_count, kincl);
  int pos = __shfl_sync(FULL, base, 31) + kincl - kept;
  {
    int e = eq_before;
    each([&](int j, bool v, unsigned k) {
      const bool keep = v && (k < T || (k == T && e < need));
      e += v && k == T;
      if (keep) key[pos++] = ((u64)k << 32) | (unsigned)(lo + j);
    });
  }
  for (int x = C + tid; x < n; x += nt) key[x] = PAD;
  __syncthreads();
  CC_STAMP(4);

  // ---- the C kept keys in order ------------------------------------------
  const u64* sorted = cc_sort::block_sort(key, tmp, n, n);
  CC_STAMP(5);

  // ---- resolve the kept rows in score order; each partition's lowest
  // kept row and lowest qualified row into the hash table ----------------
  for (int k = tid; k < C; k += nt) {
    const int crow = (int)(sorted[k] & 0xffffffffu);
    const int p =
        resolve_row(in, out, k, crow, QB, B, K, R, W, NB, tol, vec4);
    const int slot = hash_insert(hk, bits, p, k);
    if (out.qual[k]) atomicMin(&hq[slot], k);
  }
  __syncthreads();
  CC_STAMP(6);

  // ---- rep: the lowest row of each partition; one qualified row a
  // partition, the best (lowest) one --------------------------------------
  for (int k = tid; k < C; k += nt) {
    const int slot = hash_find(hk, bits, out.cand_p[k]);
    out.rep[k] = (long long)(hk[slot] & 0xffffffffu);
    if (out.qual[k] && hq[slot] != k) out.qual[k] = 0;
  }
  CC_STAMP_SYNC(7);
}

// The sort's length: the smallest power of two >= max(C, 32).
int sort_len(int C) {
  int n = 32;
  while (n < C) n <<= 1;
  return n;
}

// Bytes at C kept rows of the keys, the sort's second buffer and the hash
// table: in dynamic shared memory up to SMEM_DYN (C <= 4 096), else in
// the caller's device scratch.
constexpr size_t SMEM_DYN = 200000;

size_t scratch_bytes(int C) { return (size_t)40 * sort_len(C); }

template <bool REG>
cudaError_t kernel_attrs(size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      compact_rows_kernel<REG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes at;
  if ((e = cudaFuncGetAttributes(&at, compact_rows_kernel<REG>)) !=
      cudaSuccess) {
    return e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, compact_rows_kernel<REG>, THREADS, smem);
  if (e != cudaSuccess) return e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = per_sm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of device scratch K7 needs at C kept rows: 0 when its keys and
// hash table fit in shared memory (pass a null `scratch`).
long long compact_rows_scratch_bytes(int C) {
  if (C < 1) return -1;
  return scratch_bytes(C) <= SMEM_DYN ? 0 : (long long)scratch_bytes(C);
}

// Launches K7 on `stream` (one block); `scratch` holds
// compact_rows_scratch_bytes(C) in device memory (8-byte aligned), or is
// null when that is 0.  `dest_terms`: `vals` holds the
// incremental rescore's destination terms, so a row's scores are
// src_term + vals (else src_term + (vals - src_term)).  Returns the CUDA
// error code.
int compact_rows_launch(const float* q_scores, const int* q_rows,
                        const float* bl_score, const int* bl_p,
                        const int* bl_s, const int* bl_dst,
                        const float* src_term, int st_ld, const float* vals,
                        const int* best_d, const int* dest_pool,
                        const int* kp, const int* ks, const int* sb,
                        const int* leader_slot, const float* pload, int W,
                        int NB, int Q, int B, int K, int R, int C, float tol,
                        int dest_terms, uint8_t* is_move, float* cand_score,
                        int* cand_dst, long long* cand_src, int* cand_p,
                        int* cand_s, float* move_vec, uint8_t* qual,
                        long long* rep, uint8_t* improving, int* d0,
                        void* scratch, void* stream) {
  const long long nrow = (long long)(Q + 1) * B;
  if (Q < 1 || B < 1 || K < 1 || R < 1 || C < 1 || C > nrow ||
      nrow > 0x7fffffffLL || st_ld < 1 ||
      (NB != NR + 2 && NB != 2 * NR + 2) ||
      W != (NB == NR + 2 ? 2 * NR + 1 : 4 * NR + 1) ||
      (scratch_bytes(C) > SMEM_DYN) != (scratch != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  In in{q_scores, q_rows, bl_score, bl_p, bl_s, bl_dst, src_term, st_ld,
        vals, best_d, dest_pool, kp, ks, sb, leader_slot, pload,
        dest_terms};
  Out out{is_move, cand_score, cand_dst, cand_src, cand_p, cand_s,
          move_vec, qual, rep, improving, d0};
  const int n = sort_len(C);
  const int L = (int)((nrow + THREADS - 1) / THREADS);
  const bool vec4 = R % 4 == 0 && R <= RCH &&
                    ((uintptr_t)vals | (uintptr_t)best_d |
                     (uintptr_t)cand_score | (uintptr_t)cand_dst) % 16 == 0;
  const size_t smem = scratch == nullptr ? scratch_bytes(C) : 0;
  cudaError_t e;
  if (L <= KPT) {
    e = cudaFuncSetAttribute(compact_rows_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    compact_rows_kernel<true><<<1, THREADS, smem, (cudaStream_t)stream>>>(
        in, out, W, NB, Q, B, K, R, C, n, L, tol, vec4, (u64*)scratch);
  } else {
    e = cudaFuncSetAttribute(compact_rows_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    compact_rows_kernel<false><<<1, THREADS, smem, (cudaStream_t)stream>>>(
        in, out, W, NB, Q, B, K, R, C, n, L, tol, vec4, (u64*)scratch);
  }
  return (int)cudaGetLastError();
}

// K7's resources at C kept rows of nrow keys (in registers up to KPT a
// thread, else read again each pass): out = registers, local bytes,
// static and dynamic shared bytes, resident blocks an SM (ops/kernels.py:
// ATTR_KEYS).
int compact_rows_attrs(int C, int nrow, int* out) {
  if (C < 1 || nrow < C) return (int)cudaErrorInvalidValue;
  const bool reg = (nrow + THREADS - 1) / THREADS <= KPT;
  const size_t smem = scratch_bytes(C) <= SMEM_DYN ? scratch_bytes(C) : 0;
  return (int)(reg ? kernel_attrs<true>(smem, out)
                   : kernel_attrs<false>(smem, out));
}

}  // extern "C"
