// K11 — exact top-k with ties to the lowest index, for Hopper (sm_90a).
//
// What it replaces.  The selections of a repool: `_select_round_pools`
// (cruise_control_tpu/analyzer/tpu_optimizer.py:688: top-K over the P·S
// move priority, top-D over the B destination scores) and
// `_leadership_pool` (:2173: top-L over the P·S leadership priority) —
// XLA's `top_k`, whose ties go to the lowest index.  The plain twin is a
// stable descending sort (analyzer/pool_kernels.py: _top_desc).  The
// step launches it three times a step; it acts only when the step's
// carry says the step repools (K10 sets the flag).  A score-only round
// launches it once, ungated.
//
// Order and ties.  Each entry is keyed by the complement of its float's
// total-order bits: the largest value gets the smallest key, -0.0 ranks
// below +0.0 (XLA's top_k compares so; its sort and approx_max_k tie the
// two) and -inf entries stay selectable, so fewer finite entries than k
// still return the -inf ones by lowest index.  The k kept (key, index)
// pairs in ascending order are the plain twin's first k.
//
// What bounds it on this card.  It reads the N keys (4 B each) and writes
// k indices: ~0.25 MB at N = 60 000, bound by bytes at well under a
// microsecond.  Its time is latency: barriers across the grid, and the
// dependent steps between them.  The first design (one block of 1 024
// threads per 4 096 keys, 15 blocks at N = 60 000) paid 0.20 ms a call
// there: in each of four 8-bit radix passes one thread walked the 256
// global bins one L2 round trip at a time, the kept pairs were gathered
// in arrival order through one atomic counter, and block 0 alone waited
// for every block and bitonic-sorted all k pairs (91 barrier-separated
// stages at k = 8 192) while the other blocks had exited.
//
// How it selects now.  One cooperative launch of G blocks of 1 024
// threads (analyzer/pool_kernels.py: top_select_grid): the first
// Gs = min(G, ceil(N / 4 096)) blocks each own a contiguous slice of x,
// and G is also large enough for the ranking below (64 kept entries a
// block), up to one block an SM.
// 1. Radix select, three passes of 11, 11 and 10 bits (one grid barrier
//    fewer than 8-bit digits): each slice block counts its slice into a
//    shared histogram and adds the bins into global memory with atomics;
//    after a barrier among the Gs blocks every block loads all the bins at
//    once (two a thread), and a block scan finds the digit that holds the
//    k-th smallest key and how many entries at it are still needed — one
//    L2 round trip, not one a bin.  Each block also keeps, from its own
//    histograms, how many of its entries lie below the digits chosen.
//    After three passes that is T, the k-th smallest key, `need`, the
//    entries keyed T to keep, and the block's counts below T and at T.
// 2. Gather in index order.  Each slice block publishes its two counts;
//    after a barrier it sums those of the blocks before it, and writes its
//    kept entries (every entry below T, and those at T whose index-order
//    rank among the entries at T is below `need`) at their exclusive
//    prefix position, a block scan of packed (below, at) counts over
//    chunks of 4 096.  The kept list is ordered by index and holds exactly
//    k entries.  With k = N every entry is kept and the passes are
//    skipped.
// 3. Rank across all blocks.  After one more barrier every block stages
//    the k kept keys in shared memory (32 KB at k = 8 192) and, for its
//    share of them, counts rank = #kept keys smaller + #equal keys at an
//    earlier position, each thread over one slice of the list (a slice of
//    the block's entries a column, their partial counts summed in shared
//    memory), then writes the entry's outputs at its rank.  The ranks are
//    a permutation, so the writes neither conflict nor depend on timing.
//    That is k² compares (67 M at k = 8 192) with no barrier among them,
//    spread over the card; a multi-block LSD radix sort of the kept list
//    would take three or four more grid barriers.
//
// Grid barriers.  A counter a barrier in the zeroed workspace; a block's
// thread 0 adds one and spins until every block that arrives has.  That
// needs every block resident at once, so the grid is launched
// cooperatively and capped at the blocks the card holds at once: a grid
// that cannot be co-resident fails to launch (an error the wrapper
// raises) instead of hanging.  Each block counts itself out on one more
// counter once it has passed its last barrier; the last one out zeroes
// the bins and counters again, so one workspace serves every launch of a
// search with no fill (the captured step chunks bake its address in).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_state;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int PASSES = 3;
constexpr int BINS = 2048;             // the widest digit's bins
constexpr int HIST_WORDS = 2048 + 2048 + 1024;
constexpr int PER_BLOCK = 4096;        // fewest entries a slice block owns
constexpr int ITEMS = 4;               // consecutive entries a thread gathers
constexpr int NBAR = 8;
// barriers: the passes', the counts', the gather's; then the exit count
constexpr int BAR_COUNTS = PASSES, BAR_GATHER = PASSES + 1;
constexpr int EXIT = PASSES + 2;
constexpr unsigned FULL_MASK = 0xffffffffu;

// workspace layout in int32 words: bins [HIST_WORDS] | barriers [NBAR] —
// zero between launches; then (below, at) counts a slice block [2·G], the
// kept keys [k] and their indices [k], written afresh by every launch
constexpr int CONTROL_WORDS = HIST_WORDS + NBAR;

__device__ __forceinline__ int pass_shift(int p) {
  return p == 0 ? 21 : (p == 1 ? 10 : 0);
}
__device__ __forceinline__ int pass_bins(int p) { return p < 2 ? 2048 : 1024; }
__device__ __forceinline__ int pass_offset(int p) { return p * 2048; }

// the complement of x's total-order key: larger x, smaller key; -0.0 keyed
// apart from (below) +0.0
__device__ __forceinline__ unsigned desc_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

// Arrive (if `arrive`) at barrier `ctr` and wait until `target` blocks
// have.  Every thread of the block calls it.
__device__ void grid_wait(unsigned* ctr, bool arrive, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (arrive) atomicAdd(ctr, 1u);
    while (*(volatile unsigned*)ctr < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// Block-wide exclusive prefix sum of one int a thread, in thread order;
// the block's total in `*total`.  `tmp` is a shared scratch of WARPS + 1
// ints; it ends on a barrier, so the next call may reuse it.
__device__ __forceinline__ int block_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL_MASK, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = tmp[lane];
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL_MASK, wi, o);
      if (lane >= o) wi += t;
    }
    tmp[lane] = wi - w;
    if (lane == 31) tmp[WARPS] = wi;
  }
  __syncthreads();
  const int excl = tmp[warp] + inc - v;
  *total = tmp[WARPS];
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(THREADS, 1)
top_select_kernel(const float* __restrict__ x, int N, int k, int S,
                  int* __restrict__ hi, int* __restrict__ lo,
                  long long* __restrict__ flat, const int* state, int* ws) {
  extern __shared__ __align__(16) unsigned skey[];   // [round_up(k, 4)]
  __shared__ int shist[BINS];            // a pass's bins; then rank partials
  __shared__ int tmp[WARPS + 1];
  __shared__ int s_digit, s_need, s_last;
  if (state != nullptr && state[REPOOL] == 0) return;
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int Gs = min(G, (N + PER_BLOCK - 1) / PER_BLOCK);
  int* hist = ws;                                          // [HIST_WORDS]
  unsigned* bar = (unsigned*)(ws + HIST_WORDS);            // [NBAR]
  int* counts = ws + CONTROL_WORDS;                        // [2·G]
  unsigned* kkey = (unsigned*)(counts + 2 * G);            // [k]
  int* kidx = counts + 2 * G + k;                          // [k]
  const bool all = k == N;

  if (b < Gs) {
    const int chunk = (N + Gs - 1) / Gs;
    const int i0 = min(N, b * chunk), i1 = min(N, i0 + chunk);
    if (all) {
      for (int i = i0 + tid; i < i1; i += THREADS) {
        kkey[i] = desc_key(x[i]);
        kidx[i] = i;
      }
    } else {
      // ---- radix select: T = the k-th smallest key, need = at T kept ----
      unsigned prefix = 0u, mask = 0u;
      int need = k, below = 0;   // this thread's bins below the digits
      for (int p = 0; p < PASSES; ++p) {
        const int shift = pass_shift(p), nb = pass_bins(p);
        const unsigned dmask = (unsigned)nb - 1u;
        for (int d = tid; d < BINS; d += THREADS) shist[d] = 0;
        __syncthreads();
        for (int i = i0 + tid; i < i1; i += THREADS) {
          const unsigned u = desc_key(x[i]);
          if ((u & mask) == prefix) atomicAdd(&shist[(u >> shift) & dmask], 1);
        }
        __syncthreads();
        int* h = hist + pass_offset(p);
        for (int d = tid; d < nb; d += THREADS) {
          if (shist[d]) atomicAdd(&h[d], shist[d]);
        }
        grid_wait(&bar[p], true, (unsigned)Gs);
        // every block finds the same digit: thread t holds bins per·t ..
        const int per = nb / THREADS;                      // 2 or 1
        const int d0 = per * tid;
        const int g0 = __ldcg(&h[d0]);
        const int g1 = per == 2 ? __ldcg(&h[d0 + 1]) : 0;
        int tot;
        const int excl = block_scan(g0 + g1, tmp, &tot);
        if (excl < need && need <= excl + g0) {
          s_digit = d0;
          s_need = need - excl;
        } else if (per == 2 && excl + g0 < need && need <= excl + g0 + g1) {
          s_digit = d0 + 1;
          s_need = need - excl - g0;
        }
        __syncthreads();
        const int d = s_digit;
        below += (d0 < d ? shist[d0] : 0) +
                 (per == 2 && d0 + 1 < d ? shist[d0 + 1] : 0);
        need = s_need;
        prefix |= (unsigned)d << shift;
        mask |= dmask << shift;
        __syncthreads();
      }
      const unsigned T = prefix;
      int lt;
      block_scan(below, tmp, &lt);
      if (tid == 0) {
        counts[2 * b] = lt;
        counts[2 * b + 1] = shist[T & 1023u];
      }
      grid_wait(&bar[BAR_COUNTS], true, (unsigned)Gs);

      // ---- this block's bases: counts below and at T before its slice --
      const int c_lt = tid < b ? __ldcg(&counts[2 * tid]) : 0;
      const int c_eq = tid < b ? __ldcg(&counts[2 * tid + 1]) : 0;
      int lt_base, eq_base;
      block_scan(c_lt, tmp, &lt_base);
      block_scan(c_eq, tmp, &eq_base);

      // ---- gather: at position (#below T before) + min(#at T before,
      // need), every entry below T and those at T ranked below need ------
      for (int c0 = i0; c0 < i1; c0 += THREADS * ITEMS) {
        const int e0 = c0 + tid * ITEMS;
        unsigned u[ITEMS];
        int n_lt = 0, n_eq = 0;
#pragma unroll
        for (int q = 0; q < ITEMS; ++q) {
          u[q] = e0 + q < i1 ? desc_key(x[e0 + q]) : 0xffffffffu;
          n_lt += e0 + q < i1 && u[q] < T;
          n_eq += e0 + q < i1 && u[q] == T;
        }
        int tot;
        const int before = block_scan(n_lt | (n_eq << 16), tmp, &tot);
        int a_lt = lt_base + (before & 0xffff);
        int a_eq = eq_base + (before >> 16);
#pragma unroll
        for (int q = 0; q < ITEMS; ++q) {
          const bool in = e0 + q < i1;
          const bool is_lt = in && u[q] < T, is_eq = in && u[q] == T;
          if (is_lt || (is_eq && a_eq < need)) {
            const int pos = a_lt + min(a_eq, need);
            kkey[pos] = u[q];
            kidx[pos] = e0 + q;
          }
          a_lt += is_lt;
          a_eq += is_eq;
        }
        lt_base += tot & 0xffff;
        eq_base += tot >> 16;
      }
    }
  }
  grid_wait(&bar[BAR_GATHER], b < Gs, (unsigned)Gs);
  // past its last barrier: count out; the last block out zeroes the bins
  // and counters for the next launch
  if (tid == 0) s_last = atomicAdd(&bar[EXIT], 1u) == (unsigned)G - 1u;
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int w = tid; w < CONTROL_WORDS; w += THREADS) ws[w] = 0;
  }

  // ---- rank: every block ranks its share of the k kept entries ----------
  const int kpad = (k + 3) & ~3;
  for (int i = tid; i < kpad; i += THREADS) {
    skey[i] = i < k ? __ldcg(&kkey[i]) : 0xffffffffu;
  }
  __syncthreads();
  const int J = (k + G - 1) / G;
  const int j0 = min(k, b * J), j1 = min(k, j0 + J);
  int jt = 1;
  while (jt < j1 - j0 && jt < THREADS) jt <<= 1;  // entries ranked at once
  const int nsl = THREADS / jt;                    // list slices
  const int sl = (((kpad + nsl - 1) / nsl) + 3) & ~3;
  const int s = tid / jt, a = min(kpad, s * sl), z = min(kpad, a + sl);
  int* part = shist;                               // [nsl][jt]
  for (int g = j0; g < j1; g += jt) {
    const int j = g + tid % jt;
    int c = 0;
    if (j < j1) {
      const unsigned kj = skey[j];
      const uint4* v = reinterpret_cast<const uint4*>(skey);
      if (z <= j) {             // every key of the slice precedes entry j
        for (int i = a; i < z; i += 4) {
          const uint4 w = v[i >> 2];
          c += (w.x <= kj) + (w.y <= kj) + (w.z <= kj) + (w.w <= kj);
        }
      } else if (a > j) {       // every key of the slice follows it
        for (int i = a; i < z; i += 4) {
          const uint4 w = v[i >> 2];
          c += (w.x < kj) + (w.y < kj) + (w.z < kj) + (w.w < kj);
        }
      } else {
        for (int i = a; i < z; ++i) {
          const unsigned ki = skey[i];
          c += ki < kj || (ki == kj && i < j);
        }
      }
    }
    part[tid] = c;
    __syncthreads();
    if (s == 0 && j < j1) {
      int r = 0;
      for (int t = 0; t < nsl; ++t) r += part[t * jt + tid];
      const unsigned idx = (unsigned)__ldcg(&kidx[j]);
      hi[r] = (int)(idx / (unsigned)S);
      if (lo != nullptr) lo[r] = (int)(idx % (unsigned)S);
      if (flat != nullptr) flat[r] = (long long)idx;
    }
    __syncthreads();
  }
}

size_t smem_bytes(int k) { return (size_t)((k + 3) & ~3) * sizeof(unsigned); }

}  // namespace

extern "C" {

// int32 words of the workspace for k kept on a grid of G blocks.
long long top_select_ws_words(int k, int G) {
  return (long long)CONTROL_WORDS + 2LL * G + 2LL * k;
}

// K11's resources for k kept: {registers a thread, local (spilled) bytes a
// thread, static shared bytes, dynamic shared bytes, resident blocks an
// SM}.  Returns the CUDA error code.
int top_select_attrs(int k, int* out) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(
      top_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  if ((e = cudaFuncGetAttributes(&a, top_select_kernel)) != cudaSuccess) {
    return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, top_select_kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = per_sm;
  return 0;
}

// Launches K11 on `stream`: the k largest of x[N] (ties to the lowest
// index) as idx / S into `hi` and, when given, idx % S into `lo` and idx
// into `flat`.  `state` (or null) gates the launch on the step's repool
// flag.  G blocks, fewer when the card cannot hold G at once (at most
// 1 024); a cooperative launch, so blocks that could not all be resident
// make it fail.  `ws` holds top_select_ws_words(k, G) words.  Returns the
// CUDA error code.
int top_select_launch(const float* x, int N, int k, int S, int* hi,
                      int* lo, long long* flat, const int* state, int* ws,
                      int G, void* stream) {
  if (N < 1 || k < 1 || k > N || S < 1 || G < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(
      top_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, top_select_kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (G > per_sm * sms) G = per_sm * sms;
  if (G > THREADS) G = THREADS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, top_select_kernel, x, N, k, S, hi, lo, flat,
                         state, ws);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
