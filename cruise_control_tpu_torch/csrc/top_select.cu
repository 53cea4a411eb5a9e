// K11 — exact top-k with ties to the lowest index, for Hopper (sm_90a).
//
// What it replaces.  The selections of a repool: `_select_round_pools`
// (cruise_control_tpu/analyzer/tpu_optimizer.py:688: top-K over the P·S
// move priority, top-D over the B destination scores) and
// `_leadership_pool` (:2173: top-L over the P·S leadership priority) —
// XLA's `top_k`, whose ties go to the lowest index.  The plain twin is a
// stable descending sort (analyzer/pool_kernels.py: _top_desc).  The
// step launches it three times a step; it acts only when the step's
// carry says the step repools (K10 sets the flag).
//
// Order and ties.  Each entry is keyed by the complement of its float's
// total-order bits: the largest value gets the smallest key, -0.0 ranks
// below +0.0 (XLA's top_k compares so; its sort and approx_max_k tie the
// two) and -inf entries stay selectable, so fewer finite entries than k
// still return the -inf ones by lowest index.  The k kept (key, index)
// pairs sorted ascending are the plain twin's first k.
//
// How it selects.  One launch of G <= #SM blocks of 1 024 threads, each
// over a contiguous slice of the input.  A radix select finds the k-th
// smallest key T in four passes of 256-bin histograms: each block counts
// its slice into shared memory and adds the bins into global memory with
// atomics; after a grid barrier every block reads the same global bins and
// picks the same digit.  Then each block counts its entries keyed T, a
// barrier later takes its exclusive prefix over the blocks before it, and
// gathers every entry below T and the entries at T whose rank in index
// order is below `need` — exactly k.  The last block to arrive is not
// waited for: block 0 alone waits for every block, sorts the k pairs in
// shared memory (a bitonic sort; 64 KB at k = 8 192) and writes the
// indices (and their quotient and remainder by S: partition and slot).
//
// Grid barriers.  A counter a barrier in the zeroed workspace; a block's
// thread 0 adds one and spins until every block has.  That needs every
// block resident at once, so the grid is launched cooperatively and capped
// at the blocks the card holds at once for this block size and shared
// memory: a grid that cannot be co-resident fails to launch (an error the
// wrapper raises) instead of hanging.
// Block 0, the last to use the workspace, zeroes its counters and bins
// again, so one workspace serves every launch of a search with no fill.

// What bounds it.  It reads the N keys (4 B each) six times (four
// histogram passes, the count and the gather; the later reads hit the
// 50 MB L2 at N = 60 000, partly at 3 M) and writes k indices: at N = 3 M
// ~12 MB, bound by bytes (~4 us at 3.35 TB/s).  Its chain of grid barriers
// and the final sort in one block (~91 stages at k = 8 192) set its time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_step;
using namespace cc_state;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;
constexpr int PASSES = 4;
constexpr int NBAR = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr unsigned long long PAD = ~0ull;

// workspace layout in int32 words: hist [PASSES·BINS] | barriers [NBAR] |
// selected count (+ pad) [8] | per-block counts [G] — zero between
// launches; then the u64 keys [k]
constexpr int CONTROL_WORDS = PASSES * BINS + NBAR + 8;
__device__ __forceinline__ long long key_offset_words(int G) {
  return ((long long)PASSES * BINS + NBAR + 8 + G + 1) / 2;  // in u64 words
}

// the complement of x's total-order key: larger x, smaller key; -0.0 keyed
// apart from (below) +0.0
__device__ __forceinline__ unsigned desc_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

__device__ void grid_sync(unsigned* ctr, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    while (*(volatile unsigned*)ctr < nblocks) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
top_select_kernel(const float* __restrict__ x, long long N, int k, int n2,
                  int S, int* __restrict__ hi, int* __restrict__ lo,
                  long long* __restrict__ flat, const int* state, int* ws,
                  int G) {
  extern __shared__ unsigned long long skey[];   // [n2], block 0 sorts
  __shared__ int shist[BINS];
  __shared__ int warp_tot[WARPS];
  __shared__ unsigned s_prefix, s_mask;
  __shared__ int s_need, s_base;
  if (state != nullptr && state[REPOOL] == 0) return;
  int* hist = ws;                                          // [PASSES, BINS]
  unsigned* bar = (unsigned*)(ws + PASSES * BINS);         // [NBAR]
  int* selected = ws + PASSES * BINS + NBAR;               // [1]
  int* bcount = selected + 8;                              // [G]
  unsigned long long* keys =
      (unsigned long long*)ws + key_offset_words(G);       // [k]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long chunk = (N + G - 1) / G;
  const long long i0 = (long long)blockIdx.x * chunk;
  const long long i1 = i0 + chunk < N ? i0 + chunk : N;

  // ---- radix select: T = the k-th smallest key, need = entries at T kept
  unsigned prefix = 0u, mask = 0u;
  int need = k;
  for (int pass = 0; pass < PASSES; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int b = tid; b < BINS; b += nt) shist[b] = 0;
    __syncthreads();
    for (long long i = i0 + tid; i < i1; i += nt) {
      const unsigned u = desc_key(x[i]);
      if ((u & mask) == prefix) atomicAdd(&shist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    for (int b = tid; b < BINS; b += nt) {
      if (shist[b]) atomicAdd(&hist[pass * BINS + b], shist[b]);
    }
    grid_sync(&bar[pass], G);
    if (tid == 0) {
      const int* h = hist + pass * BINS;
      int d = 0;
      for (; d < BINS - 1; ++d) {
        const int c = __ldcg(&h[d]);
        if (c >= need) break;
        need -= c;
      }
      s_need = need;
      s_prefix = prefix | ((unsigned)d << shift);
      s_mask = mask | (255u << shift);
    }
    __syncthreads();
    prefix = s_prefix;
    mask = s_mask;
    need = s_need;
    __syncthreads();
  }
  const unsigned T = prefix;

  // ---- this block's entries at T, then its prefix over earlier blocks ---
  int eq = 0;
  for (long long i = i0 + tid; i < i1; i += nt) eq += desc_key(x[i]) == T;
  for (int o = 16; o > 0; o >>= 1) eq += __shfl_down_sync(FULL_MASK, eq, o);
  if (tid == 0) s_base = 0;
  __syncthreads();
  if (lane == 0) atomicAdd(&s_base, eq);
  __syncthreads();
  if (tid == 0) bcount[blockIdx.x] = s_base;
  grid_sync(&bar[PASSES], G);
  if (tid == 0) {
    int base = 0;
    for (int b = 0; b < (int)blockIdx.x; ++b) base += __ldcg(&bcount[b]);
    s_base = base;
  }
  __syncthreads();

  // ---- gather: every entry below T, the lowest-index `need` at T --------
  for (long long c0 = i0; c0 < i1; c0 += nt) {
    const long long i = c0 + tid;
    const unsigned u = i < i1 ? desc_key(x[i]) : 0xffffffffu;
    const bool at_t = i < i1 && u == T;
    const unsigned ball = __ballot_sync(FULL_MASK, at_t);
    if (lane == 0) warp_tot[warp] = __popc(ball);
    __syncthreads();
    int rank = s_base + __popc(ball & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += warp_tot[w];
    if (i < i1 && (u < T || (at_t && rank < need))) {
      keys[atomicAdd(selected, 1)] =
          ((unsigned long long)u << 32) | (unsigned)i;
    }
    __syncthreads();
    if (tid == 0) {
      int tot = 0;
      for (int w = 0; w < WARPS; ++w) tot += warp_tot[w];
      s_base += tot;
    }
    __syncthreads();
  }

  // ---- block 0 waits for every block, sorts the k pairs, writes out -----
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    atomicAdd(&bar[PASSES + 1], 1u);
  }
  if (blockIdx.x != 0) return;
  if (tid == 0) {
    while (*(volatile unsigned*)&bar[PASSES + 1] < (unsigned)G) {
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
  for (int j = tid; j < n2; j += nt) skey[j] = j < k ? __ldcg(&keys[j]) : PAD;
  // every block is done with the counters and bins: zero them for the
  // next launch
  for (int j = tid; j < CONTROL_WORDS + G; j += nt) ws[j] = 0;
  __syncthreads();
  bitonic_sort(skey, n2);
  for (int j = tid; j < k; j += nt) {
    const unsigned idx = (unsigned)(skey[j] & 0xffffffffu);
    hi[j] = (int)(idx / (unsigned)S);
    if (lo != nullptr) lo[j] = (int)(idx % (unsigned)S);
    if (flat != nullptr) flat[j] = (long long)idx;
  }
}

}  // namespace

extern "C" {

// Launches K11 on `stream`: the k largest of x[N] (ties to the lowest
// index) as idx / S into `hi` and, when given, idx % S into `lo` and idx
// into `flat`.  `state` (or null) gates the launch on the step's repool
// flag.  At most G blocks, fewer when the card cannot hold G at once; a
// cooperative launch, so blocks that could not all be resident make it
// fail.  Returns the CUDA error code.
int top_select_launch(const float* x, long long N, int k, int S, int* hi,
                      int* lo, long long* flat, const int* state, int* ws,
                      int G, void* stream) {
  if (N < 1 || N > 0xffffffffLL || k < 1 || k > N || S < 1 || G < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int n2 = 1;
  while (n2 < k) n2 <<= 1;
  const int smem = n2 * (int)sizeof(unsigned long long);
  cudaError_t e = cudaFuncSetAttribute(
      top_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  e = cudaLaunchKernelEx(&cfg, top_select_kernel, x, N, k, n2, S, hi, lo,
                         flat, state, ws, G);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
