// The order-free segmented exclusive prefix sum of K15
// (csrc/corrected_accept.cu), which re-scores each row at its
// destination's and source's prefix state, and the fixed-point helpers
// (column maxima and sums by warp, from_fixed) it shares with K4
// (csrc/budget_accept.cu), whose own scan runs in registers
// over block_sort.cuh's order.  One copy of the helpers, so the two cannot
// drift apart.
//
// Exactness.  The plain twin (ops/segment.py: segment_excl_prefix_sorted)
// sums floats in int64 fixed point: a column is scaled by 2^(60 - e),
// rounded half to even, summed as integers (so in any order) and scaled
// back once, with e = frexp-exponent(max |v|) + ceil(log2 N) over the
// column's N rows — an exact max and an integer, the same on every device.
// The scan here reproduces it bit for bit.
//
// How it scans.  The rows are sorted once per id kind by the unique key
// (id, row) — a bitonic sort in shared memory, the stable order the plain
// twin's argsort gives — and then scanned in that order: each warp scans a
// chunk of 32 sorted rows with shuffles, one thread carries each
// segment's running sum across chunks, and rows whose segment began in an
// earlier chunk add the carry.  O(C log² C) however the rows fall into
// segments.

#ifndef CRUISE_CONTROL_SEG_PREFIX_CUH_
#define CRUISE_CONTROL_SEG_PREFIX_CUH_

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace cc_seg {

using namespace cc_step;

constexpr int MAX_NB = 10;       // widest budget vector: 2 R + 2, R = 4
constexpr unsigned FULL = 0xffffffffu;

template <int N>
__device__ __forceinline__ void warp_max(unsigned (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = max(v[c], __shfl_xor_sync(FULL, v[c], off));
  }
}

template <int N>
__device__ __forceinline__ void warp_sum(long long (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] += __shfl_xor_sync(FULL, v[c], off);
  }
}

__device__ __forceinline__ float from_fixed(long long acc, double scale) {
  return __double2float_rn((double)acc / scale);
}

// sscale[c] = the fixed-point scale of column c of `vec` over the rows
// with `flag` set (the others count as zeros); every thread calls it
__device__ void column_scales(const float* vec, const uint8_t* flag, int C,
                              int NB, unsigned int* smax, double* sscale) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid < NB) smax[tid] = 0u;
  unsigned mx[MAX_NB];
#pragma unroll
  for (int c = 0; c < MAX_NB; ++c) mx[c] = 0u;
  for (int i = tid; i < C; i += nt) {
    if (flag[i]) {
#pragma unroll
      for (int c = 0; c < MAX_NB; ++c) {
        if (c < NB) {
          mx[c] = max(mx[c], __float_as_uint(fabsf(vec[(size_t)i * NB + c])));
        }
      }
    }
  }
  warp_max(mx);
  __syncthreads();
  if ((tid & 31) == 0) {
    for (int c = 0; c < NB; ++c) atomicMax(&smax[c], mx[c]);
  }
  __syncthreads();
  if (tid < NB) sscale[tid] = fixed_scale(__uint_as_float(smax[tid]), C);
  __syncthreads();
}

// order[p] = the row at sorted position p of the stable sort of `ids`:
// a bitonic sort of the unique keys (id << 32 | row), padded to n2 (a
// power of two >= C) with the largest key; every thread calls it
template <typename I>
__device__ void sort_rows(const I* ids, int C, int n2,
                         unsigned long long* key, int* order) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int x = tid; x < n2; x += nt) {
    key[x] = x < C ? ((unsigned long long)ids[x] << 32) | (unsigned)x : ~0ull;
  }
  __syncthreads();
  bitonic_sort(key, n2);
  for (int p = tid; p < C; p += nt) order[p] = (int)(key[p] & 0xffffffffu);
  __syncthreads();
}

// ops/segment.py: segment_excl_prefix_sorted through
// analyzer/step_kernels.py: _seg_excl_prefix — excl[i, c] = the exclusive
// prefix sum of column c of `vec` over the earlier rows (in row order) of
// row i's id with `in` set (the others count as zeros), in int64 fixed
// point at the column's scale sscale[c] (from_fixed gives the float).
// `order` is sort_rows' order of `ids`; scratch: q [C, NB], chunk
// [ceil(C/32), NB + 1], carried [C].  Every thread calls it.
template <typename I>
__device__ void seg_excl_prefix(const I* ids, const int* order,
                                const float* vec, const uint8_t* in,
                                long long* q, long long* excl,
                                long long* chunk, uint8_t* carried, int C,
                                int NB, unsigned int* smax, double* sscale) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int nch = (C + 31) / 32, W = NB + 1;
  column_scales(vec, in, C, NB, smax, sscale);
  for (int x = tid; x < C * NB; x += nt) {
    q[x] = in[x / NB] ? __double2ll_rn((double)vec[x] * sscale[x % NB]) : 0;
  }
  __syncthreads();
  // each warp scans chunks of 32 sorted positions: its prefix within the
  // chunk, restarted at the segment's head when the head is in the chunk
  const unsigned le = lane == 31 ? FULL : (2u << lane) - 1u;
  for (int ch = tid >> 5; ch < nch; ch += nt >> 5) {
    const int p = ch * 32 + lane;
    const bool valid = p < C;
    const int r = valid ? order[p] : 0;
    const long long id = valid ? (long long)ids[r] : -1;
    const bool head = valid && (p == 0 || (long long)ids[order[p - 1]] != id);
    const unsigned heads = __ballot_sync(FULL, head);
    const unsigned mine = heads & le;
    const int hl = mine ? 31 - __clz((int)mine) : -1;
#pragma unroll
    for (int c = 0; c < MAX_NB; ++c) {
      if (c < NB) {
        const long long v = valid ? q[(size_t)r * NB + c] : 0;
        long long sum = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const long long u = __shfl_up_sync(FULL, sum, d);
          if (lane >= d) sum += u;
        }
        const long long before = __shfl_sync(FULL, sum, hl > 0 ? hl - 1 : 0);
        const long long incl = hl > 0 ? sum - before : sum;
        if (valid) excl[(size_t)r * NB + c] = incl - v;
        if (lane == 31) chunk[(size_t)ch * W + c] = incl;
      }
    }
    if (valid) carried[p] = mine == 0;
    if (lane == 0) chunk[(size_t)ch * W + NB] = heads != 0;
  }
  __syncthreads();
  // one thread turns the chunks' tail sums into carries into each chunk
  if (tid == 0) {
    long long run[MAX_NB];
#pragma unroll
    for (int c = 0; c < MAX_NB; ++c) run[c] = 0;
    for (int ch = 0; ch < nch; ++ch) {
      long long* row = chunk + (size_t)ch * W;
      const bool has_head = row[NB] != 0;
#pragma unroll
      for (int c = 0; c < MAX_NB; ++c) {
        if (c < NB) {
          const long long tail = row[c];
          row[c] = run[c];
          run[c] = has_head ? tail : run[c] + tail;
        }
      }
    }
  }
  __syncthreads();
  for (int p = tid; p < C; p += nt) {
    if (carried[p]) {
      const long long* row = chunk + (size_t)(p / 32) * W;
      const size_t o = (size_t)order[p] * NB;
      for (int c = 0; c < NB; ++c) excl[o + c] += row[c];
    }
  }
  __syncthreads();
}

}  // namespace cc_seg

#endif  // CRUISE_CONTROL_SEG_PREFIX_CUH_
