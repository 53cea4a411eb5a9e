// A barrier-light ascending sort of 64-bit keys by one block: K4
// (csrc/budget_accept.cu) and K15 (csrc/corrected_accept.cu) sort their
// rows by (id, row) with it, K7 (csrc/compact_rows.cu) its kept rows by
// (score key, row) and K8 (csrc/commit_batch.cu) its finite commit keys.
//
// How it sorts.  Each warp sorts 32 keys in registers with a bitonic
// network of shuffles (15 stages, no barrier); then log2(n / 32) merge
// levels, one barrier each, turn sorted lists of w keys into lists of 2w:
// a key's place in the merged pair is its place in its own list plus how
// many keys of the other list come before it, found by a binary search
// of fixed trip count (a thread's two keys search together, so their
// shared-memory loads overlap).  Keys of the left list go before equal
// keys of the right one, so equal keys keep their order (the sort is
// stable; only the padding keys are ever equal here).  At n = 1 024: 6
// barriers, not 55; the searches' shared loads bound it.

#ifndef CRUISE_CONTROL_BLOCK_SORT_CUH_
#define CRUISE_CONTROL_BLOCK_SORT_CUH_

#include <cuda_runtime.h>
#include <stdint.h>

namespace cc_sort {

typedef unsigned long long u64;

// The 32 keys of a warp (one a lane), sorted ascending across the lanes
// by a bitonic network of shuffles; every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ T warp_sort32(T k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const T o = __shfl_xor_sync(0xffffffffu, k, stride);
      // lists of `size` lanes alternate ascending / descending; the last
      // (size 32) is ascending
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      k = (low == up) ? (o < k ? o : k) : (o < k ? k : o);
    }
  }
  return k;
}

// Step 1 of block_sort: each warp sorts the aligned chunks of 32 keys of
// key[0, total) in place (total a multiple of 32).  No barrier.
template <typename T>
__device__ __forceinline__ void sort_chunks(T* key, int total) {
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    key[i] = warp_sort32(key[i]);
  }
}

// Where key src[i] goes in one merge level: its pair's start plus its
// place in its own list; `other` is the list it searches and `upto`
// whether equal keys there go before it (it is in the right list).
template <typename T>
__device__ __forceinline__ void merge_slot(const T* src, int i, int w,
                                           T* k, int* base,
                                           const T** other, bool* upto) {
  *k = src[i];
  const int pair = i & ~(2 * w - 1);
  const int off = i - pair;
  const bool left = off < w;
  *base = pair + (left ? off : off - w);
  *other = src + pair + (left ? w : 0);
  *upto = !left;
}

// How many of the sorted keys s[0, w) (w a power of two) are below k, or
// with `upto`, at most k: a binary search of log2(w) + 1 steps.
template <typename T>
__device__ __forceinline__ int rank_in(const T* s, int w, T k, bool upto) {
  int pos = 0;
  for (int step = w >> 1; step > 0; step >>= 1) {
    const T v = s[pos + step - 1];
    if (v < k || (upto && v == k)) pos += step;
  }
  const T v = s[pos];
  return pos + ((v < k || (upto && v == k)) ? 1 : 0);
}

// One merge level of block_sort: the sorted lists of w keys of src
// [0, total), merged in aligned pairs into lists of 2w in dst.  A thread
// with two keys (i and i + blockDim.x) runs their binary searches in one
// loop, so their loads overlap.  No barrier.
template <typename T>
__device__ __forceinline__ void merge_level(const T* src, T* dst, int total,
                                            int w) {
  const int nt = blockDim.x;
  for (int i = threadIdx.x; i < total; i += 2 * nt) {
    T k0, k1;
    int b0, b1;
    const T *o0, *o1;
    bool u0, u1;
    merge_slot(src, i, w, &k0, &b0, &o0, &u0);
    if (i + nt >= total) {
      dst[b0 + rank_in(o0, w, k0, u0)] = k0;
      continue;
    }
    merge_slot(src, i + nt, w, &k1, &b1, &o1, &u1);
    int p0 = 0, p1 = 0;
    for (int step = w >> 1; step > 0; step >>= 1) {
      const T v0 = o0[p0 + step - 1];
      const T v1 = o1[p1 + step - 1];
      if (v0 < k0 || (u0 && v0 == k0)) p0 += step;
      if (v1 < k1 || (u1 && v1 == k1)) p1 += step;
    }
    const T v0 = o0[p0];
    const T v1 = o1[p1];
    dst[b0 + p0 + ((v0 < k0 || (u0 && v0 == k0)) ? 1 : 0)] = k0;
    dst[b1 + p1 + ((v1 < k1 || (u1 && v1 == k1)) ? 1 : 0)] = k1;
  }
}

// Sorts each aligned segment of n keys of key[0, total) ascending: n a
// power of two >= 32, total a multiple of n; tmp is a second buffer of
// total keys.  Returns the buffer that holds the result: key after an
// even number of merge levels (log2(n / 32)), else tmp.  Every thread of
// the block calls it; it ends on a barrier.
template <typename T>
__device__ T* block_sort(T* key, T* tmp, int total, int n) {
  sort_chunks(key, total);
  __syncthreads();
  T* src = key;
  T* dst = tmp;
  for (int w = 32; w < n; w <<= 1) {
    merge_level(src, dst, total, w);
    __syncthreads();
    T* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

}  // namespace cc_sort

#endif  // CRUISE_CONTROL_BLOCK_SORT_CUH_
