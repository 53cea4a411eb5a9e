// The exact segmented scan in registers that K4 (csrc/budget_accept.cu)
// and K15 (csrc/corrected_accept.cu) run over block_sort.cuh's stable
// order of their rows, and the fixed-point helpers around it (column
// maxima and sums by warp, the scale, quantization and its inverse), which
// K10 (csrc/pool_tables.cu) also uses for its column sums.  One copy, so
// the kernels cannot drift apart.
//
// Exactness.  The plain twin (ops/segment.py: segment_excl_prefix_sorted)
// sums floats in int64 fixed point: a column is scaled by 2^(60 - e),
// rounded half to even, summed as integers (so in any order) and scaled
// back once, with e = frexp-exponent(max |v|) + ceil(log2 N) over the
// column's N rows — an exact max and an integer, the same on every device.
// The scan here reproduces it bit for bit.
//
// How it scans.  The rows are sorted once per id kind by the unique key
// (id, row) — the stable order the plain twin's argsort gives — and a
// thread takes a sorted position: each warp scans its 32 positions by
// shuffles, restarting at segment heads (seg_scan_warp); after a barrier
// one warp combines the warps' tails into each warp's carry-in, a
// segmented scan across its lanes (seg_scan_carries); after another,
// each position with no head before it in its warp adds its warp's
// carry-in (seg_scan_add).  Three barriers a chunk of blockDim.x
// positions, however the rows fall into segments.

#ifndef CRUISE_CONTROL_SEG_PREFIX_CUH_
#define CRUISE_CONTROL_SEG_PREFIX_CUH_

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sort.cuh"
#include "step_common.cuh"

namespace cc_seg {

using namespace cc_step;
using cc_sort::u64;

constexpr int MAX_NB = 10;       // widest budget vector: 2 R + 2, R = 4
constexpr int MAX_WARPS = 32;    // warps of a block of 1 024 threads
constexpr int TAIL = MAX_NB + 1; // a warp's tail: NB sums and a head flag
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

// Each column's fixed-point scale (fixed_scale over n rows) from its
// exact max |v| `mx` (float bits): lane c computes column c, the warp
// shares them.
template <int NB>
__device__ __forceinline__ void scales(const unsigned* mx, long long n,
                                       double (&sc)[NB]) {
  const int lane = threadIdx.x & 31;
  const double mine =
      lane < NB ? fixed_scale(__uint_as_float(mx[lane]), n) : 1.0;
#pragma unroll
  for (int c = 0; c < NB; ++c) sc[c] = __shfl_sync(FULL, mine, c);
}

// round_half_even(v · sc) as int64 (ops/segment.py's torch.round(v64 * sc))
__device__ __forceinline__ long long quant(float v, double sc) {
  return fixed_q(v, fixed_scale_f(sc), sc);
}

// ops/segment.py's scale-back, (float)((double)acc / sc), for a scale sc =
// 2^k from fixed_scale: times 2^-k instead, built from sc's bits.  Both
// give the exact value (double)acc · 2^-k rounded once to f32, as every
// scale here lies in 2^-99 .. 2^208 and the product stays a normal
// double; the f64 multiply is full rate, the division a long sequence.
__device__ __forceinline__ float from_fixed_pow2(long long acc, double sc) {
  const double inv = __longlong_as_double((2046LL << 52) -
                                          __double_as_longlong(sc));
  return __double2float_rn((double)acc * inv);
}

// The column maxima of a phase's rows (float bits, per thread) into the
// shared slots `out`: warp shuffles, one atomic a warp and column.
template <int NB>
__device__ __forceinline__ void publish_max(unsigned (&mx)[NB],
                                            unsigned* out) {
  warp_max(mx);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < NB; ++c) atomicMax(&out[c], mx[c]);
  }
}

// One thread's sorted position in a segmented scan.
template <int NB>
struct Seg {
  long long v[NB];   // its value; then the inclusive sum of its segment
  bool open;         // no segment head at or before it in its warp
};

// Scratch of one segmented scan: the warps' tails (the sum of a warp's
// last segment, and whether the warp holds a head), each warp's carry-in,
// and the running sum into the next chunk.
struct ScanBuf {
  long long tails[MAX_WARPS][TAIL];
  long long carries[MAX_WARPS][MAX_NB];
  long long chunk[MAX_NB];
};

// The block's inclusive segmented scan of one chunk of sorted positions
// (one a thread), step 1: each warp scans its 32 positions by shuffles,
// restarting at segment heads, and lane 31 leaves the warp's tail.  A
// warp whose positions all lie past the rows (`idle`, warp-uniform) skips
// the shuffles and leaves an empty tail.  No barrier.
template <int NB>
__device__ __forceinline__ void seg_scan_warp(Seg<NB>& s, bool head,
                                              bool idle, ScanBuf& sb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (idle) {
    s.open = false;
    if (lane == 31) {
#pragma unroll
      for (int c = 0; c < NB; ++c) sb.tails[warp][c] = 0;
      sb.tails[warp][MAX_NB] = 1;
    }
    return;
  }
  const unsigned heads = __ballot_sync(FULL, head);
  const unsigned le = lane == 31 ? FULL : (2u << lane) - 1u;
  const unsigned mine = heads & le;
  const int hl = mine ? 31 - __clz((int)mine) : -1;
  s.open = mine == 0;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    long long sum = s.v[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(FULL, sum, d);
      if (lane >= d) sum += u;
    }
    const long long before = __shfl_sync(FULL, sum, hl > 0 ? hl - 1 : 0);
    s.v[c] = hl > 0 ? sum - before : sum;
    if (lane == 31) sb.tails[warp][c] = s.v[c];
  }
  if (lane == 31) sb.tails[warp][MAX_NB] = heads != 0u;
}

// Step 2, after a barrier, by one warp (a lane a warp of the block): each
// warp's carry-in — the tails of the warps before it combined in order
// (a segmented scan across the lanes) on top of the running sum into the
// chunk (none in the first) — and the running sum into the next chunk.
template <int NB>
__device__ __forceinline__ void seg_scan_carries(ScanBuf& sb, bool first) {
  const int lane = threadIdx.x & 31;
  const bool here = lane < (int)(blockDim.x >> 5);
  const unsigned flags =
      __ballot_sync(FULL, here && sb.tails[lane][MAX_NB] != 0);
  const unsigned le = lane == 31 ? FULL : (2u << lane) - 1u;
  const unsigned mine = flags & le;
  const int hf = mine ? 31 - __clz((int)mine) : -1;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const long long c0 = first ? 0 : sb.chunk[c];
    long long sum = here ? sb.tails[lane][c] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(FULL, sum, d);
      if (lane >= d) sum += u;
    }
    const long long before = __shfl_sync(FULL, sum, hf > 0 ? hf - 1 : 0);
    // the tails of warps 0 .. lane combined, on top of the chunk's carry
    const long long comb = hf > 0 ? sum - before : (hf == 0 ? sum : c0 + sum);
    const long long prev = __shfl_up_sync(FULL, comb, 1);
    if (here) sb.carries[lane][c] = lane == 0 ? c0 : prev;
    if (lane == 31) sb.chunk[c] = comb;
  }
}

// Step 3, after a barrier: positions with no head before them in their
// warp add the warp's carry-in.
template <int NB>
__device__ __forceinline__ void seg_scan_add(Seg<NB>& s, const ScanBuf& sb) {
  if (s.open) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < NB; ++c) s.v[c] += sb.carries[warp][c];
  }
}

// The sorted position p's row, id and whether a segment starts or ends
// there; sk holds the sorted keys (id << shift | row), padding past C.
template <typename K>
__device__ __forceinline__ void position(const K* sk, int p, int C,
                                         int* row, unsigned* id,
                                         bool* head, bool* last,
                                         int shift = 32) {
  const K k = p < C ? sk[p] : ~K(0);
  *row = (int)(k & ((K(1) << shift) - 1));
  *id = (unsigned)(k >> shift);
  *head = p < C && (p == 0 || (unsigned)(sk[p - 1] >> shift) != *id);
  *last = p < C && (p == C - 1 || (unsigned)(sk[p + 1] >> shift) != *id);
}

// Which buffer block_sort leaves its result in for segments of n keys:
// the keys after an even number of merge levels, else the second buffer.
__host__ __device__ inline bool sorted_in_tmp(int n) {
  int levels = 0;
  for (int w = 32; w < n; w <<= 1) ++levels;
  return levels % 2 != 0;
}

}  // namespace cc_seg

#endif  // CRUISE_CONTROL_SEG_PREFIX_CUH_
