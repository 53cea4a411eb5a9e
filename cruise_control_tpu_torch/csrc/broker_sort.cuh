// The counting sort of a [P, S] placement by broker that K9 and K12 share:
// every existing replica slot in a broker-ordered list, each broker's
// slots cut into items of at most `ch` (the caller's choice, up to CH), so
// that a per-broker sum is a plain reduction an item, with no atomic,
// however skewed the placement.
//
//  1. count (`nvb` blocks of ST threads, real or a cooperative launch's
//     passes, min(B, SORT_TB) ints of shared memory): block `vb`
//     histograms its slice of the slots in shared
//     memory (a 32-bit shared atomic gives each slot its rank among its
//     broker's slots in the block), then reserves each broker's run with
//     one global atomic a (block, broker) on `cursor` (zeroed before):
//     pos[x] is slot x's place in its broker's segment.
//  2. scan (one block of NT threads): start[b] = Σ_{b' < b} count, istart[b]
//     = Σ_{b' < b} ceil(count / ch) (start[B] and istart[B] the totals),
//     and ibroker[item] = the item's broker.
//  3. scatter: list[start[b] + pos[x]] = entry(x), the slot's partition
//     and slot index and whether it is the partition's leader slot.
// Slots of one broker land in no fixed order; the sums are exact in any.

#ifndef CRUISE_CONTROL_BROKER_SORT_CUH_
#define CRUISE_CONTROL_BROKER_SORT_CUH_

#include <cuda_runtime.h>
#include <stdint.h>

namespace cc_sort {

constexpr int ST = 512;            // threads of a count or scatter block
constexpr int SORT_TB = 16384;     // brokers a count block's histogram holds
constexpr int CH = 128;            // slots an item at most, the longest item
constexpr unsigned LEAD_BIT = 0x80000000u;
constexpr int MAX_P = 1 << 28;     // partitions an entry can name

// a list entry: p · 8 + s, LEAD_BIT where s is p's leader slot
__device__ __forceinline__ unsigned entry(int p, int s, bool lead) {
  return ((unsigned)p << 3) | (unsigned)s | (lead ? LEAD_BIT : 0u);
}
__device__ __forceinline__ int entry_p(unsigned e) {
  return (int)((e & ~LEAD_BIT) >> 3);
}
__device__ __forceinline__ int entry_s(unsigned e) { return (int)(e & 7u); }
__device__ __forceinline__ bool entry_lead(unsigned e) {
  return (e & LEAD_BIT) != 0u;
}

// items at most for P·S slots over B brokers: Σ ceil(c_b / ch) ≤ B + P·S/ch
__host__ __device__ inline long long max_items(long long PS, int B, int ch) {
  return B + (PS + ch - 1) / ch;
}

// step 1 as block `vb` of `nvb`, for every thread of a block of ST
// threads; `hist` is shared memory of min(B, SORT_TB) ints
__device__ void count(const int* assignment, long long PS, int B,
                      int* cursor, int* pos, int* hist, int vb, int nvb) {
  const int tid = threadIdx.x;
  const long long per = (PS + nvb - 1) / nvb;
  const long long x0 = (long long)vb * per;
  const long long x1 = x0 + per < PS ? x0 + per : PS;
  for (int t0 = 0; t0 < B; t0 += SORT_TB) {
    const int tb = B - t0 < SORT_TB ? B - t0 : SORT_TB;
    for (int i = tid; i < tb; i += ST) hist[i] = 0;
    __syncthreads();
    for (long long x = x0 + tid; x < x1; x += ST) {
      const int a = assignment[x] - t0;
      if (a >= 0 && a < tb) pos[x] = atomicAdd(&hist[a], 1);
    }
    __syncthreads();
    for (int i = tid; i < tb; i += ST) {
      const int c = hist[i];
      if (c != 0) hist[i] = atomicAdd(&cursor[t0 + i], c);
    }
    __syncthreads();
    for (long long x = x0 + tid; x < x1; x += ST) {
      const int a = assignment[x] - t0;
      if (a >= 0 && a < tb) pos[x] += hist[a];
    }
    __syncthreads();
  }
}

// step 2, for every thread of one block of NT threads
template <int NT>
__device__ void scan(const int* cursor, int B, int ch, int* start,
                     int* istart, int* ibroker) {
  __shared__ long long s_w[NT / 32][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (B + NT - 1) / NT;
  const int b0 = tid * per < B ? tid * per : B;
  const int b1 = b0 + per < B ? b0 + per : B;
  long long slots = 0, items = 0;
  for (int b = b0; b < b1; ++b) {
    const int c = cursor[b];
    slots += c;
    items += (c + ch - 1) / ch;
  }
  // block-wide exclusive prefix sums of (slots, items), in thread order
  long long a = slots, i = items;
  for (int o = 1; o < 32; o <<= 1) {
    const long long ta = __shfl_up_sync(0xffffffffu, a, o);
    const long long ti = __shfl_up_sync(0xffffffffu, i, o);
    if (lane >= o) {
      a += ta;
      i += ti;
    }
  }
  if (lane == 31) {
    s_w[warp][0] = a;
    s_w[warp][1] = i;
  }
  __syncthreads();
  long long s0 = a - slots, i0 = i - items;
  for (int q = 0; q < warp; ++q) {
    s0 += s_w[q][0];
    i0 += s_w[q][1];
  }
  for (int b = b0; b < b1; ++b) {
    const int c = cursor[b];
    const int k = (c + ch - 1) / ch;
    start[b] = (int)s0;
    istart[b] = (int)i0;
    for (int j = 0; j < k; ++j) ibroker[i0 + j] = b;
    s0 += c;
    i0 += k;
  }
  if (tid == NT - 1) {
    start[B] = (int)s0;
    istart[B] = (int)i0;
  }
  __syncthreads();
}

// step 3, for every thread of a grid of blocks
__device__ void scatter(const int* assignment, const int* leader_slot, int P,
                        int S, const int* start, const int* pos,
                        unsigned* list) {
  const long long PS = (long long)P * S;
  const long long nt = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       x < PS; x += nt) {
    const int a = assignment[x];
    if (a < 0) continue;
    const int p = (int)(x / S), s = (int)(x - (long long)p * S);
    list[start[a] + pos[x]] = entry(p, s, s == leader_slot[p]);
  }
}

// the item `it`'s list range [i0, i1) and broker, items of at most ch
__device__ __forceinline__ int item_range(int it, int ch, const int* start,
                                          const int* istart,
                                          const int* ibroker, int* i0,
                                          int* i1) {
  const int b = ibroker[it];
  *i0 = start[b] + (it - istart[b]) * ch;
  *i1 = start[b + 1] < *i0 + ch ? start[b + 1] : *i0 + ch;
  return b;
}

}  // namespace cc_sort

#endif  // CRUISE_CONTROL_BROKER_SORT_CUH_
