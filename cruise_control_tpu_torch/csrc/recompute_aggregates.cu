// K9 — the full rebuild of the per-broker aggregates from the placement,
// for Hopper (sm_90a).
//
// What it replaces.  cruise_control_tpu/analyzer/tpu_optimizer.py:444
// `_recompute_aggregates`: over every replica slot of the [P, S]
// placement, the segment sums by hosting broker of the slot's load (the
// leader's or a follower's row), its potential NW-out (the partition
// leader's NW-out, on every replica) and its capacity-estimate load, the
// replica count, and over the P partitions the leader count and
// leader NW-in by leading broker.  The search runs it when it uploads the
// model and after every host-side resync.  The eager port ran it as ~40
// torch ops over [P, S, R] temporaries.
//
// Exactness.  The plain twin (analyzer/commit_kernels.py:
// _recompute_aggregates) sums floats through ops/segment.py: each column
// is scaled by 2^(60 - e), e = frexp-exponent of the column's exact max
// |v| over all its N rows (empty slots count, as zeros; N = P·S for the
// slot columns and P for leader NW-in, partitions without a leader
// included) plus ceil(log2 N), rounded half to even to int64, summed, and
// scaled back once to f32.  Here a first pass takes the exact column
// maxima (an unsigned atomicMax on the bits of |v|, whose order is the
// float order), a second sums the int64 fixed-point values with atomics
// (exact and order free), a third scales back: the result equals the
// plain twin's bit for bit.  Counts are integer sums.
//
// What bounds it.  It reads the placement (8 B a slot with the leader
// slot) and the partitions' load rows (2R or 4R floats) twice and writes
// B·(2R+4) floats: at P·S = 60 000 slots, P = 20 000 ~1 MB a pass — bound
// by bytes (~0.3 us a pass at 3.35 TB/s); at the north-star P·S = 3 M,
// ~50 MB.  The atomics into B brokers are the likely limit where a few
// brokers host many slots.
//
// What the design does about it.  Three grid-stride launches (maxima,
// sums, scale-back) from one host call, each over the slots with every
// thread reducing its own maxima in registers and a warp shuffle before
// one atomic a warp; the sums go straight to a [B, cols] int64 scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_step;

constexpr int THREADS = 256;
constexpr int NR = 4;              // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int NW_OUT = 2;
constexpr unsigned FULL = 0xffffffffu;
// column layout of the maxima and the sums: load [R], potential NW-out,
// leader NW-in, capacity-estimate load [R]; then the two counts
constexpr int COL_POT = NR, COL_LNWIN = NR + 1, COL_CLOAD = NR + 2;
constexpr int MAX_COL = 2 * NR + 2;
constexpr int CNT_R = MAX_COL, CNT_L = MAX_COL + 1, SUMS = MAX_COL + 2;

struct Model {
  const int* assignment;       // [P, S]
  const int* leader_slot;      // [P]
  const float* leader_load;    // [P, R]
  const float* follower_load;  // [P, R]
  const float* leader_cload;   // [P, R] or null
  const float* follower_cload; // [P, R] or null
};

// the slot's load row and capacity-estimate load row (null if empty)
struct Slot {
  int broker;
  const float* load;
  const float* cload;
  float pot;
};

__device__ __forceinline__ Slot slot_of(const Model& m, int p, int s,
                                        int S) {
  Slot r;
  r.broker = m.assignment[(size_t)p * S + s];
  const bool lead = s == m.leader_slot[p];
  r.load = (lead ? m.leader_load : m.follower_load) + (size_t)p * NR;
  r.cload = m.leader_cload == nullptr
                ? nullptr
                : (lead ? m.leader_cload : m.follower_cload) + (size_t)p * NR;
  r.pot = m.leader_load[(size_t)p * NR + NW_OUT];
  return r;
}

// PHASE 0: column maxima; 1: fixed-point sums; 2: scale back
template <int PHASE>
__global__ void __launch_bounds__(THREADS)
recompute_aggregates_kernel(Model m, int P, int S, int B,
                            unsigned* __restrict__ colmax,
                            long long* __restrict__ sums,
                            float* __restrict__ load,
                            float* __restrict__ rcount,
                            float* __restrict__ lcount,
                            float* __restrict__ leader_nwin,
                            float* __restrict__ pot_nwout,
                            float* __restrict__ cload) {
  const bool has_cap = m.leader_cload != nullptr;
  const long long n_slots = (long long)P * S;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (PHASE == 2) {
    double sc[MAX_COL];
    for (int c = 0; c < MAX_COL; ++c) {
      sc[c] = fixed_scale(__uint_as_float(colmax[c]),
                          c == COL_LNWIN ? (long long)P : n_slots);
    }
    for (long long b = first; b < B; b += stride) {
      const long long* a = sums + b * SUMS;
      for (int r = 0; r < NR; ++r) {
        load[b * NR + r] = __double2float_rn((double)a[r] / sc[r]);
        if (has_cap) {
          cload[b * NR + r] =
              __double2float_rn((double)a[COL_CLOAD + r] / sc[COL_CLOAD + r]);
        }
      }
      pot_nwout[b] = __double2float_rn((double)a[COL_POT] / sc[COL_POT]);
      leader_nwin[b] =
          __double2float_rn((double)a[COL_LNWIN] / sc[COL_LNWIN]);
      rcount[b] = (float)a[CNT_R];
      lcount[b] = (float)a[CNT_L];
    }
    return;
  }
  if (PHASE == 0) {
    unsigned mx[MAX_COL];
    for (int c = 0; c < MAX_COL; ++c) mx[c] = 0u;
    for (long long x = first; x < n_slots; x += stride) {
      const int p = (int)(x / S), s = (int)(x % S);
      const Slot sl = slot_of(m, p, s, S);
      if (sl.broker != -1) {
        for (int r = 0; r < NR; ++r) {
          mx[r] = max(mx[r], __float_as_uint(fabsf(sl.load[r])));
          if (has_cap) {
            mx[COL_CLOAD + r] =
                max(mx[COL_CLOAD + r], __float_as_uint(fabsf(sl.cload[r])));
          }
        }
        mx[COL_POT] = max(mx[COL_POT], __float_as_uint(fabsf(sl.pot)));
      }
      if (s == 0) {
        // every partition's leader NW-in counts, led by a broker or not
        mx[COL_LNWIN] =
            max(mx[COL_LNWIN],
                __float_as_uint(fabsf(m.leader_load[(size_t)p * NR + NW_IN])));
      }
    }
    for (int c = 0; c < MAX_COL; ++c) {
      for (int off = 16; off > 0; off >>= 1) {
        mx[c] = max(mx[c], __shfl_xor_sync(FULL, mx[c], off));
      }
    }
    if ((threadIdx.x & 31) == 0) {
      for (int c = 0; c < MAX_COL; ++c) atomicMax(&colmax[c], mx[c]);
    }
    return;
  }
  // PHASE 1: the int64 fixed-point sums, by hosting / leading broker
  double sc[MAX_COL];
  for (int c = 0; c < MAX_COL; ++c) {
    sc[c] = fixed_scale(__uint_as_float(colmax[c]),
                        c == COL_LNWIN ? (long long)P : n_slots);
  }
  for (long long x = first; x < n_slots; x += stride) {
    const int p = (int)(x / S), s = (int)(x % S);
    const Slot sl = slot_of(m, p, s, S);
    if (sl.broker >= 0) {
      unsigned long long* a = (unsigned long long*)(sums + (long long)sl.broker * SUMS);
      for (int r = 0; r < NR; ++r) {
        atomicAdd(&a[r], (unsigned long long)__double2ll_rn(
                             (double)sl.load[r] * sc[r]));
        if (has_cap) {
          atomicAdd(&a[COL_CLOAD + r],
                    (unsigned long long)__double2ll_rn(
                        (double)sl.cload[r] * sc[COL_CLOAD + r]));
        }
      }
      atomicAdd(&a[COL_POT], (unsigned long long)__double2ll_rn(
                                 (double)sl.pot * sc[COL_POT]));
      atomicAdd(&a[CNT_R], 1ull);
    }
    if (s == 0) {
      const int lb = m.assignment[(size_t)p * S + m.leader_slot[p]];
      if (lb >= 0) {
        unsigned long long* a = (unsigned long long*)(sums + (long long)lb * SUMS);
        atomicAdd(&a[COL_LNWIN],
                  (unsigned long long)__double2ll_rn(
                      (double)m.leader_load[(size_t)p * NR + NW_IN] *
                      sc[COL_LNWIN]));
        atomicAdd(&a[CNT_L], 1ull);
      }
    }
  }
}

}  // namespace

extern "C" {

// int64 words of the sums scratch for B brokers
long long recompute_aggregates_sums_words(int B) {
  return (long long)B * SUMS;
}

// Launches K9's three passes on `stream` with `grid` blocks each; `colmax`
// is a [2R + 2] u32 scratch and `sums` a [B, 2R + 4] int64 scratch (both
// zeroed here).  Returns the CUDA error code.
int recompute_aggregates_launch(const int* assignment, const int* leader_slot,
                                const float* leader_load,
                                const float* follower_load,
                                const float* leader_cload,
                                const float* follower_cload, int P, int S,
                                int B, int grid, unsigned* colmax,
                                long long* sums, float* load, float* rcount,
                                float* lcount, float* leader_nwin,
                                float* pot_nwout, float* cload,
                                void* stream) {
  if (P < 1 || S < 1 || B < 1 || grid < 1 ||
      (leader_cload == nullptr) != (follower_cload == nullptr) ||
      (leader_cload == nullptr) != (cload == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  Model m{assignment, leader_slot, leader_load, follower_load, leader_cload,
          follower_cload};
  cudaError_t e = cudaMemsetAsync(colmax, 0, MAX_COL * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(sums, 0, (size_t)B * SUMS * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  recompute_aggregates_kernel<0><<<grid, THREADS, 0, st>>>(
      m, P, S, B, colmax, sums, load, rcount, lcount, leader_nwin, pot_nwout,
      cload);
  recompute_aggregates_kernel<1><<<grid, THREADS, 0, st>>>(
      m, P, S, B, colmax, sums, load, rcount, lcount, leader_nwin, pot_nwout,
      cload);
  recompute_aggregates_kernel<2><<<grid, THREADS, 0, st>>>(
      m, P, S, B, colmax, sums, load, rcount, lcount, leader_nwin, pot_nwout,
      cload);
  return (int)cudaGetLastError();
}

}  // extern "C"
