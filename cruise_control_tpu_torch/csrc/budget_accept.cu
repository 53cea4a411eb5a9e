// K4 — the step's budgeted cohort: water-filling budgets and two rounds of
// segmented-prefix acceptance, for Hopper (sm_90a).
//
// What it replaces.  cruise_control_tpu/analyzer/tpu_optimizer.py:2411
// `_step_budgets` (per-broker [B, NB] move budgets from the cluster's
// average and capacity-weighted utilization), :2503 `_seg_excl_prefix`
// (each candidate row's exclusive prefix sum of its move vector over the
// earlier rows of the same broker, in score order), :2630
// `_seg_prefix_fits` and :2653 `_budget_accept` (a destination-prefix
// filter, then a source-prefix filter over its survivors; accepted rows
// draw both budgets down; two rounds), with `cohort_budget_slack`
// applied to the soft dims as `_scan_call` does.  The eager port ran it as
// ~150 launches a step, among them the int64 column scans that were the
// plan's top device-time kernel.
//
// Exactness.  The plain twin sums floats in int64 fixed point
// (ops/segment.py): a column is scaled by 2^(60 - e), rounded half to
// even, summed as integers (so in any order) and scaled back once.  The
// exponent e must come out the same here as there, and a float sum of
// magnitudes would depend on its order; so both sides take
// e = frexp-exponent(max |v|) + ceil(log2 N) over the column's N rows —
// an exact max and an integer, the same on every device — which bounds
// the column's total magnitude by 2^e.  Every other operation is an f32
// or f64 IEEE operation in the plain twin's order (built without FMA
// contraction), so `acc` equals the plain twin's bit for bit.
//
// What bounds it.  It reads the broker tables (~40 B a broker) and the C
// candidate rows (4·NB + 13 B each) and writes C flags and two [B, NB]
// budget tables: ~0.1 MB at B = 1 000, C = 1 024, NB = 6 — bound by bytes
// (~0.03 us at 3.35 TB/s).  Its real limit is the chain of dependent
// phases (budgets, then per round two prefix filters and a draw-down),
// each needing every row of the phase before.
//
// What the design does about it.  One block of 1 024 threads runs the
// whole chain in one launch, with block barriers between the phases.
// The segmented exclusive prefix (csrc/seg_prefix.cuh, shared with K15)
// sorts the rows once per id kind (destination, source) by the unique key
// (id, row) — a bitonic sort in shared memory, the stable order the plain
// twin's argsort gives — and then scans in that order: each warp scans a
// chunk of 32 sorted rows with shuffles, one thread carries each
// segment's running sum across chunks, and rows whose segment began in an
// earlier chunk add the carry.  That is O(C log² C) however the rows fall into segments; a
// row-parallel O(C²) version was 0.8 ms a launch because destinations
// are skewed (on the 1000b/20k first step, 926 of 1 024 rows share one
// destination).  Column maxima and the budget column sums are reduced in
// registers, then across each warp by shuffles, then with one shared
// atomic per warp and column (integer, so exact and order free); the
// per-broker draw-down is an int64 atomicAdd into a scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "seg_prefix.cuh"

namespace {

using namespace cc_step;
using namespace cc_seg;

constexpr int NR = 4;            // resources (common/resources.py)
constexpr int NW_OUT = 2;
constexpr int NSUM = 3 * NR;     // budget column sums: load, cap, cap²
constexpr int THREADS = 1024;
static_assert(MAX_NB == 2 * NR + 2, "seg_prefix.cuh's widest vector");

// analyzer/step_kernels.py: _seg_prefix_fits — out[i] = row i is in `in`
// and its inclusive per-id prefix (seg_excl_prefix, csrc/seg_prefix.cuh)
// fits the id's budget in every dim.  Scratch as seg_excl_prefix's, and
// excl [C, NB].
template <typename I>
__device__ void prefix_fits(const I* ids, const int* order, const float* vec,
                            const float* budget, const uint8_t* in,
                            uint8_t* out, long long* q, long long* excl,
                            long long* chunk, uint8_t* carried, int C,
                            int NB, unsigned int* smax, double* sscale) {
  const int tid = threadIdx.x, nt = blockDim.x;
  seg_excl_prefix(ids, order, vec, in, q, excl, chunk, carried, C, NB, smax,
                  sscale);
  for (int i = tid; i < C; i += nt) {
    const long long id = (long long)ids[i];
    bool ok = in[i] != 0;
#pragma unroll
    for (int c = 0; c < MAX_NB; ++c) {
      if (c < NB) {
        const float ev = in[i] ? vec[(size_t)i * NB + c] : 0.0f;
        const float incl =
            from_fixed(excl[(size_t)i * NB + c], sscale[c]) + ev;
        ok = ok && incl <= budget[id * NB + c] + 1e-9f;
      }
    }
    out[i] = ok ? 1 : 0;
  }
  __syncthreads();
}

struct Brokers {
  const float* capacity;       // [B, R]
  const float* load;           // [B, R]
  const float* cload;          // [B, R] or null
  const float* rcount;         // [B]
  const float* pot_nwout;      // [B]
  const uint8_t* alive;        // [B]
  const uint8_t* dest_ok;      // [B]
  const float* cap_threshold;  // [R]
  const float* avg_rcount;     // [1]
};

__device__ __forceinline__ float budget_col(const Brokers& m, int b, int r,
                                            int col) {
  const float cap = m.capacity[(size_t)b * NR + r];
  if (col == 0) return m.load[(size_t)b * NR + r];
  const float ac = m.alive[b] ? cap : 0.0f;
  return col == 1 ? ac : ac * ac;
}

struct Scratch {
  float* work;                // [2, B, NB] working budgets (dst, src)
  long long* accum;           // [2, B, NB] draw-down sums (dst, src)
  long long* q;               // [C, NB] quantized rows
  long long* excl;            // [C, NB] exclusive prefixes
  long long* chunk;           // [ceil(C / 32), NB + 1] chunk carries
  int* order;                 // [2, C] rows sorted by (dst id, row), (src id, row)
  unsigned long long* key;    // [n2] sort keys, or null: in shared memory
  uint8_t* flags;             // [4, C] elig, dok, a, carried
};

__global__ void __launch_bounds__(THREADS)
budget_accept_kernel(Brokers m, float slack, int B,
                     const int* __restrict__ dst_ids,
                     const long long* __restrict__ src_ids,
                     const float* __restrict__ vec,
                     const uint8_t* __restrict__ eligible, int C, int NB,
                     int n2, int rounds, uint8_t* __restrict__ acc,
                     float* __restrict__ src_budget0,
                     float* __restrict__ dst_budget0, Scratch sc) {
  extern __shared__ unsigned long long skey[];
  __shared__ unsigned int smax[NSUM];
  __shared__ double sscale[NSUM];
  __shared__ unsigned long long ssum[NSUM];
  __shared__ float avg_u[NR], pivot[NR];
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool has_cap = m.cload != nullptr;

  // ---- _step_budgets: exact column sums over the B brokers --------------
  if (tid < NSUM) {
    smax[tid] = 0u;
    ssum[tid] = 0ull;
  }
  {
    unsigned mx[NSUM];
#pragma unroll
    for (int c = 0; c < NSUM; ++c) mx[c] = 0u;
    for (int b = tid; b < B; b += nt) {
#pragma unroll
      for (int c = 0; c < NSUM; ++c) {
        mx[c] = max(mx[c],
                    __float_as_uint(fabsf(budget_col(m, b, c % NR, c / NR))));
      }
    }
    warp_max(mx);
    __syncthreads();
    if ((tid & 31) == 0) {
      for (int c = 0; c < NSUM; ++c) atomicMax(&smax[c], mx[c]);
    }
    __syncthreads();
    if (tid < NSUM) sscale[tid] = fixed_scale(__uint_as_float(smax[tid]), B);
    __syncthreads();
    long long sm[NSUM];
#pragma unroll
    for (int c = 0; c < NSUM; ++c) sm[c] = 0;
    for (int b = tid; b < B; b += nt) {
#pragma unroll
      for (int c = 0; c < NSUM; ++c) {
        sm[c] += __double2ll_rn((double)budget_col(m, b, c % NR, c / NR) *
                                sscale[c]);
      }
    }
    warp_sum(sm);
    if ((tid & 31) == 0) {
      for (int c = 0; c < NSUM; ++c) {
        atomicAdd(&ssum[c], (unsigned long long)sm[c]);
      }
    }
    __syncthreads();
  }
  if (tid < NR) {
    const float s_load = from_fixed((long long)ssum[tid], sscale[tid]);
    const float s_cap =
        from_fixed((long long)ssum[NR + tid], sscale[NR + tid]);
    const float s_cap2 =
        from_fixed((long long)ssum[2 * NR + tid], sscale[2 * NR + tid]);
    avg_u[tid] = s_load / fmaxf(s_cap, 1e-9f);
    pivot[tid] = avg_u[tid] * s_cap / fmaxf(s_cap2, 1e-9f);
  }
  __syncthreads();
  float* wd = sc.work;                     // [B, NB] destination budgets
  float* ws = sc.work + (size_t)B * NB;    // [B, NB] source budgets
  const float avg_rc = m.avg_rcount[0];
  const int soft = NR + 2;
  for (int b = tid; b < B; b += nt) {
    float sbud[MAX_NB], dbud[MAX_NB];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float cap = m.capacity[(size_t)b * NR + r];
      const float ld = m.load[(size_t)b * NR + r];
      const float target = avg_u[r] * cap;
      const float quad = pivot[r] * cap * cap;
      sbud[r] = fmaxf(ld - fmaxf(target, quad), 0.0f);
      dbud[r] = m.dest_ok[b] ? fmaxf(fminf(target, quad) - ld, 0.0f) : 0.0f;
      if (has_cap) {
        sbud[NR + 2 + r] = INFINITY;
        dbud[NR + 2 + r] = fmaxf(
            m.cap_threshold[r] * cap - m.cload[(size_t)b * NR + r], 0.0f);
      }
    }
    const float rc = m.rcount[b];
    sbud[NR] = fmaxf(rc - avg_rc, 0.0f);
    dbud[NR] = fmaxf(avg_rc - rc, 0.0f);
    const float pot = m.pot_nwout[b];
    const float thr_pot =
        m.cap_threshold[NW_OUT] * m.capacity[(size_t)b * NR + NW_OUT];
    const bool above = pot >= thr_pot;
    sbud[NR + 1] = above ? pot - thr_pot : INFINITY;
    dbud[NR + 1] = above ? INFINITY : thr_pot - pot;
#pragma unroll
    for (int c = 0; c < MAX_NB; ++c) {
      if (c < NB) {
        float sv = sbud[c], dv = dbud[c];
        if (slack != 1.0f && c < soft) {
          sv = sv * slack;
          dv = dv * slack;
        }
        ws[(size_t)b * NB + c] = src_budget0[(size_t)b * NB + c] = sv;
        wd[(size_t)b * NB + c] = dst_budget0[(size_t)b * NB + c] = dv;
      }
    }
  }
  uint8_t* elig = sc.flags;
  uint8_t* dok = sc.flags + C;
  uint8_t* a = sc.flags + 2 * C;
  uint8_t* carried = sc.flags + 3 * C;
  for (int i = tid; i < C; i += nt) {
    elig[i] = eligible[i];
    acc[i] = 0;
  }
  // ---- the rows' stable order by destination and by source -------------
  unsigned long long* key = sc.key ? sc.key : skey;
  const int* order_d = sc.order;
  const int* order_s = sc.order + C;
  sort_rows(dst_ids, C, n2, key, sc.order);
  sort_rows(src_ids, C, n2, key, sc.order + C);

  // ---- _budget_accept: `rounds` dst-then-src prefix filters ------------
  long long* accum = sc.accum;
  long long* acc_d = accum;                     // [B, NB]
  long long* acc_s = accum + (size_t)B * NB;    // [B, NB]
  for (int round = 0; round < rounds; ++round) {
    prefix_fits(dst_ids, order_d, vec, wd, elig, dok, sc.q, sc.excl,
                sc.chunk, carried, C, NB, smax, sscale);
    prefix_fits(src_ids, order_s, vec, ws, dok, a, sc.q, sc.excl, sc.chunk,
                carried, C, NB, smax, sscale);
    // draw-down: budget -= segment_sum(where(a, vec, 0)) at both ends
    for (int x = tid; x < 2 * B * NB; x += nt) accum[x] = 0;
    for (int i = tid; i < C; i += nt) acc[i] |= a[i];
    column_scales(vec, a, C, NB, smax, sscale);
    for (int x = tid; x < C * NB; x += nt) {
      const int i = x / NB, c = x % NB;
      if (a[i]) {
        const unsigned long long v = (unsigned long long)__double2ll_rn(
            (double)vec[x] * sscale[c]);
        atomicAdd((unsigned long long*)&acc_d[(size_t)dst_ids[i] * NB + c],
                  v);
        atomicAdd((unsigned long long*)&acc_s[(size_t)src_ids[i] * NB + c],
                  v);
      }
    }
    __syncthreads();
    for (int x = tid; x < B * NB; x += nt) {
      const double sc = sscale[x % NB];
      wd[x] = wd[x] - from_fixed(acc_d[x], sc);
      ws[x] = ws[x] - from_fixed(acc_s[x], sc);
    }
    __syncthreads();
    for (int i = tid; i < C; i += nt) {
      bool e = elig[i] && !a[i];
      const size_t od = (size_t)dst_ids[i] * NB, os = (size_t)src_ids[i] * NB;
#pragma unroll
      for (int c = 0; c < MAX_NB; ++c) {
        if (c < NB) {
          const float v = vec[(size_t)i * NB + c];
          e = e && v <= wd[od + c] + 1e-9f && v <= ws[os + c] + 1e-9f;
        }
      }
      elig[i] = e ? 1 : 0;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches K4 on `stream` (one block); returns the CUDA error code.
// `n2` is the smallest power of two >= C.  Scratch (see Scratch): work
// f32 [2, B, NB]; accum i64 [2, B, NB]; q, excl i64 [C, NB]; chunk i64
// [ceil(C / 32), NB + 1]; order i32 [2, C]; key u64 [n2], or null to sort
// in n2 · 8 bytes of shared memory; flags u8 [4, C].
int budget_accept_launch(const float* capacity, const float* load,
                         const float* cload, const float* rcount,
                         const float* pot_nwout, const uint8_t* alive,
                         const uint8_t* dest_ok, const float* cap_threshold,
                         const float* avg_rcount, float slack, int B,
                         const int* dst_ids, const long long* src_ids,
                         const float* vec, const uint8_t* eligible, int C,
                         int NB, int n2, int rounds, uint8_t* acc,
                         float* src_budget0, float* dst_budget0, float* work,
                         long long* accum, long long* q, long long* excl,
                         long long* chunk, int* order,
                         unsigned long long* key, uint8_t* flags,
                         void* stream) {
  const int want_nb = cload ? 2 * NR + 2 : NR + 2;
  if (B < 1 || C < 0 || NB != want_nb || rounds < 0 || n2 < C ||
      (n2 & (n2 - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = key == nullptr ? n2 * (int)sizeof(unsigned long long) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      budget_accept_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  Brokers m{capacity, load,    cload,         rcount,    pot_nwout,
            alive,    dest_ok, cap_threshold, avg_rcount};
  Scratch sc{work, accum, q, excl, chunk, order, key, flags};
  budget_accept_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      m, slack, B, dst_ids, src_ids, vec, eligible, C, NB, n2, rounds, acc,
      src_budget0, dst_budget0, sc);
  return (int)cudaGetLastError();
}

}  // extern "C"
