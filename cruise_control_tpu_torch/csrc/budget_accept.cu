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
// each needing every row of the phase before: one block, and a barrier
// wherever a phase reads what another thread wrote.
//
// What the design does about it: few barriers, no redundant shuffles,
// and every table a phase reads again in shared memory.  One block of
// 1 024 threads, a thread a sorted position (a row a thread at C <= 1 024;
// larger C in chunks, the running sum carried between them).
// - The budgets read each broker's row once (float4 loads issued
//   together, kept in registers at B <= 1 024) and compute the working
//   budgets into shared memory where they fit (48 KB at B = 1 000,
//   NB = 6), copied out in order; the rows' vectors are staged there too.
// - The rows' stable order by destination and by source: both sorts at
//   once, keys (id, row) in one buffer of two segments, by block_sort.cuh
//   (warp sorts in registers, then merge levels of one barrier each):
//   6 barriers at C = 1 024, not 2 × 57 for two bitonic sorts.  A
//   comparison sort, so a hot id (on the 1000b/20k first step all 1 024
//   rows go to 3 destinations) costs nothing extra.
// - A prefix filter is one segmented scan in sorted order: each position
//   quantizes its row in registers, each warp scans 32 positions by
//   shuffles (warps past C skip it), one warp combines the warps' tails
//   into each warp's carry-in (a segmented scan across the lanes), and
//   the position tests its own row against its id's budget — no global
//   q / excl, no one-thread carry walk.  Three barriers a filter.  The
//   shuffles (two a 64-bit value) bound these phases, so no warp repeats
//   another's.
// - Each column's scale needs the max over the rows the phase before
//   passed: that phase folds the max into the pass that sets its flags
//   (warp shuffles, one shared atomic a warp and column).
// - The draw-down: rows are in id order, so an id's accepted sum is the
//   inclusive segmented scan of where(a, vec, 0) at the id's last
//   position; that position subtracts it.  No zero-filled [2, B, NB]
//   table and no global atomics; an id with no row keeps its budgets bit
//   for bit, as w - 0.0 = w in the twin.
// 30 barriers a launch at two rounds (the budgets 4, the sorts 6, a round
// 10), against ~165 before.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sort.cuh"
#include "seg_prefix.cuh"

namespace {

using namespace cc_step;
using namespace cc_seg;

constexpr int NR = 4;            // resources (common/resources.py)
constexpr int NW_OUT = 2;
constexpr int NSUM = 3 * NR;     // budget column sums: load, cap, cap²
constexpr int THREADS = 1024;
static_assert(THREADS / 32 <= MAX_WARPS, "seg_prefix.cuh's scan buffer");
static_assert(MAX_NB == 2 * NR + 2, "seg_prefix.cuh's widest vector");
static_assert(NR == 4, "a broker's row of NR floats is one float4");

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

// One broker's row of the tables, its loads issued together (one round
// trip to memory, not one a column).
struct BrokerRow {
  float4 cap, load, cload;
  float rc, pot;
  bool alive, dest_ok;
};

__device__ __forceinline__ BrokerRow load_row(const Brokers& m, int b) {
  BrokerRow w;
  w.cap = reinterpret_cast<const float4*>(m.capacity)[b];
  w.load = reinterpret_cast<const float4*>(m.load)[b];
  w.cload = m.cload != nullptr ? reinterpret_cast<const float4*>(m.cload)[b]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  w.rc = m.rcount[b];
  w.pot = m.pot_nwout[b];
  w.alive = m.alive[b] != 0;
  w.dest_ok = m.dest_ok[b] != 0;
  return w;
}

__device__ __forceinline__ float comp(const float4& v, int r) {
  return r == 0 ? v.x : (r == 1 ? v.y : (r == 2 ? v.z : v.w));
}

// Column c of the budgets' sums (load, alive capacity, its square; NR
// resources each) of a broker's row.
__device__ __forceinline__ float budget_col(const BrokerRow& w, int c) {
  const int r = c % NR, col = c / NR;
  if (col == 0) return comp(w.load, r);
  const float ac = w.alive ? comp(w.cap, r) : 0.0f;
  return col == 1 ? ac : ac * ac;
}

// analyzer/step_kernels.py: _seg_prefix_fits in one sort order:
// out[r] = row r is in `in` and its inclusive per-id prefix (the
// exclusive segmented sum of where(in, vec, 0), rows in id order, plus
// its own) fits its id's budget in every dim; the column scale comes
// from `mx_in`, the max |vec| over the rows in `in`, and the max over the
// rows it passes goes to `mx_out`.  Three barriers a chunk of 1 024
// positions, one more at the end.
template <int NB>
__device__ void prefix_fits(const u64* sk, const float* vec,
                            const float* budget, const uint8_t* in,
                            uint8_t* out, int C, const unsigned* mx_in,
                            unsigned* mx_out, ScanBuf& sb) {
  const int nt = blockDim.x, warp = threadIdx.x >> 5;
  double sc[NB];
  scales<NB>(mx_in, C, sc);
  unsigned mx[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) mx[c] = 0u;
  for (int base = 0, ch = 0; base < C; base += nt, ++ch) {
    const int p = base + (int)threadIdx.x;
    int r;
    unsigned id;
    bool head, last;
    position(sk, p, C, &r, &id, &head, &last);
    const bool f = p < C && in[r] != 0;
    const float* v = vec + (size_t)r * NB;
    Seg<NB> s;
#pragma unroll
    for (int c = 0; c < NB; ++c) s.v[c] = f ? quant(v[c], sc[c]) : 0;
    seg_scan_warp(s, head, base + (warp << 5) >= C, sb);
    __syncthreads();
    if (warp == 0) seg_scan_carries<NB>(sb, ch == 0);
    __syncthreads();
    seg_scan_add(s, sb);
    if (p < C) {
      // the row's own value comes off the inclusive sum again
      bool ok = f;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const float ev = f ? v[c] : 0.0f;
        const long long q = f ? quant(ev, sc[c]) : 0;
        const float incl = from_fixed_pow2(s.v[c] - q, sc[c]) + ev;
        ok = ok && incl <= budget[(size_t)id * NB + c] + 1e-9f;
      }
      out[r] = ok ? 1 : 0;
      if (ok) {
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          mx[c] = max(mx[c], __float_as_uint(fabsf(v[c])));
        }
      }
    }
  }
  publish_max(mx, mx_out);
  __syncthreads();
}

// The draw-down: budget -= segment_sum(where(a, vec, 0)) at both ends.
// An id's sum is the inclusive segmented scan at its last sorted
// position, in each order; that position subtracts it.  The scale comes
// from `mx_a`, the max |vec| over the accepted rows; two warps find the
// two orders' carries at once.  Ends on a barrier.
template <int NB>
__device__ void draw_down(const u64* skd, const u64* sks, const float* vec,
                          const uint8_t* a, float* wd, float* ws, int C,
                          const unsigned* mx_a, ScanBuf* sb) {
  const int nt = blockDim.x, warp = threadIdx.x >> 5;
  double sc[NB];
  scales<NB>(mx_a, C, sc);
  const u64* sk[2] = {skd, sks};
  float* w[2] = {wd, ws};
  for (int base = 0, ch = 0; base < C; base += nt, ++ch) {
    const int p = base + (int)threadIdx.x;
    const bool idle = base + (warp << 5) >= C;
    Seg<NB> s[2];
    unsigned id[2];
    bool last[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      int r;
      bool head;
      position(sk[o], p, C, &r, &id[o], &head, &last[o]);
      const bool f = p < C && a[r] != 0;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        s[o].v[c] = f ? quant(vec[(size_t)r * NB + c], sc[c]) : 0;
      }
      seg_scan_warp(s[o], head, idle, sb[o]);
    }
    __syncthreads();
    if (warp < 2) seg_scan_carries<NB>(sb[warp], ch == 0);
    __syncthreads();
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      seg_scan_add(s[o], sb[o]);
      if (last[o]) {
        float* row = w[o] + (size_t)id[o] * NB;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          row[c] = row[c] - from_fixed_pow2(s[o].v[c], sc[c]);
        }
      }
    }
  }
  __syncthreads();
}

// The scratch's pointers: keys and the sort's second buffer, the staged
// vectors (vs; vr the copy or `vec`), the working budgets, the flags and
// the two sorted orders.
struct Views {
  u64* key;
  u64* tmp;
  float* vs;
  const float* vr;
  float* wd;
  float* ws;
  uint8_t* elig;
  uint8_t* dok;
  uint8_t* a;
  const u64* skd;
  const u64* sks;
};

// Where K4 keeps its scratch: the keys (two segments of n) and the
// sort's second buffer, a copy of the rows' vectors, the working budgets
// [2, B, NB] and the flags elig, dok, a [C] in dynamic shared memory as
// far as they fit under SMEM_DYN (the budgets only if the rest fits with
// them); else the keys and flags in the caller's device scratch, the
// vectors read in place and the budgets in `work`.
constexpr size_t SMEM_DYN = 200000;

struct Layout {
  int n;                   // the sort's segment length
  size_t vec, bud, flags;  // byte offsets from the keys' start
  size_t smem;             // dynamic shared bytes (0: device scratch)
  size_t scratch;          // device scratch bytes (0: shared memory)
  bool vec_in, bud_in;
};

__host__ __device__ inline Layout layout(int C, int NB, int B) {
  Layout l{};
  l.n = 32;
  while (l.n < C) l.n <<= 1;
  const size_t keys = (size_t)32 * l.n;
  const size_t flags = ((size_t)3 * C + 7) & ~(size_t)7;
  const size_t vec = (size_t)4 * C * NB;
  const size_t bud = (size_t)8 * B * NB;
  if (keys + vec + flags <= SMEM_DYN) {
    l.vec_in = true;
    l.bud_in = keys + vec + bud + flags <= SMEM_DYN;
    l.vec = keys;
    l.bud = keys + vec;
    l.flags = keys + vec + (l.bud_in ? bud : 0);
    l.smem = l.flags + flags;
  } else {
    l.flags = keys;
    l.scratch = keys + flags;
  }
  return l;
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
budget_accept_kernel(Brokers m, float slack, int B,
                     const int* __restrict__ dst_ids,
                     const long long* __restrict__ src_ids,
                     const float* __restrict__ vec,
                     const uint8_t* __restrict__ eligible, int C,
                     int rounds, uint8_t* __restrict__ acc,
                     float* __restrict__ src_budget0,
                     float* __restrict__ dst_budget0, float* work,
                     u64* scratch) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ unsigned int bmax[NSUM];
  __shared__ unsigned long long bsum[NSUM];
  // the column maxima each phase leaves the next: over the eligible rows,
  // the destination filter's and the source filter's survivors
  __shared__ unsigned int mxe[MAX_NB], mxd[MAX_NB], mxa[MAX_NB];
  __shared__ ScanBuf sbuf[2];
  // the scratch's pointers, in shared memory: a phase loads the ones it
  // uses, so none holds registers across the kernel (1 024 threads leave
  // 64 a thread)
  __shared__ Views vw;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const bool has_cap = m.cload != nullptr;
  CC_STAMP(0);
  const Layout lay = layout(C, NB, B);
  const int n = lay.n;
  if (tid == 0) {
    uint8_t* buf = lay.smem > 0 ? (uint8_t*)smem : (uint8_t*)scratch;
    vw.key = (u64*)buf;
    vw.tmp = vw.key + 2 * n;
    vw.vs = lay.vec_in ? (float*)(buf + lay.vec) : nullptr;
    vw.vr = lay.vec_in ? vw.vs : vec;
    vw.wd = lay.bud_in ? (float*)(buf + lay.bud) : work;
    vw.ws = vw.wd + (size_t)B * NB;
    vw.elig = buf + lay.flags;
    vw.dok = vw.elig + C;
    vw.a = vw.dok + C;
    vw.skd = sorted_in_tmp(n) ? vw.tmp : vw.key;
    vw.sks = vw.skd + n;
  }

  // ---- _step_budgets: exact column sums over the B brokers --------------
  if (tid < NSUM) {
    bmax[tid] = 0u;
    bsum[tid] = 0ull;
  }
  if (tid < MAX_NB) mxe[tid] = mxd[tid] = mxa[tid] = 0u;
  // at B <= 1 024 a broker a thread: its row stays in registers
  const bool one = B <= nt;
  BrokerRow own{};
  if (one && tid < B) own = load_row(m, tid);
  {
    unsigned mx[NSUM];
#pragma unroll
    for (int c = 0; c < NSUM; ++c) mx[c] = 0u;
    for (int b = tid; b < B; b += nt) {
      const BrokerRow w = one ? own : load_row(m, b);
#pragma unroll
      for (int c = 0; c < NSUM; ++c) {
        mx[c] = max(mx[c], __float_as_uint(fabsf(budget_col(w, c))));
      }
    }
    warp_max(mx);
    __syncthreads();
    if (lane == 0) {
      for (int c = 0; c < NSUM; ++c) atomicMax(&bmax[c], mx[c]);
    }
  }
  __syncthreads();
  CC_STAMP(1);
  // lane c holds column c's scale; the sums a column at a time
  const double bscale =
      lane < NSUM ? fixed_scale(__uint_as_float(bmax[lane]), B) : 1.0;
#pragma unroll
  for (int c = 0; c < NSUM; ++c) {
    const double sc = __shfl_sync(FULL, bscale, c);
    long long sm = 0;
    for (int b = tid; b < B; b += nt) {
      const BrokerRow w = one ? own : load_row(m, b);
      sm += __double2ll_rn((double)budget_col(w, c) * sc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sm += __shfl_xor_sync(FULL, sm, off);
    }
    if (lane == 0) atomicAdd(&bsum[c], (unsigned long long)sm);
  }
  __syncthreads();
  CC_STAMP(2);
  {
    float avg_u[NR], pivot[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float s_load = from_fixed_pow2(
          (long long)bsum[r], __shfl_sync(FULL, bscale, r));
      const float s_cap = from_fixed_pow2(
          (long long)bsum[NR + r], __shfl_sync(FULL, bscale, NR + r));
      const float s_cap2 = from_fixed_pow2(
          (long long)bsum[2 * NR + r], __shfl_sync(FULL, bscale, 2 * NR + r));
      avg_u[r] = s_load / fmaxf(s_cap, 1e-9f);
      pivot[r] = avg_u[r] * s_cap / fmaxf(s_cap2, 1e-9f);
    }
    float thr[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) thr[r] = m.cap_threshold[r];
    const float avg_rc = m.avg_rcount[0];
    const int soft = NR + 2;
    for (int b = tid; b < B; b += nt) {
      const BrokerRow w = one ? own : load_row(m, b);
      float sbud[MAX_NB], dbud[MAX_NB];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float cap = comp(w.cap, r);
        const float ld = comp(w.load, r);
        const float target = avg_u[r] * cap;
        const float quad = pivot[r] * cap * cap;
        sbud[r] = fmaxf(ld - fmaxf(target, quad), 0.0f);
        dbud[r] = w.dest_ok ? fmaxf(fminf(target, quad) - ld, 0.0f) : 0.0f;
        if (has_cap) {
          sbud[NR + 2 + r] = INFINITY;
          dbud[NR + 2 + r] = fmaxf(thr[r] * cap - comp(w.cload, r), 0.0f);
        }
      }
      sbud[NR] = fmaxf(w.rc - avg_rc, 0.0f);
      dbud[NR] = fmaxf(avg_rc - w.rc, 0.0f);
      const float thr_pot = thr[NW_OUT] * comp(w.cap, NW_OUT);
      const bool above = w.pot >= thr_pot;
      sbud[NR + 1] = above ? w.pot - thr_pot : INFINITY;
      dbud[NR + 1] = above ? INFINITY : thr_pot - w.pot;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float sv = sbud[c], dv = dbud[c];
        if (slack != 1.0f && c < soft) {
          sv = sv * slack;
          dv = dv * slack;
        }
        vw.ws[(size_t)b * NB + c] = sv;
        vw.wd[(size_t)b * NB + c] = dv;
        if (!lay.bud_in) {
          src_budget0[(size_t)b * NB + c] = sv;
          dst_budget0[(size_t)b * NB + c] = dv;
        }
      }
    }
  }
  // the rows' vectors staged in order (coalesced)
  if (lay.vec_in) {
    float* vs = vw.vs;
    for (int x = tid; x < C * NB; x += nt) vs[x] = vec[x];
  }
  __syncthreads();
  CC_STAMP(3);
  // the starting budgets out, from shared memory in order (coalesced)
  if (lay.bud_in) {
    const float* wd = vw.wd;
    const float* ws = vw.ws;
    for (int x = tid; x < B * NB; x += nt) {
      src_budget0[x] = ws[x];
      dst_budget0[x] = wd[x];
    }
  }
  // the flags, and the eligible rows' maxima (the first filter's scales;
  // the sort's barriers come before the filter reads them)
  {
    unsigned mx[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) mx[c] = 0u;
    uint8_t* elig = vw.elig;
    const float* vr = vw.vr;
    for (int i = tid; i < C; i += nt) {
      const uint8_t e = eligible[i];
      elig[i] = e;
      acc[i] = 0;
      if (e) {
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          mx[c] = max(mx[c], __float_as_uint(fabsf(vr[(size_t)i * NB + c])));
        }
      }
    }
    publish_max(mx, mxe);
  }

  // ---- the rows' stable order by destination and by source: keys
  // (id, row) in two segments of n, padded with the largest key ---------
  {
    u64* key = vw.key;
    for (int x = tid; x < 2 * n; x += nt) {
      const int j = x < n ? x : x - n;
      u64 k = ~0ull;
      if (j < C) {
        const unsigned id =
            x < n ? (unsigned)dst_ids[j] : (unsigned)src_ids[j];
        k = ((u64)id << 32) | (unsigned)j;
      }
      key[x] = k;
    }
  }
  // rows by (destination, row) into vw.skd, by (source, row) into vw.sks
  cc_sort::block_sort(vw.key, vw.tmp, 2 * n, n);
  CC_STAMP(4);

  // ---- _budget_accept: `rounds` dst-then-src prefix filters ------------
  for (int round = 0; round < rounds; ++round) {
    prefix_fits<NB>(vw.skd, vw.vr, vw.wd, vw.elig, vw.dok, C, mxe, mxd,
                    sbuf[0]);
    CC_STAMP(5 + 4 * round);
    if (tid < MAX_NB) mxe[tid] = 0u;
    prefix_fits<NB>(vw.sks, vw.vr, vw.ws, vw.dok, vw.a, C, mxd, mxa,
                    sbuf[1]);
    CC_STAMP(6 + 4 * round);
    if (tid < MAX_NB) mxd[tid] = 0u;
    draw_down<NB>(vw.skd, vw.sks, vw.vr, vw.a, vw.wd, vw.ws, C, mxa, sbuf);
    CC_STAMP(7 + 4 * round);
    if (tid < MAX_NB) mxa[tid] = 0u;
    // rows that no longer fit on their own drop out; the rest's maxima
    // are the next round's first scales
    unsigned mx[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) mx[c] = 0u;
    const uint8_t* a = vw.a;
    uint8_t* elig = vw.elig;
    const float* vr = vw.vr;
    const float* wd = vw.wd;
    const float* ws = vw.ws;
    for (int i = tid; i < C; i += nt) {
      const uint8_t ai = a[i];
      acc[i] |= ai;
      bool e = elig[i] && !ai;
      const size_t od = (size_t)dst_ids[i] * NB, os = (size_t)src_ids[i] * NB;
      float v[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        v[c] = vr[(size_t)i * NB + c];
        e = e && v[c] <= wd[od + c] + 1e-9f && v[c] <= ws[os + c] + 1e-9f;
      }
      elig[i] = e ? 1 : 0;
      if (e) {
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          mx[c] = max(mx[c], __float_as_uint(fabsf(v[c])));
        }
      }
    }
    publish_max(mx, mxe);
    __syncthreads();
    CC_STAMP(8 + 4 * round);
  }
}

template <int NB>
cudaError_t kernel_attrs(size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      budget_accept_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes at;
  if ((e = cudaFuncGetAttributes(&at, budget_accept_kernel<NB>)) !=
      cudaSuccess) {
    return e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, budget_accept_kernel<NB>, THREADS, smem);
  if (e != cudaSuccess) return e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = per_sm;
  return cudaSuccess;
}

template <int NB>
cudaError_t launch(const Brokers& m, float slack, int B, const int* dst_ids,
                   const long long* src_ids, const float* vec,
                   const uint8_t* eligible, int C, int rounds, uint8_t* acc,
                   float* src_budget0, float* dst_budget0, float* work,
                   void* scratch, cudaStream_t stream) {
  const size_t smem = layout(C, NB, B).smem;
  cudaError_t e = cudaFuncSetAttribute(
      budget_accept_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  budget_accept_kernel<NB><<<1, THREADS, smem, stream>>>(
      m, slack, B, dst_ids, src_ids, vec, eligible, C, rounds, acc,
      src_budget0, dst_budget0, work, (u64*)scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device scratch K4 needs at C rows of NB budget dims: 0 when
// its keys, the rows' vectors and its flags fit in shared memory (pass a
// null `scratch`), else the keys' and flags' bytes.
long long budget_accept_scratch_bytes(int C, int NB) {
  return C < 0 ? -1 : (long long)layout(C, NB, 1).scratch;
}

// Launches K4 on `stream` (one block); returns the CUDA error code.
// Scratch: work f32 [2, B, NB] (the working budgets, where they do not
// fit in shared memory); `scratch` of budget_accept_scratch_bytes(C, NB),
// 8-byte aligned, or null when that is 0.
int budget_accept_launch(const float* capacity, const float* load,
                         const float* cload, const float* rcount,
                         const float* pot_nwout, const uint8_t* alive,
                         const uint8_t* dest_ok, const float* cap_threshold,
                         const float* avg_rcount, float slack, int B,
                         const int* dst_ids, const long long* src_ids,
                         const float* vec, const uint8_t* eligible, int C,
                         int NB, int rounds, uint8_t* acc,
                         float* src_budget0, float* dst_budget0, float* work,
                         void* scratch, void* stream) {
  const int want_nb = cload ? 2 * NR + 2 : NR + 2;
  // the [B, NR] tables are read a row (16 bytes) at a time
  const uintptr_t rows = (uintptr_t)capacity | (uintptr_t)load |
                         (uintptr_t)(cload ? cload : capacity);
  if (B < 1 || C < 0 || NB != want_nb || rounds < 0 || rows % 16 != 0 ||
      (layout(C, NB, B).scratch > 0) != (scratch != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Brokers m{capacity, load,    cload,         rcount,    pot_nwout,
            alive,    dest_ok, cap_threshold, avg_rcount};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(NB == NR + 2
                   ? launch<NR + 2>(m, slack, B, dst_ids, src_ids, vec,
                                    eligible, C, rounds, acc, src_budget0,
                                    dst_budget0, work, scratch, st)
                   : launch<2 * NR + 2>(m, slack, B, dst_ids, src_ids, vec,
                                        eligible, C, rounds, acc,
                                        src_budget0, dst_budget0, work,
                                        scratch, st));
}

// K4's resources at B brokers, C rows and NB budget dims: out =
// registers, local bytes, static and dynamic shared bytes, resident
// blocks an SM (ops/kernels.py: ATTR_KEYS).
int budget_accept_attrs(int B, int C, int NB, int* out) {
  if (B < 1 || C < 0 || (NB != NR + 2 && NB != 2 * NR + 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = layout(C, NB, B).smem;
  return (int)(NB == NR + 2 ? kernel_attrs<NR + 2>(smem, out)
                            : kernel_attrs<2 * NR + 2>(smem, out));
}

}  // extern "C"
