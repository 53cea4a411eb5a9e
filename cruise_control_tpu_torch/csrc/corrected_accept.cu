// K15 — the step's exact-conservative stacked cohort
// (`cohort_mode="corrected"`), for Hopper (sm_90a).
//
// What it replaces.  cruise_control_tpu/analyzer/tpu_optimizer.py:2522
// `_corrected_accept` (with :2503 `_seg_excl_prefix`), which the step
// calls at :1310-1314 in place of the water-filling cohort (K4): each
// qualified follower move of the C compacted rows (in score order) is
// accepted iff its delta, re-scored at its destination's and its source's
// segment-prefix state (every earlier qualified row of the same broker
// assumed committed), still clears the improvement tolerance — four
// `broker_cost` evaluations a row, plus the move-size friction and the
// evacuation / rack-fix bonuses — and the stacked state stays under the
// capacity ceiling (+1e-6) and the replica-count ceiling.  With
// `cohort_stack_tol` < 1 a row with a non-empty prefix must also keep
// `corrected <= snap_score · (1 - tol)`.  Plain twin:
// analyzer/corrected_kernel.py: _corrected_accept.
//
// Rounding.  The two exclusive prefixes are the plain twin's exact int64
// fixed-point scans (csrc/seg_prefix.cuh, K4's scan), rounded once to
// f32; the costs come from csrc/broker_cost.cuh (K2's and K6's); every
// other operation is the twin's f32 operation in its order, built without
// FMA contraction.  So `acc` equals the plain twin's bit for bit.  (The
// reference's prefix is an f32 cumsum in XLA's order: on a row that sits
// on a comparison's boundary the two can part; ROADMAP.md §C.)
//
// What bounds it.  It reads the C rows (4·NB + 21 B each), their
// partitions' slots and must-move flags and racks, and the two endpoint
// brokers' tables (~70 B each), and writes C flags: ~0.1 MB at
// C = 1 024, NB = 6 — bound by bytes (~0.03 us at 3.35 TB/s); four broker
// costs (~85 operations each) a row are ~0.35 M operations.  Its real
// limit is the chain of dependent phases: the rows' two stable orders,
// then the two prefixes, each needing every row of the phase before.
//
// What the design does about it: K4's design, one block of 1 024
// threads, few barriers, every table a phase reads again in shared
// memory.
// - Both stable orders, (destination, row) and (source, row), in one
//   buffer of two segments, sorted at once by block_sort.cuh (warp sorts
//   in registers, then merge levels of one barrier each): 6 barriers at
//   C = 1 024, where two bitonic sorts took 2 × 55.  The keys are 32-bit
//   wherever the brokers' ids fit above the row's bits (B < 4 M at
//   C = 1 024): half the shared traffic of the merges' searches.
// - Both exclusive prefixes in one pass of seg_prefix.cuh's register scan
//   (a thread a sorted position in each order, two warps combining the
//   two orders' warp tails): three barriers a chunk of 1 024 rows, where
//   two scans through global memory with a one-thread carry walk took
//   ~16 and the scratch round trips.  The two prefixes share their
//   column scales (the same rows, the same qualified flags), whose maxima
//   fold into the pass that builds the keys.
// - The prefixes, converted to f32, stay in shared memory (80 KB at
//   C = 1 024, NB = 10) for the acceptance, a thread a row.
// Where C is so large that the keys and prefixes pass SMEM_DYN, they go
// to a device scratch the wrapper passes instead.  It reads nothing from
// the host, so it runs inside a captured step chunk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sort.cuh"
#include "broker_cost.cuh"
#include "seg_prefix.cuh"

namespace {

using namespace cc_cost;
using namespace cc_seg;

constexpr int THREADS = 1024;
static_assert(MAX_NB == 2 * NR + 2, "seg_prefix.cuh's widest vector");
static_assert(THREADS / 32 <= MAX_WARPS, "seg_prefix.cuh's scan buffer");

struct Brokers {
  const float* capacity;     // [B, R]
  const float* load;         // [B, R]
  const float* cload;        // [B, R] or null
  const float* leader_nwin;  // [B]
  const float* pot_nwout;    // [B]
  const float* rcount;       // [B]
  const float* lcount;       // [B]
  const int* rack;           // [B]
  const int* assignment;     // [P, S]
  const uint8_t* must_move;  // [P, S]
};

struct Rows {
  const int* cand_p;         // [C]
  const int* cand_s;         // [C]
  const long long* cand_src; // [C]
  const int* d0;             // [C] best destination (>= 0)
  const float* vec;          // [C, NB] move vector
  const uint8_t* qual;       // [C]
  const float* snap;         // [C] at stride snap_stride, or null
  long long snap_stride;
};

// Where K15 keeps its working set: the keys (two segments of n, the
// rows by destination and by source) and the sort's second buffer, then
// the destination and source prefixes f32 [2, C, NB] — in dynamic shared
// memory when they fit under SMEM_DYN, else in the caller's device
// scratch.  A key is (id << shift | row), shift = log2(n): 32-bit keys
// (half the sort's shared traffic and shuffles) wherever every id of B
// brokers fits above the row, else 64-bit keys with shift 32.
constexpr size_t SMEM_DYN = 200000;

struct Layout {
  int n;            // the sort's segment length
  int shift;        // the row's bits in a key
  bool wide;        // 64-bit keys
  size_t bytes;     // keys, second buffer, prefixes
  bool shared;      // in dynamic shared memory (else device scratch)
};

__host__ __device__ inline Layout layout(int C, int NB, int B) {
  Layout l{};
  l.n = 32;
  l.shift = 5;
  while (l.n < C) {
    l.n <<= 1;
    ++l.shift;
  }
  // the largest real key stays below the padding key ~0
  l.wide = (long long)B >= (1LL << (32 - l.shift));
  if (l.wide) l.shift = 32;
  l.bytes = (size_t)4 * l.n * (l.wide ? 8 : 4) + (size_t)8 * C * NB;
  l.shared = l.bytes <= SMEM_DYN;
  return l;
}

__device__ __forceinline__ long long src_of(const Rows& rw, int i) {
  const long long s = rw.cand_src[i];
  return s < 0 ? 0 : s;
}

// one row's acceptance: the plain twin's operations for row i, in order;
// xd / ys are the row's destination and source prefixes
__device__ bool accept_row(const Brokers& m, const Rows& rw, const float* c,
                           const float* t, const float* xd, const float* ys,
                           int i, int S, int NB, float tol, bool guard,
                           float keep) {
  const bool has_cap = m.cload != nullptr;
  const float* v = rw.vec + (size_t)i * NB;
  const int d = rw.d0[i];
  const long long s = src_of(rw, i);
  const float* dcap = m.capacity + (size_t)d * NR;
  const float* scap = m.capacity + (size_t)s * NR;
  float dlo[NR], dhi[NR], slo[NR], shi[NR];
  float dclo[NR], dchi[NR], sclo[NR], schi[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    dlo[r] = m.load[(size_t)d * NR + r] + xd[r];
    dhi[r] = dlo[r] + v[r];
    slo[r] = m.load[(size_t)s * NR + r] - ys[r];
    shi[r] = slo[r] - v[r];
    if (has_cap) {
      const float lc = v[NR + 2 + r];
      dclo[r] = m.cload[(size_t)d * NR + r] + xd[NR + 2 + r];
      dchi[r] = dclo[r] + lc;
      sclo[r] = m.cload[(size_t)s * NR + r] - ys[NR + 2 + r];
      schi[r] = sclo[r] - lc;
    }
  }
  const float n1 = v[NR], pot1 = v[NR + 1];
  const float d_pot = m.pot_nwout[d] + xd[NR + 1];
  const float d_rc = m.rcount[d] + xd[NR];
  const float s_pot = m.pot_nwout[s] - ys[NR + 1];
  const float s_rc = m.rcount[s] - ys[NR];
  const float d_lo = broker_cost(c, t, dcap, dlo, m.leader_nwin[d], d_pot,
                                 d_rc, m.lcount[d], has_cap ? dclo : nullptr);
  const float d_hi =
      broker_cost(c, t, dcap, dhi, m.leader_nwin[d], d_pot + pot1, d_rc + n1,
                  m.lcount[d], has_cap ? dchi : nullptr);
  const float s_lo = broker_cost(c, t, scap, slo, m.leader_nwin[s], s_pot,
                                 s_rc, m.lcount[s], has_cap ? sclo : nullptr);
  const float s_hi =
      broker_cost(c, t, scap, shi, m.leader_nwin[s], s_pot - pot1, s_rc - n1,
                  m.lcount[s], has_cap ? schi : nullptr);

  // row terms: friction, evacuation and rack-repair pressure
  const int p = rw.cand_p[i];
  const int cs_raw = rw.cand_s[i];
  const int cs = cs_raw < 0 ? 0 : (cs_raw > S - 1 ? S - 1 : cs_raw);
  const int* row = m.assignment + (size_t)p * S;
  const int mine = row[cs];
  const int my_rack = mine != -1 ? m.rack[mine < 0 ? 0 : mine] : -1;
  bool rack_viol = false;
  for (int q = 0; q < cs; ++q) {
    const int b = row[q];
    const int rq = b != -1 ? m.rack[b < 0 ? 0 : b] : -1;
    rack_viol = rack_viol || (rq == my_rack && b != -1);
  }
  const bool must = m.must_move[(size_t)p * S + cs] != 0;
  float extra = v[DISK] / t[T_AVG_DISK] * t[T_W_MOVE];
  extra = extra + (must ? EVAC_BONUS : 0.0f);
  extra = extra + (rack_viol ? RACK_FIX_BONUS : 0.0f);
  float corrected = (d_hi - d_lo) + (s_hi - s_lo);
  corrected = corrected + extra;

  // hard ceilings on the stacked state
  bool cap_ok = true;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float stack = has_cap ? dchi[r] : dhi[r];
    cap_ok = cap_ok && stack <= dcap[r] * c[C_THR + r] + 1e-6f;
  }
  const bool rcount_ok = d_rc + 1.0f <= t[T_MAX_REPL];
  bool acc = rw.qual[i] && corrected < tol && cap_ok && rcount_ok;
  if (guard) {
    const bool stacked = (xd[NR] + ys[NR]) > 0.0f;
    acc = acc && (!stacked ||
                  corrected <= rw.snap[(size_t)i * rw.snap_stride] * keep);
  }
  return acc;
}

template <typename K, int NB>
__global__ void __launch_bounds__(THREADS)
corrected_accept_kernel(Brokers m, const float* __restrict__ consts,
                        const float* __restrict__ tconsts, Rows rw, int C,
                        int B, int S, float tol, int guard, float keep,
                        uint8_t* __restrict__ acc, u64* scratch) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ unsigned int mx[MAX_NB];
  __shared__ double sc[MAX_NB];
  __shared__ ScanBuf sbuf[2];
  __shared__ float c[NC], t[NT];
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  CC_STAMP(0);
  const Layout lay = layout(C, NB, B);
  const int n = lay.n, shift = lay.shift;
  K* key = reinterpret_cast<K*>(lay.shared ? smem : scratch);
  K* tmp = key + 2 * n;
  float* xd = reinterpret_cast<float*>(key + 4 * n);
  float* ys = xd + (size_t)C * NB;
  if (tid < NC) c[tid] = consts[tid];
  if (tid < NT) t[tid] = tconsts[tid];
  if (tid < MAX_NB) mx[tid] = 0u;

  // ---- the rows' stable order by destination and by source: keys
  // (id, row) in two segments of n, padded with the largest key; and the
  // qualified rows' column maxima (both prefixes' scales) --------------
  unsigned cmx[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) cmx[k] = 0u;
  for (int x = tid; x < 2 * n; x += nt) {
    const int j = x < n ? x : x - n;
    K k = ~K(0);
    if (j < C) {
      const unsigned id =
          x < n ? (unsigned)rw.d0[j] : (unsigned)src_of(rw, j);
      k = ((K)id << shift) | (K)j;
      if (x < n && rw.qual[j]) {
#pragma unroll
        for (int k2 = 0; k2 < NB; ++k2) {
          cmx[k2] = max(cmx[k2], __float_as_uint(
                                     fabsf(rw.vec[(size_t)j * NB + k2])));
        }
      }
    }
    key[x] = k;
  }
  cc_sort::block_sort(key, tmp, 2 * n, n);
  // (the sort's barriers order mx's zeroing before the atomics)
  publish_max(cmx, mx);
  __syncthreads();
  // the scales in shared memory: the scan holds two positions' sums in
  // registers, and 1 024 threads leave 64 a thread
  if (tid < NB) sc[tid] = fixed_scale(__uint_as_float(mx[tid]), C);
  __syncthreads();
  CC_STAMP(1);

  // ---- both exclusive prefixes: one register scan a sort order --------
  const K* skd = sorted_in_tmp(n) ? tmp : key;
  const K* sk[2] = {skd, skd + n};
  float* out[2] = {xd, ys};
  for (int base = 0, ch = 0; base < C; base += nt, ++ch) {
    const int p = base + tid;
    const bool idle = base + (warp << 5) >= C;
    Seg<NB> s[2];
    int r[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      unsigned id;
      bool head, last;
      position(sk[o], p, C, &r[o], &id, &head, &last, shift);
      const bool f = p < C && rw.qual[r[o]] != 0;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        s[o].v[k] = f ? quant(rw.vec[(size_t)r[o] * NB + k], sc[k]) : 0;
      }
      seg_scan_warp(s[o], head, idle, sbuf[o]);
    }
    __syncthreads();
    if (warp < 2) seg_scan_carries<NB>(sbuf[warp], ch == 0);
    __syncthreads();
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      seg_scan_add(s[o], sbuf[o]);
      if (p < C) {
        // exclusive: the row's own value comes off the inclusive sum
        const bool f = rw.qual[r[o]] != 0;
        float* dst = out[o] + (size_t)r[o] * NB;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const long long q =
              f ? quant(rw.vec[(size_t)r[o] * NB + k], sc[k]) : 0;
          dst[k] = from_fixed_pow2(s[o].v[k] - q, sc[k]);
        }
      }
    }
  }
  __syncthreads();
  CC_STAMP(2);

  // ---- the acceptance, a thread a row --------------------------------
  for (int i = tid; i < C; i += nt) {
    acc[i] = accept_row(m, rw, c, t, xd + (size_t)i * NB,
                        ys + (size_t)i * NB, i, S, NB, tol, guard != 0,
                        keep)
                 ? 1
                 : 0;
  }
  CC_STAMP_SYNC(3);
}

template <typename K, int NB>
cudaError_t set_smem(const Layout& lay) {
  return cudaFuncSetAttribute(corrected_accept_kernel<K, NB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              lay.shared ? (int)lay.bytes : 0);
}

template <typename K, int NB>
cudaError_t launch(const Brokers& m, const float* consts,
                   const float* tconsts, const Rows& rw, int C, int B, int S,
                   float tol, int guard, float keep, uint8_t* acc,
                   void* scratch, cudaStream_t st) {
  const Layout lay = layout(C, NB, B);
  cudaError_t e = set_smem<K, NB>(lay);
  if (e != cudaSuccess) return e;
  corrected_accept_kernel<K, NB>
      <<<1, THREADS, lay.shared ? lay.bytes : 0, st>>>(
          m, consts, tconsts, rw, C, B, S, tol, guard, keep, acc,
          (u64*)scratch);
  return cudaGetLastError();
}

template <typename K, int NB>
cudaError_t kernel_attrs(const Layout& lay, int* out) {
  cudaError_t e = set_smem<K, NB>(lay);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes at;
  if ((e = cudaFuncGetAttributes(&at, corrected_accept_kernel<K, NB>)) !=
      cudaSuccess) {
    return e;
  }
  const size_t smem = lay.shared ? lay.bytes : 0;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, corrected_accept_kernel<K, NB>, THREADS, smem);
  if (e != cudaSuccess) return e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = per_sm;
  return cudaSuccess;
}

// The launch of the key width that C rows over B brokers take (NB dims)
template <int NB>
cudaError_t launch_nb(const Brokers& m, const float* consts,
                      const float* tconsts, const Rows& rw, int C, int B,
                      int S, float tol, int guard, float keep, uint8_t* acc,
                      void* scratch, cudaStream_t st) {
  return layout(C, NB, B).wide
             ? launch<u64, NB>(m, consts, tconsts, rw, C, B, S, tol, guard,
                               keep, acc, scratch, st)
             : launch<unsigned, NB>(m, consts, tconsts, rw, C, B, S, tol,
                                    guard, keep, acc, scratch, st);
}

template <int NB>
cudaError_t attrs_nb(int C, int B, int* out) {
  const Layout lay = layout(C, NB, B);
  return lay.wide ? kernel_attrs<u64, NB>(lay, out)
                  : kernel_attrs<unsigned, NB>(lay, out);
}

}  // namespace

extern "C" {

// {NC, NT, MAX_NB}: the wrapper checks its constant blocks against it.
void corrected_accept_layout(int* out) {
  out[0] = NC;
  out[1] = NT;
  out[2] = MAX_NB;
}

// Bytes of device scratch K15 needs at C rows of NB dims over B brokers:
// 0 when its keys and prefixes fit in shared memory (pass a null
// `scratch`), else theirs.
long long corrected_accept_scratch_bytes(int C, int NB, int B) {
  if (C < 0 || NB < 1 || B < 1) return -1;
  const Layout lay = layout(C, NB, B);
  return lay.shared ? 0 : (long long)lay.bytes;
}

// Launches K15 on `stream` (one block); returns the CUDA error code.
// `guard` applies the stacking guard `corrected <= snap · keep` (keep =
// 1 - cohort_stack_tol); `scratch` is corrected_accept_scratch_bytes(C,
// NB) bytes, 8-byte aligned, or null when that is 0.
int corrected_accept_launch(
    const float* capacity, const float* load, const float* cload,
    const float* leader_nwin, const float* pot_nwout, const float* rcount,
    const float* lcount, const int* rack, const int* assignment,
    const uint8_t* must_move, int S, const float* consts,
    const float* tconsts, const int* cand_p, const int* cand_s,
    const long long* cand_src, const int* d0, const float* vec,
    const uint8_t* qual, const float* snap, long long snap_stride, int C,
    int NB, int B, float tol, int guard, float keep, uint8_t* acc,
    void* scratch, void* stream) {
  const int want_nb = cload ? 2 * NR + 2 : NR + 2;
  if (C < 1 || S < 1 || B < 1 || NB != want_nb ||
      (guard && snap == nullptr) ||
      (corrected_accept_scratch_bytes(C, NB, B) > 0) != (scratch != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Brokers m{capacity, load, cload, leader_nwin, pot_nwout,
            rcount,   lcount, rack, assignment,  must_move};
  Rows rw{cand_p, cand_s, cand_src, d0, vec, qual, snap, snap_stride};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(NB == NR + 2
                   ? launch_nb<NR + 2>(m, consts, tconsts, rw, C, B, S, tol,
                                       guard, keep, acc, scratch, st)
                   : launch_nb<2 * NR + 2>(m, consts, tconsts, rw, C, B, S,
                                           tol, guard, keep, acc, scratch,
                                           st));
}

// K15's resources at C rows, NB dims and B brokers: out = registers,
// local bytes, static and dynamic shared bytes, resident blocks an SM
// (ops/kernels.py: ATTR_KEYS).
int corrected_accept_attrs(int C, int NB, int B, int* out) {
  if (C < 1 || B < 1 || (NB != NR + 2 && NB != 2 * NR + 2)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(NB == NR + 2 ? attrs_nb<NR + 2>(C, B, out)
                            : attrs_nb<2 * NR + 2>(C, B, out));
}

}  // extern "C"
