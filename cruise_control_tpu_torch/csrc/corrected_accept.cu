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
// fixed-point scans (csrc/seg_prefix.cuh, K4's code), rounded once to f32;
// the costs come from csrc/broker_cost.cuh (K2's and K6's); every other
// operation is the twin's f32 operation in its order, built without FMA
// contraction.  So `acc` equals the plain twin's bit for bit.  (The
// reference's prefix is an f32 cumsum in XLA's order: on a row that sits
// on a comparison's boundary the two can part; ROADMAP.md §C.)
//
// What bounds it.  It reads the C rows (4·NB + 21 B each), their
// partitions' slots and must-move flags and racks, and the two endpoint
// brokers' tables (~70 B each), and writes C flags: ~0.1 MB at
// C = 1 024, NB = 6 — bound by bytes (~0.03 us at 3.35 TB/s); four broker
// costs (~85 operations each) a row are ~0.35 M operations.  Its real
// limit is the chain of dependent phases: two sorts and two scans, each
// needing every row of the phase before.
//
// What the design does about it.  One block of 1 024 threads runs the
// whole chain in one launch with block barriers between the phases, as
// K4 does: the rows sorted by (destination, row) and by (source, row), one
// exclusive segmented scan each (converted to f32 into a scratch), then
// one thread a row for the costs and the ceilings.  It reads nothing from
// the host, so it runs inside a captured step chunk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "broker_cost.cuh"
#include "seg_prefix.cuh"

namespace {

using namespace cc_cost;
using namespace cc_seg;

constexpr int THREADS = 1024;
static_assert(MAX_NB == 2 * NR + 2, "seg_prefix.cuh's widest vector");

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

struct Scratch {
  long long* srcc;            // [C] sources clipped at 0
  long long* q;               // [C, NB] quantized rows
  long long* excl;            // [C, NB] exclusive prefixes (fixed point)
  long long* chunk;           // [ceil(C / 32), NB + 1] chunk carries
  int* order;                 // [2, C] rows by (d0, row), (source, row)
  unsigned long long* key;    // [n2] sort keys, or null: in shared memory
  uint8_t* carried;           // [C]
  float* xd;                  // [C, NB] destination prefixes
  float* ys;                  // [C, NB] source prefixes
};

// one row's acceptance: the plain twin's operations for row i, in order
__device__ bool accept_row(const Brokers& m, const Rows& rw,
                           const Scratch& sc, const float* c, const float* t,
                           int i, int S, int NB, float tol, bool guard,
                           float keep) {
  const bool has_cap = m.cload != nullptr;
  const float* v = rw.vec + (size_t)i * NB;
  const float* xd = sc.xd + (size_t)i * NB;
  const float* ys = sc.ys + (size_t)i * NB;
  const int d = rw.d0[i];
  const long long s = sc.srcc[i];
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

__global__ void __launch_bounds__(THREADS)
corrected_accept_kernel(Brokers m, const float* __restrict__ consts,
                        const float* __restrict__ tconsts, Rows rw, int C,
                        int NB, int S, int n2, float tol, int guard,
                        float keep, uint8_t* __restrict__ acc, Scratch sc) {
  extern __shared__ unsigned long long skey[];
  __shared__ unsigned int smax[MAX_NB];
  __shared__ double sscale[MAX_NB];
  __shared__ float c[NC], t[NT];
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid < NC) c[tid] = consts[tid];
  if (tid < NT) t[tid] = tconsts[tid];
  for (int i = tid; i < C; i += nt) {
    sc.srcc[i] = rw.cand_src[i] < 0 ? 0 : rw.cand_src[i];
  }
  __syncthreads();
  unsigned long long* key = sc.key ? sc.key : skey;
  sort_rows(rw.d0, C, n2, key, sc.order);
  sort_rows(sc.srcc, C, n2, key, sc.order + C);
  // the destination's exclusive prefix, then the source's
  seg_excl_prefix(rw.d0, sc.order, rw.vec, rw.qual, sc.q, sc.excl, sc.chunk,
                  sc.carried, C, NB, smax, sscale);
  for (int x = tid; x < C * NB; x += nt) {
    sc.xd[x] = from_fixed(sc.excl[x], sscale[x % NB]);
  }
  __syncthreads();
  seg_excl_prefix(sc.srcc, sc.order + C, rw.vec, rw.qual, sc.q, sc.excl,
                  sc.chunk, sc.carried, C, NB, smax, sscale);
  for (int x = tid; x < C * NB; x += nt) {
    sc.ys[x] = from_fixed(sc.excl[x], sscale[x % NB]);
  }
  __syncthreads();
  for (int i = tid; i < C; i += nt) {
    acc[i] = accept_row(m, rw, sc, c, t, i, S, NB, tol, guard != 0, keep)
                 ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// {NC, NT, MAX_NB}: the wrapper checks its constant blocks against it.
void corrected_accept_layout(int* out) {
  out[0] = NC;
  out[1] = NT;
  out[2] = MAX_NB;
}

// Launches K15 on `stream` (one block); returns the CUDA error code.
// `n2` is the smallest power of two >= C; `guard` applies the stacking
// guard `corrected <= snap · keep` (keep = 1 - cohort_stack_tol).
// Scratch (see Scratch): srcc i64 [C]; q, excl i64 [C, NB]; chunk i64
// [ceil(C / 32), NB + 1]; order i32 [2, C]; key u64 [n2], or null to sort
// in n2 · 8 bytes of shared memory; carried u8 [C]; xd, ys f32 [C, NB].
int corrected_accept_launch(
    const float* capacity, const float* load, const float* cload,
    const float* leader_nwin, const float* pot_nwout, const float* rcount,
    const float* lcount, const int* rack, const int* assignment,
    const uint8_t* must_move, int S, const float* consts,
    const float* tconsts, const int* cand_p, const int* cand_s,
    const long long* cand_src, const int* d0, const float* vec,
    const uint8_t* qual, const float* snap, long long snap_stride, int C,
    int NB, int n2, float tol, int guard, float keep, uint8_t* acc,
    long long* srcc, long long* q, long long* excl, long long* chunk,
    int* order, unsigned long long* key, uint8_t* carried, float* xd,
    float* ys, void* stream) {
  const int want_nb = cload ? 2 * NR + 2 : NR + 2;
  if (C < 1 || S < 1 || NB != want_nb || n2 < C || (n2 & (n2 - 1)) != 0 ||
      (guard && snap == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = key == nullptr ? n2 * (int)sizeof(unsigned long long) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      corrected_accept_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  Brokers m{capacity, load, cload, leader_nwin, pot_nwout,
            rcount,   lcount, rack, assignment,  must_move};
  Rows rw{cand_p, cand_s, cand_src, d0, vec, qual, snap, snap_stride};
  Scratch sc{srcc, q, excl, chunk, order, key, carried, xd, ys};
  corrected_accept_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      m, consts, tconsts, rw, C, NB, S, n2, tol, guard, keep, acc, sc);
  return (int)cudaGetLastError();
}

}  // extern "C"
