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
// scaled back once to f32.  Here the first pass takes the exact column
// maxima (the order of the bits of |v| is the float order), the sums add
// the same int64 fixed-point values (exact and order free; one f32
// multiply by 2^k and one conversion a value, step_common.cuh: fixed_q),
// the last pass scales back: the result equals the plain twin's bit for
// bit.  Counts are integer sums.
//
// What bounds it.  It reads the placement (4 B a slot) and the
// partitions' leader slot and load rows (4 + 32 or 64 B) and writes
// B·(2R+4) floats: ~1 MB at P·S = 60 000 slots, P = 20 000 (~0.3 us at
// 3.35 TB/s), ~80 MB at the north star's 3 M slots (~0.024 ms).  A
// first version was held back by atomics: one atomicMax a warp and column
// onto 10 words, and 12 int64 atomicAdds a slot into [B, 12].
//
// What the design does about it.  No memset, no host read, and no
// global atomic a slot; six launches:
//  1. max (grid-stride, a thread a partition): the ten columns' maxima in
//     registers, reduced by warp shuffles and one shared-memory level into
//     a [block, 10] row — no atomic; it also zeroes the sort's cursors.
//  2. count, 3. scan, 4. scatter: the counting sort of broker_sort.cuh
//     lists the slots by broker in items of at most 128 (one global
//     atomic a (count block, broker)); scan also reduces the max rows to
//     the ten fixed-point scales, once a call.
//  5. gather: a warp an item, a lane its slots' 12 columns in registers,
//     a warp-shuffle sum into an [item, 12] row — no atomic.
//  6. out: a warp a broker, its lanes over the broker's items (a broker
//     holding a quarter of the north star's 3 M slots has ~5 900), a
//     warp-shuffle sum, scaled back.
// One path at every size, the sort shared with K12.  A form that
// privatised the [B, 12] sums in shared memory where they fit (B up to
// 1 966; three launches) took 0.0140 ms of device at 1 000 brokers / 20 000
// partitions against this form's 0.020-0.021, but its wrapper was no
// faster (0.110-0.129 ms against 0.090-0.122, CUDA events, in turns on one
// H100): K9 there is host-bound.  Its tiles of 1 966 brokers took ~0.8 ms
// at 10 000.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "broker_sort.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_step;

constexpr int MT = 256;            // threads of a max block
constexpr int GT = 256;            // threads of a gather block: a warp an item
constexpr int QT = 1024;           // threads of the scan block
constexpr int OT = 256;            // threads of an out block: a warp a broker
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
  int P, S, B;
};

struct Out {
  float* load;                 // [B, R]
  float* cload;                // [B, R] or null
  float* leader_nwin;          // [B]
  float* pot_nwout;            // [B]
  float* rcount;               // [B]
  float* lcount;               // [B]
};

// the buffer of one call, in bytes: the six outputs (f32, packed), then
// the workspace: the max rows (u32 [blocks, 10]), the scales, the items'
// sums (int64 [items, 12]) and the sort (cursor, pos, list, start,
// istart, ibroker); 256-byte aligned
struct Layout {
  int max_blocks, items;
  long long load, cload, lnwin, pot, rcount, lcount, part, sc, scf, sums,
      cursor, pos, list, start, istart, ibroker, bytes;
};

inline long long up256(long long x) { return (x + 255) / 256 * 256; }

inline Layout layout_of(int P, int S, int B, int has_cap, int sms) {
  Layout L{};
  const long long PS = (long long)P * S;
  int mb = (P + MT - 1) / MT;
  L.max_blocks = mb < 2 * sms ? mb : 2 * sms;
  L.items = (int)cc_sort::max_items(PS, B, cc_sort::CH);
  // the outputs packed, in this order, with no gap (all f32)
  long long o = 0;
  L.load = o;    o += 4LL * B * NR;
  L.cload = o;   o += has_cap ? 4LL * B * NR : 0;
  L.lnwin = o;   o += 4LL * B;
  L.pot = o;     o += 4LL * B;
  L.rcount = o;  o += 4LL * B;
  L.lcount = o;  o = up256(o + 4LL * B);
  L.part = o;    o = up256(o + 4LL * L.max_blocks * MAX_COL);
  L.sc = o;      o = up256(o + 8LL * MAX_COL);
  L.scf = o;     o = up256(o + 4LL * MAX_COL);
  L.sums = o;    o = up256(o + 8LL * L.items * SUMS);
  L.cursor = o;  o = up256(o + 4LL * B);
  L.pos = o;     o = up256(o + 4LL * PS);
  L.list = o;    o = up256(o + 4LL * PS);
  L.start = o;   o = up256(o + 4LL * (B + 1));
  L.istart = o;  o = up256(o + 4LL * (B + 1));
  L.ibroker = o; o = up256(o + 4LL * L.items);
  L.bytes = o;
  return L;
}

struct Work {
  unsigned* part;     // [max_blocks, 10]: a max block's column maxima
  double* sc;         // [10]: the columns' fixed-point scales
  float* scf;         // [10]: fixed_q's f32 factors of them
  long long* isums;   // [items, 12]
  int* cursor;        // [B]
  int* pos;           // [P·S]
  unsigned* list;     // [P·S]
  int* start;         // [B + 1]
  int* istart;        // [B + 1]
  int* ibroker;       // [items]
  int max_blocks;
};

Work work_of(char* base, const Layout& L) {
  return Work{(unsigned*)(base + L.part), (double*)(base + L.sc),
              (float*)(base + L.scf),     (long long*)(base + L.sums),
              (int*)(base + L.cursor),    (int*)(base + L.pos),
              (unsigned*)(base + L.list), (int*)(base + L.start),
              (int*)(base + L.istart),    (int*)(base + L.ibroker),
              L.max_blocks};
}

__device__ __forceinline__ unsigned abits(float v) {
  return __float_as_uint(fabsf(v));
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// ---- 1. max: the ten columns' maxima, a row a block ----------------------
__global__ void __launch_bounds__(MT)
recompute_aggregates_max_kernel(Model m, Work w) {
  const int tid = threadIdx.x;
  const bool has_cap = m.leader_cload != nullptr;
  for (int i = blockIdx.x * MT + tid; i < m.B; i += gridDim.x * MT) {
    w.cursor[i] = 0;
  }
  unsigned mx[MAX_COL];
#pragma unroll
  for (int c = 0; c < MAX_COL; ++c) mx[c] = 0u;
  for (int p = blockIdx.x * MT + tid; p < m.P; p += gridDim.x * MT) {
    const int ls = m.leader_slot[p];
    bool has_lead = false, has_fol = false;
    for (int s = 0; s < m.S; ++s) {
      if (m.assignment[(size_t)p * m.S + s] != -1) {
        if (s == ls) has_lead = true; else has_fol = true;
      }
    }
    const float* lr = m.leader_load + (size_t)p * NR;
    const float* fr = m.follower_load + (size_t)p * NR;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      mx[r] = max(mx[r], max(has_lead ? abits(lr[r]) : 0u,
                             has_fol ? abits(fr[r]) : 0u));
      if (has_cap) {
        mx[COL_CLOAD + r] = max(
            mx[COL_CLOAD + r],
            max(has_lead ? abits(m.leader_cload[(size_t)p * NR + r]) : 0u,
                has_fol ? abits(m.follower_cload[(size_t)p * NR + r]) : 0u));
      }
    }
    if (has_lead || has_fol) mx[COL_POT] = max(mx[COL_POT], abits(lr[NW_OUT]));
    // every partition's leader NW-in counts, led by a broker or not
    mx[COL_LNWIN] = max(mx[COL_LNWIN], abits(lr[NW_IN]));
  }
  __shared__ unsigned s_mx[MT / 32][MAX_COL];
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int c = 0; c < MAX_COL; ++c) {
    unsigned v = mx[c];
    for (int off = 16; off > 0; off >>= 1) {
      v = max(v, __shfl_xor_sync(FULL, v, off));
    }
    if (lane == 0) s_mx[warp][c] = v;
  }
  __syncthreads();
  if (tid < MAX_COL) {
    unsigned v = 0u;
    for (int q = 0; q < MT / 32; ++q) v = max(v, s_mx[q][tid]);
    w.part[(size_t)blockIdx.x * MAX_COL + tid] = v;
  }
}

// ---- 2-4. the counting sort of the placement by broker (broker_sort.cuh)
__global__ void __launch_bounds__(cc_sort::ST)
recompute_aggregates_count_kernel(Model m, Work w) {
  extern __shared__ int hist[];
  cc_sort::count(m.assignment, (long long)m.P * m.S, m.B, w.cursor, w.pos,
                 hist, blockIdx.x, gridDim.x);
}

// the scan also turns the max rows into the ten fixed-point scales: 16
// columns × 64 rows at a time, then a shared-memory tree
__global__ void __launch_bounds__(QT)
recompute_aggregates_scan_kernel(Model m, Work w) {
  __shared__ unsigned s_r[QT];
  const int tid = threadIdx.x;
  const int c = tid & 15, j0 = tid >> 4, step = QT >> 4;
  unsigned v = 0u;
  if (c < MAX_COL) {
    for (int j = j0; j < w.max_blocks; j += step) {
      v = max(v, w.part[(size_t)j * MAX_COL + c]);
    }
  }
  s_r[tid] = v;
  __syncthreads();
  for (int h = step >> 1; h > 0; h >>= 1) {
    if (j0 < h) s_r[tid] = max(s_r[tid], s_r[tid + h * 16]);
    __syncthreads();
  }
  if (tid < MAX_COL) {
    const double sc = fixed_scale(__uint_as_float(s_r[tid]),
                                  tid == COL_LNWIN ? (long long)m.P
                                                   : (long long)m.P * m.S);
    w.sc[tid] = sc;
    w.scf[tid] = fixed_scale_f(sc);
  }
  cc_sort::scan<QT>(w.cursor, m.B, cc_sort::CH, w.start, w.istart,
                    w.ibroker);
}

__global__ void __launch_bounds__(cc_sort::ST)
recompute_aggregates_scatter_kernel(Model m, Work w) {
  cc_sort::scatter(m.assignment, m.leader_slot, m.P, m.S, w.start, w.pos,
                   w.list);
}

// ---- 5. gather: a warp an item, an [item, 12] row of sums ----------------
__global__ void __launch_bounds__(GT)
recompute_aggregates_gather_kernel(Model m, Work w) {
  const int lane = threadIdx.x & 31;
  const int it = blockIdx.x * (GT / 32) + (threadIdx.x >> 5);
  if (it >= w.istart[m.B]) return;     // a whole warp: no shuffle left
  const bool has_cap = m.leader_cload != nullptr;
  double sc[MAX_COL];
  float scf[MAX_COL];
#pragma unroll
  for (int c = 0; c < MAX_COL; ++c) {
    sc[c] = w.sc[c];
    scf[c] = w.scf[c];
  }
  int i0, i1;
  cc_sort::item_range(it, cc_sort::CH, w.start, w.istart, w.ibroker, &i0,
                      &i1);
  long long v[SUMS];
#pragma unroll
  for (int c = 0; c < SUMS; ++c) v[c] = 0;
  for (int i = i0 + lane; i < i1; i += 32) {
    const unsigned e = w.list[i];
    const int p = cc_sort::entry_p(e);
    const bool lead = cc_sort::entry_lead(e);
    const float* lr = m.leader_load + (size_t)p * NR;
    const float* row = lead ? lr : m.follower_load + (size_t)p * NR;
#pragma unroll
    for (int r = 0; r < NR; ++r) v[r] += fixed_q(row[r], scf[r], sc[r]);
    if (has_cap) {
      const float* crow =
          (lead ? m.leader_cload : m.follower_cload) + (size_t)p * NR;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int c = COL_CLOAD + r;
        v[c] += fixed_q(crow[r], scf[c], sc[c]);
      }
    }
    v[COL_POT] += fixed_q(lr[NW_OUT], scf[COL_POT], sc[COL_POT]);
    v[CNT_R] += 1;
    if (lead) {
      // the partition's leader slot: its leader NW-in and leader count
      v[COL_LNWIN] += fixed_q(lr[NW_IN], scf[COL_LNWIN], sc[COL_LNWIN]);
      v[CNT_L] += 1;
    }
  }
#pragma unroll
  for (int c = 0; c < SUMS; ++c) v[c] = warp_sum(v[c]);
  if (lane < SUMS) {
    long long x = 0;
#pragma unroll
    for (int c = 0; c < SUMS; ++c) x = c == lane ? v[c] : x;
    w.isums[(size_t)it * SUMS + lane] = x;
  }
}

// ---- 6. out: a warp a broker, its items' sums scaled back ----------------
__global__ void __launch_bounds__(OT)
recompute_aggregates_out_kernel(Model m, Work w, Out o) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (OT / 32) + (threadIdx.x >> 5);
  if (b >= m.B) return;                // a whole warp
  long long a[SUMS];
#pragma unroll
  for (int c = 0; c < SUMS; ++c) a[c] = 0;
  for (int it = w.istart[b] + lane; it < w.istart[b + 1]; it += 32) {
#pragma unroll
    for (int c = 0; c < SUMS; ++c) a[c] += w.isums[(size_t)it * SUMS + c];
  }
#pragma unroll
  for (int c = 0; c < SUMS; ++c) a[c] = warp_sum(a[c]);
  // lane c writes column c
  long long x = 0;
#pragma unroll
  for (int c = 0; c < SUMS; ++c) x = c == lane ? a[c] : x;
  if (lane < NR) {
    o.load[b * NR + lane] = __double2float_rn((double)x / w.sc[lane]);
  } else if (lane == COL_POT) {
    o.pot_nwout[b] = __double2float_rn((double)x / w.sc[lane]);
  } else if (lane == COL_LNWIN) {
    o.leader_nwin[b] = __double2float_rn((double)x / w.sc[lane]);
  } else if (lane < COL_CLOAD + NR) {
    if (o.cload != nullptr) {
      o.cload[b * NR + lane - COL_CLOAD] =
          __double2float_rn((double)x / w.sc[lane]);
    }
  } else if (lane == CNT_R) {
    o.rcount[b] = (float)x;
  } else if (lane == CNT_L) {
    o.lcount[b] = (float)x;
  }
}

bool args_ok(int P, int S, int B, int sms) {
  return P >= 1 && P < cc_sort::MAX_P && S >= 1 && S <= 8 && B >= 1 &&
         (long long)P * S < (1LL << 31) && sms >= 1;
}

}  // namespace

extern "C" {

// Byte offsets into one call's buffer of the six outputs — load, capacity
// load (when has_cap), leader NW-in, potential NW-out, replica count,
// leader count — into off[0..5] and the buffer's size into off[6], for
// `sms` SMs.  Returns the CUDA error code.
int recompute_aggregates_layout(int P, int S, int B, int has_cap, int sms,
                                long long* off) {
  if (!args_ok(P, S, B, sms)) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(P, S, B, has_cap, sms);
  const long long v[7] = {L.load, L.cload, L.lnwin, L.pot, L.rcount,
                          L.lcount, L.bytes};
  for (int i = 0; i < 7; ++i) off[i] = v[i];
  return 0;
}

// Launches K9 on `stream` into `buf` (recompute_aggregates_layout's size;
// it holds the outputs and the workspace): max, count, scan, scatter,
// gather, out.  The capacity-estimate rows are both given or both null.
// Returns the CUDA error code.
int recompute_aggregates_launch(const int* assignment, const int* leader_slot,
                                const float* leader_load,
                                const float* follower_load,
                                const float* leader_cload,
                                const float* follower_cload, int P, int S,
                                int B, int sms, void* buf, void* stream) {
  if (!args_ok(P, S, B, sms) ||
      (leader_cload == nullptr) != (follower_cload == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int has_cap = leader_cload != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  const Layout L = layout_of(P, S, B, has_cap, sms);
  char* base = (char*)buf;
  const Model m{assignment, leader_slot, leader_load, follower_load,
                leader_cload, follower_cload, P, S, B};
  const Out o{(float*)(base + L.load),
              has_cap ? (float*)(base + L.cload) : nullptr,
              (float*)(base + L.lnwin), (float*)(base + L.pot),
              (float*)(base + L.rcount), (float*)(base + L.lcount)};
  const Work w = work_of(base, L);
  const int hsm = (B < cc_sort::SORT_TB ? B : cc_sort::SORT_TB) *
                  (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      recompute_aggregates_count_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, hsm);
  if (e != cudaSuccess) return (int)e;
  const long long PS = (long long)P * S;
  long long cb = PS / (4LL * B);
  cb = cb < 1 ? 1 : (cb > 2LL * sms ? 2LL * sms : cb);
  long long sg = (PS + cc_sort::ST - 1) / cc_sort::ST;
  if (sg > 4LL * sms) sg = 4LL * sms;
  recompute_aggregates_max_kernel<<<L.max_blocks, MT, 0, st>>>(m, w);
  recompute_aggregates_count_kernel<<<(int)cb, cc_sort::ST, hsm, st>>>(m, w);
  recompute_aggregates_scan_kernel<<<1, QT, 0, st>>>(m, w);
  recompute_aggregates_scatter_kernel<<<(int)sg, cc_sort::ST, 0, st>>>(m, w);
  recompute_aggregates_gather_kernel<<<(L.items + GT / 32 - 1) / (GT / 32),
                                       GT, 0, st>>>(m, w);
  recompute_aggregates_out_kernel<<<(B + OT / 32 - 1) / (OT / 32), OT, 0,
                                    st>>>(m, w, o);
  return (int)cudaGetLastError();
}

// K9's gather kernel's resources as {registers a thread, local (spilled)
// bytes a thread, static shared bytes, dynamic shared bytes, resident
// blocks an SM}.  Returns the CUDA error code.
int recompute_aggregates_attrs(int* out) {
  const void* fn = (const void*)recompute_aggregates_gather_kernel;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, GT, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = 0;
  out[4] = per_sm;
  return 0;
}

}  // extern "C"
