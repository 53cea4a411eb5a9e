// K10 — the priority side of a repool, for Hopper (sm_90a): the move-pool
// row tables, the move and leadership priorities over every replica slot
// and the destination scores, from one host call.
//
// What it replaces.  cruise_control_tpu/ops/pools.py:50-213 (`_row_tables`,
// `pool_row_tables`, `pool_row_tables_update`, `pool_broker_terms`,
// `_prio_combine`, `pool_prio`), tpu_optimizer.py:2120-2172
// (`_leadership_prio_terms`, `_leadership_prio_rows`), the destination
// score of `_select_round_pools` (:688) and the repool's predicates under
// `lax.cond` (:1016-1022: the incremental diet `pt_valid && sum(tpp) <=
// RB_POOL`, `n_incr`, the reset of `tpp`, `since_pool` and `pt_valid`).
// The eager port ran it as ~140 small torch ops a repool.  The plain twin
// is analyzer/pool_kernels.py: pool_tables_plain.
//
// Rounding.  Every sum over the resource axis is written out left to
// right as ops/cost.py: rsum, every product and division is the torch
// twin's, in f32, and the build disables FMA contraction.  The three
// broker-axis column sums (mean capacity, cluster load, alive capacity)
// are ops/segment.py's order-free int64 fixed point, so any order of the
// atomics gives the same bits.  A row recomputed by the same arithmetic as
// a full rebuild gives the same bits, so the incremental repool equals the
// full one exactly, as pool_row_tables_update does.
//
// What bounds it.  It reads the [P, S] placement, leader slots, must-move
// flags and exclusions, the refreshed rows' load rows or the stored
// tables, and writes the priorities (and the refreshed rows' tables):
// about 2 MB at P = 20 000, S = 3 — bound by bytes (~0.6 us at
// 3.35 TB/s).  What it paid was its structure: two launches a step, of
// which 169 of 176 return at once, and a one-block terms kernel whose
// 12 000 colliding shared atomics and B-row loops took most of an acting
// repool.
//
// What the design does about it.  One cooperative launch of G blocks of
// 512, capped at the blocks the card holds, in three phases with a grid
// barrier between consecutive ones:
//   gate      every block reads the carry; when the step does not repool,
//             all return at once (block 0 clears the repool flag): a
//             gated step pays one launch, not two.
//   A         the touched partitions counted; a broker a thread over the
//             grid, every load of the broker before any store (the
//             compiler must assume stores alias the inputs): the three
//             columns' exact maxima (warp shuffles, one shared atomic a
//             warp and column, one global atomic a block and column), and
//             two float4s a broker for the rows: its utilization row and
//             the terms that need no sum (overage, lc_need, lead_ok,
//             leadership stress); and the destination score.
//   B         every block derives the columns' scales from the maxima;
//             the column sums in int64 fixed point the same way.
//   rows      every block derives the sums' f32 values (the mean capacity,
//             the average utilization) and the diet's decision itself; then
//             a lane a replica slot: a warp takes 32 / NS rows of NS lanes
//             (NS = 1, 2, 3, 4 or 8, the slot instance compiled for S;
//             lanes past S idle), so a row never straddles warps.  A lane
//             issues its partition's loads together, then its broker's
//             (rack, the two float4s, the leader's stress); the broker's
//             stress, which needs the average, is summed from its
//             utilization row here, so no phase or barrier is spent on it.
//             The row's leader broker and lower slots' racks come by
//             shuffles, so no lane holds a row array; the four [P, S]
//             tables are read and written at consecutive addresses.
// The maxima, sums and touched count live in a small workspace that the
// launch leaves zero (the last block to read them clears them), so no
// memset launch is needed.  On an H100 80GB HBM3 at 700 W: 0.0132 ms at
// 1 000 brokers / 20 000 partitions against the two-launch design's
// 0.055, 0.0011 gated against 0.0021 (tools/time_kernels.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "seg_prefix.cuh"
#include "step_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cc_step;
using namespace cc_state;
using cc_seg::warp_max;
using cc_seg::warp_sum;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NR = 4;              // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int MAX_S = 8;           // widest replica-slot axis (as K1)
constexpr int NCOL = 3 * NR;       // clamped capacity, load, alive capacity
constexpr float MUST_MOVE_PRIO = 1e6f;   // ops/pools.py: POOL_MUST_MOVE_PRIO
constexpr float RACK_PRIO = 1e5f;        // ops/pools.py: POOL_RACK_PRIO
constexpr unsigned FULL_MASK = 0xffffffffu;
static_assert(NR == 4, "a broker's row of NR floats is one float4");

// The workspace: the grid's accumulators, zero between launches (the
// last block to read them clears them), then the broker tables the rows
// read, a float4 a broker each: util [B] (pool_broker_terms' util row)
// and terms [B] (overage, lc_need, lead_ok, leadership stress).
// analyzer/pool_kernels.py: POOL_WS_HEADER_WORDS is the header's size in
// int64 words.
struct WsHeader {
  unsigned long long sums[NCOL];
  unsigned int colmax[NCOL];
  int touched;
  unsigned int done;         // blocks that have read the sums
};
constexpr int WS_HEADER_WORDS = 32;
static_assert(sizeof(WsHeader) <= 8 * WS_HEADER_WORDS, "workspace header");

struct Args {
  // brokers
  const float* capacity;     // [B, R]
  const float* load;         // [B, R]
  const float* cload;        // [B, R] or null
  const uint8_t* alive;      // [B]
  const uint8_t* dest_ok;    // [B]
  const uint8_t* lead_ok;    // [B]
  const float* leader_nwin;  // [B]
  const float* lcount;       // [B]
  const float* util_upper;   // [R]
  const float* cap_thr;      // [R]
  const float* lc_upper;     // scalar
  const float* lc_lower;     // scalar
  const int* rack;           // [B]
  int B;
  // partitions
  const int* assignment;     // [P, S]
  const int* leader_slot;    // [P]
  const uint8_t* must_move;  // [P, S]
  const uint8_t* excluded;   // [P]
  const float* pload;        // [P, W]: leader load | follower load | ...
  int P, S, W;
  int rows_budget;
  int* state;                // the step loop's carry
  WsHeader* ws;
  float4* util;              // the workspace's tables
  float4* terms;
  // outputs
  float* size;               // [P, S] stored, refreshed in place
  float* base;               // [P, S]
  uint8_t* tpp;              // [P] touched since the last repool; cleared
  float* prio;               // [P, S] move-pool priority
  float* lprio;              // [P, S] leadership-pool priority
  float* dneg;               // [B] negated destination score
};

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

__device__ __forceinline__ float comp(const float4& v, int r) {
  return r == 0 ? v.x : (r == 1 ? v.y : (r == 2 ? v.z : v.w));
}

// One broker's rows of the tables, its loads issued together.
struct BrokerRow {
  float4 cap, load;
  bool alive;
};

__device__ __forceinline__ BrokerRow load_row(const Args& a, int b) {
  BrokerRow w;
  w.cap = reinterpret_cast<const float4*>(a.capacity)[b];
  w.load = reinterpret_cast<const float4*>(a.load)[b];
  w.alive = a.alive[b] != 0;
  return w;
}

// Column c of the three broker-axis sums (clamped capacity, load, alive
// capacity; NR resources each) of a broker's row.
__device__ __forceinline__ float col_value(const BrokerRow& w, int c) {
  const int r = c % NR, col = c / NR;
  const float cap = comp(w.cap, r);
  if (col == 0) return fmaxf(cap, 1e-9f);
  if (col == 1) return comp(w.load, r);
  return w.alive ? cap : 0.0f;
}

// Phase stamps of block 0 only (tools/time_kernels.py reads them as
// POOL_TABLES_PHASES)
#define STAMP0(i)                      \
  do {                                 \
    if (blockIdx.x == 0) CC_STAMP(i);  \
  } while (0)

template <int NS>
__global__ void __launch_bounds__(THREADS, 2) pool_tables_kernel(Args a) {
  __shared__ unsigned int smax[NCOL];
  __shared__ unsigned long long ssum[NCOL];
  __shared__ double sscale[NCOL];
  __shared__ float savg[NR], smean[NR];
  __shared__ int stouched, sfull;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gtid = blockIdx.x * THREADS + tid;
  const int gsize = gridDim.x * THREADS;
  int* state = a.state;
  // ---- gate: the step repools, or every block returns at once ---------
  const bool go = state[ACTIVE] != 0 && state[NEED_POOL] != 0;
  if (!go) {
    if (gtid == 0) state[REPOOL] = 0;
    return;
  }
  STAMP0(0);
  const bool pt_valid = state[PT_VALID] != 0;
  const bool count = a.rows_budget >= 0 && pt_valid;
  cg::grid_group grid = cg::this_grid();
  if (tid < NCOL) {
    smax[tid] = 0u;
    ssum[tid] = 0ull;
  }
  if (tid == 0) stouched = 0;
  __syncthreads();

  // ---- A: touched partitions; the columns' exact maxima; the broker
  // terms that need no sum (overage, leadership stress and table,
  // destination score) ---------------------------------------------------
  if (count) {
    int t = 0;
    for (int p = gtid; p < a.P; p += gsize) t += a.tpp[p] != 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(FULL_MASK, t, o);
    if (lane == 0 && t != 0) atomicAdd(&stouched, t);
  }
  if ((gtid & ~31) < a.B) {
    unsigned mx[NCOL];
#pragma unroll
    for (int c = 0; c < NCOL; ++c) mx[c] = 0u;
    float uu[NR], thr[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      uu[r] = a.util_upper[r];
      thr[r] = a.cap_thr[r];
    }
    const float lc_up = *a.lc_upper, lc_lo = *a.lc_lower;
    const bool has_cap = a.cload != nullptr;
    for (int b = gtid; b < a.B; b += gsize) {
      // every load of the broker before any store
      const BrokerRow w = load_row(a, b);
      const float4 cl = has_cap ? reinterpret_cast<const float4*>(a.cload)[b]
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float lc = a.lcount[b], lnw = a.leader_nwin[b];
      const bool lead_ok = a.lead_ok[b] != 0, dest_ok = a.dest_ok[b] != 0;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        mx[c] = max(mx[c], __float_as_uint(fabsf(col_value(w, c))));
      }
      // pool_broker_terms' utilization row
      float capc[NR], u[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        capc[r] = fmaxf(comp(w.cap, r), 1e-9f);
        u[r] = comp(w.load, r) / capc[r];
      }
      float ov = relu(u[0] - uu[0]);
      float umax = u[0];
#pragma unroll
      for (int r = 1; r < NR; ++r) {
        ov = ov + relu(u[r] - uu[r]);
        umax = fmaxf(umax, u[r]);
      }
      if (has_cap) {
        float co = relu(cl.x / capc[0] - thr[0]);
#pragma unroll
        for (int r = 1; r < NR; ++r) {
          co = co + relu(comp(cl, r) / capc[r] - thr[r]);
        }
        ov = ov + 10.0f * co;
      }
      const float lc_over = relu(lc - lc_up) / fmaxf(lc_up, 1.0f);
      a.util[b] = make_float4(u[0], u[1], u[2], u[3]);
      a.terms[b] = make_float4(ov, relu(lc_lo - lc) / fmaxf(lc_lo, 1.0f),
                               lead_ok ? 1.0f : 0.0f,
                               (umax + lnw / capc[NW_IN]) + lc_over);
      a.dneg[b] = -(umax + (dest_ok ? 0.0f : INFINITY));
    }
    warp_max(mx);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) atomicMax(&smax[c], mx[c]);
    }
  }
  __syncthreads();
  if (tid < NCOL && smax[tid] != 0u) atomicMax(&a.ws->colmax[tid], smax[tid]);
  if (tid == 0 && stouched != 0) atomicAdd(&a.ws->touched, stouched);
  grid.sync();
  STAMP0(1);

  // ---- B: the column sums in int64 fixed point ------------------------
  if (tid < NCOL) {
    sscale[tid] = fixed_scale(__uint_as_float(__ldcg(&a.ws->colmax[tid])),
                              a.B);
  }
  __syncthreads();
  if ((gtid & ~31) < a.B) {
    long long q[NCOL];
#pragma unroll
    for (int c = 0; c < NCOL; ++c) q[c] = 0;
    for (int b = gtid; b < a.B; b += gsize) {
      const BrokerRow w = load_row(a, b);
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const double sc = sscale[c];
        q[c] += fixed_q(col_value(w, c), fixed_scale_f(sc), sc);
      }
    }
    warp_sum(q);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        if (q[c] != 0) atomicAdd(&ssum[c], (unsigned long long)q[c]);
      }
    }
  }
  __syncthreads();
  if (tid < NCOL && ssum[tid] != 0ull) atomicAdd(&a.ws->sums[tid], ssum[tid]);
  grid.sync();
  STAMP0(2);

  // ---- every block: the sums' values and the diet's decision; the last
  // block to read the accumulators leaves them zero for the next launch -
  if (tid < NR) {
    // ops/segment.py's scale-back: (acc.double() / scale).to(f32)
    float v[3];
#pragma unroll
    for (int col = 0; col < 3; ++col) {
      const int c = col * NR + tid;
      v[col] = __double2float_rn(
          (double)(long long)__ldcg(&a.ws->sums[c]) / sscale[c]);
    }
    smean[tid] = v[0] / (float)a.B;
    savg[tid] = v[1] / fmaxf(v[2], 1e-9f);
  }
  if (tid == 0) {
    sfull = !(count && __ldcg(&a.ws->touched) <= a.rows_budget);
  }
  __syncthreads();
  if (tid == 0 && atomicAdd(&a.ws->done, 1u) == gridDim.x - 1) {
    for (int c = 0; c < NCOL; ++c) {
      a.ws->sums[c] = 0ull;
      a.ws->colmax[c] = 0u;
    }
    a.ws->touched = 0;
    a.ws->done = 0u;
  }
  const bool full = sfull != 0;
  if (gtid == 0) {
    // every block read the carry at the gate, before the first barrier;
    // the repool consumes the touched set (cleared row by row below)
    state[REPOOL] = 1;
    state[FULL] = full ? 1 : 0;
    state[N_INCR] += full ? 0 : 1;
    state[N_REPOOL] += 1;
    state[SINCE_POOL] = 0;
    state[PT_VALID] = 1;
    state[NEED_POOL] = 0;
  }

  // ---- the rows: a lane a replica slot ---------------------------------
  constexpr int RPW = 32 / NS;               // rows a warp
  const int r_in = lane / NS;
  const int s = lane - r_in * NS;
  const bool lane_on = r_in < RPW;
  const int row_lane = lane_on ? r_in * NS : 0;
  const int S = a.S;
  const int nwarps = gsize >> 5;
  for (int p0 = (gtid >> 5) * RPW; p0 < a.P; p0 += nwarps * RPW) {
    const int p = p0 + r_in;
    const bool row_on = lane_on && p < a.P;
    const bool slot_on = row_on && s < S;
    const size_t x = (size_t)p * S + s;
    // the partition's loads together: its slot, flags and, for a full
    // rebuild, both load rows; else the stored tables
    const int b = slot_on ? a.assignment[x] : -1;
    const int ls = row_on ? a.leader_slot[p] : 0;
    const bool excl = row_on && a.excluded[p] != 0;
    const bool tp = row_on && a.tpp[p] != 0;
    const bool must = slot_on && a.must_move[x] != 0;
    const float* pl = a.pload + (size_t)p * a.W;
    float lead[NR], fol[NR];
    float sz = 0.0f, bs = 0.0f;
    if (slot_on) {
      if (full) {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          lead[r] = pl[r];
          fol[r] = pl[NR + r];
        }
      } else {
        sz = a.size[x];
        bs = a.base[x];
      }
    }
    const bool exists = b >= 0;
    // the row's leader broker, from the row's lanes (every lane of the
    // warp takes part in each shuffle)
    const int lead_b = __shfl_sync(
        FULL_MASK, b, row_lane + min(max(ls, 0), NS - 1));
    // the broker's loads together: its rack, its tables, the leader's
    // stress
    const int bb = exists ? b : 0;
    const int rk = exists ? a.rack[b] : -1;
    float4 ub = make_float4(0.0f, 0.0f, 0.0f, 0.0f), tb = ub;
    float lst = 0.0f;
    if (slot_on) {
      ub = a.util[bb];
      tb = a.terms[bb];
      lst = a.terms[lead_b < 0 ? 0 : lead_b].w;
    }
    // its lower slots' racks (the canonical-holder rule)
    bool dup = false;
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      const int rq = __shfl_sync(FULL_MASK, rk, row_lane + q);
      const int eq = __shfl_sync(FULL_MASK, (int)exists, row_lane + q);
      dup = dup || (q < s && eq != 0 && rq == rk);
    }
    dup = dup && exists;
    if (slot_on) {
      if (full || tp) {
        // the row tables (_row_tables)
        if (!full) {
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            lead[r] = pl[r];
            fol[r] = pl[NR + r];
          }
        }
        // the slot's load row, chosen value by value (a pointer to either
        // array would put both in local memory)
        const bool is_lead = s == ls;
        sz = (is_lead ? lead[0] : fol[0]) / smean[0];
#pragma unroll
        for (int r = 1; r < NR; ++r) {
          sz = sz + (is_lead ? lead[r] : fol[r]) / smean[r];
        }
        const float bonus =
            (dup ? RACK_PRIO : 0.0f) + (must ? MUST_MOVE_PRIO : 0.0f);
        const bool eligible = exists && (!excl || must);
        bs = eligible ? bonus : -INFINITY;
        a.size[x] = sz;
        a.base[x] = bs;
      }
      // the move priority (_prio_combine, the broker's stress from its
      // utilization and the average) and the leadership priority
      float surplus = relu(ub.x - savg[0]);
#pragma unroll
      for (int r = 1; r < NR; ++r) {
        surplus = surplus + relu(comp(ub, r) - savg[r]);
      }
      const float fit = surplus - fabsf(sz - surplus);
      a.prio[x] = ((tb.x * 10.0f + surplus * 2.0f) + fit) + bs;
      const bool valid =
          exists && s != ls && !excl && !must && tb.z > 0.0f;
      a.lprio[x] = valid ? lst + tb.y : -INFINITY;
    }
    // every lane of the row has read its touched mark
    __syncwarp();
    if (row_on && s == 0 && tp) a.tpp[p] = 0;
  }
  STAMP0(3);
}

template <int NS>
cudaError_t launch_ns(const Args& a, int sms, cudaStream_t st) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pool_tables_kernel<NS>, THREADS, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // a block takes WARPS · 32 / NS rows at a time; no more blocks than the
  // card holds at once, so every grid barrier can be met
  const long long rows = (long long)WARPS * (32 / NS);
  const long long want = (a.P + rows - 1) / rows;
  const long long cap = (long long)sms * per_sm;
  const int G = (int)(want < cap ? want : cap);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, pool_tables_kernel<NS>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The slot instance of S slots (grid_cell.cuh's map: 1-4, else 8)
__host__ __device__ constexpr int slot_instance(int S) {
  return S <= 4 ? S : MAX_S;
}

template <int NS>
cudaError_t attrs_ns(int* out) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, pool_tables_kernel<NS>);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pool_tables_kernel<NS>, THREADS, 0);
  if (e != cudaSuccess) return e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes;
  out[3] = 0;
  out[4] = per_sm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches K10 on `stream`: one cooperative launch of at most `sms` times
// the blocks an SM holds.  `state` is the step loop's carry;
// `rows_budget` < 0 turns the incremental diet off.  `ws` is the
// workspace: WS_HEADER_WORDS int64 words, zero before the first launch
// (each launch leaves them so), then the tables util [B] and terms [B],
// a float4 a broker each; 16-byte aligned.  Returns the CUDA error
// code.
int pool_tables_launch(const float* capacity, const float* load,
                       const float* cload, const uint8_t* alive,
                       const uint8_t* dest_ok, const uint8_t* lead_ok,
                       const float* leader_nwin, const float* lcount,
                       const float* util_upper, const float* cap_thr,
                       const float* lc_upper, const float* lc_lower, int B,
                       const int* assignment, const int* leader_slot,
                       const uint8_t* must_move, const uint8_t* excluded,
                       const int* rack, const float* pload, int P, int S,
                       int W, int rows_budget, int* state, void* ws,
                       float* size, float* base, uint8_t* tpp, float* prio,
                       float* lprio, float* dneg, int sms, void* stream) {
  // the [B, NR] tables are read a row (16 bytes) at a time
  const uintptr_t rows = (uintptr_t)capacity | (uintptr_t)load |
                         (uintptr_t)(cload ? cload : capacity);
  if (B < 1 || P < 1 || S < 1 || S > MAX_S || W < 2 * NR + 1 || sms < 1 ||
      (rows | (uintptr_t)ws) % 16 != 0 || ws == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  float4* util = reinterpret_cast<float4*>(
      reinterpret_cast<unsigned long long*>(ws) + WS_HEADER_WORDS);
  Args a{capacity,  load,       cload,      alive,      dest_ok,
         lead_ok,   leader_nwin, lcount,    util_upper, cap_thr,
         lc_upper,  lc_lower,   rack,       B,          assignment,
         leader_slot, must_move, excluded,  pload,      P,
         S,         W,          rows_budget, state,
         reinterpret_cast<WsHeader*>(ws), util, util + B, size, base, tpp,
         prio, lprio, dneg};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (slot_instance(S)) {
    case 1: e = launch_ns<1>(a, sms, st); break;
    case 2: e = launch_ns<2>(a, sms, st); break;
    case 3: e = launch_ns<3>(a, sms, st); break;
    case 4: e = launch_ns<4>(a, sms, st); break;
    default: e = launch_ns<MAX_S>(a, sms, st); break;
  }
  return (int)e;
}

// K10's resources for S slots: out = registers, local bytes, static and
// dynamic shared bytes, resident blocks an SM (ops/kernels.py: ATTR_KEYS).
int pool_tables_attrs(int S, int* out) {
  if (S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  switch (slot_instance(S)) {
    case 1: return (int)attrs_ns<1>(out);
    case 2: return (int)attrs_ns<2>(out);
    case 3: return (int)attrs_ns<3>(out);
    case 4: return (int)attrs_ns<4>(out);
    default: return (int)attrs_ns<MAX_S>(out);
  }
}

}  // extern "C"
