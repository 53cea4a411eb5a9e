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
// Two launches.  The terms kernel (one block) reads the step's carry and
// returns at once unless the step repools; else it counts the touched
// partitions, decides the diet on the device, takes the three exact
// broker-axis column sums (mean capacity, cluster load, alive capacity:
// ops/segment.py's order-free fixed point, int64 atomics) and writes the
// [B] tables: the move-pool broker terms (overage, stress), the leadership
// stress and (lc_need, lead_ok), and the negated destination score.  The
// rows kernel (one thread a partition) recomputes row p's size and base
// when the repool is full or p was touched — the [S, S] canonical-holder
// rack scan in registers — and writes row p's move and leadership
// priorities.  A row recomputed by the same arithmetic as a full rebuild
// gives the same bits, so the incremental repool equals the full one
// exactly, as pool_row_tables_update does.
//
// Rounding.  Every sum over the resource axis is written out left to
// right as ops/cost.py: rsum, every product and division is the torch
// twin's, in f32, and the build disables FMA contraction: the kernel
// equals its plain twin bit for bit.
//
// What bounds it.  It reads the [P, S] placement, leader slots, must-move
// flags and exclusions, the touched rows' load rows and the [P, S] stored
// tables, and writes the priorities (and the touched rows' tables): about
// 0.6 MB at P = 20 000, S = 3 — bound by bytes (~0.2 us at 3.35 TB/s).
// The terms kernel is one block over B brokers: its time is its chain of
// block barriers and the B-row loops, a few microseconds.
//
// What the design does about it.  One thread a partition row keeps the
// row's slots, racks and flags in registers and writes each output once;
// the [B] tables the rows gather sit in a small scratch the terms kernel
// writes, so the rows kernel reads 20 B a slot from the cache.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_step;
using namespace cc_state;

constexpr int THREADS = 1024;      // terms kernel
constexpr int ROW_THREADS = 256;   // rows kernel
constexpr int NR = 4;              // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int MAX_S = 8;           // widest replica-slot axis (as K1)
constexpr int NCOL = 3 * NR;       // clamped capacity, load, alive capacity
constexpr float MUST_MOVE_PRIO = 1e6f;   // ops/pools.py: POOL_MUST_MOVE_PRIO
constexpr float RACK_PRIO = 1e5f;        // ops/pools.py: POOL_RACK_PRIO

struct Brokers {
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
};

struct Rows {
  const int* assignment;     // [P, S]
  const int* leader_slot;    // [P]
  const uint8_t* must_move;  // [P, S]
  const uint8_t* excluded;   // [P]
  const int* rack;           // [B]
  const float* pload;        // [P, W]: leader load | follower load | ...
};

struct Tables {
  float* size;               // [P, S] stored, refreshed in place
  float* base;               // [P, S]
  uint8_t* tpp;              // [P] touched since the last repool; cleared
  float* prio;               // [P, S] move-pool priority
  float* lprio;              // [P, S] leadership-pool priority
  float* dneg;               // [B] negated destination score
};

// terms scratch (f32): btab [B, 2] | lstress [B] | ltab [B, 2] | capmean [R]
__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

__device__ __forceinline__ float col_value(const Brokers& k, int b, int col) {
  const int r = col % NR;
  const float cap = k.capacity[(size_t)b * NR + r];
  if (col < NR) return fmaxf(cap, 1e-9f);
  if (col < 2 * NR) return k.load[(size_t)b * NR + r];
  return k.alive[b] ? cap : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
pool_tables_terms_kernel(Brokers k, int B, int P, const uint8_t* tpp,
                         int rows_budget, int* state, float* terms,
                         float* dneg) {
  __shared__ unsigned colmax[NCOL];
  __shared__ unsigned long long sums[NCOL];
  __shared__ double scale[NCOL];
  __shared__ float colv[NCOL];
  __shared__ int s_touched;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (!(state[ACTIVE] && state[NEED_POOL])) {
    if (tid == 0) state[REPOOL] = 0;
    return;
  }
  if (tid < NCOL) {
    colmax[tid] = 0u;
    sums[tid] = 0ull;
  }
  if (tid == 0) s_touched = 0;
  __syncthreads();

  // ---- touched partitions; exact maxima of the three broker columns -----
  int touched = 0;
  for (int p = tid; p < P; p += nt) touched += tpp[p] != 0;
  for (int o = 16; o > 0; o >>= 1) {
    touched += __shfl_down_sync(0xffffffffu, touched, o);
  }
  if ((tid & 31) == 0) atomicAdd(&s_touched, touched);
  for (int x = tid; x < B * NCOL; x += nt) {
    const int b = x / NCOL, col = x % NCOL;
    atomicMax(&colmax[col], __float_as_uint(fabsf(col_value(k, b, col))));
  }
  __syncthreads();
  if (tid < NCOL) scale[tid] = fixed_scale(__uint_as_float(colmax[tid]), B);
  __syncthreads();
  // ---- the column sums in int64 fixed point (ops/segment.py) ------------
  for (int x = tid; x < B * NCOL; x += nt) {
    const int b = x / NCOL, col = x % NCOL;
    const long long q =
        __double2ll_rn((double)col_value(k, b, col) * scale[col]);
    atomicAdd(&sums[col], (unsigned long long)q);
  }
  __syncthreads();
  if (tid < NCOL) {
    colv[tid] = __double2float_rn((double)(long long)sums[tid] / scale[tid]);
  }
  __syncthreads();

  // ---- per broker: pool_broker_terms, _leadership_prio_terms, dest score
  float* btab = terms;
  float* lstress = terms + 2 * (size_t)B;
  float* ltab = terms + 3 * (size_t)B;
  float avg_u[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    avg_u[r] = colv[NR + r] / fmaxf(colv[2 * NR + r], 1e-9f);
  }
  const float lc_up = *k.lc_upper, lc_lo = *k.lc_lower;
  for (int b = tid; b < B; b += nt) {
    float capc[NR], u[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      capc[r] = fmaxf(k.capacity[(size_t)b * NR + r], 1e-9f);
      u[r] = k.load[(size_t)b * NR + r] / capc[r];
    }
    float ov = relu(u[0] - k.util_upper[0]);
    float st = relu(u[0] - avg_u[0]);
    float umax = u[0];
#pragma unroll
    for (int r = 1; r < NR; ++r) {
      ov = ov + relu(u[r] - k.util_upper[r]);
      st = st + relu(u[r] - avg_u[r]);
      umax = fmaxf(umax, u[r]);
    }
    if (k.cload != nullptr) {
      float co = relu(k.cload[(size_t)b * NR] / capc[0] - k.cap_thr[0]);
#pragma unroll
      for (int r = 1; r < NR; ++r) {
        co = co + relu(k.cload[(size_t)b * NR + r] / capc[r] - k.cap_thr[r]);
      }
      ov = ov + 10.0f * co;
    }
    btab[2 * b] = ov;
    btab[2 * b + 1] = st;
    const float lc = k.lcount[b];
    const float lc_over = relu(lc - lc_up) / fmaxf(lc_up, 1.0f);
    lstress[b] = (umax + k.leader_nwin[b] / capc[NW_IN]) + lc_over;
    ltab[2 * b] = relu(lc_lo - lc) / fmaxf(lc_lo, 1.0f);
    ltab[2 * b + 1] = k.lead_ok[b] ? 1.0f : 0.0f;
    dneg[b] = -(umax + (k.dest_ok[b] ? 0.0f : INFINITY));
  }
  if (tid < NR) terms[5 * (size_t)B + tid] = colv[tid] / (float)B;
  if (tid == 0) {
    const bool incr =
        rows_budget >= 0 && state[PT_VALID] && s_touched <= rows_budget;
    state[REPOOL] = 1;
    state[FULL] = incr ? 0 : 1;
    state[N_INCR] += incr ? 1 : 0;
    state[N_REPOOL] += 1;
  }
}

__global__ void __launch_bounds__(ROW_THREADS)
pool_tables_rows_kernel(Rows in, Tables out, int P, int S, int W, int B,
                        int* state, const float* terms) {
  if (!state[REPOOL]) return;
  const bool full = state[FULL] != 0;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p == 0) {
    // the repool consumes the touched set (cleared row by row below)
    state[SINCE_POOL] = 0;
    state[PT_VALID] = 1;
    state[NEED_POOL] = 0;
  }
  if (p >= P) return;
  const float* btab = terms;
  const float* lstress = terms + 2 * (size_t)B;
  const float* ltab = terms + 3 * (size_t)B;
  const float* capmean = terms + 5 * (size_t)B;
  int row[MAX_S];
  bool exists[MAX_S];
  for (int s = 0; s < S; ++s) {
    row[s] = in.assignment[(size_t)p * S + s];
    exists[s] = row[s] >= 0;
  }
  const int ls = in.leader_slot[p];
  const bool excl = in.excluded[p] != 0;
  float* size = out.size + (size_t)p * S;
  float* base = out.base + (size_t)p * S;

  // ---- the row tables (_row_tables), when the repool covers this row ---
  if (full || out.tpp[p]) {
    const float* pl = in.pload + (size_t)p * W;
    int racks[MAX_S];
    for (int s = 0; s < S; ++s) racks[s] = exists[s] ? in.rack[row[s]] : -1;
    for (int s = 0; s < S; ++s) {
      const float* rl = s == ls ? pl : pl + NR;
      float sz = rl[0] / capmean[0];
#pragma unroll
      for (int r = 1; r < NR; ++r) sz = sz + rl[r] / capmean[r];
      bool dup = false;
      for (int q = 0; q < s; ++q) dup |= exists[q] && racks[q] == racks[s];
      dup = dup && exists[s];
      const bool must = in.must_move[(size_t)p * S + s] != 0;
      const float bonus =
          (dup ? RACK_PRIO : 0.0f) + (must ? MUST_MOVE_PRIO : 0.0f);
      const bool eligible = exists[s] && (!excl || must);
      size[s] = sz;
      base[s] = eligible ? bonus : -INFINITY;
    }
    if (out.tpp[p]) out.tpp[p] = 0;
  }

  // ---- the move priority (_prio_combine) and the leadership priority ----
  const int lb = row[ls] < 0 ? 0 : row[ls];
  const float lst = lstress[lb];
  for (int s = 0; s < S; ++s) {
    const int b = exists[s] ? row[s] : 0;
    const float ov = btab[2 * b], surplus = btab[2 * b + 1];
    const float fit = surplus - fabsf(size[s] - surplus);
    out.prio[(size_t)p * S + s] =
        ((ov * 10.0f + surplus * 2.0f) + fit) + base[s];
    const bool must = in.must_move[(size_t)p * S + s] != 0;
    const bool valid = exists[s] && s != ls && !excl && !must &&
                       ltab[2 * b + 1] > 0.0f;
    out.lprio[(size_t)p * S + s] = valid ? lst + ltab[2 * b] : -INFINITY;
  }
}

}  // namespace

extern "C" {

// Launches K10 on `stream`: the terms kernel (one block) and the rows
// kernel (one thread a partition).  `state` is the step loop's carry;
// `rows_budget` < 0 turns the incremental diet off.  `terms` is an f32
// scratch of 5·B + R entries.  Returns the CUDA error code.
int pool_tables_launch(const float* capacity, const float* load,
                       const float* cload, const uint8_t* alive,
                       const uint8_t* dest_ok, const uint8_t* lead_ok,
                       const float* leader_nwin, const float* lcount,
                       const float* util_upper, const float* cap_thr,
                       const float* lc_upper, const float* lc_lower, int B,
                       const int* assignment, const int* leader_slot,
                       const uint8_t* must_move, const uint8_t* excluded,
                       const int* rack, const float* pload, int P, int S,
                       int W, int rows_budget, int* state, float* terms,
                       float* size, float* base, uint8_t* tpp, float* prio,
                       float* lprio, float* dneg, void* stream) {
  if (B < 1 || P < 1 || S < 1 || S > MAX_S || W < 2 * NR + 1) {
    return (int)cudaErrorInvalidValue;
  }
  Brokers k{capacity, load, cload, alive, dest_ok, lead_ok, leader_nwin,
            lcount, util_upper, cap_thr, lc_upper, lc_lower};
  Rows in{assignment, leader_slot, must_move, excluded, rack, pload};
  Tables out{size, base, tpp, prio, lprio, dneg};
  cudaStream_t st = (cudaStream_t)stream;
  pool_tables_terms_kernel<<<1, THREADS, 0, st>>>(k, B, P, tpp, rows_budget,
                                                  state, terms, dneg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int grid = (P + ROW_THREADS - 1) / ROW_THREADS;
  pool_tables_rows_kernel<<<grid, ROW_THREADS, 0, st>>>(in, out, P, S, W, B,
                                                        state, terms);
  return (int)cudaGetLastError();
}

}  // extern "C"
