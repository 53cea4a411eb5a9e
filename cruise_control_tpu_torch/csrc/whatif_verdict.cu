// K12 — the what-if verdict chain, for Hopper (sm_90a).
//
// What it replaces.  cruise_control_tpu/whatif/engine.py:39
// `_verdict_one` under `jax.vmap` (`_EVALUATE`, :140): for N futures over
// one shared placement — future n a dead-broker mask dead[n, B] and a
// per-partition traffic multiplier scale[n, P] — the surviving replicas of
// each partition (unavailable, under-replicated), the rate-scaled slot
// loads summed by surviving broker (hosted [B, R]) and in total, the
// surviving capacity, the overloaded brokers, rack co-location among the
// survivors, the offline slots, dead leaders and data to move, and the
// four heaviest offline slots pointed at the least-utilized surviving
// broker.  The plain twin is whatif/verdict_kernels.py: verdict_plain.
//
// Exactness.  Every float sum is the order-free int64 fixed point of
// ops/segment.py, scaled per future and per resource: the slot loads'
// scale 2^(60 - e) from the exact maximum of that future's |slot load|
// over all P·S slots (empty slots count as zeros) and ceil(log2(P·S));
// the surviving capacity's from its own maximum and B.  Hosted load, the
// total and the data to move (the DISK column's fixed-point values over
// the offline slots) share the slot loads' scale.  The slot loads are the
// twin's f32 operations, one rounding each (built with --fmad=false), the
// fixed-point values are rounded half to even like torch.round, the
// integer sums are exact in any order and each is scaled back once, so
// every output equals the twin's bit for bit.  The top-4 ranks one u64
// key a slot, the priority's bits above the inverted flat index: larger
// first, ties to the lowest index, lax.top_k's order.  The argmin ranks
// (ord32(util), broker): ties to the lowest broker, all-dead → 0.
//
// What bounds it.  Each future reads its scale row (4·P bytes) and dead
// row (B bytes); the base (placement, leader slots, load rows, ~(4S + 36)
// bytes a partition; capacity and rack, 20 bytes a broker) is read once
// and stays in L2 for the other futures.  At 1 000 brokers / 20 000
// partitions × 64 futures that is ~6 MB (~2 us at 3.35 TB/s); at the
// north star's 10 000 / 1 000 000 × 64, ~0.3 GB (~0.09 ms).  What limits
// the kernel in practice is the N·P·S·R int64 atomics into hosted load.
//
// What the design does about it.  Three launches from one host call, no
// host read between them.  Phase 0 (grid: partition tiles × futures, one
// thread a partition) takes the slot loads' exact maxima, a warp shuffle
// before one atomicMax a warp.  Phase 1 (same grid) recomputes the slot
// loads, quantizes them, adds each surviving slot's values into
// hosted[n, b, :] with int64 atomics, and reduces its block's counts,
// totals, data to move and top-4 keys (warp shuffles, then shared memory)
// into one atomic each and a [n, tile, 4] candidate row.  Phase 2 (one
// block a future) sums the surviving capacity exactly, scales the sums
// back, counts the overloaded brokers, takes the argmin and the largest
// utilization, merges the tiles' candidates and writes the 13 outputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_step;

constexpr int NR = 4;              // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int DISK = 3;
constexpr int TOP = 4;             // whatif/verdict_kernels.py: TOP_ACTIONS
constexpr int MAX_S = 8;           // verdict_kernels.py: _MAX_S
constexpr int TILE = 256;          // partitions a block, phases 0 and 1
constexpr int FIN = 1024;          // threads of a phase-2 block
constexpr int NCNT = 5;            // unavailable, under-replicated, rack
                                   // violations, moves, leadership moves
constexpr int C_UNAV = 0, C_UNDER = 1, C_RACK = 2, C_MOVES = 3, C_LEAD = 4;
constexpr int NSUM = NR + 1;       // total [R], data to move
constexpr unsigned FULL = 0xffffffffu;

struct Base {
  const int* assignment;       // [P, S]
  const int* leader_slot;      // [P]
  const float* leader_load;    // [P, R]
  const float* follower_load;  // [P, R]
  const float* capacity;       // [B, R]
  const int* rack;             // [B]
  const uint8_t* alive0;       // [B]
  const uint8_t* dead;         // [N, B]
  const float* scale;          // [N, P]
  int N, P, S, B;
};

// the workspace's regions (int64 words): colmax (u32 [N, R]), hosted
// ([N, B, R]), sums ([N, R+1]), counts (int32 [N, NCNT]) — zeroed at each
// call — then the tiles' top-4 candidates (u64 [N, tiles, 4])
struct Work {
  unsigned* colmax;
  long long* hosted;
  long long* sums;
  int* cnt;
  unsigned long long* cand;
};

__host__ __device__ inline long long tiles_of(int P) {
  return ((long long)P + TILE - 1) / TILE;
}

__host__ __device__ inline long long zeroed_words(int N, int B) {
  return 2LL * N + (long long)N * B * NR + (long long)N * NSUM +
         ((long long)N * NCNT + 1) / 2;
}

__host__ __device__ inline Work work_of(long long* ws, int N, int B) {
  Work w;
  w.colmax = (unsigned*)ws;
  w.hosted = ws + 2LL * N;
  w.sums = w.hosted + (long long)N * B * NR;
  w.cnt = (int*)(w.sums + (long long)N * NSUM);
  w.cand = (unsigned long long*)(ws + zeroed_words(N, B));
  return w;
}

// one partition's leader and follower load rows under future n's
// multiplier: 1 + (scale - 1)·mask, the mask 0 for DISK (an integral)
__device__ __forceinline__ void rated(const Base& m, int n, int p,
                                      float lead[NR], float fol[NR]) {
  const float s = m.scale[(size_t)n * m.P + p];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float ls = 1.0f + (s - 1.0f) * (r == DISK ? 0.0f : 1.0f);
    lead[r] = m.leader_load[(size_t)p * NR + r] * ls;
    fol[r] = m.follower_load[(size_t)p * NR + r] * ls;
  }
}

// insert key k into t (descending, distinct keys; 0 = empty)
__device__ __forceinline__ void top_insert(unsigned long long t[TOP],
                                           unsigned long long k) {
#pragma unroll
  for (int i = 0; i < TOP; ++i) {
    if (k > t[i]) {
      const unsigned long long x = t[i];
      t[i] = k;
      k = x;
    }
  }
}

// t := the top-4 of the warp's lists (lanes hold disjoint key sets)
__device__ __forceinline__ void warp_top(unsigned long long t[TOP]) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o[TOP];
#pragma unroll
    for (int i = 0; i < TOP; ++i) o[i] = __shfl_xor_sync(FULL, t[i], off);
#pragma unroll
    for (int i = 0; i < TOP; ++i) top_insert(t, o[i]);
  }
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ unsigned warp_max(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(FULL, v, off));
  }
  return v;
}

// ---- phase 0: the slot loads' exact maxima, per future and resource ----
__global__ void __launch_bounds__(TILE)
verdict_max_kernel(Base m, Work w) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * TILE + threadIdx.x;
  unsigned mx[NR] = {0u, 0u, 0u, 0u};
  if (p < m.P) {
    float lead[NR], fol[NR];
    rated(m, n, p, lead, fol);
    const int ls = m.leader_slot[p];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < m.S) {
        const float e = m.assignment[(size_t)p * m.S + s] >= 0 ? 1.0f : 0.0f;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float v = (s == ls ? lead[r] : fol[r]) * e;
          mx[r] = max(mx[r], __float_as_uint(fabsf(v)));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const unsigned v = warp_max(mx[r]);
    if ((threadIdx.x & 31) == 0) atomicMax(&w.colmax[n * NR + r], v);
  }
}

// ---- phase 1: the slots ------------------------------------------------
__global__ void __launch_bounds__(TILE)
verdict_slots_kernel(Base m, Work w) {
  const int n = blockIdx.y;
  const int tile = blockIdx.x;
  const int p = tile * TILE + threadIdx.x;
  const long long n_slots = (long long)m.P * m.S;
  long long tot[NR] = {0, 0, 0, 0};
  long long dm = 0;
  int c[NCNT] = {0, 0, 0, 0, 0};
  unsigned long long top[TOP] = {0ull, 0ull, 0ull, 0ull};
  if (p < m.P) {
    double sc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      sc[r] = fixed_scale(__uint_as_float(w.colmax[n * NR + r]), n_slots);
    }
    float lead[NR], fol[NR];
    rated(m, n, p, lead, fol);
    const int ls = m.leader_slot[p];
    const uint8_t* dead = m.dead + (size_t)n * m.B;
    int rf = 0, n_alive = 0;
    bool lead_alive = false;
    bool sa[MAX_S];
    int rk[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      sa[s] = false;
      rk[s] = -1 - s;
      if (s >= m.S) continue;
      const int a = m.assignment[(size_t)p * m.S + s];
      const bool ex = a >= 0;
      const int b = ex ? a : 0;
      const bool al = ex && m.alive0[b] != 0 && dead[b] == 0;
      rf += ex;
      n_alive += al;
      sa[s] = al;
      if (al) rk[s] = m.rack[b];
      if (s == ls) lead_alive = al;
      const float e = ex ? 1.0f : 0.0f;
      float v[NR];
      long long q[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        v[r] = (s == ls ? lead[r] : fol[r]) * e;
        q[r] = __double2ll_rn((double)v[r] * sc[r]);
        tot[r] += q[r];
      }
      if (al) {
        unsigned long long* h =
            (unsigned long long*)(w.hosted + ((size_t)n * m.B + b) * NR);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          atomicAdd(&h[r], (unsigned long long)q[r]);
        }
      } else if (ex) {
        // an offline replica: a move, its data, and a suggested action
        c[C_MOVES] += 1;
        dm += q[DISK];
        const float prio = (v[DISK] + v[NW_IN]) + 1.0f;
        if (prio > 0.0f) {
          const unsigned flat = (unsigned)((long long)p * m.S + s);
          top_insert(top, ((unsigned long long)__float_as_uint(prio) << 32) |
                              (unsigned long long)(0xffffffffu - flat));
        }
      }
    }
    const bool has = rf > 0;
    c[C_UNAV] = has && n_alive == 0;
    c[C_UNDER] = has && n_alive > 0 && n_alive < rf;
    bool dup = false;
#pragma unroll
    for (int i = 0; i < MAX_S; ++i) {
#pragma unroll
      for (int j = i + 1; j < MAX_S; ++j) {
        dup = dup || (sa[i] && sa[j] && rk[i] == rk[j]);
      }
    }
    c[C_RACK] = dup;
    c[C_LEAD] = has && !lead_alive;
  }
  // the block's counts, totals, data to move and top-4
  __shared__ long long s_l[TILE / 32][NSUM];
  __shared__ int s_c[TILE / 32][NCNT];
  __shared__ unsigned long long s_t[TILE / 32][TOP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < NR; ++r) tot[r] = warp_sum(tot[r]);
  dm = warp_sum(dm);
#pragma unroll
  for (int k = 0; k < NCNT; ++k) c[k] = (int)warp_sum(c[k]);
  warp_top(top);
  if (lane == 0) {
    for (int r = 0; r < NR; ++r) s_l[warp][r] = tot[r];
    s_l[warp][NR] = dm;
    for (int k = 0; k < NCNT; ++k) s_c[warp][k] = c[k];
    for (int i = 0; i < TOP; ++i) s_t[warp][i] = top[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < TILE / 32; ++q) {
      for (int k = 0; k < NSUM; ++k) s_l[0][k] += s_l[q][k];
      for (int k = 0; k < NCNT; ++k) s_c[0][k] += s_c[q][k];
      for (int i = 0; i < TOP; ++i) top_insert(top, s_t[q][i]);
    }
    unsigned long long* sums = (unsigned long long*)(w.sums + (size_t)n * NSUM);
    for (int k = 0; k < NSUM; ++k) {
      if (s_l[0][k] != 0) atomicAdd(&sums[k], (unsigned long long)s_l[0][k]);
    }
    for (int k = 0; k < NCNT; ++k) {
      if (s_c[0][k] != 0) atomicAdd(&w.cnt[n * NCNT + k], s_c[0][k]);
    }
    unsigned long long* cand =
        w.cand + ((size_t)n * gridDim.x + tile) * TOP;
    for (int i = 0; i < TOP; ++i) cand[i] = top[i];
  }
}

// ---- phase 2: one block a future ----------------------------------------
struct Out {
  uint8_t* survivable;
  int* unavailable;
  int* under;
  uint8_t* infeasible;
  int* overloaded;
  int* rack_violations;
  int* moves;
  int* leadership_moves;
  float* data_move;
  float* max_util;
  int* top_part;
  int* top_src;
  int* top_dst;
};

// block-wide reductions for FIN threads through `red` (FIN / 32 words of
// 8 bytes); every thread gets the result
__device__ long long block_sum(long long v, long long* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
  for (int i = 0; i < FIN / 32; ++i) t += red[i];
  return t;
}

__device__ unsigned long long block_min(unsigned long long v,
                                        unsigned long long* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v = min(v, __shfl_xor_sync(FULL, v, off));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long t = red[0];
  for (int i = 1; i < FIN / 32; ++i) t = min(t, red[i]);
  return t;
}

__global__ void __launch_bounds__(FIN)
verdict_finish_kernel(Base m, Work w, int tiles, Out o) {
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* dead = m.dead + (size_t)n * m.B;
  __shared__ unsigned long long red[FIN / 32];
  __shared__ unsigned long long s_t[FIN / 32][TOP];

  // the surviving capacity, exactly: maxima, then fixed-point sums
  unsigned cm[NR] = {0u, 0u, 0u, 0u};
  for (int b = tid; b < m.B; b += FIN) {
    const float e = (m.alive0[b] != 0 && dead[b] == 0) ? 1.0f : 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      cm[r] = max(cm[r], __float_as_uint(fabsf(m.capacity[(size_t)b * NR + r] * e)));
    }
  }
  double csc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const unsigned v = warp_max(cm[r]);
    __syncthreads();
    if ((tid & 31) == 0) red[tid >> 5] = v;
    __syncthreads();
    unsigned t = 0u;
    for (int i = 0; i < FIN / 32; ++i) t = max(t, (unsigned)red[i]);
    csc[r] = fixed_scale(__uint_as_float(t), (long long)m.B);
  }
  long long cq[NR] = {0, 0, 0, 0};
  for (int b = tid; b < m.B; b += FIN) {
    const float e = (m.alive0[b] != 0 && dead[b] == 0) ? 1.0f : 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      cq[r] += __double2ll_rn((double)(m.capacity[(size_t)b * NR + r] * e) *
                              csc[r]);
    }
  }
  float cap_alive[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    cap_alive[r] =
        __double2float_rn((double)block_sum(cq[r], (long long*)red) / csc[r]);
  }

  // the totals and infeasibility
  const long long n_slots = (long long)m.P * m.S;
  double sc[NR];
  bool infeasible = false;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    sc[r] = fixed_scale(__uint_as_float(w.colmax[n * NR + r]), n_slots);
    const float total =
        __double2float_rn((double)w.sums[(size_t)n * NSUM + r] / sc[r]);
    infeasible = infeasible || total > cap_alive[r];
  }

  // brokers: overloaded, argmin of utilization, largest utilization
  int over = 0;
  unsigned long long amin = ~0ull;
  unsigned umax = 0u;   // ord32 of the largest utilization; util >= 0
  for (int b = tid; b < m.B; b += FIN) {
    const bool al = m.alive0[b] != 0 && dead[b] == 0;
    const long long* hq = w.hosted + ((size_t)n * m.B + b) * NR;
    bool ob = false;
    float util = 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float h = __double2float_rn((double)hq[r] / sc[r]);
      const float cap = m.capacity[(size_t)b * NR + r];
      ob = ob || h > cap;
      const float u = h / fmaxf(cap, 1e-9f);
      util = r == 0 ? u : fmaxf(util, u);
    }
    over += ob && al;
    const float um = al ? util : INFINITY;
    amin = min(amin, ((unsigned long long)ord32(um) << 32) | (unsigned)b);
    if (al) umax = max(umax, ord32(util));
  }
  const int overloaded = (int)block_sum(over, (long long*)red);
  amin = block_min(amin, red);
  umax = (unsigned)(~block_min(~(unsigned long long)umax, red));

  // the top-4 over the tiles' candidates
  unsigned long long top[TOP] = {0ull, 0ull, 0ull, 0ull};
  const unsigned long long* cand = w.cand + (size_t)n * tiles * TOP;
  for (long long i = tid; i < (long long)tiles * TOP; i += FIN) {
    top_insert(top, cand[i]);
  }
  warp_top(top);
  if ((tid & 31) == 0) {
    for (int i = 0; i < TOP; ++i) s_t[tid >> 5][i] = top[i];
  }
  __syncthreads();
  if (tid != 0) return;
  for (int q = 1; q < FIN / 32; ++q) {
    for (int i = 0; i < TOP; ++i) top_insert(top, s_t[q][i]);
  }
  const int* cnt = w.cnt + n * NCNT;
  const int dst = (int)(amin & 0xffffffffull);
  o.survivable[n] = cnt[C_UNAV] == 0 && !infeasible;
  o.unavailable[n] = cnt[C_UNAV];
  o.under[n] = cnt[C_UNDER];
  o.infeasible[n] = infeasible;
  o.overloaded[n] = overloaded;
  o.rack_violations[n] = cnt[C_RACK];
  o.moves[n] = cnt[C_MOVES];
  o.leadership_moves[n] = cnt[C_LEAD];
  o.data_move[n] =
      __double2float_rn((double)w.sums[(size_t)n * NSUM + NR] / sc[DISK]);
  // the largest surviving utilization (0.0 when none survives)
  o.max_util[n] = umax == 0u ? 0.0f : from_ord32(umax);
  for (int i = 0; i < TOP; ++i) {
    const unsigned long long k = top[i];
    int part = -1, src = -1;
    if (k != 0ull) {
      const long long flat = 0xffffffffll - (long long)(k & 0xffffffffull);
      part = (int)(flat / m.S);
      src = max(m.assignment[flat], 0);
    }
    o.top_part[n * TOP + i] = part;
    o.top_src[n * TOP + i] = src;
    o.top_dst[n * TOP + i] = dst;
  }
}

}  // namespace

extern "C" {

// int64 words of K12's workspace for N futures, P partitions, B brokers
long long whatif_verdict_workspace_words(int N, int P, int B) {
  return zeroed_words(N, B) + (long long)N * tiles_of(P) * TOP;
}

// Launches K12's three phases on `stream`.  `ws` holds
// whatif_verdict_workspace_words(N, P, B) int64 words (its first region
// zeroed here).  Outputs: survivable, unavailable, under-replicated,
// infeasible, overloaded, rack violations, moves, leadership moves, data
// to move, largest utilization ([N] each) and the top actions'
// partitions, sources and destination ([N, 4] each).  Returns the CUDA
// error code.
int whatif_verdict_launch(const int* assignment, const int* leader_slot,
                          const float* leader_load, const float* follower_load,
                          const float* capacity, const int* rack,
                          const uint8_t* alive0, const uint8_t* dead,
                          const float* scale, int N, int P, int S, int B,
                          long long* ws, uint8_t* survivable, int* unavailable,
                          int* under, uint8_t* infeasible, int* overloaded,
                          int* rack_violations, int* moves,
                          int* leadership_moves, float* data_move,
                          float* max_util, int* top_part, int* top_src,
                          int* top_dst, void* stream) {
  if (N < 1 || N > 65535 || P < 1 || S < 1 || S > MAX_S || B < 1 ||
      (long long)P * S >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const Base m{assignment, leader_slot, leader_load, follower_load, capacity,
               rack, alive0, dead, scale, N, P, S, B};
  const Work w = work_of(ws, N, B);
  const Out o{survivable, unavailable, under, infeasible, overloaded,
              rack_violations, moves, leadership_moves, data_move, max_util,
              top_part, top_src, top_dst};
  cudaError_t e = cudaMemsetAsync(
      ws, 0, (size_t)zeroed_words(N, B) * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (int)tiles_of(P);
  const dim3 grid(tiles, N);
  verdict_max_kernel<<<grid, TILE, 0, st>>>(m, w);
  verdict_slots_kernel<<<grid, TILE, 0, st>>>(m, w);
  verdict_finish_kernel<<<N, FIN, 0, st>>>(m, w, tiles, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
