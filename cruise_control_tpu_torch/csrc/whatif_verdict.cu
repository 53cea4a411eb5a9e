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
// every output equals the twin's bit for bit.  The maxima are taken per
// partition as max(|leader row · rate|, |follower row · rate|) over the
// rows that occur: rounding is monotone, so that is the slots' maximum.
// The top-4 ranks one u64 key a slot, the priority's bits above the
// inverted flat index: larger first, ties to the lowest index,
// lax.top_k's order.  The argmin ranks (ord32(util), broker): ties to the
// lowest broker, all-dead → 0.
//
// What bounds it.  Each future reads its scale row (4·P bytes) and dead
// row (B bytes); the base (placement, leader slots, load rows, ~(4S + 36)
// bytes a partition; capacity and rack, 20 bytes a broker) is read once
// and stays in L2 for the other futures.  At 1 000 brokers / 20 000
// partitions × 64 futures that is ~6 MB (~2 us at 3.35 TB/s); at the
// north star's 10 000 / 1 000 000 × 64, ~0.3 GB (~0.09 ms).  A first
// version was held back by same-address atomics: one atomicMax a warp
// onto the N·R maxima (8 M onto 256 words at the north star, 6.45 of
// ~17 ms) and one int64 atomicAdd a surviving slot and resource into
// hosted[n, b, :] (N·P·S·R of them).  What holds the design below back is
// latency and L2 traffic: the dead-row and scale gathers and the chains
// of dependent loads along a broker's slots.
//
// What the design does about it.  No sum or maximum goes
// through a global atomic; the only global atomics left are the slot
// sort's reservations, one a (sort block, broker).  Seven launches, no
// memset, no host read:
//  1. alive: each future's surviving brokers as a bitmask (a ballot a
//     warp), so a block holds its futures' rows in shared memory; it
//     zeroes the sort's broker cursors.
//  2. part (grid: partition stripes × groups of 8 futures): a lane a
//     (partition, future), the 8 lanes of a partition in one warp reading
//     its base (placement, leader slot, load rows) at once; a lane keeps
//     its future's slot-load maxima and partition counts (unavailable,
//     under-replicated, rack co-location, dead leaders) in registers,
//     testing the survivors' bits in shared memory (8 futures' bits of up
//     to MAX_B = 32 768 brokers: 32 KB; the wrapper refuses more), and
//     writes the scale transposed (8 futures' multipliers of a partition
//     in one 32-byte sector).  The block reduces its rows by warp shuffles and one
//     shared-memory level into a [stripe, n] row.
//  3. sort_count, prep, scatter: the counting sort of the shared
//     placement by broker (broker_sort.cuh, once a call): per-block
//     histograms in shared memory, one global reservation a (block,
//     broker), a one-block scan that cuts every broker's slots into items
//     of at most 16-128 (fewer, longer items where N·P·S keeps the card
//     busy anyway), and the scatter into a broker-ordered list of
//     (partition, slot, leader) entries.  prep also turns the stripes'
//     maxima into each future's scales (f64, and fixed_q's f32 factors)
//     and lists the brokers of more than 8 items.
//  4. brokers (grid: groups of 32 items × groups of 8 futures): a lane an
//     (item, future), the 8 lanes of an item in one warp reading the same
//     list entries and base rows and one sector of the transposed scale;
//     a lane sums its item's slots in registers — a plain reduction, no
//     atomics — four loads in flight at a time, and writes its item's
//     hosted partial (0 where the broker is dead in that future).  A
//     fixed-point value is one f32 multiply by 2^k and one conversion
//     (step_common.cuh: fixed_q), not an f64 product.  The same walk
//     gives the total, and on a dead broker the moves, data to
//     move and top-4 candidates; warp shuffles and one shared-memory level
//     reduce them to a [item group, n] row.  A broker hosting a quarter
//     of the slots is spread over many items, not one lane.
//  5. finish (one block a future): the surviving capacity, infeasibility,
//     the overloaded brokers (hosted: its items' partials, a thread a
//     broker, a warp a broker of more than 8 items), the argmin and the
//     largest utilization, and the rows of steps 2 and 4, by block-wide
//     reductions of several values at once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "broker_sort.cuh"
#include "step_common.cuh"

namespace {

using namespace cc_step;
using cc_sort::ST;

constexpr int NR = 4;              // resources (common/resources.py)
constexpr int NW_IN = 1;
constexpr int DISK = 3;
constexpr int TOP = 4;             // whatif/verdict_kernels.py: TOP_ACTIONS
constexpr int MAX_S = 8;           // verdict_kernels.py: _MAX_S
constexpr int AT = 256;            // threads of an alive block
constexpr int PT = 256;            // threads of a part block: a partition each
constexpr int NPW = 8;             // u32 words a (stripe, future) row: the
                                   // maxima [R] (f32 bits), then the counts
constexpr int C_UNAV = 0, C_UNDER = 1, C_RACK = 2, C_LEAD = 3;
constexpr int MAX_B = 32768;       // brokers at most: part holds 8 futures'
                                   // survivor bits in 32 KB of shared memory
constexpr int GB = 8;              // futures a part or brokers block; the
                                   // transposed scale's group of futures
constexpr int BT = 256;            // threads of a brokers block
constexpr int IPB = BT / GB;       // items a brokers block
constexpr int U = 4;               // list entries a lane loads at once
constexpr int NBW = 10;            // int64 words a (group, future) row:
                                   // total [R], data to move, moves, top-4
constexpr int W_DM = NR, W_MV = NR + 1, W_TOP = NR + 2;
constexpr int FIN = 1024;          // threads of a finish block
constexpr int QT = 1024;           // threads of the prep block
constexpr int FW = FIN / 32;
constexpr int HEAVY = 8;           // items of a broker the finish gives a
                                   // warp rather than a thread
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

// One call's buffer: the 13 outputs packed by type — the six int32 [N]
// counts and the three int32 [N, 4] top actions, the two f32 [N], the two
// bool [N] — then the workspace, each region at a 256-byte boundary.
// verdict_kernels.py reads every output's offset from
// whatif_verdict_layout and checks the packing, so the two cannot
// disagree.
struct Layout {
  int stripes;        // part's partition stripes
  int groups;         // [*, N] rows of step 4 (item groups)
  int items;          // items at most
  int ch;             // slots an item at most
  int sort_blocks;    // sort_count's blocks
  int words;          // u32 words of a future's survivor bits
  long long out[13];  // byte offsets of the outputs, in KEYS' order
  long long part, sc, scf, heavy, bits, cursor, start, istart, ibroker, pos,
      list,
      scale_t, hosted, rows;
  long long bytes;
};

inline long long up256(long long x) { return (x + 255) / 256 * 256; }

inline Layout layout_of(int N, int P, int S, int B, int sms) {
  Layout L{};
  const long long PS = (long long)P * S;
  const int ng = (N + GB - 1) / GB;
  const int tiles = (P + PT / GB - 1) / (PT / GB);
  const int ta = (8 * sms + ng - 1) / ng;
  L.stripes = ta < 1 ? 1 : (ta > tiles ? tiles : ta);
  long long sb = PS / (4LL * B);
  if (sb > 2LL * sms) sb = 2LL * sms;
  L.sort_blocks = sb < 1 ? 1 : (int)sb;
  L.words = (B + 31) / 32;
  // items short enough that ~64 lanes an SM walk them at once: 16 slots
  // at 1 000 brokers / 20 000 partitions × 64, 128 at the north star
  const long long lanes = 64LL * 256 * sms;
  int ch = 16;
  while (ch < cc_sort::CH && PS * N > lanes * ch) ch <<= 1;
  L.ch = ch;
  L.items = (int)cc_sort::max_items(PS, B, ch);
  L.groups = (L.items + IPB - 1) / IPB;
  long long o = 0;
  // int32: unavailable, under, overloaded, rack, moves, leadership [N],
  // then the top partitions, sources, destinations [N, 4]
  const int ints[6] = {1, 2, 4, 5, 6, 7};
  for (int i = 0; i < 6; ++i) L.out[ints[i]] = o + 4LL * N * i;
  L.out[10] = o + 24LL * N;
  L.out[11] = o + 40LL * N;
  L.out[12] = o + 56LL * N;
  L.out[8] = o + 72LL * N;     // f32: dataMoveMB, maxBrokerUtilization
  L.out[9] = o + 76LL * N;
  L.out[0] = o + 80LL * N;     // bool: survivable, capacityInfeasible
  L.out[3] = o + 81LL * N;
  o = up256(o + 82LL * N);
  const long long npad = (N + GB - 1) / GB * GB;
  L.part = o;    o = up256(o + 4LL * L.stripes * N * NPW);
  L.sc = o;      o = up256(o + 8LL * N * NR);
  L.scf = o;     o = up256(o + 4LL * N * NR);
  L.heavy = o;   o = up256(o + 4LL * (B + 1));
  L.bits = o;    o = up256(o + 4LL * N * L.words);
  L.cursor = o;  o = up256(o + 4LL * B);
  L.start = o;   o = up256(o + 4LL * (B + 1));
  L.istart = o;  o = up256(o + 4LL * (B + 1));
  L.ibroker = o; o = up256(o + 4LL * L.items);
  L.pos = o;     o = up256(o + 4LL * PS);
  L.list = o;    o = up256(o + 4LL * PS);
  L.scale_t = o; o = up256(o + 4LL * npad * P);
  L.hosted = o;  o = up256(o + 8LL * L.items * N * NR);
  L.rows = o;    o = up256(o + 8LL * L.groups * N * NBW);
  L.bytes = o;
  return L;
}

struct Work {
  unsigned* part;       // [stripes, N, NPW]
  double* sc;           // [N, R]: the slot loads' fixed-point scales
  float* scf;           // [N, R]: fixed_q's f32 factors of them
  int* heavy;           // [B + 1]: the count, then the brokers of more
                        // than HEAVY items
  unsigned* bits;       // [N, words]: 1 where the broker survives
  int* cursor;          // [B]
  int* start;           // [B + 1]: a broker's first list entry
  int* istart;          // [B + 1]: a broker's first item
  int* ibroker;         // [items]: an item's broker
  int* pos;             // [P·S]
  unsigned* list;       // [P·S]
  float* scale_t;       // [N / 8, P, 8]
  long long* hosted;    // [items, N, R]
  long long* rows;      // [groups, N, NBW]
  int stripes, groups, items, words, ch;
};

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

// t := the top-4 of the lists of the lanes whose lane ids differ in the
// bits of [lo, 32) (lanes hold disjoint key sets)
__device__ __forceinline__ void warp_top(unsigned long long t[TOP],
                                         int lo = 1) {
  for (int off = 16; off >= lo; off >>= 1) {
    unsigned long long o[TOP];
#pragma unroll
    for (int i = 0; i < TOP; ++i) o[i] = __shfl_xor_sync(FULL, t[i], off);
#pragma unroll
    for (int i = 0; i < TOP; ++i) top_insert(t, o[i]);
  }
}

__device__ __forceinline__ long long warp_sum(long long v, int lo = 1) {
  for (int off = 16; off >= lo; off >>= 1) {
    v += __shfl_xor_sync(FULL, v, off);
  }
  return v;
}

__device__ __forceinline__ unsigned warp_max(unsigned v, int lo = 1) {
  for (int off = 16; off >= lo; off >>= 1) {
    v = max(v, __shfl_xor_sync(FULL, v, off));
  }
  return v;
}

// the rated multiplier of resource r under traffic multiplier s:
// 1 + (s - 1)·mask, the mask 0 for DISK (an integral)
__device__ __forceinline__ float rate(float s, int r) {
  return 1.0f + (s - 1.0f) * (r == DISK ? 0.0f : 1.0f);
}

__device__ __forceinline__ unsigned long long top_key(float prio,
                                                      long long flat) {
  return ((unsigned long long)__float_as_uint(prio) << 32) |
         (unsigned long long)(0xffffffffu - (unsigned)flat);
}

// ---- 1. alive: the survivors' bits; zeroes the sort's cursors ----------
__global__ void __launch_bounds__(AT)
whatif_verdict_alive_kernel(Base m, Work w) {
  const int n = blockIdx.y;
  const int b = blockIdx.x * AT + threadIdx.x;
  const bool al = b < m.B && m.alive0[b] != 0 &&
                  m.dead[(size_t)n * m.B + b] == 0;
  const unsigned word = __ballot_sync(FULL, al);
  if ((threadIdx.x & 31) == 0 && b < m.B) {
    w.bits[(size_t)n * w.words + (b >> 5)] = word;
  }
  if (n == 0 && b < m.B) w.cursor[b] = 0;
}

// ---- 2. part: maxima and partition counts, a lane a (partition, future),
// G lanes a partition ----------------------------------------------------
__global__ void __launch_bounds__(PT)
whatif_verdict_part_kernel(Base m, Work w) {
  constexpr int G = GB;
  extern __shared__ unsigned s_bits[];   // [G, words]
  constexpr int PPB = PT / G;            // partitions a block a step
  const int tid = threadIdx.x;
  const int g = tid & (G - 1);
  const int g0 = blockIdx.y * G;
  const int n = g0 + g;
  const int ng = min(G, m.N - g0);
  const unsigned* bits = w.bits + (size_t)g0 * w.words;
  for (int i = tid; i < ng * w.words; i += PT) s_bits[i] = bits[i];
  __syncthreads();
  const unsigned* ab = s_bits + (size_t)g * w.words;
  unsigned mx[NR] = {0u, 0u, 0u, 0u};
  int cnt[4] = {0, 0, 0, 0};
  if (n < m.N) {
    const float* srow = m.scale + (size_t)n * m.P;
    float* trow = w.scale_t + (size_t)(n / GB) * m.P * GB + n % GB;
    for (int p = blockIdx.x * PPB + tid / G; p < m.P;
         p += gridDim.x * PPB) {
      const int ls = m.leader_slot[p];
      const float4 lrow =
          *reinterpret_cast<const float4*>(m.leader_load + (size_t)p * NR);
      const float4 frow =
          *reinterpret_cast<const float4*>(m.follower_load + (size_t)p * NR);
      const float sc = srow[p];
      trow[(size_t)p * GB] = sc;
      // the slots' survival in this future, and the rack pairs
      unsigned am = 0u;
      bool has_lead = false, has_fol = false, dup = false;
      int rf = 0;
      int rk[MAX_S];
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) {
        rk[s] = -1 - s;
        if (s >= m.S) continue;
        const int a = m.assignment[(size_t)p * m.S + s];
        if (a < 0) continue;
        rf += 1;
        if (s == ls) has_lead = true; else has_fol = true;
        if ((ab[a >> 5] >> (a & 31)) & 1u) {
          am |= 1u << s;
          rk[s] = m.rack[a];
        }
      }
#pragma unroll
      for (int i = 0; i < MAX_S; ++i) {
#pragma unroll
        for (int j = i + 1; j < MAX_S; ++j) dup = dup || rk[i] == rk[j];
      }
      // max over the slots of |row · rate|: the leader slot's row and the
      // followers' (an empty slot's zero adds nothing)
      const float lr[NR] = {lrow.x, lrow.y, lrow.z, lrow.w};
      const float fr[NR] = {frow.x, frow.y, frow.z, frow.w};
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float ra = rate(sc, r);
        const unsigned lv = __float_as_uint(fabsf(lr[r] * ra));
        const unsigned fv = __float_as_uint(fabsf(fr[r] * ra));
        mx[r] = max(mx[r], max(has_lead ? lv : 0u, has_fol ? fv : 0u));
      }
      const int n_alive = __popc(am);
      const bool has = rf > 0;
      const bool lead_alive = ls >= 0 && ls < MAX_S && ((am >> ls) & 1u);
      cnt[C_UNAV] += has && n_alive == 0;
      cnt[C_UNDER] += has && n_alive > 0 && n_alive < rf;
      cnt[C_RACK] += dup;
      cnt[C_LEAD] += has && !lead_alive;
    }
  }
  // the block's row a future: the lanes of a future in a warp by
  // shuffles, then the warps through shared memory
  __shared__ unsigned s_v[PT / 32][G][NPW];
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    mx[k] = warp_max(mx[k], G);
    cnt[k] = (int)warp_sum(cnt[k], G);
  }
  if (lane < G) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      s_v[warp][lane][k] = mx[k];
      s_v[warp][lane][NR + k] = (unsigned)cnt[k];
    }
  }
  __syncthreads();
  if (tid < ng * NPW) {
    const int gg = tid / NPW, k = tid % NPW;
    unsigned v = 0u;
    for (int q = 0; q < PT / 32; ++q) {
      v = k < NR ? max(v, s_v[q][gg][k]) : v + s_v[q][gg][k];
    }
    w.part[((size_t)blockIdx.x * m.N + g0 + gg) * NPW + k] = v;
  }
}

// ---- 3. the counting sort of the placement by broker (broker_sort.cuh) --
__global__ void __launch_bounds__(ST)
whatif_verdict_sort_count_kernel(Base m, Work w) {
  extern __shared__ int hist[];
  cc_sort::count(m.assignment, (long long)m.P * m.S, m.B, w.cursor, w.pos,
                 hist, blockIdx.x, gridDim.x);
}

// ---- prep (one block): the futures' fixed-point scales from the stripes'
// maxima; every broker's first list entry and first item, each item's
// broker, and the brokers of more than HEAVY items ------------------------
__global__ void __launch_bounds__(QT)
whatif_verdict_prep_kernel(Base m, Work w) {
  const int tid = threadIdx.x;
  const long long PS = (long long)m.P * m.S;
  // the maxima: QT / (N·R) threads a (future, resource) when that is more
  // than one, each over a share of the stripes, then a shared level
  __shared__ unsigned s_mx[QT];
  const int cols = m.N * NR;
  const int per = cols < QT ? QT / cols : 1;
  for (int i0 = 0; i0 < cols; i0 += QT) {
    const int i = i0 + (per > 1 ? tid % cols : tid);
    const int j0 = per > 1 ? tid / cols : 0;
    unsigned v = 0u;
    if (i < cols && j0 < per) {
      const int n = i / NR, r = i % NR;
      for (int j = j0; j < w.stripes; j += per) {
        v = max(v, w.part[((size_t)j * m.N + n) * NPW + r]);
      }
    }
    s_mx[tid] = v;
    __syncthreads();
    if (tid < cols - i0 && tid < (per > 1 ? cols : QT)) {
      unsigned t = 0u;
      for (int q = 0; q < per; ++q) t = max(t, s_mx[q * cols + tid]);
      const double sc = fixed_scale(__uint_as_float(t), PS);
      w.sc[i0 + tid] = sc;
      w.scf[i0 + tid] = fixed_scale_f(sc);
    }
    __syncthreads();
  }
  cc_sort::scan<QT>(w.cursor, m.B, w.ch, w.start, w.istart, w.ibroker);
  __shared__ int s_heavy;
  if (tid == 0) s_heavy = 0;
  __syncthreads();
  for (int b = tid; b < m.B; b += QT) {
    if (w.istart[b + 1] - w.istart[b] > HEAVY) {
      w.heavy[1 + atomicAdd(&s_heavy, 1)] = b;
    }
  }
  __syncthreads();
  if (tid == 0) w.heavy[0] = s_heavy;
}

__global__ void __launch_bounds__(ST)
whatif_verdict_scatter_kernel(Base m, Work w) {
  cc_sort::scatter(m.assignment, m.leader_slot, m.P, m.S, w.start, w.pos,
                   w.list);
}

// the [group, n] rows of a block's lanes (GB futures, lanes of one
// future GB apart in a warp) for its first `nf` futures: warp shuffles,
// then the `nw` warps through shared memory
__device__ void group_row(long long acc[NR], long long dm, long long mv,
                          unsigned long long top[TOP], long long* row_out,
                          long long (*s_v)[GB][NBW], int nw, int nf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = warp_sum(acc[r], GB);
  dm = warp_sum(dm, GB);
  mv = warp_sum(mv, GB);
  warp_top(top, GB);
  if (lane < GB) {
#pragma unroll
    for (int r = 0; r < NR; ++r) s_v[warp][lane][r] = acc[r];
    s_v[warp][lane][W_DM] = dm;
    s_v[warp][lane][W_MV] = mv;
#pragma unroll
    for (int i = 0; i < TOP; ++i) {
      s_v[warp][lane][W_TOP + i] = (long long)top[i];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nf * (W_TOP + 1)) {
    const int g = t / (W_TOP + 1), k = t % (W_TOP + 1);
    long long* row = row_out + (size_t)g * NBW;
    if (k < W_TOP) {
      long long v = 0;
      for (int q = 0; q < nw; ++q) v += s_v[q][g][k];
      row[k] = v;
    } else {
      unsigned long long tt[TOP] = {0ull, 0ull, 0ull, 0ull};
      for (int q = 0; q < nw; ++q) {
        for (int i = 0; i < TOP; ++i) {
          top_insert(tt, (unsigned long long)s_v[q][g][W_TOP + i]);
        }
      }
      for (int i = 0; i < TOP; ++i) row[W_TOP + i] = (long long)tt[i];
    }
  }
}

// ---- 4. brokers: a lane an (item, future), plain sums over the list -----
__global__ void __launch_bounds__(BT, 4)
whatif_verdict_brokers_kernel(Base m, Work w) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane & (GB - 1);
  const int it = blockIdx.x * IPB + warp * (32 / GB) + (lane / GB);
  const int n = blockIdx.y * GB + g;
  long long acc[NR] = {0, 0, 0, 0};
  long long dm = 0, mv = 0;
  unsigned long long top[TOP] = {0ull, 0ull, 0ull, 0ull};
  if (it < w.istart[m.B] && n < m.N) {
    int i0, i1;
    const int b = cc_sort::item_range(it, w.ch, w.start, w.istart,
                                      w.ibroker, &i0, &i1);
    const double* sc = w.sc + n * NR;   // read only where scf is 0
    float scf[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) scf[r] = w.scf[n * NR + r];
    const bool al =
        (w.bits[(size_t)n * w.words + (b >> 5)] >> (b & 31)) & 1u;
    const float* srow = w.scale_t + (size_t)(n / GB) * m.P * GB + g;
    for (int i = i0; i < i1; i += U) {
      unsigned e[U];
      float s[U];
      float4 row[U];
#pragma unroll
      for (int u = 0; u < U; ++u) e[u] = i + u < i1 ? w.list[i + u] : 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u < i1) {
          const int p = cc_sort::entry_p(e[u]);
          s[u] = srow[(size_t)p * GB];
          row[u] = *reinterpret_cast<const float4*>(
              (cc_sort::entry_lead(e[u]) ? m.leader_load : m.follower_load) +
              (size_t)p * NR);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u >= i1) continue;
        const float v[NR] = {row[u].x * rate(s[u], 0),
                             row[u].y * rate(s[u], 1),
                             row[u].z * rate(s[u], 2),
                             row[u].w * rate(s[u], 3)};
        long long q[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          // fixed_q, the f64 scale read only where it is needed
          q[r] = scf[r] != 0.0f ? __float2ll_rn(v[r] * scf[r])
                                : __double2ll_rn((double)v[r] * sc[r]);
          acc[r] += q[r];
        }
        if (!al) {
          // an offline replica: a move, its data, a suggested action
          mv += 1;
          dm += q[DISK];
          const float prio = (v[DISK] + v[NW_IN]) + 1.0f;
          if (prio > 0.0f) {
            const long long flat = (long long)cc_sort::entry_p(e[u]) * m.S +
                                   cc_sort::entry_s(e[u]);
            top_insert(top, top_key(prio, flat));
          }
        }
      }
    }
    long long* h = w.hosted + ((size_t)it * m.N + n) * NR;
#pragma unroll
    for (int r = 0; r < NR; ++r) h[r] = al ? acc[r] : 0;
  }
  __shared__ long long s_v[BT / 32][GB][NBW];
  const int nn = blockIdx.y * GB;
  group_row(acc, dm, mv, top, w.rows + ((size_t)blockIdx.x * m.N + nn) * NBW,
            s_v, BT / 32, min(GB, m.N - nn));
}

// ---- 5. finish: one block a future ----------------------------------------
// the block-wide sums of K values a thread (FIN threads), every thread
// getting them; s holds (FW + 1)·K words
template <int K>
__device__ void block_sums(long long v[K], long long* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    long long t = 0;
    for (int q = 0; q < FW; ++q) t += s[q * K + threadIdx.x];
    s[FW * K + threadIdx.x] = t;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = s[FW * K + k];
}

// the same for minima of K u64 values
template <int K>
__device__ void block_mins(unsigned long long v[K], unsigned long long* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int off = 16; off > 0; off >>= 1) {
      v[k] = min(v[k], __shfl_xor_sync(FULL, v[k], off));
    }
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    unsigned long long t = ~0ull;
    for (int q = 0; q < FW; ++q) t = min(t, s[q * K + threadIdx.x]);
    s[FW * K + threadIdx.x] = t;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = s[FW * K + k];
}

__global__ void __launch_bounds__(FIN)
whatif_verdict_finish_kernel(Base m, Work w, Out o) {
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned* ab = w.bits + (size_t)n * w.words;
  __shared__ long long red[(FW + 1) * 10];
  __shared__ unsigned long long s_t[FW][TOP];
  auto alive = [&](int b) { return ((ab[b >> 5] >> (b & 31)) & 1u) != 0u; };

  // the surviving capacity's maxima (as minima of the complements), the
  // stripes' partition counts and the step-4 rows, reduced together
  unsigned long long cm[NR] = {~0ull, ~0ull, ~0ull, ~0ull};
  for (int b = tid; b < m.B; b += FIN) {
    const float e = alive(b) ? 1.0f : 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      cm[r] = min(cm[r], ~(unsigned long long)__float_as_uint(
                             fabsf(m.capacity[(size_t)b * NR + r] * e)));
    }
  }
  long long rs[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};  // counts [4], row [6]
  for (int j = tid; j < w.stripes; j += FIN) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rs[k] += w.part[((size_t)j * m.N + n) * NPW + NR + k];
    }
  }
  unsigned long long top[TOP] = {0ull, 0ull, 0ull, 0ull};
  for (int j = tid; j < w.groups; j += FIN) {
    const long long* row = w.rows + ((size_t)j * m.N + n) * NBW;
#pragma unroll
    for (int k = 0; k < W_TOP; ++k) rs[4 + k] += row[k];
#pragma unroll
    for (int i = 0; i < TOP; ++i) {
      top_insert(top, (unsigned long long)row[W_TOP + i]);
    }
  }
  block_mins<NR>(cm, (unsigned long long*)red);
  block_sums<10>(rs, red);
  warp_top(top);
  if ((tid & 31) == 0) {
    for (int i = 0; i < TOP; ++i) s_t[tid >> 5][i] = top[i];
  }
  __syncthreads();
  if (tid < 32) {
    for (int i = 0; i < TOP; ++i) top[i] = tid < FW ? s_t[tid][i] : 0ull;
    warp_top(top);
  }

  // the surviving capacity, exactly
  double csc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    csc[r] = fixed_scale(__uint_as_float((unsigned)~cm[r]), (long long)m.B);
  }
  long long cq[NR] = {0, 0, 0, 0};
  for (int b = tid; b < m.B; b += FIN) {
    const float e = alive(b) ? 1.0f : 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      cq[r] += __double2ll_rn((double)(m.capacity[(size_t)b * NR + r] * e) *
                              csc[r]);
    }
  }

  // the totals' scale; brokers: overloaded, argmin of utilization, the
  // largest utilization
  double sc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) sc[r] = w.sc[n * NR + r];
  long long over = 0;
  unsigned long long mins[2] = {~0ull, ~0ull};   // argmin key, ~umax
  // broker b with its hosted load hq: overloaded, its utilization key
  auto broker = [&](int b, const long long hq[NR]) {
    const bool al = alive(b);
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
    mins[0] = min(mins[0], ((unsigned long long)ord32(um) << 32) | (unsigned)b);
    if (al) mins[1] = min(mins[1], ~(unsigned long long)ord32(util));
  };
  // a thread a broker of at most HEAVY items ...
  for (int b = tid; b < m.B; b += FIN) {
    const int it0 = w.istart[b], it1 = w.istart[b + 1];
    if (it1 - it0 > HEAVY) continue;   // on w.heavy's list
    long long hq[NR] = {0, 0, 0, 0};
    for (int it = it0; it < it1; ++it) {
      const long long* h = w.hosted + ((size_t)it * m.N + n) * NR;
#pragma unroll
      for (int r = 0; r < NR; ++r) hq[r] += h[r];
    }
    broker(b, hq);
  }
  // ... and a warp a heavier one, its lanes over the items
  const int lane = tid & 31;
  for (int j = tid >> 5; j < w.heavy[0]; j += FW) {
    const int b = w.heavy[1 + j];
    const int it0 = w.istart[b], it1 = w.istart[b + 1];
    long long hq[NR] = {0, 0, 0, 0};
    for (int it = it0 + lane; it < it1; it += 32) {
      const long long* h = w.hosted + ((size_t)it * m.N + n) * NR;
#pragma unroll
      for (int r = 0; r < NR; ++r) hq[r] += h[r];
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) hq[r] = warp_sum(hq[r]);
    if (lane == 0) broker(b, hq);
  }
  long long s5[NR + 1] = {cq[0], cq[1], cq[2], cq[3], over};
  block_sums<NR + 1>(s5, red);
  block_mins<2>(mins, (unsigned long long*)red);

  if (tid != 0) return;
  bool infeasible = false;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float cap_alive = __double2float_rn((double)s5[r] / csc[r]);
    const float total = __double2float_rn((double)rs[4 + r] / sc[r]);
    infeasible = infeasible || total > cap_alive;
  }
  const unsigned umax = (unsigned)~mins[1];   // ord32 of the largest; 0: none
  const int dst = (int)(mins[0] & 0xffffffffull);
  const int unav = (int)rs[C_UNAV];
  o.survivable[n] = unav == 0 && !infeasible;
  o.unavailable[n] = unav;
  o.under[n] = (int)rs[C_UNDER];
  o.infeasible[n] = infeasible;
  o.overloaded[n] = (int)s5[NR];
  o.rack_violations[n] = (int)rs[C_RACK];
  o.moves[n] = (int)rs[4 + W_MV];
  o.leadership_moves[n] = (int)rs[C_LEAD];
  o.data_move[n] = __double2float_rn((double)rs[4 + W_DM] / sc[DISK]);
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

bool args_ok(int N, int P, int S, int B, int sms) {
  return N >= 1 && N <= 65535 && P >= 1 && P < cc_sort::MAX_P && S >= 1 &&
         S <= MAX_S && B >= 1 && B <= MAX_B &&
         (long long)P * S < (1LL << 31) && sms >= 1;
}

Work work_of(char* buf, const Layout& L) {
  Work w;
  w.part = (unsigned*)(buf + L.part);
  w.sc = (double*)(buf + L.sc);
  w.scf = (float*)(buf + L.scf);
  w.heavy = (int*)(buf + L.heavy);
  w.bits = (unsigned*)(buf + L.bits);
  w.cursor = (int*)(buf + L.cursor);
  w.start = (int*)(buf + L.start);
  w.istart = (int*)(buf + L.istart);
  w.ibroker = (int*)(buf + L.ibroker);
  w.pos = (int*)(buf + L.pos);
  w.list = (unsigned*)(buf + L.list);
  w.scale_t = (float*)(buf + L.scale_t);
  w.hosted = (long long*)(buf + L.hosted);
  w.rows = (long long*)(buf + L.rows);
  w.stripes = L.stripes;
  w.groups = L.groups;
  w.items = L.items;
  w.words = L.words;
  w.ch = L.ch;
  return w;
}

// part's dynamic shared memory: its futures' survivor bits
int part_smem(int B) { return GB * ((B + 31) / 32) * 4; }

}  // namespace

extern "C" {

// The byte offsets of one call's 13 outputs (in verdict_kernels.KEYS'
// order) into off[0..12] and the buffer's size into off[13], for `sms`
// SMs.  Returns the CUDA error code.
int whatif_verdict_layout(int N, int P, int S, int B, int sms,
                          long long* off) {
  if (!args_ok(N, P, S, B, sms)) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(N, P, S, B, sms);
  for (int i = 0; i < 13; ++i) off[i] = L.out[i];
  off[13] = L.bytes;
  return 0;
}

// Launches K12 on `stream` into `buf` (whatif_verdict_layout's size):
// alive, part, sort_count, prep, scatter, brokers, finish; no memset and
// no host read.  Returns the CUDA error code.
int whatif_verdict_launch(const int* assignment, const int* leader_slot,
                          const float* leader_load, const float* follower_load,
                          const float* capacity, const int* rack,
                          const uint8_t* alive0, const uint8_t* dead,
                          const float* scale, int N, int P, int S, int B,
                          int sms, void* buf, void* stream) {
  if (!args_ok(N, P, S, B, sms)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Layout L = layout_of(N, P, S, B, sms);
  char* base = (char*)buf;
  const Base m{assignment, leader_slot, leader_load, follower_load, capacity,
               rack, alive0, dead, scale, N, P, S, B};
  const Work w = work_of(base, L);
  const Out o{(uint8_t*)(base + L.out[0]), (int*)(base + L.out[1]),
              (int*)(base + L.out[2]), (uint8_t*)(base + L.out[3]),
              (int*)(base + L.out[4]), (int*)(base + L.out[5]),
              (int*)(base + L.out[6]), (int*)(base + L.out[7]),
              (float*)(base + L.out[8]), (float*)(base + L.out[9]),
              (int*)(base + L.out[10]), (int*)(base + L.out[11]),
              (int*)(base + L.out[12])};
  const long long PS = (long long)P * S;
  const int hsm = (B < cc_sort::SORT_TB ? B : cc_sort::SORT_TB) *
                  (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      whatif_verdict_sort_count_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, hsm);
  if (e != cudaSuccess) return (int)e;
  long long sg = (PS + ST - 1) / ST;
  if (sg > 4LL * sms) sg = 4LL * sms;
  const int ng = (N + GB - 1) / GB;
  whatif_verdict_alive_kernel<<<dim3((B + AT - 1) / AT, N), AT, 0, st>>>(m,
                                                                         w);
  whatif_verdict_part_kernel<<<dim3(L.stripes, ng), PT, part_smem(B), st>>>(
      m, w);
  whatif_verdict_sort_count_kernel<<<L.sort_blocks, ST, hsm, st>>>(m, w);
  whatif_verdict_prep_kernel<<<1, QT, 0, st>>>(m, w);
  whatif_verdict_scatter_kernel<<<(int)sg, ST, 0, st>>>(m, w);
  whatif_verdict_brokers_kernel<<<dim3(L.groups, ng), BT, 0, st>>>(m, w);
  whatif_verdict_finish_kernel<<<N, FIN, 0, st>>>(m, w, o);
  return (int)cudaGetLastError();
}

// One of K12's kernels' resources — phase 0 alive, 1 part, 2 sort_count,
// 3 prep, 4 scatter, 5 brokers, 6 finish — at B brokers, as {registers a
// thread, local (spilled) bytes a thread, static shared bytes, dynamic
// shared bytes, resident blocks an SM}.  Returns the CUDA error code.
int whatif_verdict_attrs(int phase, int B, int* out) {
  if (B < 1 || B > MAX_B) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaSuccess;
  int threads = 0, dyn = 0, per_sm = 0;
  const void* fn = nullptr;
  switch (phase) {
    case 0:
      fn = (const void*)whatif_verdict_alive_kernel;
      threads = AT;
      break;
    case 1:
      fn = (const void*)whatif_verdict_part_kernel;
      threads = PT;
      dyn = part_smem(B);
      break;
    case 2:
      fn = (const void*)whatif_verdict_sort_count_kernel;
      threads = ST;
      dyn = (B < cc_sort::SORT_TB ? B : cc_sort::SORT_TB) * (int)sizeof(int);
      e = cudaFuncSetAttribute(whatif_verdict_sort_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dyn);
      break;
    case 3:
      fn = (const void*)whatif_verdict_prep_kernel;
      threads = QT;
      break;
    case 4:
      fn = (const void*)whatif_verdict_scatter_kernel;
      threads = ST;
      break;
    case 5:
      fn = (const void*)whatif_verdict_brokers_kernel;
      threads = BT;
      break;
    case 6:
      fn = (const void*)whatif_verdict_finish_kernel;
      threads = FIN;
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, dyn);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = dyn;
  out[4] = per_sm;
  return 0;
}

}  // extern "C"
