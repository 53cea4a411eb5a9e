// K5 — the step's disjoint auction, for Hopper (sm_90a).
//
// What it replaces.  cruise_control_tpu/analyzer/tpu_optimizer.py:2684
// `_match_batch`: N candidates with A alternate (score, destination)
// pairs each bid, round after round, for destinations, source brokers and
// partitions that no two winners may share.  Per round every unmatched
// candidate proposes its current alternate; the lowest score per
// destination wins, ties to the lowest candidate index on all three
// conflict tables at once; a loser advances to its next alternate once
// its destination is full.  With `dest_cap` or `src_cap` above 1
// (`track_bars`) a destination or source takes a second winner only if it
// scores within `stack_ratio` of the first.  The eager port ran about 25
// launches a round for A = 8 rounds.  This kernel is every round, in one
// launch.
//
// How it stays equal to the plain twin.  The per-destination minimum is
// an unsigned atomicMin over the score mapped to an order-preserving
// 32-bit key (-0.0 made +0.0 first, as `<=` treats them), and the
// lowest-index tie-break an integer atomicMin on each of the three
// tables — both exact and order free.  Scores are only compared, never
// summed, and `stack_ratio * best` is one f32 product, as in torch.  The
// three tables stay packed in one [2B + P] vector as the reference packs
// them, so an id outside its table lands where the reference's lands.
//
// The cohort's footprint.  The step decides its budgeted cohort (K4) first
// and passes its accepted rows as `acc`; the kernel then starts from the
// cohort's occupancy — each accepted row's source broker, best destination
// (`cand_dst[:, 0]` clamped at 0) and partition representative taken —
// and treats the accepted rows' scores as +inf, which is what
// tpu_optimizer.py:1322-1334 build with three scatters and a mask before
// the auction.  With `acc` null it starts from the `used_*` tables.
//
// What bounds it.  It reads the N·A alternates once (8 B each) and the
// N candidates' ids and the initial occupancy, and writes 13 B a
// candidate: ~0.1 MB at N = 1 024, A = 8, B = 1 000 — bound by bytes
// (~0.03 us at 3.35 TB/s).  Its real limit is the chain of rounds, each
// reading the occupancy the last one wrote.  The first design took 23 us
// on an H100 at N = 1 024, B = 1 000: six barriers a round, each round
// re-filling the [2B + P] tie-break table and four [B] tables,
// every round run to the end, a candidate's ids and alternate re-read from
// device memory each round.
//
// What the design does about it.  One block of 1 024 threads loops over
// the rounds with three barriers a round: win (the bids' tied best stake
// their index on the three tables), winners (a winner is its tables'
// lowest index: it is the only thread to touch its three occupancy
// entries this round, so it updates them and the first-winner bars with
// plain stores; the bidders reset the minima they set, which nothing
// reads again this round), and one phase that resets the stakes, moves
// the losers at a full destination to their next alternate and makes the
// next round's bids.  Nothing is re-filled, and the bars need no reset (a
// broker's bar is +0.0 until its first winner, then that winner's score).
// That phase ends in a `__syncthreads_or` of "some candidate won or
// advanced": a round that changes neither leaves every table as it was,
// so every later round would repeat it, and the loop ends there.  With
// N <= 1 024 and A <= 8 (the step's) a thread keeps its candidate, its ids
// and its eight alternates in registers (two 16-byte loads of each table
// where aligned), so an advance reads no memory; otherwise the
// candidates' state sits beside the tables and an advance re-reads its
// alternate.  The tables sit in shared memory (28 KB at B = 1 000, N = P
// = 1 024; 208 KB at B = 10 000 without the bars), or in a global scratch
// the wrapper allocates when they do not fit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_step;

constexpr int THREADS = 1024;
constexpr int REG_A = 8;         // alternates a thread keeps in registers
// a candidate's round state: flags in the low bits, its pointer above
constexpr int ACTIVE = 1, PROP = 2, WIN = 4, TAKE = 8, PTR_SHIFT = 4;

// One candidate between phases: its current alternate (score, clamped
// destination), its packed source and partition entries, flags | pointer
struct Cand {
  float s;
  int d, sx, px, f;
};

struct Args {
  const float* score;            // [N, A]
  const int* dst;                // [N, A]
  const long long* cand_src;     // [N]
  const long long* cand_p;       // [N]
  int N, A, B, P;
  float tol;
  int dest_cap, src_cap;
  float stack_ratio;
  int rounds;
  const uint8_t* used_src;       // [B] or null
  const uint8_t* used_dst;       // [B] or null
  const uint8_t* used_p;         // [P] or null
  const uint8_t* acc;            // [N] or null
  uint8_t* take;                 // [N] out
  float* win_score;              // [N] out
  long long* win_dst;            // [N] out
};

// REG: N <= THREADS and A <= REG_A, a thread's candidate and alternates
// in registers; else every candidate's state in the workspace and its
// alternates re-read from device memory on an advance
template <bool REG>
__global__ void __launch_bounds__(THREADS)
match_batch_kernel(Args a, int* gws) {
  extern __shared__ int sws[];
  int* ws = gws ? gws : sws;
  const int N = a.N, A = a.A, B = a.B;
  const bool track = a.dest_cap > 1 || a.src_cap > 1;
  const int T = 2 * B + a.P;
  int* occ = ws;                                   // [T]
  int* fmin = occ + T;                             // [T]
  unsigned int* best = (unsigned int*)(fmin + T);  // [B]
  float* dbest = (float*)(best + B);               // [B] with track
  float* sbest = dbest + (track ? B : 0);          // [B] with track
  // the candidates' state without REG: [N] each
  float* cs_s = sbest + (track ? B : 0);
  int* cs_d = (int*)(cs_s + N);
  int* cs_sx = cs_d + N;
  int* cs_px = cs_sx + N;
  int* cs_f = cs_px + N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const unsigned int zero_key = ord32(0.0f);
  CC_STAMP(0);

  // a thread's candidate (REG) and its alternates; its cohort footprint's
  // source entry (-1: none; the last candidate of the thread's, REG)
  Cand reg{0.0f, 0, 0, 0, 0};
  int foot = -1;
  float sc[REG_A];
  int dc[REG_A];
  // candidate n's alternate pa → (score, clamped destination)
  auto alt = [&](int n, int pa, float* s, int* d) {
    if constexpr (REG) {
      float s_ = sc[0];
      int d_ = dc[0];
#pragma unroll
      for (int j = 1; j < REG_A; ++j) {
        if (j == pa) {
          s_ = sc[j];
          d_ = dc[j];
        }
      }
      *s = s_;
      *d = d_;
    } else {
      *s = a.score[(size_t)n * A + pa];
      *d = max(a.dst[(size_t)n * A + pa], 0);
    }
  };
  // body(c, n) on each candidate of this thread, its state kept between
  // phases
  auto each = [&](auto&& body) {
    if constexpr (REG) {
      if (tid < N) body(reg, tid);
    } else {
      for (int n = tid; n < N; n += nt) {
        Cand c{cs_s[n], cs_d[n], cs_sx[n], cs_px[n], cs_f[n]};
        body(c, n);
        cs_s[n] = c.s;
        cs_d[n] = c.d;
        cs_f[n] = c.f;
      }
    }
  };

  // ---- the tables and the candidates' first alternates ------------------
  for (int x = tid; x < T; x += nt) {
    occ[x] = a.acc != nullptr ? 0
             : x < B          ? a.used_dst[x] * a.dest_cap
             : x < 2 * B      ? a.used_src[x - B] * a.src_cap
                              : a.used_p[x - 2 * B];
    fmin[x] = N;
  }
  for (int b = tid; b < B; b += nt) {
    best[b] = ~0u;
    if (track) dbest[b] = sbest[b] = 0.0f;
  }
  // a row of eight alternates is two 16-byte loads of each table where
  // both tables are 16-byte aligned
  const bool vec = A == REG_A && ((uintptr_t)a.score & 15) == 0 &&
                   ((uintptr_t)a.dst & 15) == 0;
  for (int n = tid; n < N; n += nt) {
    Cand c;
    if constexpr (REG) {
      if (vec) {
        const float4* s4 = (const float4*)(a.score + (size_t)n * REG_A);
        const int4* d4 = (const int4*)(a.dst + (size_t)n * REG_A);
        const float4 s0 = s4[0], s1 = s4[1];
        const int4 d0 = d4[0], d1 = d4[1];
        sc[0] = s0.x, sc[1] = s0.y, sc[2] = s0.z, sc[3] = s0.w;
        sc[4] = s1.x, sc[5] = s1.y, sc[6] = s1.z, sc[7] = s1.w;
        dc[0] = d0.x, dc[1] = d0.y, dc[2] = d0.z, dc[3] = d0.w;
        dc[4] = d1.x, dc[5] = d1.y, dc[6] = d1.z, dc[7] = d1.w;
#pragma unroll
        for (int j = 0; j < REG_A; ++j) dc[j] = max(dc[j], 0);
      } else {
#pragma unroll
        for (int j = 0; j < REG_A; ++j) {
          sc[j] = j < A ? a.score[(size_t)n * A + j] : INFINITY;
          dc[j] = j < A ? max(a.dst[(size_t)n * A + j], 0) : 0;
        }
      }
    }
    alt(n, 0, &c.s, &c.d);
    if (a.acc != nullptr && a.acc[n]) c.s = INFINITY;
    const long long src = a.cand_src[n];
    c.sx = B + (int)src;
    c.px = 2 * B + (int)max(a.cand_p[n], 0ll);
    c.f = 0;
    if (a.acc != nullptr && a.acc[n]) {
      // the cohort's footprint, written after the tables' fill (below)
      foot = B + (int)max(src, 0ll);
    }
    if constexpr (REG) {
      reg = c;
    } else {
      cs_s[n] = c.s;
      cs_d[n] = c.d;
      cs_sx[n] = c.sx;
      cs_px[n] = c.px;
      cs_f[n] = c.f;
    }
    a.take[n] = 0;
    a.win_score[n] = INFINITY;
    a.win_dst[n] = 0;
  }
  __syncthreads();
  if (a.acc != nullptr) {
    // the cohort's footprint (plain writes of one value: order free)
    if constexpr (REG) {
      if (foot >= 0) {
        occ[reg.d] = a.dest_cap;
        occ[foot] = a.src_cap;
        occ[reg.px] = 1;
      }
    } else {
      for (int n = tid; n < N; n += nt) {
        if (a.acc[n]) {
          occ[cs_d[n]] = a.dest_cap;
          occ[B + (int)max(a.cand_src[n], 0ll)] = a.src_cap;
          occ[cs_px[n]] = 1;
        }
      }
    }
    __syncthreads();
  }
  CC_STAMP(1);

  // ---- propose: the round's bids and their per-destination minimum ------
  auto propose = [&](Cand& c) {
    const int ptr = c.f >> PTR_SHIFT;
    const int os = occ[c.sx], op = occ[c.px], od = occ[c.d];
    bool active = !(c.f & TAKE) && ptr < A && c.s < a.tol &&
                  os < a.src_cap && op < 1;
    bool prop = active && od < a.dest_cap;
    if (track) {
      active = active &&
               (os == 0 || c.s <= a.stack_ratio * sbest[c.sx - B]);
      prop = active && od < a.dest_cap &&
             (od == 0 || c.s <= a.stack_ratio * dbest[c.d]);
    }
    c.f = (ptr << PTR_SHIFT) | (c.f & TAKE) | (active ? ACTIVE : 0) |
          (prop ? PROP : 0);
    if (prop) atomicMin(&best[c.d], ord32(c.s));
  };
  each([&](Cand& c, int) { propose(c); });
  __syncthreads();
  CC_STAMP(2);

  for (int round = 0; round < a.rounds; ++round) {
    // ---- the tied best stake their index on all three tables -----------
    each([&](Cand& c, int n) {
      if ((c.f & PROP) && ord32(c.s) <= best[c.d]) {
        c.f |= WIN;
        atomicMin(&fmin[c.d], n);
        atomicMin(&fmin[c.sx], n);
        atomicMin(&fmin[c.px], n);
      }
    });
    __syncthreads();
    CC_STAMP(3 + 3 * round);
    // ---- winners: the lowest index on all three tables.  A winner is the
    // only thread touching its three entries this round: it reads the
    // occupancy as the round began, sets the first-winner bars and adds
    // itself with plain stores.  The proposers reset the minima (read no
    // more this round; the next bids come after a barrier) -------------
    bool changed = false;
    each([&](Cand& c, int n) {
      if (c.f & PROP) best[c.d] = ~0u;
      if (!(c.f & WIN)) return;
      if (fmin[c.d] == n && fmin[c.sx] == n && fmin[c.px] == n) {
        if (track) {
          const float bar = from_ord32(min(ord32(c.s), zero_key));
          if (occ[c.d] == 0) dbest[c.d] = bar;
          if (occ[c.sx] == 0) sbest[c.sx - B] = bar;
        }
        occ[c.d] += 1;
        occ[c.sx] += 1;
        occ[c.px] += 1;
        c.f |= TAKE;
        a.take[n] = 1;
        a.win_score[n] = c.s;
        a.win_dst[n] = c.d;
        changed = true;
      }
    });
    __syncthreads();
    CC_STAMP(4 + 3 * round);
    if (round + 1 == a.rounds) break;
    // ---- the stakes reset; losers at a full destination advance; the
    // next round's bids.  A round that changed nothing is the auction's
    // fixed point: every later round would repeat it ---------------------
    each([&](Cand& c, int n) {
      if (c.f & WIN) {
        fmin[c.d] = N;
        fmin[c.sx] = N;
        fmin[c.px] = N;
      }
      if ((c.f & ACTIVE) && !(c.f & TAKE)) {
        bool blocked = occ[c.d] >= a.dest_cap;
        if (track) {
          blocked = blocked ||
                    (occ[c.d] > 0 && c.s > a.stack_ratio * dbest[c.d]);
        }
        if (blocked) {
          const int ptr = (c.f >> PTR_SHIFT) + 1;
          c.f = ptr << PTR_SHIFT;
          alt(n, min(ptr, A - 1), &c.s, &c.d);
          changed = true;
        }
      }
      propose(c);
    });
    const bool any = __syncthreads_or(changed) != 0;
    CC_STAMP(5 + 3 * round);
    if (!any) break;
  }
}

}  // namespace

extern "C" {

// Shared memory a block's workspace may take
constexpr long long SMEM_MAX = 232448 - 1024;

// Bytes of the workspace of a [B, N, P] auction: the tables, the minima,
// the first-winner bars when `track`, and the candidates' state unless
// they are kept in registers (N <= 1 024 and A <= 8)
long long workspace_bytes(int N, int A, int B, int P, bool track) {
  const bool reg = N <= THREADS && A <= REG_A;
  return 4 * (2ll * (2ll * B + P) + (track ? 3ll : 1ll) * B +
              (reg ? 0ll : 5ll * N));
}

// Bytes of device scratch the wrapper passes as `gws` (with caps above 1
// when `track`): 0 where the workspace fits in shared memory.
long long match_batch_scratch_bytes(int N, int A, int B, int P,
                                    int track) {
  const long long bytes = workspace_bytes(N, A, B, P, track != 0);
  return bytes <= SMEM_MAX ? 0 : bytes;
}

// Launches K5 on `stream` (one block): from the cohort `acc` when it is
// not null, else from the three `used_*` tables.  `gws` is null or
// match_batch_scratch_bytes(...) of device scratch.  Returns the CUDA
// error code.
int match_batch_launch(const float* score, const int* dst,
                       const long long* cand_src, const long long* cand_p,
                       int N, int A, int B, int P, float tol, int dest_cap,
                       int src_cap, float stack_ratio, int rounds,
                       const uint8_t* used_src, const uint8_t* used_dst,
                       const uint8_t* used_p, const uint8_t* acc,
                       uint8_t* take, float* win_score, long long* win_dst,
                       int* gws, void* stream) {
  if (N < 0 || A < 1 || A > (1 << 26) || B < 1 || P < 1 || rounds < 0 ||
      dest_cap < 1 || src_cap < 1 ||
      (acc == nullptr) == (used_src == nullptr || used_dst == nullptr ||
                           used_p == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long bytes =
      workspace_bytes(N, A, B, P, dest_cap > 1 || src_cap > 1);
  if (gws == nullptr && bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int smem = gws == nullptr ? (int)bytes : 0;
  Args a{score, dst, cand_src, cand_p, N, A, B, P, tol, dest_cap, src_cap,
         stack_ratio, rounds, used_src, used_dst, used_p, acc, take,
         win_score, win_dst};
  cudaError_t e;
  if (N <= THREADS && A <= REG_A) {
    e = cudaFuncSetAttribute(match_batch_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    match_batch_kernel<true><<<1, THREADS, smem, (cudaStream_t)stream>>>(
        a, gws);
  } else {
    e = cudaFuncSetAttribute(match_batch_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    match_batch_kernel<false><<<1, THREADS, smem, (cudaStream_t)stream>>>(
        a, gws);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
