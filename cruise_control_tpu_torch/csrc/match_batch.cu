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
// launch, and runs all rounds as the plain twin does: a round that
// changes nothing is a fixed point the later rounds repeat.
//
// How it stays equal to the plain twin.  The per-destination minimum is
// an unsigned atomicMin over the score mapped to an order-preserving
// 32-bit key (-0.0 made +0.0 first, as `<=` treats them), and the
// lowest-index tie-break an integer atomicMin on each of the three
// tables — both exact and order free.  Scores are only compared, never
// summed, and `stack_ratio * best` is one f32 product, as in torch.
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
// reading the occupancy the last one wrote, with four dependent phases a
// round (propose, per-destination minimum, three-table tie-break, then
// occupancy and pointer updates).
//
// What the design does about it.  One persistent block of 1 024 threads
// loops over the rounds with block barriers between the phases; the
// [2B + P] occupancy and tie-break tables, the per-destination and
// per-source minima and each candidate's round state sit in shared
// memory (60 KB at B = 1 000, N = P = 1 024), or in a global scratch the
// wrapper allocates when they do not fit.  Threads loop over candidates
// where N exceeds the block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_step;

constexpr int THREADS = 1024;
constexpr int ACTIVE = 1, PROP = 2, WIN = 4;

__global__ void __launch_bounds__(THREADS)
match_batch_kernel(const float* __restrict__ score,
                   const int* __restrict__ dst,
                   const long long* __restrict__ cand_src,
                   const long long* __restrict__ cand_p, int N, int A,
                   int B, int P, float tol, int dest_cap, int src_cap,
                   float stack_ratio, int rounds,
                   const uint8_t* __restrict__ used_src,
                   const uint8_t* __restrict__ used_dst,
                   const uint8_t* __restrict__ used_p,
                   const uint8_t* __restrict__ acc,
                   uint8_t* __restrict__ take, float* __restrict__ win_score,
                   long long* __restrict__ win_dst, int* gws) {
  extern __shared__ int sws[];
  int* ws = gws ? gws : sws;
  const int T = 2 * B + P;
  int* occ = ws;                                   // [T]
  int* fmin = occ + T;                             // [T]
  unsigned int* best = (unsigned int*)(fmin + T);  // [B]
  unsigned int* dmin = best + B;                   // [B]
  unsigned int* smin = dmin + B;                   // [B]
  float* dbest = (float*)(smin + B);               // [B]
  float* sbest = dbest + B;                        // [B]
  int* ptr = (int*)(sbest + B);                    // [N]
  float* cur_s = (float*)(ptr + N);                // [N]
  int* cur_d = (int*)(cur_s + N);                  // [N]
  int* st = cur_d + N;                             // [N]
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool track = dest_cap > 1 || src_cap > 1;
  const unsigned int zero_key = ord32(0.0f);

  for (int x = tid; x < T; x += nt) {
    occ[x] = acc != nullptr ? 0
             : x < B        ? used_dst[x] * dest_cap
             : x < 2 * B    ? used_src[x - B] * src_cap
                            : used_p[x - 2 * B];
    fmin[x] = N;
  }
  for (int b = tid; b < B; b += nt) {
    best[b] = ~0u;
    dmin[b] = smin[b] = zero_key;
    dbest[b] = sbest[b] = 0.0f;
  }
  for (int n = tid; n < N; n += nt) {
    ptr[n] = 0;
    take[n] = 0;
    win_score[n] = INFINITY;
    win_dst[n] = 0;
  }
  __syncthreads();
  if (acc != nullptr) {
    // the cohort's footprint (plain writes of one value: order free)
    for (int n = tid; n < N; n += nt) {
      if (acc[n]) {
        occ[max(dst[(size_t)n * A], 0)] = dest_cap;
        occ[B + (int)max(cand_src[n], 0ll)] = src_cap;
        occ[2 * B + (int)max(cand_p[n], 0ll)] = 1;
      }
    }
    __syncthreads();
  }

  for (int round = 0; round < rounds; ++round) {
    // ---- propose; per-destination score minimum ------------------------
    for (int n = tid; n < N; n += nt) {
      const int pa = min(max(ptr[n], 0), A - 1);
      const float s =
          (acc != nullptr && acc[n]) ? INFINITY : score[(size_t)n * A + pa];
      const int d = max(dst[(size_t)n * A + pa], 0);
      const int src = (int)cand_src[n];
      const int p = (int)max(cand_p[n], 0ll);
      const int od = occ[d], os = occ[B + src], op = occ[2 * B + p];
      bool active = !take[n] && ptr[n] < A && s < tol && os < src_cap &&
                    op < 1;
      bool prop = active && od < dest_cap;
      if (track) {
        active = active && (os == 0 || s <= stack_ratio * sbest[src]);
        prop = active && od < dest_cap &&
               (od == 0 || s <= stack_ratio * dbest[d]);
      }
      cur_s[n] = s;
      cur_d[n] = d;
      st[n] = (active ? ACTIVE : 0) | (prop ? PROP : 0);
      if (prop) atomicMin(&best[d], ord32(s));
    }
    __syncthreads();
    // ---- best per destination; lowest index on all three tables -------
    for (int n = tid; n < N; n += nt) {
      if ((st[n] & PROP) && ord32(cur_s[n]) <= best[cur_d[n]]) {
        st[n] |= WIN;
        atomicMin(&fmin[cur_d[n]], n);
        atomicMin(&fmin[B + (int)cand_src[n]], n);
        atomicMin(&fmin[2 * B + (int)max(cand_p[n], 0ll)], n);
      }
    }
    __syncthreads();
    for (int n = tid; n < N; n += nt) {
      if (st[n] & WIN) {
        const int src = (int)cand_src[n];
        if (fmin[cur_d[n]] == n && fmin[B + src] == n &&
            fmin[2 * B + (int)max(cand_p[n], 0ll)] == n) {
          take[n] = 1;
          if (track) {
            atomicMin(&dmin[cur_d[n]], ord32(cur_s[n]));
            atomicMin(&smin[src], ord32(cur_s[n]));
          }
        } else {
          st[n] &= ~WIN;
        }
      }
    }
    __syncthreads();
    // ---- first-winner bars (occupancy still as the round began); reset --
    for (int b = tid; b < B; b += nt) {
      if (track) {
        if (occ[b] == 0) dbest[b] = from_ord32(dmin[b]);
        if (occ[B + b] == 0) sbest[b] = from_ord32(smin[b]);
      }
      best[b] = ~0u;
      dmin[b] = smin[b] = zero_key;
    }
    for (int x = tid; x < T; x += nt) fmin[x] = N;
    __syncthreads();
    // ---- occupancy ------------------------------------------------------
    for (int n = tid; n < N; n += nt) {
      if (st[n] & WIN) {
        atomicAdd(&occ[cur_d[n]], 1);
        atomicAdd(&occ[B + (int)cand_src[n]], 1);
        atomicAdd(&occ[2 * B + (int)max(cand_p[n], 0ll)], 1);
        win_score[n] = cur_s[n];
        win_dst[n] = cur_d[n];
      }
    }
    __syncthreads();
    // ---- losers at a full destination advance ---------------------------
    for (int n = tid; n < N; n += nt) {
      const int d = cur_d[n];
      bool blocked = occ[d] >= dest_cap;
      if (track) {
        blocked = blocked || (occ[d] > 0 && cur_s[n] > stack_ratio * dbest[d]);
      }
      if ((st[n] & ACTIVE) && !(st[n] & WIN) && blocked) ptr[n] += 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Workspace words (4 B each) of a [B, N, P] auction: the wrapper keeps it
// in shared memory when it fits, else passes a device scratch as `gws`.
long long match_batch_workspace_words(int N, int B, int P) {
  return 2ll * (2ll * B + P) + 5ll * B + 4ll * N;
}

// Launches K5 on `stream` (one block): from the cohort `acc` when it is
// not null, else from the three `used_*` tables.  Returns the CUDA error
// code.
int match_batch_launch(const float* score, const int* dst,
                       const long long* cand_src, const long long* cand_p,
                       int N, int A, int B, int P, float tol, int dest_cap,
                       int src_cap, float stack_ratio, int rounds,
                       const uint8_t* used_src, const uint8_t* used_dst,
                       const uint8_t* used_p, const uint8_t* acc,
                       uint8_t* take, float* win_score, long long* win_dst,
                       int* gws, void* stream) {
  if (N < 0 || A < 1 || B < 1 || P < 1 || rounds < 0 || dest_cap < 1 ||
      src_cap < 1 ||
      (acc == nullptr) == (used_src == nullptr || used_dst == nullptr ||
                           used_p == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long bytes = 4 * match_batch_workspace_words(N, B, P);
  const int smem = gws == nullptr ? (int)bytes : 0;
  cudaError_t e = cudaFuncSetAttribute(
      match_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  match_batch_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      score, dst, cand_src, cand_p, N, A, B, P, tol, dest_cap, src_cap,
      stack_ratio, rounds, used_src, used_dst, used_p, acc, take, win_score,
      win_dst, gws);
  return (int)cudaGetLastError();
}

}  // extern "C"
