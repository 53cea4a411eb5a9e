// K13 — the score-only round's flat key and its packed result, for Hopper
// (sm_90a).  Two entry points, launched on either side of K11's top-k.
//
// What it replaces.  The round's flat ranking in
// cruise_control_tpu/analyzer/tpu_optimizer.py:2892 `_cached_round_fn`
// (the branch with mesh=None): `lax.top_k(-scores, k)` over the flat score
// vector, then :2875 `_decode_flat_idx` (grid form) or the columnar
// gathers (:2902 `columnar_topk`), and :2059 `_pack_round_result`.
//
//   (a) round_keys: key = -concat(a, b), literally negated.  Grid form:
//       a = K1's [K, R] raw grid scores (the reference's `-neg_best`,
//       :2308), b = K6's [L] leadership scores (:2334 `_merged_scores`);
//       columnar form: a = K14's [K·D + P·S] scores, b empty.  K11 then
//       keeps the k largest keys with ties to the lowest index in the
//       floats' total order — `top_k`'s order on its input, so a score of
//       -0.0 (key +0.0) ranks ahead of +0.0 (key -0.0) as in the
//       reference; ranking the raw scores ascending would tie or reverse
//       the two zeros.
//   (b) round_pack: for each of the k selected flat indices i, the score
//       -key[i] and the candidate it names, written as the packed f32
//       [5, k] (score, kind, partition, slot, destination).  Grid layout
//       (`_merged_scores`): i < K·R is the move of pool row i / R to
//       dest_pool[best_i[i / R, i % R]] (K1's pool index, so the broker
//       ids of the reference's `best_d` are looked up here), any other i
//       the leadership entry i - K·R of (lp, lsl); the row, the entry and
//       the column are clipped as `_decode_flat_idx` clips them.  Columnar
//       layout (`_build_round_candidates`): i < K·D is the move of pool
//       row i / D to dest_pool[i % D], any other i the leadership transfer
//       of partition (i - K·D) / S to slot (i - K·D) % S.
//
// Rounding.  Negation flips the sign bit only; ids below 2^24 convert to
// f32 exactly.  Both entry points equal the plain twin
// (analyzer/round_kernels.py: round_keys_plain, round_pack_plain) bit for
// bit.
//
// What bounds it.  (a) reads and writes N floats (N = 73 728 in the grid
// form at 1000b/20k, 8 252 000 in the columnar form: 66 MB, ~0.02 ms at
// 3.35 TB/s); (b) gathers k = 2 048 keys and a few ids each and writes 40
// KB: microseconds.  Both are bound by bytes.
//
// What the design does about it.  One thread per element, grid-stride,
// no shared state and no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KIND_MOVE = 0;
constexpr int KIND_LEADERSHIP = 1;   // analyzer/score_kernel.py
constexpr int LAYOUT_GRID = 0;       // analyzer/round_kernels.py
constexpr int LAYOUT_COLUMNAR = 1;

__device__ __forceinline__ long long clip(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(THREADS)
round_keys_kernel(const float* __restrict__ a, long long na,
                  const float* __restrict__ b, long long n,
                  float* __restrict__ key) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    key[i] = -(i < na ? a[i] : b[i - na]);
  }
}

struct Layout {
  int kind;                 // LAYOUT_GRID or LAYOUT_COLUMNAR
  long long K;              // move pool rows
  long long W;              // grid: R alternates a row; columnar: D
  long long L;              // grid: leadership entries
  int S;                    // columnar: replica slots a partition
  const int* kp;            // [K]
  const int* ks;            // [K]
  const int* dest_pool;     // [D]
  const int* best_i;        // grid: [K, R] pool index
  const int* lp;            // grid: [L]
  const int* lsl;           // grid: [L]
};

__global__ void __launch_bounds__(THREADS)
round_pack_kernel(const float* __restrict__ key, const int* __restrict__ sel,
                  int k, Layout lay, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const long long i = sel[j];
  const long long KW = lay.K * lay.W;
  const bool is_move = i < KW;
  int p, s, d;
  if (lay.kind == LAYOUT_GRID) {
    const long long row = clip(i / lay.W, lay.K - 1);
    const long long li = clip(i - KW, lay.L - 1);
    const long long col = clip(i % lay.W, lay.W - 1);
    p = is_move ? lay.kp[row] : lay.lp[li];
    s = is_move ? lay.ks[row] : lay.lsl[li];
    d = is_move ? lay.dest_pool[lay.best_i[row * lay.W + col]] : 0;
  } else {
    const long long jl = i - KW;
    p = is_move ? lay.kp[i / lay.W] : (int)(jl / lay.S);
    s = is_move ? lay.ks[i / lay.W] : (int)(jl % lay.S);
    d = is_move ? lay.dest_pool[i % lay.W] : 0;
  }
  out[j] = -key[i];
  out[k + j] = (float)(is_move ? KIND_MOVE : KIND_LEADERSHIP);
  out[2 * (long long)k + j] = (float)p;
  out[3 * (long long)k + j] = (float)s;
  out[4 * (long long)k + j] = (float)d;
}

int blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (int)(b < 0x7fffffffLL ? b : 0x7fffffffLL);
}

}  // namespace

extern "C" {

// (a) key[0, na + nb) = -(a then b) on `stream`; returns the CUDA error
// code (0 = launched).  `b` may be null when nb is 0.
int round_keys_launch(const float* a, long long na, const float* b,
                      long long nb, float* key, void* stream) {
  if (na < 0 || nb < 0 || na + nb < 1 || (nb > 0 && b == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = na + nb;
  round_keys_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      a, na, b, n, key);
  return (int)cudaGetLastError();
}

// (b) the packed f32 [5, k] of the k flat indices `sel` into `key` (of N
// entries), in the grid layout (layout 0: W = R, best_i [K, R], lp and
// lsl [L]) or the columnar layout (layout 1: W = D, S slots a partition);
// returns the CUDA error code.
int round_pack_launch(const float* key, long long N, const int* sel, int k,
                      int layout, int K, int W, int L, int S, const int* kp,
                      const int* ks, const int* dest_pool, const int* best_i,
                      const int* lp, const int* lsl, float* out,
                      void* stream) {
  const bool grid = layout == LAYOUT_GRID;
  if (k < 1 || K < 1 || W < 1 || N < k ||
      (layout != LAYOUT_GRID && layout != LAYOUT_COLUMNAR) ||
      (grid && (L < 1 || best_i == nullptr || lp == nullptr ||
                lsl == nullptr || N != (long long)K * W + L)) ||
      (!grid && (S < 1 || (N - (long long)K * W) % S != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  Layout lay{layout, K, W, L, S, kp, ks, dest_pool, best_i, lp, lsl};
  round_pack_kernel<<<blocks_for(k), THREADS, 0, (cudaStream_t)stream>>>(
      key, sel, k, lay, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
