// K3 — per-source-broker reductions of a step, for Hopper (sm_90a).
//
// What it replaces.  cruise_control_tpu/analyzer/tpu_optimizer.py:2357
// `_reduce_leadership_per_src` (the best leadership transfer per current
// leader broker over the L leadership candidates: a scatter-min of the
// score, then a scatter-min of the lowest row that reaches it) and :2381
// `_topq_rows_per_src` (Q sequential passes of the same pair of
// scatter-mins over the K move rows' best scores, each knocking its chosen
// rows out for the next).  XLA runs them as a dozen fused scatters; the
// eager port ran ~60 launches a step.  This kernel is both, in one launch.
//
// How ties and order come out right.  Each candidate becomes one 64-bit
// key: the high 32 bits map its f32 score to an unsigned int whose order
// is the float order (-0.0 first made +0.0, so the two zeros tie as they
// do under `<=`), the low 32 bits hold its row index.  The unsigned
// minimum of the keys of one broker is then its (lowest score, lowest
// row) pair — exactly the two scatter-mins of the plain twin — and a
// 64-bit atomicMin reaches it in any order, so the result is the same
// every run.  analyzer/step_kernels.py: order_key is the same map in torch.
//
// What bounds it.  It reads the L candidates once (lp, lsl, score and a
// two-int gather of the leader broker: ~20 B each), the K move rows' best
// score and source broker once (8 B each; the passes reread them from
// cache), and writes 16 B + Q·8 B per broker: ~0.28 MB at L = K = 8 192,
// B = 1 000, Q = 4 — bound by bytes (~0.08 us at 3.35 TB/s).  Its real
// limit is that each of the Q passes depends on the last: the passes need
// a barrier between them.
//
// What the design does about it.  One block of 1 024 threads runs all
// 1 + Q passes, with a block barrier between passes instead of a kernel
// launch; the per-broker keys live in shared memory when 2·B·8 bytes fit
// (B ≤ 14 000), else in a global scratch the wrapper allocates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace cc_step;

constexpr int THREADS = 1024;
constexpr unsigned long long NONE = ~0ull;

__device__ __forceinline__ unsigned long long key64(float x, int i) {
  return ((unsigned long long)ord32(x) << 32) | (unsigned int)i;
}

__global__ void __launch_bounds__(THREADS)
per_src_top_kernel(const int* __restrict__ lp, const int* __restrict__ lsl,
                   const float* __restrict__ ls, int L,
                   const int* __restrict__ assignment,
                   const int* __restrict__ leader_slot, int S,
                   const int* __restrict__ sb,
                   const float* __restrict__ row_best, int ld, int K, int B,
                   int Q, float* __restrict__ bl_score,
                   int* __restrict__ bl_p, int* __restrict__ bl_s,
                   int* __restrict__ bl_dst, int* __restrict__ rows,
                   float* __restrict__ scores,
                   unsigned long long* gkeys, float* __restrict__ cur) {
  extern __shared__ unsigned long long skeys[];
  unsigned long long* lkey = gkeys ? gkeys : skeys;     // [B]
  unsigned long long* qkey = lkey + B;                  // [B]
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int b = tid; b < B; b += nt) {
    lkey[b] = NONE;
    qkey[b] = NONE;
  }
  for (int i = tid; i < K; i += nt) cur[i] = row_best[(size_t)i * ld];
  __syncthreads();

  // ---- best leadership transfer per current leader broker -------------
  for (int i = tid; i < L; i += nt) {
    const int p = lp[i];
    const int lb = assignment[(size_t)p * S + leader_slot[p]];
    atomicMin(&lkey[lb < 0 ? 0 : lb], key64(ls[i], i));
  }
  __syncthreads();
  for (int b = tid; b < B; b += nt) {
    const unsigned long long k = lkey[b];
    const int r = k == NONE ? L : (int)(k & 0xffffffffu);
    const int rc = r < L ? r : L - 1;
    const int p = lp[rc], s = lsl[rc];
    bl_score[b] = r < L ? ls[rc] : INFINITY;
    bl_p[b] = p;
    bl_s[b] = s;
    const int d = assignment[(size_t)p * S + s];
    bl_dst[b] = d < 0 ? 0 : d;
  }

  // ---- Q passes of the best finite move row per source broker ----------
  for (int q = 0; q < Q; ++q) {
    for (int i = tid; i < K; i += nt) {
      const float v = cur[i];
      if (isfinite(v)) atomicMin(&qkey[sb[i]], key64(v, i));
    }
    __syncthreads();
    // row r belongs to broker sb[r] alone, so only this thread reads and
    // knocks out cur[r]
    for (int b = tid; b < B; b += nt) {
      const unsigned long long k = qkey[b];
      const int r = k == NONE ? K : (int)(k & 0xffffffffu);
      rows[(size_t)q * B + b] = r;
      scores[(size_t)q * B + b] = r < K ? cur[r] : INFINITY;
      if (r < K) cur[r] = INFINITY;
      qkey[b] = NONE;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches K3 on `stream`; `keys` is a [2B] u64 scratch in device memory,
// or null to keep the keys in shared memory.  Returns the CUDA error code.
int per_src_top_launch(const int* lp, const int* lsl, const float* ls, int L,
                       const int* assignment, const int* leader_slot, int S,
                       const int* sb, const float* row_best, int ld, int K,
                       int B, int Q, float* bl_score, int* bl_p, int* bl_s,
                       int* bl_dst, int* rows, float* scores,
                       unsigned long long* keys, float* cur, void* stream) {
  if (L < 1 || K < 0 || B < 1 || Q < 0 || S < 1 || ld < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem =
      keys == nullptr ? 2 * B * (int)sizeof(unsigned long long) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      per_src_top_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  per_src_top_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      lp, lsl, ls, L, assignment, leader_slot, S, sb, row_best, ld, K, B, Q,
      bl_score, bl_p, bl_s, bl_dst, rows, scores, keys, cur);
  return (int)cudaGetLastError();
}

}  // extern "C"
