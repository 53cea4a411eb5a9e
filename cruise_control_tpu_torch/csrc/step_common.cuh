// Helpers the step's kernels share: the order-preserving key of an f32
// score, the order-free fixed-point scale of ops/segment.py, a bitonic
// sort inside one block and the layout of the step loop's device carry.
// One copy, so the kernels that must agree on an order or on a sum's bits
// (K3, K4, K5, K7, K8, K9, K10, K11) cannot drift apart.

#ifndef CRUISE_CONTROL_STEP_COMMON_CUH_
#define CRUISE_CONTROL_STEP_COMMON_CUH_

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cc_step {

// An unsigned int whose order is the f32 order: -0.0 is keyed as +0.0 (the
// two tie, as `<=` and the stable sort compare them) and +inf above every
// finite value.  analyzer/step_kernels.py: order_key is the same map.
__device__ __forceinline__ unsigned int ord32(float x) {
  const unsigned int u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The score an ord32 key stands for (+0.0 for either zero)
__device__ __forceinline__ float from_ord32(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

constexpr int FP_BITS = 60;      // ops/segment.py: _FP_BITS

__device__ __forceinline__ int ceil_log2(long long n) {
  return n <= 1 ? 0 : 64 - __clzll(n - 1);
}

// ops/segment.py: _to_fixed — the scale 2^(60 - e) of a column of n rows,
// e from the column's exact max |v| and the row count, so every order of
// summation finds the same scale
__device__ __forceinline__ double fixed_scale(float maxabs, long long n) {
  int ex;
  frexp((double)maxabs, &ex);
  return exp2((double)(FP_BITS - (ex + ceil_log2(n))));
}

// Ascending bitonic sort of n2 (a power of two) keys by one block; every
// thread of the block calls it.
__device__ void bitonic_sort(unsigned long long* key, int n2) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < n2 / 2; t += nt) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = key[lo], b = key[hi];
        if ((a > b) == ((lo & size) == 0)) {
          key[lo] = b;
          key[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace cc_step

// The step loop's carry on the device: indices into the int32 state vector
// (analyzer/step_state.py holds the same layout).  K8 advances it after each
// step's commit; K10 and K11 act only when it asks for a repool.
namespace cc_state {

constexpr int DONE = 0, STEP = 1, COUNT = 2, SINCE_POOL = 3, PT_VALID = 4;
constexpr int N_INCR = 5, ACTIVE = 6, NEED_POOL = 7, REPOOL = 8, FULL = 9;
constexpr int N_REPOOL = 10;
constexpr int NSTATE = 16;

}  // namespace cc_state

#endif  // CRUISE_CONTROL_STEP_COMMON_CUH_
