// Helpers the step's kernels share: the order-preserving key of an f32
// score, the order-free fixed-point scale of ops/segment.py, a prefix
// count inside one block, and the layout of the step loop's device
// carry.  One copy, so the kernels that must agree on an
// order or on a sum's bits (K3, K4, K5, K7, K8, K9, K10, K11, K16) cannot
// drift apart.

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

// fixed_q's f32 factor for a fixed_scale 2^k: 2^k itself when it is a
// normal f32, else 0 (fixed_q then multiplies in f64)
__device__ __forceinline__ float fixed_scale_f(double sc) {
  return (sc >= 0x1p-126 && sc <= 0x1p127) ? (float)sc : 0.0f;
}

// round_half_even(v · sc) as int64, sc = 2^k from fixed_scale and scf =
// fixed_scale_f(sc): ops/segment.py's torch.round(v64 * sc) bit for bit.
// An f32 times a power of two is exact wherever the product is a normal
// f32, and a product below 2^-126 rounds to 0 either way; it cannot
// overflow, as |v · sc| < 2^60 by the scale's choice.  So one f32
// multiply and one f32 → s64 conversion stand for two conversions and an
// f64 multiply.
__device__ __forceinline__ long long fixed_q(float v, float scf, double sc) {
  return scf != 0.0f ? __float2ll_rn(v * scf)
                     : __double2ll_rn((double)v * sc);
}

// The block-wide exclusive count of a flag over one chunk of blockDim.x
// entries, one a thread in thread order: the set flags on lower threads,
// and the chunk's total in `*total`.  Every thread of the block calls it;
// `warp_tot` is a shared scratch of blockDim.x / 32 ints.  It ends on a
// barrier, so the next call may reuse the scratch.  K7 gathers its kept
// rows and K16 compacts its index lists in stable order with it.
__device__ __forceinline__ int block_count_before(bool flag, int* warp_tot,
                                                  int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned ball = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_tot[warp] = __popc(ball);
  __syncthreads();
  int before = __popc(ball & ((1u << lane) - 1u)), tot = 0;
  for (int w = 0; w < nw; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    tot += t;
  }
  __syncthreads();
  *total = tot;
  return before;
}

}  // namespace cc_step

// Phase stamps, compiled in only with -DCC_PHASE_STAMPS: tools/
// time_kernels.py builds such a copy of a one-block kernel to split its
// device time by phase.  CC_STAMP(i) has thread 0 write %globaltimer (ns)
// and clock64() (the SM's cycles) as stamp i into the buffer that
// cc_phase_stamps() set; a kernel stamps right after the barrier that
// ends a phase (CC_STAMP_SYNC adds that barrier where the phase ends
// without one).  Without the macro both are nothing.
#ifdef CC_PHASE_STAMPS
__device__ unsigned long long* cc_stamp_buf;

__device__ __forceinline__ void cc_stamp(int i) {
  if (threadIdx.x == 0 && cc_stamp_buf != nullptr) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    cc_stamp_buf[2 * i] = t;
    cc_stamp_buf[2 * i + 1] = (unsigned long long)clock64();
  }
}

extern "C" int cc_phase_stamps(unsigned long long* buf) {
  return (int)cudaMemcpyToSymbol(cc_stamp_buf, &buf, sizeof(buf));
}
#define CC_STAMP(i) cc_stamp(i)
#define CC_STAMP_SYNC(i) \
  do {                   \
    __syncthreads();     \
    cc_stamp(i);         \
  } while (0)
#else
#define CC_STAMP(i) ((void)0)
#define CC_STAMP_SYNC(i) ((void)0)
#endif

// The step loop's carry on the device: indices into the int32 state vector
// (analyzer/step_state.py holds the same layout).  K8 advances it after each
// step's commit; K10 and K11 act only when it asks for a repool; K16 decides
// each incremental step's full rescore or patch.
namespace cc_state {

constexpr int DONE = 0, STEP = 1, COUNT = 2, SINCE_POOL = 3, PT_VALID = 4;
constexpr int N_INCR = 5, ACTIVE = 6, NEED_POOL = 7, REPOOL = 8, FULL = 9;
constexpr int N_REPOOL = 10;
// the incremental rescore (K16 writes, K17 and the gated K1 / K6 read)
// and the call's step cap (K8 reads)
constexpr int SINCE_FULL = 11, N_OVF = 12, FRESH = 13, T_CAP = 14;
constexpr int N_PATCH = 15;
constexpr int NSTATE = 16;

// Whether a kernel gated on the carry runs this step: the step is active
// and its FRESH flag is `want` (1: the full rescore, 0: the patch).
__device__ __forceinline__ bool gate_open(const int* state, int want) {
  return state[ACTIVE] != 0 && state[FRESH] == want;
}

}  // namespace cc_state

#endif  // CRUISE_CONTROL_STEP_COMMON_CUH_
