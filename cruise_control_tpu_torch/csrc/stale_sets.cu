// K16 — the incremental rescore's stale sets and decision, for Hopper
// (sm_90a).
//
// What it replaces.  The head of the reference's incremental rescore,
// cruise_control_tpu/analyzer/tpu_optimizer.py:1075-1095 (with :1157 and
// the `argsort`s of :1098, :1130 and :1146): from the step before's
// commits — the brokers `tb` [B] and partitions `tpm` [P] it touched (K8
// marks them) — the stale pool rows `row_stale[k] = tpm[kp[k]]`, the stale
// destination columns `col_stale[j] = dest_pool[j] >= 0 && tb[dest_pool[j]]`
// and the stale leadership entries `l_stale[i] = tpm[lp[i]] |
// tb[leader broker of lp[i]] | tb[broker in slot lsl[i]]`; the overflow
// test of their counts against the budgets RB, CB, LB; the step's decision
// `fresh = repool | overflow | since_full >= refresh_steps`; the carry's
// N_OVF, SINCE_FULL, FRESH and N_PATCH; and the index lists the patch
// reads, each the first RB / CB / LB of `argsort(~stale)` (stable: stale
// indices ascending, then the others ascending), the column list as pool
// indices with -1 where the column is not stale.  It reads REPOOL, which K10
// set this step (K10 has already cleared NEED_POOL).  An inactive step
// (past the loop's end) writes nothing.  Its plain twin is
// analyzer/rescore_kernels.py: stale_sets_plain.
//
// What bounds it.  It reads K + D + L pool entries and, per leadership
// entry, two assignment words and a leader slot (~24 B), plus the marks
// they index: ~0.3 MB at K = L = 8 192, D = 1 000 — bytes (~0.1 us at
// 3.35 TB/s).  Its real limit is latency: a leadership entry's test is a
// chain of four dependent loads (lp, then leader_slot and assignment, then
// tb), and every position depends on the stale entries of the whole list
// ahead of it.
//
// What the design does about it.  One cooperative launch over the three
// lists cut into tiles of THREADS entries, a tile a block (up to
// MAX_TILES a block where the lists outgrow the card's resident blocks):
// each thread tests its entry once and keeps the flag and its warp's
// ballot in registers, so the dependent chains of ~17 000 entries run side
// by side on many SMs.  Each block writes its tiles' stale counts to a
// small global array; one grid barrier; then each block sums the counts of
// its list's tiles ahead of it (its base) and of the whole list (n), and a
// thread writes its position as the twin's stable order gives it:
// `before = base + the warps ahead + popc(ballot & lanemask_lt)` for a
// stale entry, `n + (i - before)` for the others, where it is under the
// budget.  Block 0's thread 0 writes the counts, the decision and the
// carry, in the twin's order.  An inactive step: every block reads ACTIVE
// and returns before the barrier.
//
// Its ceiling.  One launch holds at most MAX_TILES tiles a resident block
// (stale_sets_max_tiles): 132 SMs × 8 blocks × 8 = 8 448 tiles, ~2.16 M
// entries of K + D + L, on an NVIDIA H100 80GB HBM3.  Past it the wrapper
// raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "step_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;   // entries a tile (a block's pass)
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TILES = 8;   // tiles a block holds in registers
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_TILES <= WARPS, "a warp sums each tile's base");

struct In {
  const int* assignment;     // [P, S]
  const int* leader_slot;    // [P]
  const int* kp;             // [K]
  const int* dest_pool;      // [D]
  const int* lp;             // [L]
  const int* lsl;            // [L]
  const uint8_t* tb;         // [B]
  const uint8_t* tpm;        // [P]
  int S;
};

struct Args {
  In in;
  int len[3];       // K, D, L
  int budget[3];    // RB, CB, LB
  int tiles[3];     // tiles of each list
  int T;            // tiles in all
  int refresh;
  int* state;
  int* out[3];      // ridx, cidx, lidx
  int* nstale;      // [3]
  int* tile_tot;    // [T] stale entries of each tile
};

// entry i of list `which` (0 rows, 1 columns, 2 leadership) is stale
__device__ __forceinline__ bool stale(const In& in, int which, int i) {
  if (which == 0) return in.tpm[in.kp[i]] != 0;
  if (which == 1) {
    const int d = in.dest_pool[i];
    return d >= 0 && in.tb[d] != 0;
  }
  const int p = in.lp[i];
  const int* row = in.assignment + (size_t)p * in.S;
  const int lb = max(row[in.leader_slot[p]], 0);
  const int sb = max(row[in.lsl[i]], 0);
  return in.tpm[p] != 0 || in.tb[lb] != 0 || in.tb[sb] != 0;
}

// Args' arrays picked by selects, not indexed: a runtime index into a
// kernel parameter's array would copy it to local memory
template <class X>
__device__ __forceinline__ X pick(const X (&x)[3], int w) {
  return w == 0 ? x[0] : w == 1 ? x[1] : x[2];
}

// tile t → its list w and the list's first tile t0 in the numbering
__device__ __forceinline__ void locate(const Args& a, int t, int* w,
                                       int* t0) {
  const int e1 = a.tiles[0], e2 = a.tiles[0] + a.tiles[1];
  *w = t < e1 ? 0 : t < e2 ? 1 : 2;
  *t0 = t < e1 ? 0 : t < e2 ? e1 : e2;
}

// one warp: the sum of tile_tot[lo, hi), read past L1 (other blocks wrote
// it before the grid barrier)
__device__ __forceinline__ int warp_sum(const int* tot, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  int s = 0;
  for (int t = lo + lane; t < hi; t += 32) s += __ldcg(tot + t);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

__global__ void __launch_bounds__(THREADS) stale_sets_kernel(Args a) {
  __shared__ int s_warp[MAX_TILES][WARPS];   // each warp's stale count
  __shared__ int s_base[MAX_TILES];          // stale ahead of each tile
  __shared__ int s_n[3];                     // each list's count
  if (!a.state[cc_state::ACTIVE]) return;
  if (blockIdx.x == 0) CC_STAMP(0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;

  // ---- each entry tested once; ballots and flags kept in registers -------
  bool flag[MAX_TILES];
  unsigned ball[MAX_TILES];
#pragma unroll
  for (int u = 0; u < MAX_TILES; ++u) {
    const int t = blockIdx.x + u * G;
    flag[u] = false;
    ball[u] = 0;
    if (t < a.T) {   // the same for the whole block
      int w, t0;
      locate(a, t, &w, &t0);
      const int i = (t - t0) * THREADS + tid;
      flag[u] = i < pick(a.len, w) && stale(a.in, w, i);
      ball[u] = __ballot_sync(FULL, flag[u]);
      if (lane == 0) s_warp[u][warp] = __popc(ball[u]);
    }
  }
  __syncthreads();
  if (tid < MAX_TILES && blockIdx.x + tid * G < a.T) {
    int c = 0;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) c += s_warp[tid][v];
    a.tile_tot[blockIdx.x + tid * G] = c;
  }
  if (blockIdx.x == 0) CC_STAMP_SYNC(1);
  cg::this_grid().sync();
  if (blockIdx.x == 0) CC_STAMP(2);

  // ---- the lists' counts and each tile's base ------------------------------
  if (warp < 3) {
    const int t0 = warp == 0 ? 0 : warp == 1 ? a.tiles[0]
                                             : a.tiles[0] + a.tiles[1];
    const int s = warp_sum(a.tile_tot, t0, t0 + pick(a.tiles, warp));
    if (lane == 0) s_n[warp] = s;
  }
  {
    // warp u: the stale entries of its list's tiles ahead of tile u
    const int t = blockIdx.x + warp * G;
    if (warp < MAX_TILES && t < a.T) {
      int w, t0;
      locate(a, t, &w, &t0);
      const int s = warp_sum(a.tile_tot, t0, t);
      if (lane == 0) s_base[warp] = s;
    }
  }
  __syncthreads();

  // ---- the decision, into the carry (the twin's order) ---------------------
  if (blockIdx.x == 0 && tid == 0) {
    using namespace cc_state;
    int* state = a.state;
    const int n0 = s_n[0], n1 = s_n[1], n2 = s_n[2];
    const bool repool = state[REPOOL] != 0;
    const bool overflow =
        n0 > a.budget[0] || n1 > a.budget[1] || n2 > a.budget[2];
    const int since = state[SINCE_FULL];
    const bool fresh =
        repool || overflow || (a.refresh > 0 && since >= a.refresh);
    state[N_OVF] += overflow && !repool ? 1 : 0;
    state[SINCE_FULL] = fresh ? 0 : since + 1;
    state[FRESH] = fresh ? 1 : 0;
    state[N_PATCH] += fresh ? 0 : 1;
    a.nstale[0] = n0;
    a.nstale[1] = n1;
    a.nstale[2] = n2;
    CC_STAMP(3);
  }

  // ---- each entry at its place in argsort(~stale), to its budget -----------
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < MAX_TILES; ++u) {
    const int t = blockIdx.x + u * G;
    if (t < a.T) {
      int w, t0;
      locate(a, t, &w, &t0);
      const int i = (t - t0) * THREADS + tid;
      if (i < pick(a.len, w)) {
        int before = s_base[u] + __popc(ball[u] & lt);
        for (int v = 0; v < warp; ++v) before += s_warp[u][v];
        const int pos = flag[u] ? before : s_n[w] + (i - before);
        if (pos < pick(a.budget, w)) {
          pick(a.out, w)[pos] = (w == 1 && !flag[u]) ? -1 : i;
        }
      }
    }
  }
  if (blockIdx.x == 0) CC_STAMP_SYNC(4);
}

// the blocks the card holds at once (a cooperative launch must fit in
// them), or -1
int resident_blocks(int* per_sm_out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stale_sets_kernel, THREADS, 0);
  }
  if (e != cudaSuccess || per_sm < 1) return -1;
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  return sms * per_sm;
}

// the launch's grid: a block a tile, capped at the resident blocks; -1
// when the tiles do not fit MAX_TILES a block
int grid_for(int T, int* per_sm_out) {
  const int R = resident_blocks(per_sm_out);
  if (R < 1 || (long long)R * MAX_TILES < T) return -1;
  return T < R ? T : R;
}

int tiles_of(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// Ints of device scratch K16 takes over lists of K, D and L entries (one
// stale count a tile).
int stale_sets_scratch(int K, int D, int L) {
  return tiles_of(K) + tiles_of(D) + tiles_of(L);
}

// The most tiles of THREADS entries one launch takes on this card
// (MAX_TILES a resident block): lists need tiles_of(K) + tiles_of(D) +
// tiles_of(L) at most this many.  -1 on a CUDA error.
int stale_sets_max_tiles(void) {
  const int R = resident_blocks(nullptr);
  return R < 1 ? -1 : R * MAX_TILES;
}

// Launches K16 on `stream`: one cooperative launch of a block a tile of
// THREADS entries (at most the blocks the card holds at once); `state` is
// the step loop's carry, `nstale` an int32 [3] of the three stale counts,
// `scratch` stale_sets_scratch(K, D, L) ints (no contents needed).
// Budgets must be in [1, list length]; lists past stale_sets_max_tiles()
// get cudaErrorCooperativeLaunchTooLarge.  Returns the CUDA error code.
int stale_sets_launch(const int* assignment, const int* leader_slot,
                      const int* kp, const int* dest_pool, const int* lp,
                      const int* lsl, const uint8_t* tb, const uint8_t* tpm,
                      int* state, int K, int D, int L, int S, int RB, int CB,
                      int LB, int refresh, int* ridx, int* cidx, int* lidx,
                      int* nstale, int* scratch, void* stream) {
  if (K < 1 || D < 1 || L < 1 || S < 1 || RB < 1 || RB > K || CB < 1 ||
      CB > D || LB < 1 || LB > L || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{{assignment, leader_slot, kp, dest_pool, lp, lsl, tb, tpm, S},
         {K, D, L},
         {RB, CB, LB},
         {tiles_of(K), tiles_of(D), tiles_of(L)},
         stale_sets_scratch(K, D, L),
         refresh,
         state,
         {ridx, cidx, lidx},
         nstale,
         scratch};
  const int G = grid_for(a.T, nullptr);
  if (G < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, stale_sets_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The built kernel's resources (ops/kernels.py: ATTR_KEYS) at (K, D, L);
// the last is the blocks an SM the card holds at once.
int stale_sets_attrs(int K, int D, int L, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, stale_sets_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  if (grid_for(stale_sets_scratch(K, D, L), &per_sm) < 1) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = 0;
  out[4] = per_sm;
  return 0;
}

}  // extern "C"
