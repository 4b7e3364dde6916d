// ell_reduce.cuh — the warp-level row reductions of the ELL kernels.
//
// In the warp layout lane l of a warp takes a row's slots j = l, l + 32,
// l + 64, ... in ascending order; the reductions below turn those per-lane
// partials into the row's result.  The combine kernels (ell_cc.cu,
// ell_pagerank.cu, ell_multi.cu, through the row tiers of ell_rows.cuh)
// and ell_hindex.cu pack short rows into groups of 8 lanes and keep them
// in registers (`group_sum`, `group_min`, `reg_hindex_of`, `vlane_sum`);
// longer rows take the warp layout, and the h-index the histogram.
// Integers equal the histogram's, and `vlane_sum` gives `warp_sum`'s bits,
// so a fused output of ell_multi.cu is bit-identical to its standalone
// kernel, the float sum included, and so is a row read with its length
// `deg` or without.  `warp_shape` sizes the launch of every kernel whose
// warps keep per-row arrays in shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ell {

constexpr unsigned kFull = 0xffffffffu;
// what PAD slots and neighbourless rows give under the "min" combine
constexpr int32_t kMinFill = 0x7fffffff;

// "min": a lane keeps the min of its slots' values, the warp takes the min
// of the lanes.  Integers, so any order gives the same result.
__device__ __forceinline__ void min_step(int32_t& acc, int32_t x) {
  acc = x < acc ? x : acc;
}
__device__ __forceinline__ int32_t warp_min(int32_t acc) {
  return __reduce_min_sync(kFull, acc);
}

// "sum": a lane adds its slots' values in ascending slot order, starting at
// 0.0f; the warp then adds the lanes in a fixed xor butterfly.  IEEE
// addition is commutative, so lanes i and i ^ off hold the same value after
// each stage and every lane ends with the same, deterministic sum.
__device__ __forceinline__ void sum_step(float& acc, float x) { acc += x; }
__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// "hindex": h <= number of valid slots <= C, so each gathered value is
// clamped into [0, C] and counted into a (C+1)-bin histogram of the warp's
// own in shared memory (values <= 0 count for nothing).  The h-index is
// then the largest k whose suffix count reaches k, found by scanning the
// bins from the top, 32 bins per step, with a warp prefix sum and a ballot.
// Callers put a __syncwarp() between clear, the adds and the scan.
__device__ __forceinline__ void hist_clear(int32_t* bins, int C, int lane) {
  for (int b = lane; b <= C; b += 32) bins[b] = 0;
}
__device__ __forceinline__ void hist_add(int32_t* bins, int C, int32_t e) {
  if (e > 0) atomicAdd(&bins[e < C ? e : C], 1);
}
__device__ __forceinline__ int32_t hist_hindex(const int32_t* bins, int C,
                                               int lane) {
  // largest k in [1, C] with sum_{b >= k} bins[b] >= k; lane l of a step
  // holds threshold k = top - l, so an inclusive prefix sum over the lanes
  // is the count of bins[k..top]
  int above = 0;  // sum of the bins above this step's top
  for (int top = C; top >= 1; top -= 32) {
    const int k = top - lane;
    int c = k >= 1 ? bins[k] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, c, off);
      if (lane >= off) c += t;
    }
    const unsigned ok = __ballot_sync(kFull, k >= 1 && above + c >= k);
    if (ok) return top - (__ffs(ok) - 1);  // the lowest such lane: largest k
    above += __shfl_sync(kFull, c, 31);
  }
  return 0;
}

// --- Rows packed into groups of W lanes (W a power of two, <= 32) --------
// All 32 lanes call these together; each group reduces its own row.

// Sum of x over this lane's W-lane group.
template <int W>
__device__ __forceinline__ int group_sum(int x) {
  if constexpr (W == 32) {
    return __reduce_add_sync(kFull, x);
  } else {
#pragma unroll
    for (int off = W / 2; off >= 1; off >>= 1)
      x += __shfl_xor_sync(kFull, x, off);
    return x;
  }
}

// Min of x over this lane's W-lane group.
template <int W>
__device__ __forceinline__ int32_t group_min(int32_t x) {
  if constexpr (W == 32) {
    return __reduce_min_sync(kFull, x);
  } else {
#pragma unroll
    for (int off = W / 2; off >= 1; off >>= 1) {
      const int32_t y = __shfl_xor_sync(kFull, x, off);
      x = y < x ? y : x;
    }
    return x;
  }
}

// h-index of a row held in its group's registers: v[i], i < steps, are
// this lane's gathered values (0 for a PAD or an unused slot: 0 counts for
// no k >= 1) and n the group's valid slots, so h lies in [0, n].  Bisection
// over [lo, hi): each probe counts the lane's values >= k and sums over the
// group; ceil(log2(n + 1)) probes, the warp's most (a group already at
// hi = lo + 1 probes k = lo and stays), so the warp never diverges.
template <int W, int kSlots>
__device__ __forceinline__ int32_t reg_hindex_of(const int32_t (&v)[kSlots],
                                                 int steps, int n) {
  int lo = 0, hi = n + 1;
  const int probes = 32 - __clz(__reduce_max_sync(kFull, n));
  for (int t = 0; t < probes; ++t) {
    const int k = (lo + hi) >> 1;
    int c = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i >= steps) break;
      c += v[i] >= k;
    }
    if (group_sum<W>(c) >= k) lo = k; else hi = k;
  }
  return lo;
}

// "sum" of a row packed into 8 lanes, bit-equal to `warp_sum` of the same
// row laid out one warp per row.  In that layout slot j folds into lane
// j mod 32 ("its virtual lane"), and the butterfly's stages 16 and 8 leave
// in lane g < 8 the value (a_g + a_{g+16}) + (a_{g+8} + a_{g+24}), a_l the
// fold of virtual lane l; stages 4, 2, 1 then stay within lanes 0..7.  Here
// lane g of the group takes slots j = g + 8 i and folds slot j into
// acc[i mod 4], the fold of virtual lane g + 8 (i mod 4), in ascending j
// from 0.0f, skipping PAD (never adding 0.0f for it), exactly as that
// virtual lane would.  Forming (acc[0] + acc[2]) + (acc[1] + acc[3]) is
// then the value of stages 16 and 8 in lane g, operand for operand, and
// the xor shuffles over 4, 2 and 1 stay within the group and pair the same
// lanes as the warp's last three stages.  IEEE addition is commutative, so
// every addition takes the same two operands: the bits are the same.
__device__ __forceinline__ float vlane_sum(const float (&acc)[4]) {
  float s = (acc[0] + acc[2]) + (acc[1] + acc[3]);
#pragma unroll
  for (int off = 4; off >= 1; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Launch shape of a kernel that gives each warp (one row) `per_warp` bytes
// of dynamic shared memory: as many warps per block as fit in the 48 KB a
// block gets without opting in, 8 at most; past 48 KB the kernel opts in, up
// to Hopper's 227 KB per block.  Returns the error for the launcher to
// return, or cudaSuccess.
struct WarpShape {
  int warps;
  size_t smem;
};
template <typename Kernel>
inline cudaError_t warp_shape(Kernel* kernel, size_t per_warp,
                              WarpShape* s) {
  constexpr int kMaxWarps = 8;
  constexpr size_t kDefaultSmem = 48 * 1024;
  constexpr size_t kMaxSmem = 227 * 1024;
  int w = per_warp ? (int)(kDefaultSmem / per_warp) : kMaxWarps;
  w = w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
  s->warps = w;
  s->smem = per_warp * w;
  if (s->smem > kMaxSmem) return cudaErrorInvalidValue;
  if (s->smem > kDefaultSmem)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s->smem);
  return cudaSuccess;
}

}  // namespace ell
