// ell_reduce.cuh — the warp-level row reductions of the ELL kernels.
//
// Every ELL kernel of the port gives one warp to one row of nbr and lets
// lane l take the slots j = l, l + 32, l + 64, ... in ascending order.  The
// reductions below are the only code that turns those per-lane partials
// into a row's result.  The standalone kernels (ell_cc.cu, ell_pagerank.cu,
// ell_hindex.cu) and the fused ell_multi.cu call the same functions in the
// same order, so a fused output is bit-identical to its standalone kernel,
// the float sum included.  `warp_shape` sizes the launch of every kernel
// whose warps keep per-row arrays in shared memory.

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
