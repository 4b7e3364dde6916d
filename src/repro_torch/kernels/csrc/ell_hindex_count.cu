// ell_hindex_count.cu — h-index of neighbour estimates over an ELL
// adjacency, by threshold counts.
//
// Replaces the TPU kernel `hindex_ell` of src/repro/kernels/ell_hindex.py,
// variant "count" (Pallas body `_ell_hindex_count_kernel`: a fori_loop over
// the slots accumulates a (T, K) count matrix).  For every row u of nbr
// (N, ld) int32 with -1 = PAD it computes, over the first C columns,
//
//     cnt[k] = #{j < C : nbr[u, j] >= 0, est[nbr[u, j]] >= k},  k = 1..C
//     h[u]   = sum_k [cnt[k] >= k]
//
// which is the same h-index as the "sort" kernel (ell_hindex.cu), bit for
// bit: cnt[k] is non-increasing in k, so the sum is the largest k whose
// count reaches k, and a threshold above the row's n valid slots never
// fires (cnt <= n), whatever the slot order.  PAD may sit anywhere.  `deg`
// (N,) int32 is optional, each row's count of valid slots: with it a row
// stops at its length, and the result is the same (ell_rows.cuh).
//
// What bounds it on the card: latency, as for ell_cc.cu.  With deg a launch
// needs each row's valid slots, deg, their estimates and the output (0.38
// us of HBM time at DS1); without it the first C columns of every row.
// Its operations are the compares of each valid value with the row's
// thresholds k <= n, n^2 a row, far below the bytes' time.  Design: the
// row tiers of ell_rows.cuh with a threshold-count operation (`CountOp`).
// In tiers 1 and 2 (a row in the registers of its W-lane group, W = 8 or
// 32) lane gl owns the thresholds k = gl + 1 + W t, t < T = ceil(n / W)
// <= 8, and counts them in registers; the group's values are broadcast one
// by one with __shfl_sync: W shuffles per register slot in use and T
// compares per shuffle, in a loop instance for each T.  In tier 3 (the
// warp loop: rows past 256 columns, a PAD inside the deg prefix, every row
// without deg when C > 64) lane l owns k = l + 1 + 32 t: t < 8 in
// registers, and the thresholds past 256 in this warp's C - 256 ints of
// shared memory (none at C <= 256); each positive estimate of a 32-slot
// step is broadcast to every lane.  Integers only; no histogram, no sort.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

// the thresholds a lane keeps in registers: k = lane + 1 + 32 t, t < 8
constexpr int kRegThresholds = 32 * ell::kSlots;

struct CountOp {
  const int32_t* __restrict__ in;  // est
  int32_t* __restrict__ out;
  int32_t* hi;  // this warp's counters of thresholds 257..C (tier 3)
  static constexpr bool kWarpWide = true;  // warp_add shuffles
  using Vals = int32_t[ell::kSlots];
  struct Acc {
    int32_t c[ell::kSlots];  // thresholds lane + 1 + 32 t
    int t;                   // of them in use: min(8, ceil(C / 32))
  };

  // est at this lane's slots, at least 0; 0 (below every threshold) for
  // a PAD
  __device__ __forceinline__ void gather(const int32_t (&v)[ell::kSlots],
                                         int steps, Vals& x) const {
    ell::gather_slots(in, v, steps, x);
#pragma unroll
    for (int i = 0; i < ell::kSlots; ++i) x[i] = x[i] > 0 ? x[i] : 0;
  }
  // h of a row in its W-lane group's registers (x: its values, n: its
  // valid slots): lane gl counts the thresholds gl + 1 + W t <= the
  // warp's largest n, T = ceil(n / W) of them, over every value of the
  // group (`count_values<W, T>`, one instance for each T, so its loops
  // hold no test of T)
  template <int W>
  __device__ __forceinline__ void reduce(const int32_t (&)[ell::kSlots],
                                         const Vals& x, int steps, int n,
                                         long long row, bool write) const {
    const int k0 = (int)(threadIdx.x % W) + 1;
    int h = 0;
    switch (__reduce_max_sync(ell::kFull, (n + W - 1) / W)) {
      case 1: h = count_values<W, 1>(x, steps, k0); break;
      case 2: h = count_values<W, 2>(x, steps, k0); break;
      case 3: h = count_values<W, 3>(x, steps, k0); break;
      case 4: h = count_values<W, 4>(x, steps, k0); break;
      case 5: h = count_values<W, 5>(x, steps, k0); break;
      case 6: h = count_values<W, 6>(x, steps, k0); break;
      case 7: h = count_values<W, 7>(x, steps, k0); break;
      case 8: h = count_values<W, 8>(x, steps, k0); break;
      default: break;  // no valid slot in the warp's rows
    }
    h = ell::group_sum<W>(h);
    if (write) out[row] = h;
  }
  // This lane's part of h: its T thresholds k0 + W t counted over the
  // group's values, register slot by register slot (a slot's values are
  // broadcast one lane at a time), then [cnt >= k] summed.
  template <int W, int T>
  __device__ __forceinline__ int count_values(const Vals& x, int steps,
                                              int k0) const {
    int32_t c[T];
#pragma unroll
    for (int t = 0; t < T; ++t) c[t] = 0;
    for (int i = 0; i < steps; ++i) {
      int32_t xi = x[0];  // x[i], without indexing the registers
#pragma unroll
      for (int s = 1; s < ell::kSlots; ++s) xi = i == s ? x[s] : xi;
#pragma unroll 8
      for (int g = 0; g < W; ++g) {
        const int32_t y = __shfl_sync(ell::kFull, xi, g, W) - k0;  // >= -W
#pragma unroll
        for (int t = 0; t < T; ++t) c[t] += y >= W * t;
      }
    }
    int h = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) h += c[t] >= k0 + W * t;
    return h;
  }
  __device__ __forceinline__ void warp_begin(Acc& a, int C, int lane) const {
    a.t = (C + 31) / 32 < ell::kSlots ? (C + 31) / 32 : ell::kSlots;
#pragma unroll
    for (int t = 0; t < ell::kSlots; ++t) a.c[t] = 0;
    for (int k = kRegThresholds + 1 + lane; k <= C; k += 32)
      hi[k - kRegThresholds - 1] = 0;
  }
  // all 32 lanes: this lane's slot v (< 0: none); each positive estimate
  // of the step is broadcast and counted against every lane's thresholds
  __device__ __forceinline__ void warp_add(Acc& a, int32_t v, int C) const {
    const int32_t e = v >= 0 ? __ldg(in + v) : 0;
    const int k0 = (int)(threadIdx.x & 31) + 1;
    unsigned live = __ballot_sync(ell::kFull, e >= 1);  // e <= 0 counts 0
    while (live) {  // warp-uniform
      const int s = __ffs(live) - 1;
      live &= live - 1;
      const int32_t x = __shfl_sync(ell::kFull, e, s);
#pragma unroll
      for (int t = 0; t < ell::kSlots; ++t) {
        if (t >= a.t) break;
        a.c[t] += x >= k0 + 32 * t;
      }
      for (int k = kRegThresholds + k0; k <= C; k += 32)
        hi[k - kRegThresholds - 1] += x >= k;
    }
  }
  __device__ __forceinline__ void warp_end(Acc& a, long long u, int C,
                                           int lane) const {
    int h = 0;
#pragma unroll
    for (int t = 0; t < ell::kSlots; ++t) {
      if (t >= a.t) break;
      h += a.c[t] >= lane + 1 + 32 * t;
    }
    for (int k = kRegThresholds + 1 + lane; k <= C; k += 32)
      h += hi[k - kRegThresholds - 1] >= k;
    h = __reduce_add_sync(ell::kFull, h);
    if (lane == 0) out[u] = h;
  }
};

// the ints of shared memory a warp's tier 3 needs: thresholds 257..C
__host__ __device__ inline int hi_ints(int C) {
  return C > kRegThresholds ? C - kRegThresholds : 0;
}

template <bool kPacked>
__device__ __forceinline__ void count_rows(const int32_t* __restrict__ nbr,
                                           const int32_t* __restrict__ est,
                                           const int32_t* __restrict__ deg,
                                           int32_t* __restrict__ out,
                                           long long n_rows, int ld, int C) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const CountOp op{est, out, smem + (size_t)warp * hi_ints(C)};
  ell::combine_rows<kPacked>(op, nbr, deg, n_rows, ld, C);
}

// The packed instance (4 rows a warp, tiers 1 and 2 in registers) is held
// to 48 registers, 5 blocks an SM, with no spill: as fast as without the
// bound at DS1 and 12 % faster at 2^21 (PERF.md); (256, 6), as ell_cc.cu
// has it, spilled.  The warp-loop instance (one row a warp, no deg and
// C > 64) keeps the compiler's choice: the bound made it slower.
__global__ void __launch_bounds__(256, 5)
    ell_hindex_count_packed(const int32_t* __restrict__ nbr,
                            const int32_t* __restrict__ est,
                            const int32_t* __restrict__ deg,
                            int32_t* __restrict__ out, long long n_rows,
                            int ld, int C) {
  count_rows<true>(nbr, est, deg, out, n_rows, ld, C);
}

__global__ void ell_hindex_count_loop(const int32_t* __restrict__ nbr,
                                      const int32_t* __restrict__ est,
                                      const int32_t* __restrict__ deg,
                                      int32_t* __restrict__ out,
                                      long long n_rows, int ld, int C) {
  count_rows<false>(nbr, est, deg, out, n_rows, ld, C);
}

}  // namespace

// nbr: (n_rows, ld) int32; est: (n_rows,) int32 (any values; nbr ids index
// it); deg: (n_rows,) int32 valid slots per row, or NULL; out: (n_rows,)
// int32.  Reads columns [0, C) of each row, C <= ld.  Returns the launch's
// cudaError_t.
extern "C" int ell_hindex_count_launch(const void* nbr, const void* est,
                                       const void* deg, void* out,
                                       long long n_rows, int ld, int C,
                                       void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const bool packed = ell::packs(deg, C);
  return (int)ell::launch_rows(
      packed ? ell_hindex_count_packed : ell_hindex_count_loop,
      (size_t)hi_ints(C) * sizeof(int32_t), packed, n_rows,
      (cudaStream_t)stream, (const int32_t*)nbr, (const int32_t*)est,
      (const int32_t*)deg, (int32_t*)out, n_rows, ld, C);
}
