// kcore_hindex.cu — h-index of neighbour estimates over a dense adjacency.
//
// Replaces the TPU kernel `hindex_counts` of src/repro/kernels/kcore_hindex.py
// (Pallas body `_hindex_kernel`: cnt = A @ B on the MXU, with
// B[v, k-1] = (est[v] >= k), then h[u] = sum_k [cnt[u, k-1] >= k]).  For adj
// (N, N) bf16 0/1 and est (N,) int32 it computes
//
//     h[u] = sum_{k=1..K} [ #{v : adj[u, v] != 0, est[v] >= k} >= k ]
//
// the h-index of {est[v] : v ~ u} capped at K (the indicator is
// prefix-monotone in k, so the sum is the largest k whose count reaches k).
//
// Design: one block per row and no matrix product.  The block streams its
// row with 16-byte loads (8 columns each; a 2-byte load per column when N is
// not a multiple of 8) and, for each nonzero column v, counts min(est[v], B)
// into a (B+1)-bin histogram in shared memory, B = min(K, kMaxBins).  Values
// at or above K are all alike to a count capped at K, so with B = K the
// histogram is exact, and warp 0 scans it from the top (`ell::hist_hindex`
// of ell_reduce.cuh).  With K > kMaxBins (the raw wrapper's default
// K = N on a large graph) a row whose top bin alone reaches B has h >= B;
// the block then finds h in [B, min(K, deg)] by binary search, each probe a
// counting pass over the row.  So the bins stay 16 KB at most and the result
// is exact at any K; only rows with thousands of high-estimate neighbours
// take the search.
//
// What bounds it on the card: bytes.  The product does 2*K operations per
// 2-byte adjacency element, K per byte.  At the main path's K (128 in the
// static fixpoint, Cd + 1 = 150 in the clamped recompute) that is below the
// ~295 op/byte at which the H100's bf16 tensor cores, not its memory, become
// the limit.  So the least time is reading the adjacency once: N^2 * 2
// bytes, 1.50 ms at N = 50,048 and 3.35 TB/s, against 0.65 ms (K = 128) and
// 0.76 ms (K = 150) of tensor-core time at 989 TFLOP/s.  Tensor cores
// (mma.sync or wgmma) cannot move that bound; a streaming histogram reaches
// it as well, and needs no (N, K) threshold matrix.
//
// Offsets are 64-bit: u * N passes 2^31 from N = 46,341 on.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace {

constexpr int kThreads = 256;   // one block per row
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // 16-byte loads in flight per thread
constexpr int kMaxBins = 4096;  // B <= 4096: at most 16 KB of bins

// Call visit(v) for every column v of the row whose bf16 entry is nonzero
// (either sign of zero counts as zero).  kVec: the row is 16-byte aligned
// and N is a multiple of 8.
template <bool kVec, typename Visit>
__device__ __forceinline__ void for_nonzero(const uint16_t* __restrict__ row,
                                            long long n, Visit visit) {
  if (kVec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const long long n8 = n >> 3;
    for (long long i0 = threadIdx.x; i0 < n8;
         i0 += (long long)kThreads * kUnroll) {
      uint4 x[kUnroll];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const long long i = i0 + (long long)t * kThreads;
        x[t] = i < n8 ? __ldg(r4 + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        if ((x[t].x | x[t].y | x[t].z | x[t].w) == 0u) continue;
        const long long c = (i0 + (long long)t * kThreads) * 8;
        const uint32_t w[4] = {x[t].x, x[t].y, x[t].z, x[t].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // little-endian: low half first
          if (w[q] & 0x7fffu) visit(c + 2 * q);
          if (w[q] & 0x7fff0000u) visit(c + 2 * q + 1);
        }
      }
    }
  } else {
    for (long long v = threadIdx.x; v < n; v += kThreads)
      if (__ldg(row + v) & 0x7fffu) visit(v);
  }
}

// Sum of x over the block, returned to every thread.
__device__ __forceinline__ int block_sum(int x, int* red) {
  x = __reduce_add_sync(ell::kFull, x);
  __syncthreads();  // every thread has read red from the last call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    kcore_hindex_kernel(const uint16_t* __restrict__ adj,
                        const int32_t* __restrict__ est,
                        int32_t* __restrict__ out, long long n, int K, int B) {
  extern __shared__ int32_t bins[];  // B + 1 bins
  __shared__ int red[kWarps];
  __shared__ int32_t h_top;
  const long long u = blockIdx.x;
  const uint16_t* row = adj + u * n;

  for (int b = threadIdx.x; b <= B; b += kThreads) bins[b] = 0;
  __syncthreads();
  int deg = 0;
  for_nonzero<kVec>(row, n, [&](long long v) {
    ++deg;
    const int32_t e = __ldg(est + v);
    if (e > 0) atomicAdd(&bins[e < B ? e : B], 1);
  });
  deg = block_sum(deg, red);  // its barriers also publish the bins
  if (threadIdx.x < 32) {
    const int32_t h = ell::hist_hindex(bins, B, threadIdx.x);
    if (threadIdx.x == 0) h_top = h;
  }
  __syncthreads();
  int h = h_top;
  if (h == B && B < K) {  // h >= B: search [B, min(K, deg)] for the largest
    int lo = B;           // k with #{v ~ u : est[v] >= k} >= k
    int hi = deg < K ? deg : K;
    while (lo < hi) {
      const int mid = lo + (hi - lo + 1) / 2;
      int c = 0;
      for_nonzero<kVec>(row, n,
                        [&](long long v) { c += __ldg(est + v) >= mid; });
      c = block_sum(c, red);
      if (c >= mid) lo = mid; else hi = mid - 1;
    }
    h = lo;
  }
  if (threadIdx.x == 0) out[u] = h;
}

}  // namespace

// adj: (n, n) bf16 0/1, row-major and contiguous; est: (n,) int32; out:
// (n,) int32; K >= 1.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int kcore_hindex_launch(const void* adj, const void* est,
                                   void* out, long long n, int K,
                                   void* stream) {
  if (n <= 0) return 0;
  if (K < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int B = K < kMaxBins ? K : kMaxBins;
  const size_t smem = (size_t)(B + 1) * sizeof(int32_t);
  const bool vec = n % 8 == 0 && (reinterpret_cast<uintptr_t>(adj) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    kcore_hindex_kernel<true><<<(unsigned)n, kThreads, smem, s>>>(
        (const uint16_t*)adj, (const int32_t*)est, (int32_t*)out, n, K, B);
  } else {
    kcore_hindex_kernel<false><<<(unsigned)n, kThreads, smem, s>>>(
        (const uint16_t*)adj, (const int32_t*)est, (int32_t*)out, n, K, B);
  }
  return (int)cudaGetLastError();
}
