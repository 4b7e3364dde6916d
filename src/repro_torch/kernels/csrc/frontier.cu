// frontier.cu — one masked BFS hop for R stacked frontiers over a dense
// adjacency.
//
// Replaces the TPU kernel `frontier_step` of src/repro/kernels/frontier.py
// (Pallas body `_frontier_kernel`: A @ F on the MXU, then the mask).  For
// adj (N, N) bf16 0/1, f and visited (N, R) bytes and eligible (N,) bytes
// (uint8 views of bool tensors; one eligibility shared by all R columns),
//
//     next[u, r] = (OR_{v : adj[u, v] != 0} f[v, r]) & eligible[u]
//                  & !visited[u, r]
//
// R is the window width (8 on the main path) and is not padded.
//
// Design: one warp per row.  The warp first ballots the columns the row
// still needs (eligible and not visited).  A row that needs none reads no
// adjacency at all: after `ops.frontier_blocks` folds the per-column
// eligibility into `visited`, that is most rows of the main path's hops.  A
// row that needs some streams its adjacency row with 16-byte loads (a 2-byte
// load per column when N is not a multiple of 8); each nonzero column's
// frontier bytes become an R-bit mask, the warp ORs the lanes' masks with
// __reduce_or_sync after each step of 512 columns (256 with 2-byte loads),
// and it stops as soon as every needed column is hit.  Both exits are
// exact, because the output is the hit mask ANDed with the need mask.
// Frontier columns go 32 at a time (R > 32 reads the row once per 32).
//
// What bounds it on the card: bytes.  A hop must read eligible and visited
// and write next (N * (2R + 1) bytes); rows that need a column also read
// their adjacency row (2N bytes) up to the column where the last needed
// frontier column is first hit.  Reading every row: N^2 * 2 bytes, 1.50 ms
// at N = 50,048.  Operations (an OR of R bits per nonzero) are nothing
// beside that.  Offsets are 64-bit: u * N passes 2^31 from N = 46,341 on.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // rows per block
constexpr int kUnroll = 2;  // 16-byte loads in flight per lane

__device__ __forceinline__ unsigned frontier_bits(
    const uint8_t* __restrict__ fr, int width) {
  unsigned bits = 0;
  for (int b = 0; b < width; ++b) bits |= (unsigned)(__ldg(fr + b) != 0) << b;
  return bits;
}

template <bool kVec>
__global__ void frontier_kernel(const uint16_t* __restrict__ adj,
                                const uint8_t* __restrict__ f,
                                const uint8_t* __restrict__ elig,
                                const uint8_t* __restrict__ vis,
                                uint8_t* __restrict__ out, long long n,
                                int R) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long u = (long long)blockIdx.x * kWarps + warp;
  if (u >= n) return;  // the whole warp leaves; no block-wide sync

  const uint16_t* row = adj + u * n;
  const bool eligible = elig[u] != 0;
  for (int c0 = 0; c0 < R; c0 += 32) {
    const int c = c0 + lane;
    const long long o = u * (long long)R + c;
    const unsigned need =
        __ballot_sync(kFull, eligible && c < R && vis[o] == 0);
    const int width = R - c0 < 32 ? R - c0 : 32;
    const uint8_t* fc = f + c0;
    unsigned hit = 0;
    if (need && kVec) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
      const long long n8 = n >> 3;
      for (long long i0 = 0; i0 < n8; i0 += 32 * kUnroll) {  // warp-uniform
        uint4 x[kUnroll];
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) {
          const long long i = i0 + t * 32 + lane;
          x[t] = i < n8 ? __ldg(r4 + i) : make_uint4(0u, 0u, 0u, 0u);
        }
        unsigned bits = 0;
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) {
          if ((x[t].x | x[t].y | x[t].z | x[t].w) == 0u) continue;
          const long long col = (i0 + t * 32 + lane) * 8;
          const uint32_t w[4] = {x[t].x, x[t].y, x[t].z, x[t].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // little-endian: low half first
            if (w[q] & 0x7fffu)
              bits |= frontier_bits(fc + (col + 2 * q) * R, width);
            if (w[q] & 0x7fff0000u)
              bits |= frontier_bits(fc + (col + 2 * q + 1) * R, width);
          }
        }
        hit |= __reduce_or_sync(kFull, bits);
        if ((hit & need) == need) break;  // every needed column is hit
      }
    } else if (need) {
      for (long long v0 = 0; v0 < n; v0 += 32 * 8) {  // warp-uniform
        unsigned bits = 0;
        for (int t = 0; t < 8; ++t) {
          const long long v = v0 + t * 32 + lane;
          if (v < n && (__ldg(row + v) & 0x7fffu))
            bits |= frontier_bits(fc + v * R, width);
        }
        hit |= __reduce_or_sync(kFull, bits);
        if ((hit & need) == need) break;
      }
    }
    if (c < R) out[o] = (uint8_t)(((hit & need) >> lane) & 1u);
  }
}

}  // namespace

// adj: (n, n) bf16 0/1; f, vis, out: (n, R) uint8; elig: (n,) uint8; all
// row-major and contiguous.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int frontier_launch(const void* adj, const void* f,
                               const void* elig, const void* vis, void* out,
                               long long n, int R, void* stream) {
  if (n <= 0 || R <= 0) return 0;
  const long long blocks = (n + kWarps - 1) / kWarps;
  const bool vec = n % 8 == 0 && (reinterpret_cast<uintptr_t>(adj) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    frontier_kernel<true><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        (const uint16_t*)adj, (const uint8_t*)f, (const uint8_t*)elig,
        (const uint8_t*)vis, (uint8_t*)out, n, R);
  } else {
    frontier_kernel<false><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        (const uint16_t*)adj, (const uint8_t*)f, (const uint8_t*)elig,
        (const uint8_t*)vis, (uint8_t*)out, n, R);
  }
  return (int)cudaGetLastError();
}
