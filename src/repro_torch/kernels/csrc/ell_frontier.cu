// ell_frontier.cu — one masked BFS hop for R stacked frontiers over ELL.
//
// Replaces the TPU kernel `frontier_step_ell` of
// src/repro/kernels/ell_frontier.py (Pallas body `_ell_frontier_kernel`).
// For nbr (N, ld) int32 with -1 = PAD and f, eligible, visited (N, R) bytes
// (uint8 views of bool tensors), it computes
//
//     next[u, r] = (OR_{j < C, nbr[u, j] >= 0} f[nbr[u, j], r])
//                  & eligible[u, r] & !visited[u, r]
//
// for any slot order.  R is the window width (8 on the main path) and is
// not padded: the TPU's 128-lane padding has no use here.
//
// Design: one warp per row, lanes over neighbour slots.  The row's columns
// are taken 32 at a time; for each group the warp first ballots the columns
// it still needs (eligible and not visited).  A row that needs none reads
// no neighbour at all, and a row stops reading slots as soon as every
// needed column is hit — both exits are exact, because the output is the
// hit mask ANDed with the need mask.  Each lane turns its neighbour's
// frontier bytes into a bit mask (one 8-byte load when R = 8 and the
// frontier is 8-byte aligned), and the warp ORs the masks with
// __reduce_or_sync.
//
// What bounds it on the card: bytes.  A launch must read eligible and
// visited (2*N*R bytes) and write N*R bytes; rows that need a column also
// read their nbr slots (C*4 bytes) and gather R bytes of frontier per valid
// slot.  This version is the simple exact one; making it fast (several rows
// per warp, stopping at the first PAD of a sorted row) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

template <bool kVec8>
__global__ void ell_frontier_kernel(const int32_t* __restrict__ nbr,
                                    const uint8_t* __restrict__ f,
                                    const uint8_t* __restrict__ elig,
                                    const uint8_t* __restrict__ vis,
                                    uint8_t* __restrict__ out,
                                    long long n_rows, int ld, int C, int R) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // the whole warp leaves; no block-wide sync

  const int32_t* r = nbr + row * (long long)ld;
  for (int c0 = 0; c0 < R; c0 += 32) {
    const int c = c0 + lane;
    const long long o = row * (long long)R + c;
    const bool want = c < R && elig[o] != 0 && vis[o] == 0;
    const unsigned need = __ballot_sync(0xffffffffu, want);
    unsigned hit = 0;
    if (need) {
      const int width = R - c0 < 32 ? R - c0 : 32;
      for (int j0 = 0; j0 < C; j0 += 32) {
        const int j = j0 + lane;
        unsigned bits = 0;
        if (j < C) {
          const int32_t v = r[j];
          if (v >= 0) {
            const uint8_t* fr = f + (long long)v * R + c0;
            if (kVec8) {
              const unsigned long long x =
                  __ldg(reinterpret_cast<const unsigned long long*>(fr));
#pragma unroll
              for (int b = 0; b < 8; ++b)
                bits |= (unsigned)(((x >> (8 * b)) & 0xffull) != 0) << b;
            } else {
              for (int b = 0; b < width; ++b)
                bits |= (unsigned)(__ldg(fr + b) != 0) << b;
            }
          }
        }
        hit |= __reduce_or_sync(0xffffffffu, bits);
        if ((hit & need) == need) break;  // every needed column is hit
      }
    }
    if (c < R) out[o] = (uint8_t)(((hit & need) >> lane) & 1u);
  }
}

}  // namespace

// nbr: (n_rows, ld) int32; f, elig, vis, out: (n_rows, R) uint8, row-major
// and contiguous.  Reads columns [0, C) of each nbr row, C <= ld.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ell_frontier_launch(const void* nbr, const void* f,
                                   const void* elig, const void* vis,
                                   void* out, long long n_rows, int ld, int C,
                                   int R, void* stream) {
  if (n_rows <= 0 || R <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rows + kWarps - 1) / kWarps;
  const bool vec8 = R == 8 && (reinterpret_cast<uintptr_t>(f) & 7) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec8) {
    ell_frontier_kernel<true><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        (const int32_t*)nbr, (const uint8_t*)f, (const uint8_t*)elig,
        (const uint8_t*)vis, (uint8_t*)out, n_rows, ld, C, R);
  } else {
    ell_frontier_kernel<false><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        (const int32_t*)nbr, (const uint8_t*)f, (const uint8_t*)elig,
        (const uint8_t*)vis, (uint8_t*)out, n_rows, ld, C, R);
  }
  return (int)cudaGetLastError();
}
