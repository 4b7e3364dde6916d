// ell_pagerank.cu — row-wise float32 sum of a neighbour field over ELL.
//
// Replaces the TPU kernel `neighbor_sum_ell` of
// src/repro/kernels/ell_pagerank.py (Pallas body `_ell_sum_kernel`): the
// "sum" combine of the BlockProgram contract, PageRank's push of rank/deg.
// For every row u of nbr (N, ld) int32 with -1 = PAD and field (N,) float32,
//
//     out[u] = sum{field[nbr[u, j]] : j < C, nbr[u, j] >= 0}
//
// with 0.0 for a row that has no valid slot among its first C columns.  PAD
// is skipped wherever it sits; N, Cd and K are not padded.
//
// Design: one warp per row; each lane adds its slots j = lane, lane + 32,
// ... in ascending order, and the warp adds the lanes in a fixed xor
// butterfly (`ell::warp_sum` in ell_reduce.cuh).  The order is fixed, so
// the result is deterministic, and the fused ell_multi.cu, which calls the
// same functions in the same order, gives the same bits.  The order is not
// torch.sum's, so the plain version agrees to float32 rounding only.
//
// What bounds it on the card: bytes, as for ell_cc.cu: the first C columns
// of nbr, one float per valid slot, N*4 bytes written; one add per slot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block

__global__ void ell_pagerank_kernel(const int32_t* __restrict__ nbr,
                                    const float* __restrict__ field,
                                    float* __restrict__ out, long long n_rows,
                                    int ld, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // the whole warp leaves

  const int32_t* r = nbr + row * (long long)ld;
  float acc = 0.0f;
  for (int j = lane; j < C; j += 32) {
    const int32_t v = r[j];
    if (v >= 0) ell::sum_step(acc, __ldg(field + v));
  }
  acc = ell::warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

}  // namespace

// nbr: (n_rows, ld) int32; field, out: (n_rows,) float32.  Reads columns
// [0, C) of each nbr row, C <= ld.  Returns the launch's cudaError_t.
extern "C" int ell_pagerank_launch(const void* nbr, const void* field,
                                   void* out, long long n_rows, int ld, int C,
                                   void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rows + kWarps - 1) / kWarps;
  ell_pagerank_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const float*)field, (float*)out, n_rows, ld, C);
  return (int)cudaGetLastError();
}
