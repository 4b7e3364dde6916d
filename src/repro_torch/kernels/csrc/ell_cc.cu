// ell_cc.cu — row-wise min of a neighbour field over an ELL adjacency.
//
// Replaces the TPU kernel `neighbor_min_ell` of src/repro/kernels/ell_cc.py
// (Pallas body `_ell_min_kernel`): the "min" combine of the BlockProgram
// contract, the label exchange of connected components.  For every row u of
// nbr (N, ld) int32 with -1 = PAD and field (N,) int32,
//
//     out[u] = min{field[nbr[u, j]] : j < C, nbr[u, j] >= 0}
//
// with INT32_MAX for a row that has no valid slot among its first C columns
// (C = min(Cd, K)).  PAD is skipped wherever it sits, so the result is
// exact for any slot order when C = Cd.  N, Cd and K are not padded.
//
// Design: one warp per row; each lane keeps the min of its slots
// (j = lane, lane + 32, ...) and the warp takes the min of the lanes
// (`ell::warp_min`, shared with ell_multi.cu).  Integers, so deterministic.
//
// What bounds it on the card: bytes.  A launch must read the first C
// columns of nbr (N*C*4 bytes), one field value per valid slot, and write
// N*4 bytes; one integer min per slot.  The field gather is the only
// uncoalesced traffic.  Several rows per warp on short rows, and stopping
// at the first PAD of a sorted row, are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block

__global__ void ell_cc_kernel(const int32_t* __restrict__ nbr,
                              const int32_t* __restrict__ field,
                              int32_t* __restrict__ out, long long n_rows,
                              int ld, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // the whole warp leaves

  const int32_t* r = nbr + row * (long long)ld;
  int32_t acc = ell::kMinFill;
  for (int j = lane; j < C; j += 32) {
    const int32_t v = r[j];
    if (v >= 0) ell::min_step(acc, __ldg(field + v));
  }
  acc = ell::warp_min(acc);
  if (lane == 0) out[row] = acc;
}

}  // namespace

// nbr: (n_rows, ld) int32; field, out: (n_rows,) int32.  Reads columns
// [0, C) of each nbr row, C <= ld.  Returns the launch's cudaError_t.
extern "C" int ell_cc_launch(const void* nbr, const void* field, void* out,
                             long long n_rows, int ld, int C, void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rows + kWarps - 1) / kWarps;
  ell_cc_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const int32_t*)field, (int32_t*)out, n_rows, ld,
      C);
  return (int)cudaGetLastError();
}
