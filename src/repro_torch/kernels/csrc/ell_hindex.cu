// ell_hindex.cu — h-index of neighbour estimates over an ELL adjacency.
//
// Replaces the TPU kernel `hindex_ell` of src/repro/kernels/ell_hindex.py
// (Pallas body `_ell_hindex_sort_kernel`, which sorts each row tile).
// It computes, for every row u of nbr (N, ld) int32 with -1 = PAD,
//
//     h[u] = max{k : at least k of {est[nbr[u, j]] : j < C, nbr[u, j] >= 0}
//                    are >= k}
//
// reading only the first C columns (C = min(Cd, K)) and skipping PAD
// wherever it sits, so the result is exact for any slot order when C = Cd.
//
// Design: one warp per row and no sort.  Each lane counts its slots'
// estimates into the warp's (C+1)-bin histogram in shared memory, and the
// warp scans it from the top (`ell::hist_*` in ell_reduce.cuh, shared with
// the fused ell_multi.cu).  Integers only, so the result is deterministic.
//
// What bounds it on the card: bytes.  A launch must read the first C
// columns of nbr (N*C*4 bytes), one est value per valid slot, and write
// N*4 bytes; the arithmetic is a few integer operations per slot.  The est
// gather is the only uncoalesced traffic.  This version is the simple exact
// one; making it fast (skipping all-PAD 32-slot chunks on sorted rows,
// several rows per warp when C is small) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace {

__global__ void ell_hindex_kernel(const int32_t* __restrict__ nbr,
                                  const int32_t* __restrict__ est,
                                  int32_t* __restrict__ out,
                                  long long n_rows, int ld, int C) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= n_rows) return;  // the whole warp leaves; no block-wide sync

  int32_t* bins = smem + (size_t)warp * (C + 1);
  ell::hist_clear(bins, C, lane);
  __syncwarp();
  const int32_t* r = nbr + row * (long long)ld;
  for (int j = lane; j < C; j += 32) {
    const int32_t v = r[j];
    if (v >= 0) ell::hist_add(bins, C, __ldg(est + v));
  }
  __syncwarp();
  const int32_t h = ell::hist_hindex(bins, C, lane);
  if (lane == 0) out[row] = h;
}

}  // namespace

// nbr: (n_rows, ld) int32; est: (n_rows,) int32 (any values; nbr ids index
// it); out: (n_rows,) int32.  Reads columns [0, C) of each row, C <= ld.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ell_hindex_launch(const void* nbr, const void* est, void* out,
                                 long long n_rows, int ld, int C,
                                 void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)(C + 1) * sizeof(int32_t);
  ell::WarpShape shape;
  const cudaError_t err =
      ell::warp_shape(ell_hindex_kernel, per_warp, &shape);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_rows + shape.warps - 1) / shape.warps;
  ell_hindex_kernel<<<(unsigned)blocks, shape.warps * 32, shape.smem,
                      (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const int32_t*)est, (int32_t*)out, n_rows, ld, C);
  return (int)cudaGetLastError();
}
