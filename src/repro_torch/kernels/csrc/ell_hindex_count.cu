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
// count reaches k, and thresholds above C never fire (cnt <= C).  PAD may
// sit anywhere.
//
// Design: one warp per row; lane l owns the thresholds k = l + 1, l + 33,
// ... and keeps their counters in the warp's C ints of shared memory (no
// lane touches another's, so no atomics and no barrier).  The warp reads the
// row 32 slots at a time; each slot whose estimate is positive is broadcast
// with __shfl_sync, and every lane adds [value >= k] into its counters.  The
// warp sums the lanes' [cnt[k] >= k] at the end.  Integers only.
//
// What bounds it on the card: bytes, like ell_hindex.cu.  A launch must read
// the first C columns of nbr (N*C*4 bytes), one est value per valid slot,
// and write N*4 bytes.  Its operations are C compares per valid slot
// (N*C^2 if every slot were valid), far below the bytes at the main path's
// shapes.  It does C/32 times the work of the histogram kernel per slot;
// it is the variant the JAX package keeps for its kernel sweep.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace {

__global__ void ell_hindex_count_kernel(const int32_t* __restrict__ nbr,
                                        const int32_t* __restrict__ est,
                                        int32_t* __restrict__ out,
                                        long long n_rows, int ld, int C) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= n_rows) return;  // the whole warp leaves; no block-wide sync

  int32_t* cnt = smem + (size_t)warp * C;  // cnt[k - 1] for threshold k
  for (int k = lane; k < C; k += 32) cnt[k] = 0;
  const int32_t* r = nbr + row * (long long)ld;
  for (int j0 = 0; j0 < C; j0 += 32) {
    const int j = j0 + lane;
    int32_t e = 0;
    if (j < C) {
      const int32_t v = r[j];
      if (v >= 0) e = __ldg(est + v);
    }
    unsigned live = __ballot_sync(ell::kFull, e >= 1);  // e <= 0 counts 0
    while (live) {  // warp-uniform
      const int s = __ffs(live) - 1;
      live &= live - 1;
      const int32_t x = __shfl_sync(ell::kFull, e, s);
      for (int k = lane + 1; k <= C; k += 32) cnt[k - 1] += x >= k;
    }
  }
  int h = 0;
  for (int k = lane + 1; k <= C; k += 32) h += cnt[k - 1] >= k;
  h = __reduce_add_sync(ell::kFull, h);
  if (lane == 0) out[row] = h;
}

}  // namespace

// nbr: (n_rows, ld) int32; est: (n_rows,) int32 (any values; nbr ids index
// it); out: (n_rows,) int32.  Reads columns [0, C) of each row, C <= ld.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ell_hindex_count_launch(const void* nbr, const void* est,
                                       void* out, long long n_rows, int ld,
                                       int C, void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)C * sizeof(int32_t);
  ell::WarpShape shape;
  const cudaError_t err =
      ell::warp_shape(ell_hindex_count_kernel, per_warp, &shape);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_rows + shape.warps - 1) / shape.warps;
  ell_hindex_count_kernel<<<(unsigned)blocks, shape.warps * 32, shape.smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const int32_t*)est, (int32_t*)out, n_rows, ld, C);
  return (int)cudaGetLastError();
}
