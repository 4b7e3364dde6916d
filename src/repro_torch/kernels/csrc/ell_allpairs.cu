// ell_allpairs.cu — common-neighbour counts over an ELL adjacency, by an
// all-pairs id match.
//
// Replaces the TPU kernel `neighbor_common_ell` of
// src/repro/kernels/ell_triangles.py, variant "allpairs" (Pallas body
// `_ell_allpairs_kernel`: a (T, C, C) id match per neighbour slot).  For nbr
// and rows (N, ld) int32, any negative id a PAD, it computes over the first
// C columns of both
//
//     red[u] = sum over valid slots j of
//              #{(i, l) : rows[u, i] == rows[nbr[u, j], l] >= 0}
//
// the same counts as the "merge" kernel (ell_triangles.cu) and the plain
// `ref.ell_common_ref`: a multiset intersection, duplicate ids counted as
// products.  It sorts nothing and assumes no slot order: PAD may sit
// anywhere in nbr and in rows, and PAD slots are skipped one by one (there
// is no stop at the first PAD).
//
// Design: one warp per row u.  The warp compacts u's valid row elements
// into its own n_own ints of shared memory (ballot + popc), and leaves at
// once when there are none.  It then reads nbr's row 32 slots at a time;
// each valid neighbour v is broadcast with __shfl_sync, lane l takes the
// elements l, l + 32, ... of rows[v], and each valid element is compared
// with all n_own elements of u (a shared-memory broadcast).  The warp sums
// the lanes' integer counts at the end.
//
// What bounds it on the card: bytes at the main path's shapes.  A launch
// must read the first C columns of nbr and rows (the same tensor for
// whole-graph use, read once: N*C*4 bytes) and write N*4 bytes.  Its
// operations are n_own(u) * (valid elements of rows[v]) compares per valid
// slot (u, v), thanks to the compaction, against the (valid slots) * C^2
// of the match without it (3.7*10^9 on DS1); chip_smoke.py counts both.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace {

__global__ void ell_allpairs_kernel(const int32_t* __restrict__ nbr,
                                    const int32_t* __restrict__ rows,
                                    int32_t* __restrict__ out,
                                    long long n_rows, int ld, int C) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= n_rows) return;  // the whole warp leaves; no block-wide sync

  int32_t* own = smem + (size_t)warp * C;
  const int32_t* ru = rows + row * (long long)ld;
  int n_own = 0;  // warp-uniform
  for (int i0 = 0; i0 < C; i0 += 32) {
    const int i = i0 + lane;
    const int32_t x = i < C ? ru[i] : -1;
    const unsigned ok = __ballot_sync(ell::kFull, x >= 0);
    if (x >= 0) own[n_own + __popc(ok & ((1u << lane) - 1u))] = x;
    n_own += __popc(ok);
  }
  __syncwarp();
  int cnt = 0;
  if (n_own > 0) {
    const int32_t* r = nbr + row * (long long)ld;
    for (int j0 = 0; j0 < C; j0 += 32) {
      const int j = j0 + lane;
      const int32_t v = j < C ? r[j] : -1;
      unsigned live = __ballot_sync(ell::kFull, v >= 0);
      while (live) {  // warp-uniform
        const int s = __ffs(live) - 1;
        live &= live - 1;
        const int32_t* rv =
            rows + (long long)__shfl_sync(ell::kFull, v, s) * ld;
        for (int l = lane; l < C; l += 32) {
          const int32_t y = __ldg(rv + l);
          if (y < 0) continue;
          for (int i = 0; i < n_own; ++i) cnt += own[i] == y;
        }
      }
    }
  }
  cnt = __reduce_add_sync(ell::kFull, cnt);
  if (lane == 0) out[row] = cnt;
}

}  // namespace

// nbr, rows: (n_rows, ld) int32, row-major and contiguous; out: (n_rows,)
// int32.  Reads columns [0, C) of each row of both, C <= ld.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ell_allpairs_launch(const void* nbr, const void* rows,
                                   void* out, long long n_rows, int ld, int C,
                                   void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)C * sizeof(int32_t);
  ell::WarpShape shape;
  const cudaError_t err =
      ell::warp_shape(ell_allpairs_kernel, per_warp, &shape);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_rows + shape.warps - 1) / shape.warps;
  ell_allpairs_kernel<<<(unsigned)blocks, shape.warps * 32, shape.smem,
                        (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const int32_t*)rows, (int32_t*)out, n_rows, ld,
      C);
  return (int)cudaGetLastError();
}
