// ell_triangles.cu — common-neighbour counts over an ELL adjacency.
//
// Replaces the TPU kernel `neighbor_common_ell` of
// src/repro/kernels/ell_triangles.py, variant "merge" (Pallas body
// `_ell_merge_kernel`): the "count_common" combine of the BlockProgram
// contract, triangle counting.  For nbr (N, ld) int32 with -1 = PAD and
// rows (N, C) int32, the row field with PAD keyed to INT32_MAX and every
// row sorted ascending (the wrapper makes this copy, as the JAX wrapper
// does),
//
//     red[u] = sum over valid slots j < C of |rows[u] ∩ rows[nbr[u, j]]|
//
// counted as a multiset intersection: each element x of rows[u] adds the
// number of times x occurs in rows[v], so duplicate ids count as the JAX
// package counts them.  Exact for any slot order of nbr.
//
// Design: one warp per row u.  The warp walks u's slots in order (every
// lane reads the same slot, a broadcast); for a valid slot v, lane l takes
// the elements l, l + 32, ... of u's sorted row, stops at the first PAD key,
// and adds upper_bound - lower_bound of its element in v's sorted row (two
// binary searches over C entries).  The warp sums the lanes' integer counts
// at the end, so the result is exact and deterministic.
//
// What bounds it on the card: bytes at the shapes of the main path.  A
// launch must read the first C columns of nbr and the sorted rows (2*N*C*4
// bytes) and write N*4 bytes; the searches re-read neighbours' rows from
// L1/L2.  The work is sum_u deg(u)^2 * 2*log2(C) probes, which a tiled
// merge in shared memory would cut; that is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace {

constexpr int kWarps = 8;                 // rows per block
constexpr int32_t kPadKey = 0x7fffffff;   // what a PAD slot is keyed to

__device__ __forceinline__ int lower_bound(const int32_t* row, int n,
                                           int32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int32_t* row, int n,
                                           int32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void ell_triangles_kernel(const int32_t* __restrict__ nbr,
                                     const int32_t* __restrict__ rows,
                                     int32_t* __restrict__ out,
                                     long long n_rows, int ld, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // the whole warp leaves

  const int32_t* r = nbr + row * (long long)ld;
  const int32_t* own = rows + row * (long long)C;
  int cnt = 0;
  for (int j = 0; j < C; ++j) {
    const int32_t v = r[j];  // the same slot for every lane
    if (v < 0) continue;     // uniform across the warp
    const int32_t* vr = rows + (long long)v * C;
    for (int i = lane; i < C; i += 32) {
      const int32_t x = own[i];
      if (x == kPadKey) break;  // sorted: the rest of the row is PAD
      cnt += upper_bound(vr, C, x) - lower_bound(vr, C, x);
    }
  }
  cnt = __reduce_add_sync(ell::kFull, cnt);
  if (lane == 0) out[row] = cnt;
}

}  // namespace

// nbr: (n_rows, ld) int32; rows: (n_rows, C) int32, keyed and sorted as
// above; out: (n_rows,) int32.  Reads columns [0, C) of each nbr row,
// C <= ld.  Returns the launch's cudaError_t.
extern "C" int ell_triangles_launch(const void* nbr, const void* rows,
                                    void* out, long long n_rows, int ld,
                                    int C, void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rows + kWarps - 1) / kWarps;
  ell_triangles_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const int32_t*)rows, (int32_t*)out, n_rows, ld,
      C);
  return (int)cudaGetLastError();
}
