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
// products.  It sorts nothing, builds no table and assumes no slot order:
// PAD may sit anywhere in nbr and in rows.  Row lengths: `deg` (N,) int32,
// optional, bounds u's nbr row, and `fdeg` the field's rows when the field
// is nbr itself, as ell_pairs.cuh sets out; the result never depends on
// them.
//
// What bounds it on the card: latency, at the analytics shapes, as for
// ell_triangles.cu: with deg the data needs the valid slots of nbr, deg and
// the output (0.32 us of HBM time at DS1) and |u's row| compares per
// (u, v, y) triple (1.1 * 10^7 at DS1, 0.16 us at the scalar rate).  So it
// runs ell_triangles.cu's row split (ell_pairs.cuh: 8 lanes a row of up to
// 64 columns and 128 pairs, a team of 8 warps for each other row, spread
// over the grid), and only the work per (v, y) pair differs (`AllPairsOp`):
// each pair's id is compared with every valid id of u's row.  In pass 1
// (8 lanes a row) u's ids sit in the group's registers, 8 a lane, and are
// broadcast by shuffles, over the register slots some lane of the warp
// uses; in pass 2 (a warp, u's row 256 columns at a time) they are
// compacted into the warp's shared memory and read 4 at a time, every lane
// reading the same address.  This generalises ell_triangles.cu's no-table
// case to any row length.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_pairs.cuh"

namespace {

constexpr int32_t kNoPair = -2;  // a pair's id when it has none: below -1

// The per-pair operation of "allpairs": #{i : own[i] == y} over u's valid
// ids, which are -1 where invalid, so no id of a pair (kNoPair where it has
// none) equals an invalid one.
struct AllPairsOp {
  struct Own {
    int n;  // W = 8: the register slots in use; W = 32: the ids in shared
  };        // memory, padded to a multiple of 4 with -1

  template <int W>
  __device__ __forceinline__ Own begin(int2* table,
                                       int32_t (&x)[pairs::kSlots], int n,
                                       bool) const {
    Own o;
    if constexpr (W == pairs::kGroup) {  // in registers, compared by shuffles
      int used = 0;
#pragma unroll
      for (int i = 0; i < pairs::kSlots; ++i) {
        if (x[i] >= 0) used = i + 1;
        else x[i] = -1;
      }
      o.n = __reduce_max_sync(ell::kFull, used);
    } else {  // compacted into the warp's shared memory
      static_assert(W == 32, "a warp's ids in shared memory");
      const int lane = (int)(threadIdx.x & 31);
      int32_t* own = reinterpret_cast<int32_t*>(table);
      int at = 0;  // warp-uniform
#pragma unroll
      for (int i = 0; i < pairs::kSlots; ++i) {
        const unsigned ok = __ballot_sync(ell::kFull, x[i] >= 0);
        if (x[i] >= 0) own[at + __popc(ok & ((1u << lane) - 1u))] = x[i];
        at += __popc(ok);
      }
      if (lane < 3) own[at + lane] = -1;  // pad to a multiple of 4
      o.n = (n + 3) & ~3;
      __syncwarp();
    }
    return o;
  }
  template <int W, int U>
  __device__ __forceinline__ int count(const int2* table,
                                       const int32_t (&x)[pairs::kSlots],
                                       const Own& o,
                                       const int32_t (&y)[U]) const {
    int32_t q[U];
#pragma unroll
    for (int k = 0; k < U; ++k) q[k] = y[k] >= 0 ? y[k] : kNoPair;
    int cnt = 0;
    if constexpr (W == pairs::kGroup) {
#pragma unroll
      for (int i = 0; i < pairs::kSlots; ++i) {
        if (i >= o.n) break;
#pragma unroll
        for (int g = 0; g < W; ++g) {
          const int32_t own = __shfl_sync(ell::kFull, x[i], g, W);
#pragma unroll
          for (int k = 0; k < U; ++k) cnt += q[k] == own;
        }
      }
    } else {
      const int4* own = reinterpret_cast<const int4*>(table);
      for (int m = 0; m < o.n / 4; ++m) {
        const int4 e = own[m];  // the same address on every lane
#pragma unroll
        for (int k = 0; k < U; ++k)
          cnt += (q[k] == e.x) + (q[k] == e.y) + (q[k] == e.z) +
                 (q[k] == e.w);
      }
    }
    return cnt;
  }
};

}  // namespace

// nbr, rows: (n_rows, ld) int32, row-major and contiguous (the same tensor
// for whole-graph use); deg: (n_rows,) int32 valid nbr slots per row, or
// NULL; fdeg: deg when rows is nbr, else NULL; out: (n_rows,) int32.  Reads
// columns [0, C) of each row of both, C <= ld.  Returns the launch's
// cudaError_t.
extern "C" int ell_allpairs_launch(const void* nbr, const void* rows,
                                   const void* deg, const void* fdeg,
                                   void* out, long long n_rows, int ld, int C,
                                   void* stream) {
  return (int)pairs::launch<AllPairsOp>(nbr, rows, deg, fdeg, out, n_rows,
                                        ld, C, (cudaStream_t)stream);
}
