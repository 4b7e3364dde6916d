// ell_triangles.cu — common-neighbour counts over an ELL adjacency.
//
// Replaces the TPU kernel `neighbor_common_ell` of
// src/repro/kernels/ell_triangles.py, variant "merge" (Pallas body
// `_ell_merge_kernel`, which keys PAD to INT32_MAX, sorts the row tiles and
// probes each element into the neighbour's sorted row): the "count_common"
// combine of the BlockProgram contract, triangle counting.  For nbr and
// rows (N, ld) int32, any negative id a PAD, over the first C columns of
// both,
//
//     red[u] = sum over valid slots j of |rows[u] ∩ rows[nbr[u, j]]|
//
// counted as a multiset intersection: each valid element y of a
// neighbour's row adds the number of times y occurs in rows[u], so
// duplicate ids count as the JAX package counts them.  Nothing is sorted,
// and the result is exact for any slot order of nbr and of rows.
//
// Row lengths: `deg` (N,) int32, optional, bounds u's nbr row, and `fdeg`
// the field's rows when the field is nbr itself, as ell_pairs.cuh sets
// out; the result never depends on them.
//
// What bounds it on the card: latency, at the analytics shapes.  What the
// data needs is small: the valid slots of nbr with deg and the output
// (1.06 MB at DS1, 0.32 us of HBM time), the neighbours' valid rows (sum of
// deg^2 ids, 4.8 MB, mostly L2 hits) and one probe per (u, v, y) triple
// (1.2 M).  So the design does one probe per triple, into a hash table in
// shared memory, spreads a row's triples over lanes, and keeps the rows
// with many triples from queueing behind one another: the row split of
// ell_pairs.cuh (pass 1, 8 lanes a row of up to 64 columns and 128 pairs;
// pass 2, a team of 8 warps for each other row), shared with
// ell_allpairs.cu, with this per-pair operation (`TableOp`): u's valid
// field entries go into an open-addressing table of (id, multiplicity), a
// power of two at least twice their number, built with shared-memory
// atomics, and each pair adds mult_u(y).  When the own entries of every
// row of a warp fit one slot a lane (8 in pass 1, DS1's typical row),
// there is no table: each pair's id is compared with the group's entries
// by shuffles.
//
// The wrapper calls no sort: there is no keyed copy of the field.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_pairs.cuh"

namespace {

constexpr int kEmpty = -1;  // a free table slot's key

__device__ __forceinline__ unsigned hash_slot(int32_t y, int log_t) {
  return ((unsigned)y * 2654435769u) >> (32 - log_t);  // Fibonacci hashing
}

__device__ __forceinline__ void table_add(int2* t, int log_t, int32_t y) {
  const unsigned mask = (1u << log_t) - 1u;
  for (unsigned h = hash_slot(y, log_t);; h = (h + 1) & mask) {
    const int prev = atomicCAS(&t[h].x, kEmpty, y);
    if (prev == kEmpty || prev == y) {
      atomicAdd(&t[h].y, 1);
      return;
    }
  }
}

__device__ __forceinline__ int table_count(const int2* t, int log_t,
                                           int32_t y) {
  const unsigned mask = (1u << log_t) - 1u;
  for (unsigned h = hash_slot(y, log_t);; h = (h + 1) & mask) {
    const int2 e = t[h];
    if (e.x == y) return e.y;
    if (e.x == kEmpty) return 0;
  }
}

// The per-pair operation of "merge": mult_u(y) from a hash table of u's
// entries, or, when every group's row holds at most one own entry a lane
// (`small`), a compare with the group's entries by shuffles.
struct TableOp {
  struct Own {
    int log_t;   // the table holds 2^log_t >= 2n slots
    bool small;  // no table: u's entries are x[0] of the group's lanes
  };

  template <int W>
  __device__ __forceinline__ Own begin(int2* table,
                                       int32_t (&x)[pairs::kSlots], int n,
                                       bool narrow) const {
    const int gl = (int)(threadIdx.x % W);
    Own o;
    o.small = narrow;
    o.log_t = n > 0 ? 32 - __clz(2 * n - 1) : 0;  // 2^log_t >= 2n
    if (!o.small) {  // into the table
      for (int k = gl; k < (n > 0 ? 1 << o.log_t : 0); k += W)
        table[k] = make_int2(kEmpty, 0);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < pairs::kSlots; ++i)
        if (x[i] >= 0) table_add(table, o.log_t, x[i]);
      __syncwarp();
    }
    return o;
  }
  template <int W, int U>
  __device__ __forceinline__ int count(const int2* table,
                                       const int32_t (&x)[pairs::kSlots],
                                       const Own& o,
                                       const int32_t (&y)[U]) const {
    int cnt = 0;
    if (o.small) {  // u's entries are x[0] of the group's lanes
#pragma unroll
      for (int g = 0; g < W; ++g) {
        const int32_t own = __shfl_sync(ell::kFull, x[0], g, W);
#pragma unroll
        for (int k = 0; k < U; ++k) cnt += y[k] >= 0 && y[k] == own;
      }
    } else {
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (y[k] >= 0) cnt += table_count(table, o.log_t, y[k]);
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
extern "C" int ell_triangles_launch(const void* nbr, const void* rows,
                                    const void* deg, const void* fdeg,
                                    void* out, long long n_rows, int ld,
                                    int C, void* stream) {
  return (int)pairs::launch<TableOp>(nbr, rows, deg, fdeg, out, n_rows, ld,
                                     C, (cudaStream_t)stream);
}
