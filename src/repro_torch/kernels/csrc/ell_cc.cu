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
// `deg` (N,) int32 is optional, each row's count of valid slots: with it a
// row stops at its length, and the result is the same (ell_rows.cuh).
//
// What bounds it on the card: latency, not bytes.  With deg a launch needs
// each row's valid slots, deg, the field and the output (about 1.3 MB at
// DS1); without it the first C columns of every row (29.8 MB at DS1, 98 %
// PAD).  Design: the row tiers of ell_rows.cuh (8 lanes a row, 4 rows a
// warp, every slot load then every gather before any use; without deg and
// with C > 64 a warp a row) with the min fixed at compile time: a group
// min (`ell::reg_min`), `ell::warp_min` in the warp layout.  Integers, so
// every tier gives the same, deterministic min, and ell_multi.cu's "min"
// equals it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

struct MinOp {
  const int32_t* __restrict__ in;
  int32_t* __restrict__ out;
  using Vals = int32_t[ell::kSlots];
  using Acc = int32_t;

  __device__ __forceinline__ void gather(const int32_t (&v)[ell::kSlots],
                                         int steps, Vals& x) const {
    ell::gather_slots(in, v, steps, x);
  }
  template <int W>
  __device__ __forceinline__ void reduce(const int32_t (&v)[ell::kSlots],
                                         const Vals& x, int steps, int,
                                         long long row, bool write) const {
    const int32_t m = ell::reg_min<W>(v, x, steps);
    if (write) out[row] = m;
  }
  __device__ __forceinline__ void warp_begin(Acc& a, int, int) const {
    a = ell::kMinFill;
  }
  __device__ __forceinline__ void warp_add(Acc& a, int32_t v, int) const {
    ell::min_step(a, __ldg(in + v));
  }
  __device__ __forceinline__ void warp_end(Acc& a, long long u, int,
                                           int lane) const {
    const int32_t m = ell::warp_min(a);
    if (lane == 0) out[u] = m;
  }
};

// 256: the 8 warps a block of `ell::warp_shape`; 6 blocks an SM hold a
// thread to 40 registers, with no spill (the compiler's own choice, about
// 54, leaves 4 blocks an SM and measured slower; see PERF.md).
template <bool kPacked>
__global__ void __launch_bounds__(256, 6)
    ell_cc_kernel(const int32_t* __restrict__ nbr,
                  const int32_t* __restrict__ field,
                  const int32_t* __restrict__ deg, int32_t* __restrict__ out,
                  long long n_rows, int ld, int C) {
  ell::combine_rows<kPacked>(MinOp{field, out}, nbr, deg, n_rows, ld, C);
}

}  // namespace

// nbr: (n_rows, ld) int32; field, out: (n_rows,) int32; deg: (n_rows,)
// int32 valid slots per row, or NULL.  Reads columns [0, C) of each nbr
// row, C <= ld.  Returns the launch's cudaError_t.
extern "C" int ell_cc_launch(const void* nbr, const void* field,
                             const void* deg, void* out, long long n_rows,
                             int ld, int C, void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const bool packed = ell::packs(deg, C);
  return (int)ell::launch_rows(
      packed ? ell_cc_kernel<true> : ell_cc_kernel<false>, 0, packed,
      n_rows, (cudaStream_t)stream, (const int32_t*)nbr, (const int32_t*)field,
      (const int32_t*)deg, (int32_t*)out, n_rows, ld, C);
}
