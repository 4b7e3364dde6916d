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
// is skipped wherever it sits; N, Cd and K are not padded.  `deg` (N,)
// int32 is optional, each row's count of valid slots: with it a row stops
// at its length, and the result is the same, bit for bit (ell_rows.cuh).
//
// The order of the additions is fixed: the warp layout's.  Lane l of a warp
// adds the row's slots j = l, l + 32, ... in ascending order from 0.0f,
// skipping PAD (a PAD never adds 0.0f, which would turn -0.0 into +0.0),
// and the warp adds the lanes in a fixed xor butterfly (`ell::warp_sum`).
// Every tier keeps those operands: tier 1 packs a row into 8 lanes and
// folds slot j into the accumulator of its virtual lane j mod 32
// (`ell::vlane_sum`, the proof beside it); tiers 2 and 3 are the warp
// layout.  So the sum is deterministic, the same with deg and without, and
// ell_multi.cu's "sum", which runs the same code, gives the same bits.  The
// order is not torch.sum's, so the plain version agrees to float32
// rounding only.
//
// What bounds it on the card: latency, as for ell_cc.cu (the same tiers,
// with the sum fixed at compile time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

struct SumOp {
  const int32_t* __restrict__ in;  // the field's float bits
  float* __restrict__ out;
  using Vals = int32_t[ell::kSlots];
  using Acc = float;

  __device__ __forceinline__ void gather(const int32_t (&v)[ell::kSlots],
                                         int steps, Vals& x) const {
    ell::gather_slots(in, v, steps, x);
  }
  template <int W>
  __device__ __forceinline__ void reduce(const int32_t (&v)[ell::kSlots],
                                         const Vals& x, int steps, int,
                                         long long row, bool write) const {
    const float s = ell::reg_sum<W>(v, x, steps);
    if (write) out[row] = s;
  }
  __device__ __forceinline__ void warp_begin(Acc& a, int, int) const {
    a = 0.0f;
  }
  __device__ __forceinline__ void warp_add(Acc& a, int32_t v, int) const {
    ell::sum_step(a, __int_as_float(__ldg(in + v)));
  }
  __device__ __forceinline__ void warp_end(Acc& a, long long u, int,
                                           int lane) const {
    const float s = ell::warp_sum(a);
    if (lane == 0) out[u] = s;
  }
};

// 256: the 8 warps a block of `ell::warp_shape`; 6 blocks an SM hold a
// thread to 40 registers, with no spill (the compiler's own choice, about
// 54, leaves 4 blocks an SM and measured slower; see PERF.md).
template <bool kPacked>
__global__ void __launch_bounds__(256, 6)
    ell_pagerank_kernel(const int32_t* __restrict__ nbr,
                        const float* __restrict__ field,
                        const int32_t* __restrict__ deg,
                        float* __restrict__ out, long long n_rows, int ld,
                        int C) {
  ell::combine_rows<kPacked>(
      SumOp{reinterpret_cast<const int32_t*>(field), out}, nbr, deg, n_rows,
      ld, C);
}

}  // namespace

// nbr: (n_rows, ld) int32; field, out: (n_rows,) float32; deg: (n_rows,)
// int32 valid slots per row, or NULL.  Reads columns [0, C) of each nbr
// row, C <= ld.  Returns the launch's cudaError_t.
extern "C" int ell_pagerank_launch(const void* nbr, const void* field,
                                   const void* deg, void* out,
                                   long long n_rows, int ld, int C,
                                   void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const bool packed = ell::packs(deg, C);
  return (int)ell::launch_rows(
      packed ? ell_pagerank_kernel<true> : ell_pagerank_kernel<false>, 0,
      packed, n_rows, (cudaStream_t)stream, (const int32_t*)nbr,
      (const float*)field, (const int32_t*)deg, (float*)out, n_rows, ld, C);
}
