// ell_multi.cu — one read of nbr serves up to three neighbour fields.
//
// Replaces the TPU kernel `neighbor_multi_ell` of
// src/repro/kernels/ell_multi.py (Pallas body `_ell_multi_kernel`): the
// fused superstep of a MultiProgram (coreness + CC labels + PageRank in
// `fused_analytics`).  For every row u of nbr (N, ld) int32 with -1 = PAD
// and k <= 3 fields, each reduced over the valid slots among the row's
// first C columns by its own combine:
//
//     "min"    (int32)   min of field[v],   INT32_MAX on an empty row
//     "sum"    (float32) sum of field[v],   0.0 on an empty row
//     "hindex" (int32)   h-index of field[v], 0 on an empty row
//
// `deg` (N,) int32 is optional: each row's count of valid slots, as a
// GraphBlocks keeps it.  With it a row stops once it has seen
// min(deg[u], valid slots of its first C columns) valid slots (on a
// left-filled row, exactly nbr[u, :min(deg[u], C)]), and a PAD found before
// that sends the row on to C, as in ell_hindex.cu; the result is the same.
// Without it every row reads its C columns.
//
// Every output is bit-identical to the standalone kernel of its combine
// (ell_cc.cu, ell_pagerank.cu, ell_hindex.cu), the float sum included.
//
// What bounds it on the card: at the analytics shapes, latency.  With deg
// a launch needs the valid slots (3.3 a row on average at DS1), deg, the
// three fields' values and three outputs: about 2.1 MB, under a microsecond
// of HBM time.  What is left is the launch and each row's chain of
// dependent loads (deg, its slots, the field gathers).  The design is the
// row tiers of ell_rows.cuh, which ell_cc.cu and ell_pagerank.cu run too,
// with every field of a row served from one read of its slots:
//
//  * Tiers 1 and 2 (rows of up to 64 columns in an 8-lane group's
//    registers, 4 rows a warp; rows of up to 256 in the warp's): every
//    slot load, then every field's gathers, before any value is used.
//    "min" is `ell::reg_min`, "sum" `ell::reg_sum` (the virtual-lane fold
//    in a group, the warp layout in a warp), "hindex" the bisection
//    `ell::reg_hindex_of` that ell_hindex.cu calls.  No shared memory, no
//    atomics.
//  * Tier 3 (a longer row, or one whose first min(deg, C) columns hold a
//    PAD): the whole warp, 32 slots a step, each field through the same
//    ell_reduce.cuh functions as its standalone kernel: `warp_min`,
//    `warp_sum`, and for "hindex" a (C + 1)-bin histogram per warp in
//    shared memory.  The warp stops once a ballot count of the row's valid
//    slots reaches deg.
//
// The fields' combines are known only at run time (`Fields`), so each
// register slot holds up to three gathered values, and a thread needs more
// registers than in ell_cc.cu or ell_pagerank.cu, whose single combine is
// fixed at compile time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

constexpr int kMaxFields = 3;

enum Combine : int { kMin = 0, kSum = 1, kHindex = 2 };

struct Fields {
  const void* in[kMaxFields];
  void* out[kMaxFields];
  int code[kMaxFields];
  int bin[kMaxFields];  // which of the warp's histograms an "hindex" uses
  int k;                // fields in use
  int n_hist;           // "hindex" fields
};

// The fields of a row, for the tiers of ell_rows.cuh.  `bins`: this warp's
// histograms in shared memory, C + 1 bins for each "hindex" field.
struct MultiOp {
  const Fields& f;
  int32_t* bins;
  // every field's gathers, float bits as int32 (0 for a PAD)
  using Vals = int32_t[kMaxFields][ell::kSlots];
  struct Acc {
    int32_t mins[kMaxFields];
    float sums[kMaxFields];
  };

  __device__ __forceinline__ void gather(const int32_t (&v)[ell::kSlots],
                                         int steps, Vals& x) const {
#pragma unroll
    for (int q = 0; q < kMaxFields; ++q) {
      if (q >= f.k) break;
      ell::gather_slots(static_cast<const int32_t*>(f.in[q]), v, steps, x[q]);
    }
  }
  template <int W>
  __device__ __forceinline__ void reduce(const int32_t (&v)[ell::kSlots],
                                         const Vals& x, int steps, int n,
                                         long long row, bool write) const {
#pragma unroll
    for (int q = 0; q < kMaxFields; ++q) {
      if (q >= f.k) break;
      if (f.code[q] == kMin) {
        const int32_t m = ell::reg_min<W>(v, x[q], steps);
        if (write) static_cast<int32_t*>(f.out[q])[row] = m;
      } else if (f.code[q] == kSum) {
        const float s = ell::reg_sum<W>(v, x[q], steps);
        if (write) static_cast<float*>(f.out[q])[row] = s;
      } else {
        const int32_t h = ell::reg_hindex_of<W, ell::kSlots>(x[q], steps, n);
        if (write) static_cast<int32_t*>(f.out[q])[row] = h;
      }
    }
  }
  __device__ __forceinline__ void warp_begin(Acc& a, int C, int lane) const {
#pragma unroll
    for (int i = 0; i < kMaxFields; ++i) {
      a.mins[i] = ell::kMinFill;
      a.sums[i] = 0.0f;
      if (i < f.k && f.code[i] == kHindex)
        ell::hist_clear(bins + f.bin[i] * (C + 1), C, lane);
    }
  }
  __device__ __forceinline__ void warp_add(Acc& a, int32_t v, int C) const {
#pragma unroll
    for (int i = 0; i < kMaxFields; ++i) {
      if (i >= f.k) break;
      if (f.code[i] == kMin) {
        ell::min_step(a.mins[i],
                      __ldg(static_cast<const int32_t*>(f.in[i]) + v));
      } else if (f.code[i] == kSum) {
        ell::sum_step(a.sums[i],
                      __ldg(static_cast<const float*>(f.in[i]) + v));
      } else {
        ell::hist_add(bins + f.bin[i] * (C + 1), C,
                      __ldg(static_cast<const int32_t*>(f.in[i]) + v));
      }
    }
  }
  __device__ __forceinline__ void warp_end(Acc& a, long long u, int C,
                                           int lane) const {
#pragma unroll
    for (int i = 0; i < kMaxFields; ++i) {
      if (i >= f.k) break;
      if (f.code[i] == kMin) {
        const int32_t m = ell::warp_min(a.mins[i]);
        if (lane == 0) static_cast<int32_t*>(f.out[i])[u] = m;
      } else if (f.code[i] == kSum) {
        const float s = ell::warp_sum(a.sums[i]);
        if (lane == 0) static_cast<float*>(f.out[i])[u] = s;
      } else {
        const int32_t h =
            ell::hist_hindex(bins + f.bin[i] * (C + 1), C, lane);
        if (lane == 0) static_cast<int32_t*>(f.out[i])[u] = h;
      }
    }
  }
};

template <bool kPacked>
__global__ void ell_multi_kernel(const int32_t* __restrict__ nbr,
                                 const int32_t* __restrict__ deg,
                                 const Fields f, long long n_rows, int ld,
                                 int C) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const MultiOp op{f, smem + (size_t)warp * f.n_hist * (C + 1)};
  ell::combine_rows<kPacked>(op, nbr, deg, n_rows, ld, C);
}

}  // namespace

// nbr: (n_rows, ld) int32; deg: (n_rows,) int32 valid slots per row, or
// NULL.  Field i (i < k <= 3) is in_i, (n_rows,) int32 for code 0 ("min")
// or 2 ("hindex"), float32 for code 1 ("sum"); its result goes to out_i, of
// the same type.  Reads columns [0, C) of each nbr row, C <= ld.  Returns
// the launch's cudaError_t.
extern "C" int ell_multi_launch(const void* nbr, const void* deg,
                                const void* in0, const void* in1,
                                const void* in2, void* out0, void* out1,
                                void* out2, int code0, int code1, int code2,
                                int k, long long n_rows, int ld, int C,
                                void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld || k < 1 || k > kMaxFields)
    return (int)cudaErrorInvalidValue;
  Fields f{};
  const void* ins[kMaxFields] = {in0, in1, in2};
  void* outs[kMaxFields] = {out0, out1, out2};
  const int codes[kMaxFields] = {code0, code1, code2};
  f.k = k;
  for (int i = 0; i < k; ++i) {
    if (codes[i] < kMin || codes[i] > kHindex)
      return (int)cudaErrorInvalidValue;
    f.in[i] = ins[i];
    f.out[i] = outs[i];
    f.code[i] = codes[i];
    f.bin[i] = codes[i] == kHindex ? f.n_hist++ : 0;
  }
  const size_t per_warp = (size_t)f.n_hist * (C + 1) * sizeof(int32_t);
  const bool packed = ell::packs(deg, C);
  return (int)ell::launch_rows(
      packed ? ell_multi_kernel<true> : ell_multi_kernel<false>, per_warp,
      packed, n_rows, (cudaStream_t)stream, (const int32_t*)nbr,
      (const int32_t*)deg, f, n_rows, ld, C);
}
