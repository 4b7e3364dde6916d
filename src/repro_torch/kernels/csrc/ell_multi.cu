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
// Design: the layout of the standalone kernels (one warp per row, lane l on
// slots l, l + 32, ...), with each nbr slot read once and every field served
// from it.  Each field folds and reduces through the same functions of
// ell_reduce.cuh that its standalone kernel (ell_cc.cu, ell_pagerank.cu,
// ell_hindex.cu) calls, in the same order, so every output is bit-identical
// to that kernel's, the float sum included.  An "hindex" field takes C + 1
// bins of shared memory per warp, as ell_hindex.cu does.
//
// What bounds it on the card: bytes.  A launch must read the first C
// columns of nbr once (N*C*4 bytes), one value of each field per valid
// slot, and write N*4 bytes per field: k fields cost one sweep of nbr where
// the standalone kernels cost k.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

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

__global__ void ell_multi_kernel(const int32_t* __restrict__ nbr,
                                 const Fields f, long long n_rows, int ld,
                                 int C) {
  extern __shared__ int32_t smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= n_rows) return;  // the whole warp leaves; no block-wide sync

  int32_t* bins = smem + (size_t)warp * f.n_hist * (C + 1);
  int32_t mins[kMaxFields];
  float sums[kMaxFields];
#pragma unroll
  for (int i = 0; i < kMaxFields; ++i) {
    mins[i] = ell::kMinFill;
    sums[i] = 0.0f;
    if (i < f.k && f.code[i] == kHindex)
      ell::hist_clear(bins + f.bin[i] * (C + 1), C, lane);
  }
  __syncwarp();

  const int32_t* r = nbr + row * (long long)ld;
  for (int j = lane; j < C; j += 32) {
    const int32_t v = r[j];  // read once for every field
    if (v < 0) continue;
#pragma unroll
    for (int i = 0; i < kMaxFields; ++i) {
      if (i >= f.k) break;
      if (f.code[i] == kMin) {
        ell::min_step(mins[i],
                      __ldg(static_cast<const int32_t*>(f.in[i]) + v));
      } else if (f.code[i] == kSum) {
        ell::sum_step(sums[i], __ldg(static_cast<const float*>(f.in[i]) + v));
      } else {
        ell::hist_add(bins + f.bin[i] * (C + 1), C,
                      __ldg(static_cast<const int32_t*>(f.in[i]) + v));
      }
    }
  }
  __syncwarp();

#pragma unroll
  for (int i = 0; i < kMaxFields; ++i) {
    if (i >= f.k) break;
    if (f.code[i] == kMin) {
      const int32_t m = ell::warp_min(mins[i]);
      if (lane == 0) static_cast<int32_t*>(f.out[i])[row] = m;
    } else if (f.code[i] == kSum) {
      const float s = ell::warp_sum(sums[i]);
      if (lane == 0) static_cast<float*>(f.out[i])[row] = s;
    } else {
      const int32_t h = ell::hist_hindex(bins + f.bin[i] * (C + 1), C, lane);
      if (lane == 0) static_cast<int32_t*>(f.out[i])[row] = h;
    }
  }
}

}  // namespace

// nbr: (n_rows, ld) int32.  Field i (i < k <= 3) is in_i, (n_rows,) int32
// for code 0 ("min") or 2 ("hindex"), float32 for code 1 ("sum"); its
// result goes to out_i, of the same type.  Reads columns [0, C) of each nbr
// row, C <= ld.  Returns the launch's cudaError_t.
extern "C" int ell_multi_launch(const void* nbr, const void* in0,
                                const void* in1, const void* in2, void* out0,
                                void* out1, void* out2, int code0, int code1,
                                int code2, int k, long long n_rows, int ld,
                                int C, void* stream) {
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
  ell::WarpShape shape;
  const cudaError_t err =
      ell::warp_shape(ell_multi_kernel, per_warp, &shape);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_rows + shape.warps - 1) / shape.warps;
  ell_multi_kernel<<<(unsigned)blocks, shape.warps * 32, shape.smem,
                     (cudaStream_t)stream>>>((const int32_t*)nbr, f, n_rows,
                                             ld, C);
  return (int)cudaGetLastError();
}
