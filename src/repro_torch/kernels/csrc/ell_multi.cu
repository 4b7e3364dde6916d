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
// dependent loads (deg, its slots, the field gathers).  The design is
// ell_hindex.cu's, to keep that chain short:
//
//  * 8 lanes a row, 4 rows a warp, 8 slots a lane in registers: rows of
//    up to 64 columns (with deg, all but 9 of DS1's rows) are read into
//    the group's registers.  Every slot load is issued, then every field's
//    gathers, before any value is used.  "min" is a group min, "hindex" the
//    bisection `ell::reg_hindex_of` that ell_hindex.cu calls, "sum" the
//    virtual-lane fold `ell::vlane_sum`: slot j folds into the accumulator
//    of its virtual lane j mod 32, so the sum has `warp_sum`'s bits (the
//    proof is beside that function).  No shared memory, no atomics.
//  * Rows of 65 to 32 * 8 = 256 columns are done the same way by the
//    whole warp, one after another, after its short rows, in the
//    standalone kernels' layout (lane l on slots l, l + 32, ...):
//    `warp_min`, `warp_sum`, `reg_hindex_of`.  Without deg and with
//    C > 64 (every DS1 row without deg, C = 149) no row fits a group, so
//    each warp takes one row, as the standalone kernels do.
//  * A longer row, or one whose first min(deg, C) columns hold a PAD, is
//    done last by the whole warp, 32 slots a step, each field through the
//    same ell_reduce.cuh functions as its standalone kernel: `warp_min`,
//    `warp_sum`, and for "hindex" a (C + 1)-bin histogram per warp in
//    shared memory.  The warp stops once a ballot count of the row's valid
//    slots reaches deg.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace {

constexpr int kMaxFields = 3;
constexpr int kGroup = 8;                   // lanes per short row
constexpr int kRowsPerWarp = 32 / kGroup;   // rows per warp
constexpr int kSlots = 8;                   // register slots per lane

enum Combine : int { kMin = 0, kSum = 1, kHindex = 2 };

struct Fields {
  const void* in[kMaxFields];
  void* out[kMaxFields];
  int code[kMaxFields];
  int bin[kMaxFields];  // which of the warp's histograms an "hindex" uses
  int k;                // fields in use
  int n_hist;           // "hindex" fields
};

// Row u's fields by the whole warp, in the standalone kernels' layout,
// reading its first C columns until `target` valid slots have been seen.
__device__ __forceinline__ void warp_row(const int32_t* __restrict__ r,
                                         const Fields& f, long long u, int C,
                                         int target, int32_t* bins,
                                         int lane) {
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
  int seen = 0;  // warp-uniform
  for (int j0 = 0; j0 < C && seen < target; j0 += 32) {
    const int j = j0 + lane;
    const int32_t v = j < C ? r[j] : -1;  // read once for every field
    seen += __popc(__ballot_sync(ell::kFull, v >= 0));
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
      if (lane == 0) static_cast<int32_t*>(f.out[i])[u] = m;
    } else if (f.code[i] == kSum) {
      const float s = ell::warp_sum(sums[i]);
      if (lane == 0) static_cast<float*>(f.out[i])[u] = s;
    } else {
      const int32_t h = ell::hist_hindex(bins + f.bin[i] * (C + 1), C, lane);
      if (lane == 0) static_cast<int32_t*>(f.out[i])[u] = h;
    }
  }
  __syncwarp();  // the scans are done before the next row clears the bins
}

// Row `row`'s fields from the first S columns of its nbr row `r`, held in
// the registers of this lane's W-lane group (this lane is lane `gl`; a
// group with S = 0 reads nothing).  S <= W * kSlots.  Every slot load, then
// every field's gathers, before any value is used.  "sum" folds as the
// standalone kernel does: with W = 32 lane l holds slots l, l + 32, ..., as
// in ell_pagerank.cu, then `warp_sum`; with W = 8 `vlane_sum`.  Writes the
// outputs when `write`, unless the row's first S < C columns hold a PAD
// and deg is known: then returns false (the row goes on past them) and
// writes nothing.  All 32 lanes call it together; its loops run the
// warp's largest trip counts, so the warp never diverges.
template <int W>
__device__ __forceinline__ bool reg_row(const int32_t* __restrict__ r,
                                        const Fields& f, long long row, int S,
                                        int C, bool has_deg, bool write,
                                        int gl) {
  const int steps = __reduce_max_sync(ell::kFull, (S + W - 1) / W);
  int32_t v[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i >= steps) break;
    const int j = gl + i * W;
    v[i] = j < S ? __ldg(r + j) : -1;
  }
  // every field's gathers (float bits as int32), before any is used
  int32_t x[kMaxFields][kSlots];
#pragma unroll
  for (int q = 0; q < kMaxFields; ++q) {
    if (q >= f.k) break;
    const int32_t* in = static_cast<const int32_t*>(f.in[q]);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i >= steps) break;
      x[q][i] = v[i] >= 0 ? __ldg(in + v[i]) : 0;
    }
  }
  int c = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i >= steps) break;
    c += v[i] >= 0;
  }
  const int n = ell::group_sum<W>(c);
  const bool done = !(has_deg && n < S && S < C);
  write = write && done && gl == 0;
#pragma unroll
  for (int q = 0; q < kMaxFields; ++q) {
    if (q >= f.k) break;
    if (f.code[q] == kMin) {
      int32_t m = ell::kMinFill;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (i >= steps) break;
        if (v[i] >= 0) ell::min_step(m, x[q][i]);
      }
      m = ell::group_min<W>(m);
      if (write) static_cast<int32_t*>(f.out[q])[row] = m;
    } else if (f.code[q] == kSum) {
      float s;
      if constexpr (W == 32) {
        s = 0.0f;  // lane l: slots l, l + 32, ... in order, PAD skipped
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (i >= steps) break;
          if (v[i] >= 0) ell::sum_step(s, __int_as_float(x[q][i]));
        }
        s = ell::warp_sum(s);
      } else {
        static_assert(W == 8, "vlane_sum packs 8 lanes");
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {  // slot gl + 8 i: virtual lane
          if (i >= steps) break;            // gl + 8 (i mod 4); PAD skipped
          if (v[i] >= 0) ell::sum_step(acc[i & 3], __int_as_float(x[q][i]));
        }
        s = ell::vlane_sum(acc);
      }
      if (write) static_cast<float*>(f.out[q])[row] = s;
    } else {
      const int32_t h = ell::reg_hindex_of<W, kSlots>(x[q], steps, n);
      if (write) static_cast<int32_t*>(f.out[q])[row] = h;
    }
  }
  return done;
}

// `packed`: 4 rows a warp, each first in an 8-lane group; else (no deg and
// C > 64, so no row fits a group) one row a warp.
__global__ void ell_multi_kernel(const int32_t* __restrict__ nbr,
                                 const int32_t* __restrict__ deg,
                                 const Fields f, long long n_rows, int ld,
                                 int C, bool packed) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool has_deg = deg != nullptr;
  int32_t* bins = smem + (size_t)warp * f.n_hist * (C + 1);
  if (!packed) {
    const long long u = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (u >= n_rows) return;  // the whole warp leaves
    if (C > 32 * kSlots ||
        !reg_row<32>(nbr + u * (long long)ld, f, u, C, C, false, true, lane))
      warp_row(nbr + u * (long long)ld, f, u, C, C, bins, lane);
    return;
  }
  const int grp = lane / kGroup;
  const int gl = lane % kGroup;
  const long long base =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * kRowsPerWarp;
  const long long row = base + grp;

  // S: the columns read first, min(deg, C); tier: 1 the group's
  // registers, 2 the warp's, 3 the warp's histogram (0: no row)
  int S = C, tier = 0;
  if (row < n_rows) {
    if (has_deg) {
      const int d = __ldg(deg + row);
      S = d < C ? (d > 0 ? d : 0) : C;
    }
    tier = S <= kGroup * kSlots ? 1 : (S <= 32 * kSlots ? 2 : 3);
  }
  if (!reg_row<kGroup>(nbr + row * (long long)ld, f, row, tier == 1 ? S : 0,
                       C, has_deg, tier == 1, gl) && tier == 1)
    tier = 3;

  // the longer rows, one at a time with all 32 lanes: those that fit the
  // warp's registers, then the histogram's
  unsigned todo = __ballot_sync(ell::kFull, gl == 0 && tier == 2);
  unsigned hist = __ballot_sync(ell::kFull, gl == 0 && tier == 3);
  while (todo) {  // warp-uniform
    const int lead = __ffs(todo) - 1;  // the row's lane gl == 0
    todo &= todo - 1;
    const long long u = base + lead / kGroup;
    const int Su = __shfl_sync(ell::kFull, S, lead);
    if (!reg_row<32>(nbr + u * (long long)ld, f, u, Su, C, has_deg, true,
                     lane))
      hist |= 1u << lead;
  }
  while (hist) {  // warp-uniform
    const long long u = base + (__ffs(hist) - 1) / kGroup;
    hist &= hist - 1;
    const int target = has_deg ? __ldg(deg + u) : C;
    warp_row(nbr + u * (long long)ld, f, u, C, target, bins, lane);
  }
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
  ell::WarpShape shape;
  const cudaError_t err =
      ell::warp_shape(ell_multi_kernel, per_warp, &shape);
  if (err != cudaSuccess) return (int)err;
  const bool packed = deg != nullptr || C <= kGroup * kSlots;
  const long long rows = (long long)shape.warps * (packed ? kRowsPerWarp : 1);
  const long long blocks = (n_rows + rows - 1) / rows;
  ell_multi_kernel<<<(unsigned)blocks, shape.warps * 32, shape.smem,
                     (cudaStream_t)stream>>>((const int32_t*)nbr,
                                             (const int32_t*)deg, f, n_rows,
                                             ld, C, packed);
  return (int)cudaGetLastError();
}
