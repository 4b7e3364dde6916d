// ell_hindex.cu — h-index of neighbour estimates over an ELL adjacency.
//
// Replaces the TPU kernel `hindex_ell` of src/repro/kernels/ell_hindex.py
// (Pallas body `_ell_hindex_sort_kernel`, which sorts each row tile).
// It computes, for every row u of nbr (N, ld) int32 with -1 = PAD,
//
//     h[u] = max{k : at least k of {est[nbr[u, j]] : j < C, nbr[u, j] >= 0}
//                    are >= k}
//
// reading only the first C columns (C = min(Cd, K)) and skipping PAD
// wherever it sits, so the result is exact for any slot order when C = Cd.
// `deg` (N,) int32 is optional: each row's count of valid slots, as a
// GraphBlocks keeps it.  With it a row stops once it has seen
// min(deg[u], valid slots of its first C columns) valid slots — on a
// left-filled row it reads exactly nbr[u, :min(deg[u], C)] — and the
// result is the same.  Without it every row reads its C columns.
//
// What bounds it on the card: at the main path's shapes, latency.  With
// deg a launch needs the valid slots (3.3 a row on average at DS1, 0.7 MB
// in all), deg, est and the output: well under a microsecond of HBM time.
// What is left is the launch and each row's chain of dependent loads (deg,
// then its slots, then the est gathers).  The design keeps that chain
// short:
//
//  * kGroup = 8 lanes per row, 4 rows per warp, kSlots = 8 slots a lane
//    in registers: rows of up to 64 columns (all but 9 of DS1's 50,048
//    with deg) are read into the group's registers.  All slot loads are
//    issued, then all est gathers, before any is consumed, so a row costs
//    about one load and one gather of latency.  h is then found by
//    bisection over [0, n], n the row's valid slots: each probe counts the
//    lane's values >= k and sums over the group with shuffles —
//    ceil(log2(n + 1)) probes, no shared memory, no atomics
//    (`ell::reg_hindex_of`, which ell_multi.cu calls too).  The loops
//    run the warp's largest trip counts, so a warp never diverges.
//  * Rows of 65 to 32 * kSlots = 256 columns (every row of DS1 without
//    deg, Cd = 149) are done the same way by the whole warp, one row after
//    another, after its short rows.  That second pass is what sets the
//    group width: a warp's long rows add to its chain, and narrower groups
//    put more rows, so more long rows, in one warp.
//  * A longer row, or one whose first min(deg, C) columns hold a PAD (a
//    row that is not left-filled), is done last by the whole warp with the
//    shared-memory histogram of ell_reduce.cuh: 32 slots a step, stopping
//    once a ballot count of its valid slots reaches deg.
//
// Integers only, so every path gives the same, deterministic h.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace {

constexpr int kGroup = 8;                   // lanes per short row
constexpr int kRowsPerWarp = 32 / kGroup;   // rows per warp
constexpr int kSlots = 8;                   // register slots per lane

// h-index of the first S columns of row r, for every W-lane group of the
// warp at once (this lane is lane `gl` of its group; a group with S = 0
// reads nothing and gets 0).  Each lane holds slots j = gl + i * W, i <
// kSlots, in registers: every slot load, then every est gather, then the
// bisection.  S <= W * kSlots.  All 32 lanes call it together, and its
// loops run the warp's largest trip counts, so the warp never diverges
// (groups of one warp that diverge run one after another).  Sets *n to
// the valid slots the group saw.
template <int W>
__device__ __forceinline__ int32_t reg_hindex(const int32_t* __restrict__ r,
                                              const int32_t* __restrict__ est,
                                              int S, int gl, int* n) {
  const int steps = __reduce_max_sync(ell::kFull, (S + W - 1) / W);
  int32_t v[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i >= steps) break;
    const int j = gl + i * W;
    v[i] = j < S ? __ldg(r + j) : -1;
  }
  int c = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {  // PAD counts for no k >= 1
    if (i >= steps) break;
    c += v[i] >= 0;
    v[i] = v[i] >= 0 ? __ldg(est + v[i]) : 0;
  }
  *n = ell::group_sum<W>(c);
  return ell::reg_hindex_of<W, kSlots>(v, steps, *n);
}

__global__ void ell_hindex_kernel(const int32_t* __restrict__ nbr,
                                  const int32_t* __restrict__ est,
                                  const int32_t* __restrict__ deg,
                                  int32_t* __restrict__ out,
                                  long long n_rows, int ld, int C) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kGroup;
  const int gl = lane % kGroup;
  const long long base =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * kRowsPerWarp;
  const long long row = base + grp;

  // S: the columns read first, min(deg, C); tier: 1 the group's
  // registers, 2 the warp's, 3 the warp's histogram (0: no row)
  int S = C, tier = 0;
  if (row < n_rows) {
    if (deg != nullptr) {
      const int d = __ldg(deg + row);
      S = d < C ? (d > 0 ? d : 0) : C;
    }
    tier = S <= kGroup * kSlots ? 1 : (S <= 32 * kSlots ? 2 : 3);
  }
  int n;
  const int32_t h = reg_hindex<kGroup>(nbr + row * (long long)ld, est,
                                       tier == 1 ? S : 0, gl, &n);
  if (tier == 1) {
    // a PAD among the first S < C columns: the row's valid slots go on
    // past them
    if (deg != nullptr && n < S && S < C) tier = 3;
    else if (gl == 0) out[row] = h;
  }

  // the longer rows, one at a time with all 32 lanes: those that fit the
  // warp's registers, then the histogram's
  unsigned todo = __ballot_sync(ell::kFull, gl == 0 && tier == 2);
  unsigned hist = __ballot_sync(ell::kFull, gl == 0 && tier == 3);
  while (todo) {
    const int lead = __ffs(todo) - 1;  // the row's lane gl == 0
    todo &= todo - 1;
    const long long u = base + lead / kGroup;
    const int Su = __shfl_sync(ell::kFull, S, lead);
    const int32_t hu = reg_hindex<32>(nbr + u * (long long)ld, est, Su,
                                      lane, &n);
    if (deg != nullptr && n < Su && Su < C) hist |= 1u << lead;
    else if (lane == 0) out[u] = hu;
  }
  if (hist == 0) return;  // warp-uniform
  int32_t* bins = smem + (size_t)warp * (C + 1);
  while (hist) {
    const long long u = base + (__ffs(hist) - 1) / kGroup;
    hist &= hist - 1;
    const int target = deg != nullptr ? __ldg(deg + u) : C;
    const int32_t* r = nbr + u * (long long)ld;
    ell::hist_clear(bins, C, lane);
    __syncwarp();
    int seen = 0;
    for (int j0 = 0; j0 < C && seen < target; j0 += 32) {
      const int j = j0 + lane;
      const int32_t x = j < C ? r[j] : -1;
      if (x >= 0) ell::hist_add(bins, C, __ldg(est + x));
      seen += __popc(__ballot_sync(ell::kFull, x >= 0));
    }
    __syncwarp();
    const int32_t hu = ell::hist_hindex(bins, C, lane);
    if (lane == 0) out[u] = hu;
    __syncwarp();  // the scan is done before the next row clears the bins
  }
}

}  // namespace

// nbr: (n_rows, ld) int32; est: (n_rows,) int32 (any values; nbr ids index
// it); deg: (n_rows,) int32 valid slots per row, or NULL; out: (n_rows,)
// int32.  Reads columns [0, C) of each row, C <= ld.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ell_hindex_launch(const void* nbr, const void* est,
                                 const void* deg, void* out, long long n_rows,
                                 int ld, int C, void* stream) {
  if (n_rows <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)(C + 1) * sizeof(int32_t);
  ell::WarpShape shape;
  const cudaError_t err =
      ell::warp_shape(ell_hindex_kernel, per_warp, &shape);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)shape.warps * kRowsPerWarp;
  const long long blocks = (n_rows + rows - 1) / rows;
  ell_hindex_kernel<<<(unsigned)blocks, shape.warps * 32, shape.smem,
                      (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const int32_t*)est, (const int32_t*)deg,
      (int32_t*)out, n_rows, ld, C);
  return (int)cudaGetLastError();
}
