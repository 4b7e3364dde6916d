// ell_rows.cuh — the row tiers of the ELL combines, shared by ell_cc.cu,
// ell_pagerank.cu, ell_multi.cu and ell_hindex_count.cu.
//
// Each of those kernels reduces, for every row u of nbr (N, ld) int32 with
// -1 = PAD, the neighbour values field[nbr[u, j]] over the valid slots of
// the row's first C columns.  `deg` (N,) int32 is optional: each row's
// count of valid slots, as a GraphBlocks keeps it.  With it a row stops
// once it has seen min(deg[u], valid slots of its first C columns) valid
// slots (on a left-filled row, exactly nbr[u, :min(deg[u], C)]), and a PAD
// found before that sends the row on to C, so the result is the same for
// any slot order.  Without it every row reads its C columns.
//
// What bounds them on the card at the analytics shapes: latency.  With deg
// a launch needs the valid slots (3.3 a row on average at DS1), deg, the
// field values and the output, well under a microsecond of HBM time.  What
// is left is the launch and each row's chain of dependent loads (deg, its
// slots, the field gathers).  The tiers keep that chain short; they are
// ell_hindex.cu's, with the reduction left to an operation type `Op`:
//
//  1. 8 lanes a row, 4 rows a warp, 8 slots a lane in registers: rows of
//     up to 64 columns (with deg, all but 9 of DS1's rows).  Every slot
//     load is issued, then every gather (`Op::gather`), before any value
//     is used (`Op::reduce`).
//  2. Rows of 65 to 32 * 8 = 256 columns, by the whole warp's registers,
//     one after another, after its short rows, in the warp layout: lane l
//     on slots l, l + 32, ...
//  3. A longer row, or one whose first min(deg, C) columns hold a PAD, is
//     done last by the whole warp, 32 slots a step, in the same warp
//     layout (`Op::warp_add`), stopping once a ballot count of the row's
//     valid slots reaches deg.
//
// Without deg and with C > 64 (every DS1 row without deg, C = 149) no row
// fits a group: each warp takes one row through tier 3 alone, in a kernel
// instance of its own.
//
// The loops run the warp's largest trip counts, so a warp never diverges
// (groups of one warp that diverge run one after another).  An `Op` gives:
//
//   Vals   a lane's gathered values, one per register slot;
//   Acc    a lane's accumulator in tier 3;
//   gather(v, steps, x)            the field at this lane's slots v;
//   reduce<W>(v, x, steps, n, row, write)
//                                  the row's result over its W-lane
//                                  group, written to row when `write`
//                                  (n: the group's valid slots);
//   warp_begin(a, C, lane), warp_add(a, v, C), warp_end(a, u, C, lane)
//                                  tier 3, in the warp layout: warp_add
//                                  by the lanes whose slot v is valid,
//                                  or, where the Op sets `kWarpWide`, by
//                                  all 32 lanes together (v < 0 for a PAD
//                                  or past C), so it may shuffle.
//
// All 32 lanes call each of them together, warp_add as just said.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ell_reduce.cuh"

namespace ell {

constexpr int kGroup = 8;                   // lanes per short row
constexpr int kRowsPerWarp = 32 / kGroup;   // rows per warp
constexpr int kSlots = 8;                   // register slots per lane

// Loads the first S columns of row r into this lane's registers: lane gl
// of a W-lane group holds slots j = gl + i * W, i < kSlots, and -1 past S.
// S <= W * kSlots.  Returns the warp's largest trip count.
template <int W>
__device__ __forceinline__ int load_slots(const int32_t* __restrict__ r,
                                          int S, int gl,
                                          int32_t (&v)[kSlots]) {
  const int steps = __reduce_max_sync(kFull, (S + W - 1) / W);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i >= steps) break;
    const int j = gl + i * W;
    v[i] = j < S ? __ldg(r + j) : -1;
  }
  return steps;
}

// The values of a 4-byte field (int32, or float bits) at this lane's
// slots v, 0 for a PAD: every gather is issued before any value is used.
__device__ __forceinline__ void gather_slots(const int32_t* __restrict__ in,
                                             const int32_t (&v)[kSlots],
                                             int steps,
                                             int32_t (&x)[kSlots]) {
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i >= steps) break;
    x[i] = v[i] >= 0 ? __ldg(in + v[i]) : 0;
  }
}

// "min" of a row held in its W-lane group's registers (v: the slots, x:
// the gathered values); PAD slots are skipped.
template <int W>
__device__ __forceinline__ int32_t reg_min(const int32_t (&v)[kSlots],
                                           const int32_t (&x)[kSlots],
                                           int steps) {
  int32_t m = kMinFill;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i >= steps) break;
    if (v[i] >= 0) min_step(m, x[i]);
  }
  return group_min<W>(m);
}

// "sum" of a row held in its W-lane group's registers (x: float bits), in
// the warp layout's order, PAD skipped: with W = 32 lane l holds slots l,
// l + 32, ... and adds them in order, then `warp_sum`; with W = 8 slot
// gl + 8 i folds into the accumulator of its virtual lane gl + 8 (i mod 4),
// then `vlane_sum`.  The same bits either way.
template <int W>
__device__ __forceinline__ float reg_sum(const int32_t (&v)[kSlots],
                                         const int32_t (&x)[kSlots],
                                         int steps) {
  if constexpr (W == 32) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i >= steps) break;
      if (v[i] >= 0) sum_step(s, __int_as_float(x[i]));
    }
    return warp_sum(s);
  } else {
    static_assert(W == 8, "vlane_sum packs 8 lanes");
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i >= steps) break;
      if (v[i] >= 0) sum_step(acc[i & 3], __int_as_float(x[i]));
    }
    return vlane_sum(acc);
  }
}

// Tiers 1 and 2: row `row` from the first S columns of its nbr row `r`,
// held in the registers of this lane's W-lane group (this lane is lane
// `gl`; a group with S = 0 reads nothing).  Writes the result when
// `write`, unless the row's first S < C columns hold a PAD and deg is
// known: then returns false (the row goes on past them) and writes
// nothing.
template <int W, class Op>
__device__ __forceinline__ bool reg_row(const Op& op,
                                        const int32_t* __restrict__ r,
                                        long long row, int S, int C,
                                        bool has_deg, bool write, int gl) {
  int32_t v[kSlots];
  const int steps = load_slots<W>(r, S, gl, v);
  typename Op::Vals x;
  op.gather(v, steps, x);  // every gather, before any value is used
  int c = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i >= steps) break;
    c += v[i] >= 0;
  }
  const int n = group_sum<W>(c);
  const bool done = !(has_deg && n < S && S < C);
  op.template reduce<W>(v, x, steps, n, row, write && done && gl == 0);
  return done;
}

// True when Op::warp_add takes all 32 lanes' slots together (an Op that
// sets `static constexpr bool kWarpWide = true`).
template <class Op, class = void>
struct warp_wide : std::false_type {};
template <class Op>
struct warp_wide<Op, std::void_t<decltype(Op::kWarpWide)>>
    : std::bool_constant<Op::kWarpWide> {};

// Tier 3: row u by the whole warp, 32 slots a step, reading its first C
// columns; with `kStop`, only until `target` valid slots have been seen.
// The stop makes each step wait for the ballot of the last one's slots, so
// a row read to its end (no deg) goes without it: its steps' loads are
// independent.
template <bool kStop, class Op>
__device__ __forceinline__ void warp_row(const Op& op,
                                         const int32_t* __restrict__ r,
                                         long long u, int C, int target,
                                         int lane) {
  typename Op::Acc a;
  op.warp_begin(a, C, lane);
  __syncwarp();
  [[maybe_unused]] int seen = 0;  // warp-uniform
  for (int j0 = 0; j0 < C; j0 += 32) {
    if constexpr (kStop) {
      if (seen >= target) break;
    }
    const int j = j0 + lane;
    const int32_t v = j < C ? r[j] : -1;
    if constexpr (kStop) seen += __popc(__ballot_sync(kFull, v >= 0));
    if constexpr (warp_wide<Op>::value) op.warp_add(a, v, C);
    else if (v >= 0) op.warp_add(a, v, C);
  }
  __syncwarp();
  op.warp_end(a, u, C, lane);
  __syncwarp();  // the row is done before the next one starts
}

// True when the rows go 4 a warp (tier 1 first): with deg, or when no row
// is longer than a group's registers.  Else one row a warp, tier 3 only.
inline bool packs(const void* deg, int C) {
  return deg != nullptr || C <= kGroup * kSlots;
}

// The body of a combine kernel: this warp's rows through the tiers, 4 a
// warp when `kPacked` (as `packs` gives it), else one a warp, through the
// warp loop alone.  Two instances, so the loop's instance keeps the
// registers of the loop (a thread's registers bound the warps an SM
// holds, and one row a warp is a wait on its loads).
template <bool kPacked, class Op>
__device__ __forceinline__ void combine_rows(const Op& op,
                                             const int32_t* __restrict__ nbr,
                                             const int32_t* __restrict__ deg,
                                             long long n_rows, int ld,
                                             int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if constexpr (!kPacked) {
    const long long u = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (u >= n_rows) return;  // the whole warp leaves
    warp_row<false>(op, nbr + u * (long long)ld, u, C, C, lane);
    return;
  }
  const bool has_deg = deg != nullptr;
  const int grp = lane / kGroup;
  const int gl = lane % kGroup;
  const long long base =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * kRowsPerWarp;
  const long long row = base + grp;

  // S: the columns read first, min(deg, C); tier: 1 the group's
  // registers, 2 the warp's, 3 the warp's loop (0: no row)
  int S = C, tier = 0;
  if (row < n_rows) {
    if (has_deg) {
      const int d = __ldg(deg + row);
      S = d < C ? (d > 0 ? d : 0) : C;
    }
    tier = S <= kGroup * kSlots ? 1 : (S <= 32 * kSlots ? 2 : 3);
  }
  if (!reg_row<kGroup>(op, nbr + row * (long long)ld, row,
                       tier == 1 ? S : 0, C, has_deg, tier == 1, gl) &&
      tier == 1)
    tier = 3;

  // the longer rows, one at a time with all 32 lanes: those that fit the
  // warp's registers, then the loop's
  unsigned todo = __ballot_sync(kFull, gl == 0 && tier == 2);
  unsigned loop = __ballot_sync(kFull, gl == 0 && tier == 3);
  while (todo) {  // warp-uniform
    const int lead = __ffs(todo) - 1;  // the row's lane gl == 0
    todo &= todo - 1;
    const long long u = base + lead / kGroup;
    const int Su = __shfl_sync(kFull, S, lead);
    if (!reg_row<32>(op, nbr + u * (long long)ld, u, Su, C, has_deg, true,
                     lane))
      loop |= 1u << lead;
  }
  while (loop) {  // warp-uniform
    const long long u = base + (__ffs(loop) - 1) / kGroup;
    loop &= loop - 1;
    const int target = has_deg ? __ldg(deg + u) : C;
    warp_row<true>(op, nbr + u * (long long)ld, u, C, target, lane);
  }
}

// Launches `kernel`, whose warps run `combine_rows<packed>`, over n_rows
// rows, each warp with `per_warp` bytes of dynamic shared memory; `args`
// are the kernel's arguments.  Returns the launch's cudaError_t.
template <typename... P, typename... A>
inline cudaError_t launch_rows(void (*kernel)(P...), size_t per_warp,
                               bool packed, long long n_rows,
                               cudaStream_t stream, A... args) {
  WarpShape shape;
  const cudaError_t err = warp_shape(kernel, per_warp, &shape);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)shape.warps * (packed ? kRowsPerWarp : 1);
  const long long blocks = (n_rows + rows - 1) / rows;
  kernel<<<(unsigned)blocks, shape.warps * 32, shape.smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace ell
