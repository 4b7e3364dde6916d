// ell_pairs.cuh — the row split of the common-neighbour counts, shared by
// ell_triangles.cu ("merge") and ell_allpairs.cu ("allpairs").
//
// Both kernels compute, for nbr and rows (N, ld) int32, any negative id a
// PAD, over the first C columns of both,
//
//     red[u] = sum over valid slots j of |rows[u] ∩ rows[nbr[u, j]]|
//
// counted as a multiset intersection: each valid element y of a
// neighbour's row adds the number of times y occurs in rows[u].  Their
// iteration space is the same: for each row u, its valid neighbours v, and
// their valid field entries y, the (v, y) "pairs" of u.  Only the work per
// pair differs, and an operation type `Op` gives it:
//
//   Own                       its state for one chunk of u's field entries;
//   begin<W>(mem, x, n, narrow)
//                             that state, from the chunk's entries x (8 a
//                             lane, -1 past the row; n valid in the group;
//                             narrow: every group's row holds at most W
//                             own columns, one a lane), with the group's
//                             shared memory `mem` (a table of 2 W kSlots
//                             int2) to keep it in; may rewrite x, which
//                             `count` reads next;
//   count<W, U>(mem, x, own, y)
//                             this lane's count for its U pairs' entries
//                             y (any negative: no pair, or a PAD), summed
//                             over the chunk's entries.
//
// All 32 lanes call both together.
//
// Row lengths: `deg` (N,) int32 is optional, each row's count of valid nbr
// slots.  With it u's nbr row stops after min(deg[u], C) columns.  `fdeg`
// bounds the rows of the field the same way; the wrappers pass deg there
// only when rows and nbr are the same tensor (whole-graph triangles), and
// NULL otherwise (the field is then read over its C columns).  A PAD met
// inside such a bounded prefix (a row that is not left-filled) sends the
// row back to be counted over all C columns of everything, so the result
// never depends on deg.
//
// The split keeps the rows with many pairs from queueing behind one
// another.  DS1's hubs hold neighbouring ids (rows 12512 to 12582 hold up
// to 1,499 triples each, against 12 for the median row), so a layout that
// gives each warp a run of consecutive rows leaves a few warps with most of
// the work.  Two passes, launched back to back:
//
//  * Pass 1 gives a row of up to 64 columns a group of 8 lanes (4 rows a
//    warp).  The group loads u's first 64 columns beside deg[u] (one load
//    serves nbr and the field when they are the same tensor), holds its
//    field entries 8 a lane in registers (`Op::begin`), and compacts u's
//    valid neighbours v into a shared list with each one's row length
//    (min(deg[v], C) under fdeg, else C) and its offset among the
//    flattened (v, column) pairs.  A row of at most 128 pairs deals them
//    out to its lanes, 4 a lane per step: U lockstep binary searches of
//    the offsets, every load before any use (`Op::count`).  Counts are
//    summed over the group in integers: exact and deterministic.  Every
//    other row is left to pass 2 with a code in out.
//  * Pass 2 gives each such row a team of 8 warps (a block), 4 pairs a
//    lane per step.  The team's warps split the row's neighbour slots; each
//    keeps u's entries in its own 6 KB, and the team sums their counts in
//    shared memory.  Team t of the grid's NT takes rows t, t + NT, ..., so
//    neighbouring hubs go to different teams.  Cd is unbounded: a warp
//    takes u's row 256 columns at a time (the counts add up) and its
//    neighbours 256 at a time.  Without deg every row is pass 2's, one warp
//    a row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_reduce.cuh"

namespace pairs {

constexpr int kGroup = 8;                   // lanes per short row
constexpr int kRowsPerWarp = 32 / kGroup;   // rows per warp
constexpr int kSlots = 8;                   // register slots per lane
constexpr int kLightUnroll = 4;             // pairs a lane loads per step,
constexpr int kHeavyUnroll = 4;             //   in pass 1 and in pass 2
constexpr int kLightPairs = 128;            // pass 1's most pairs per row
constexpr int32_t kHeavy = -1;              // pass 1's codes for pass 2
constexpr int32_t kBack = -2;
constexpr int kScan = 32;                   // rows a pass-2 team scans
constexpr int kTeam = 8;                    // warps a pass-2 row gets
// a W-lane group's shared memory: a table of 2 * W * kSlots (id, count)
// pairs and a list of W * kSlots (neighbour, offset) pairs; the same
// 6 KB per warp whether W = 8 or 32
__host__ __device__ constexpr int group_int2s(int W) {
  return W * kSlots * 3;  // 2 W kSlots int2 of table, then the list
}
constexpr int kWarpInt2s = group_int2s(32);
constexpr size_t kWarpBytes = kWarpInt2s * sizeof(int2);
static_assert(kRowsPerWarp * group_int2s(kGroup) == kWarpInt2s, "layout");

// every warp's tables and lists; indexed from this symbol, not through a
// pointer argument, so the compiler emits shared-memory loads and atomics
extern __shared__ __align__(16) int2 pairs_smem[];

// This lane's part of red[u] for every W-lane group of the warp at once
// (this lane is lane `gl` of its group, whose shared memory starts at
// pairs_smem[mem]): u's nbr row over its first Sn columns (only the slots
// j with j % split == part: a team of `split` warps shares a row), u's
// field row over its first Sf, each neighbour's field row over
// min(fdeg[v], C) columns, or C when fdeg is NULL.  A group with Sn = 0
// reads nothing and gets 0.  Each lane takes U pairs a step.  All 32 lanes
// call it together; its loops run the warp's largest trip counts.  Sets
// *bad when a bounded prefix shorter than C holds a PAD, and *heavy
// (counting nothing) when the group's row has more than `max_pairs`
// (neighbour, column) pairs.  With kPre (one chunk of each, Sn, Sf <= W *
// kSlots) the row's slots are already loaded: px[i], pv[i] hold its field
// and nbr columns gl + i * W (any value past C).
template <int W, int U, class Op, bool kPre = false>
__device__ __forceinline__ int row_common(
    const Op& op, const int32_t* __restrict__ nbr,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ fdeg,
    long long u, int Sn, int Sf, int C, int ld, int gl, int mem, int part,
    int split, int max_pairs, bool* bad, bool* heavy,
    const int32_t* px = nullptr, const int32_t* pv = nullptr) {
  constexpr int kChunk = W * kSlots;
  int2* table = pairs_smem + mem;
  int32_t* lv = reinterpret_cast<int32_t*>(table + 2 * kChunk);
  int32_t* loff = lv + kChunk;
  if (Sn == 0) Sf = 0;  // no neighbour: nothing to count
  const int32_t* ru = nbr + u * (long long)ld;
  const int32_t* fu = rows + u * (long long)ld;
  int cnt = 0;
  bool b = false, h = false;
  const int own_chunks =
      __reduce_max_sync(ell::kFull, (Sf + kChunk - 1) / kChunk);
  const int nbr_chunks =
      __reduce_max_sync(ell::kFull, (Sn + kChunk - 1) / kChunk);
  const bool narrow = __all_sync(ell::kFull, Sf <= W);
  for (int oc = 0; oc < own_chunks; ++oc) {
    // u's field entries [o0, o0 + kChunk)
    const int o0 = oc * kChunk;
    int32_t x[kSlots];
    int c = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int j = o0 + gl + i * W;
      if constexpr (kPre) x[i] = j < Sf ? px[i] : -1;
      else x[i] = j < Sf ? __ldg(fu + j) : -1;
      c += x[i] >= 0;
      if (j < Sf && x[i] < 0 && Sf < C) b = true;  // a PAD inside
    }
    const int n = ell::group_sum<W>(c);
    const typename Op::Own own = op.template begin<W>(table, x, n, narrow);
    for (int nc = 0; nc < nbr_chunks; ++nc) {
      // u's valid neighbours in [n0, n0 + kChunk), compacted with their
      // row lengths' offsets (none when u has no own entry here)
      const int n0 = nc * kChunk;
      int32_t v[kSlots];
      int len[kSlots];
      int cv = 0, lsum = 0;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int j = n0 + gl + i * W;
        const bool mine = n > 0 && j < Sn && j % split == part;
        if constexpr (kPre) v[i] = mine ? pv[i] : -1;
        else v[i] = mine ? __ldg(ru + j) : -1;
        if (mine && v[i] < 0 && Sn < C) b = true;  // a PAD inside
      }
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        len[i] = 0;
        if (v[i] >= 0) {
          int d = C;
          if (fdeg != nullptr) {
            d = __ldg(fdeg + v[i]);
            d = d < C ? (d > 0 ? d : 0) : C;
          }
          len[i] = d;
          ++cv;
          lsum += d;
        }
      }
      const int nv = ell::group_sum<W>(cv);
      int pc = cv, pl = lsum;  // inclusive scans over the group's lanes
#pragma unroll
      for (int off = 1; off < W; off <<= 1) {
        const int tc = __shfl_up_sync(ell::kFull, pc, off, W);
        const int tl = __shfl_up_sync(ell::kFull, pl, off, W);
        if (gl >= off) {
          pc += tc;
          pl += tl;
        }
      }
      int P = __shfl_sync(ell::kFull, pl, W - 1, W);  // pairs in all
      if (P > max_pairs) {  // left to the warp pass
        h = true;
        P = 0;
      }
      int pos = pc - cv, o = pl - lsum;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (v[i] >= 0) {
          lv[pos] = v[i];
          loff[pos] = o;
          ++pos;
          o += len[i];
        }
      }
      __syncwarp();
      const int trips =
          __reduce_max_sync(ell::kFull, (P + W * U - 1) / (W * U));
      for (int t = 0; t < trips; ++t) {
        // the entry of each of this lane's U pairs: the last offset <= p,
        // U searches in lockstep (nv steps' worth for every pair alike)
        int p[U], e[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          p[k] = (t * U + k) * W + gl;
          e[k] = 0;
        }
        for (int m = nv; m > 1;) {
          const int half = m >> 1;
#pragma unroll
          for (int k = 0; k < U; ++k)
            e[k] = loff[e[k] + half] <= p[k] ? e[k] + half : e[k];
          m -= half;
        }
        int32_t y[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          y[k] = -1;
          if (p[k] < P) {
            const int start = loff[e[k]];
            const int room = (e[k] + 1 < nv ? loff[e[k] + 1] : P) - start;
            y[k] = __ldg(rows + (long long)lv[e[k]] * ld + (p[k] - start));
            if (y[k] < 0 && room < C) b = true;  // a PAD inside
          }
        }
        cnt += op.template count<W, U>(table, x, own, y);
      }
      __syncwarp();  // the list is read before the next chunk writes it
    }
    __syncwarp();  // u's entries are read before the next chunk's
  }
  *bad = b;
  *heavy = h;
  return cnt;
}

// (Sn, Sf) of row u: its nbr and field columns read first
__device__ __forceinline__ void row_extent(const int32_t* __restrict__ deg,
                                           const int32_t* __restrict__ fdeg,
                                           long long u, int C, int* Sn,
                                           int* Sf) {
  *Sn = *Sf = C;
  if (deg != nullptr) {
    const int d = __ldg(deg + u);
    *Sn = d < C ? (d > 0 ? d : 0) : C;
    if (fdeg != nullptr) *Sf = *Sn;
  }
}

// Pass 1: rows of up to 64 columns with at most kLightPairs pairs, 8 lanes
// each.  Every other row gets a code for pass 2 in out: kHeavy, or kBack
// for a row sent back (counted over all C columns of everything).
template <class Op>
__global__ void pairs_light(const int32_t* __restrict__ nbr,
                            const int32_t* __restrict__ rows,
                            const int32_t* __restrict__ deg,
                            const int32_t* __restrict__ fdeg,
                            int32_t* __restrict__ out, long long n_rows,
                            int ld, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kGroup;
  const int gl = lane % kGroup;
  const long long row =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * kRowsPerWarp + grp;
  const int mem = warp * kWarpInt2s + grp * group_int2s(kGroup);
  const bool live = row < n_rows;
  // the row's first 64 columns, loaded beside deg rather than after it
  // (for the whole-graph field, fdeg set, one load serves both)
  int32_t px[kSlots], pv[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = gl + i * kGroup;
    const bool in = live && j < C;
    px[i] = in ? __ldg(rows + row * (long long)ld + j) : -1;
    pv[i] = fdeg != nullptr ? px[i]
                            : (in ? __ldg(nbr + row * (long long)ld + j) : -1);
  }
  int Sn = 0, Sf = 0;
  bool light = false;
  if (live) {
    row_extent(deg, fdeg, row, C, &Sn, &Sf);
    light = Sn <= kGroup * kSlots && Sf <= kGroup * kSlots;
  }
  bool bad, heavy;
  int cnt = row_common<kGroup, kLightUnroll, Op, true>(
      Op{}, nbr, rows, fdeg, row, light ? Sn : 0, light ? Sf : 0, C, ld, gl,
      mem, 0, 1, kLightPairs, &bad, &heavy, px, pv);
  cnt = ell::group_sum<kGroup>(cnt);
  bad = ell::group_sum<kGroup>(bad) > 0;
  heavy = ell::group_sum<kGroup>(heavy) > 0;
  if (live && gl == 0)
    out[row] = bad ? kBack : (!light || heavy ? kHeavy : cnt);
}

// Pass 2: the rows pass 1 left (every row when `all_heavy`), a team of
// kTeam warps a row: its warps split the row's neighbour slots, each keeps
// u's entries, and the team sums their counts in shared memory.  Team t of
// the grid's NT takes rows t, t + NT, t + 2 NT, ..., so rows of
// neighbouring ids (a hub's neighbourhood) go to different teams.  A team
// of more than one warp is a whole block (its __syncthreads are the
// team's).  With one warp a row (every row, without deg) warp w of block
// b is team w * B + b of the grid's B blocks: neighbouring rows run at
// the same time on different blocks, so a run of hubs does not queue on
// one block's warps.
template <class Op, int kTeam>
__global__ void pairs_heavy(const int32_t* __restrict__ nbr,
                            const int32_t* __restrict__ rows,
                            const int32_t* __restrict__ deg,
                            const int32_t* __restrict__ fdeg,
                            int32_t* __restrict__ out, long long n_rows,
                            int ld, int C, bool all_heavy) {
  __shared__ unsigned masks[kTeam];    // the team's rows left, per warp
  __shared__ int32_t codes[kTeam * 32];
  __shared__ int parts[kTeam];         // the warps' counts of one row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wi = warp % kTeam;         // this warp's part of the team's row
  const int teams = (blockDim.x >> 5) / kTeam;
  const long long nt = (long long)gridDim.x * teams;
  const long long t = kTeam == 1
                          ? (long long)warp * gridDim.x + blockIdx.x
                          : (long long)blockIdx.x * teams + warp / kTeam;
  const int mem = warp * kWarpInt2s;
  const int tl = wi * 32 + lane;       // this thread within its team
  for (long long k0 = 0; t + k0 * nt < n_rows; k0 += kTeam * 32) {
    const long long mine = t + (k0 + tl) * nt;  // team-uniform loop
    int code = 0;
    if (mine < n_rows) code = all_heavy ? kHeavy : out[mine];
    const unsigned todo = __ballot_sync(ell::kFull, code < 0);
    if constexpr (kTeam > 1) {
      if (lane == 0) masks[wi] = todo;
      codes[tl] = code;
      __syncthreads();
    }
    for (int q = 0; q < kTeam; ++q) {
      unsigned m = kTeam > 1 ? masks[q] : todo;
      while (m) {  // team-uniform
        const int l = __ffs(m) - 1;
        m &= m - 1;
        const int idx = q * 32 + l;
        const long long u = t + (k0 + idx) * nt;
        const int cu =
            kTeam > 1 ? codes[idx] : __shfl_sync(ell::kFull, code, l);
        bool full = cu == kBack;
        int Sn, Sf, c;
        row_extent(deg, fdeg, u, C, &Sn, &Sf);
        for (;;) {
          bool b, unused;
          c = row_common<32, kHeavyUnroll, Op>(
              Op{}, nbr, rows, full ? nullptr : fdeg, u, full ? C : Sn,
              full ? C : Sf, C, ld, lane, mem, wi, kTeam, INT32_MAX, &b,
              &unused);
          bool any = __any_sync(ell::kFull, b);
          if constexpr (kTeam > 1) any = __syncthreads_or(any);
          if (full || !any) break;
          full = true;
        }
        c = __reduce_add_sync(ell::kFull, c);
        if constexpr (kTeam > 1) {
          if (lane == 0) parts[wi] = c;
          __syncthreads();
          if (tl == 0) {
            int sum = 0;
            for (int i = 0; i < kTeam; ++i) sum += parts[i];
            out[u] = sum;
          }
          __syncthreads();  // parts are read before the next row's writes
        } else if (lane == 0) {
          out[u] = c;
        }
      }
    }
    if constexpr (kTeam > 1) __syncthreads();  // before the next round
  }
}

// Launches the two passes with the per-pair operation Op.  nbr, rows:
// (n_rows, ld) int32, row-major and contiguous (the same tensor for
// whole-graph use); deg: (n_rows,) int32 valid nbr slots per row, or NULL;
// fdeg: deg when rows is nbr, else NULL; out: (n_rows,) int32.  Reads
// columns [0, C) of each row of both, C <= ld.  Returns the launches'
// cudaError_t.
template <class Op>
inline cudaError_t launch(const void* nbr, const void* rows, const void* deg,
                          const void* fdeg, void* out, long long n_rows,
                          int ld, int C, cudaStream_t st) {
  if (n_rows <= 0) return cudaSuccess;
  if (C < 0 || C > ld) return cudaErrorInvalidValue;
  const int32_t* nb = (const int32_t*)nbr;
  const int32_t* rw = (const int32_t*)rows;
  const int32_t* dg = (const int32_t*)deg;
  const int32_t* fd = deg != nullptr ? (const int32_t*)fdeg : nullptr;
  ell::WarpShape shape;
  // without deg every neighbour's row is read over its C columns: every
  // row goes to pass 2, one warp a row
  const bool all_heavy = deg == nullptr;
  if (!all_heavy) {
    cudaError_t err = ell::warp_shape(pairs_light<Op>, kWarpBytes, &shape);
    if (err != cudaSuccess) return err;
    const long long per_block = (long long)shape.warps * kRowsPerWarp;
    const long long blocks = (n_rows + per_block - 1) / per_block;
    pairs_light<Op><<<(unsigned)blocks, shape.warps * 32, shape.smem, st>>>(
        nb, rw, dg, fd, (int32_t*)out, n_rows, ld, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // every row without deg: a warp each; else a team of 8 warps (a block)
  // for each row pass 1 left, 32 rows scanned by each team
  auto heavy = all_heavy ? pairs_heavy<Op, 1> : pairs_heavy<Op, kTeam>;
  cudaError_t err = ell::warp_shape(heavy, kWarpBytes, &shape);
  // the team's static shared memory comes on top of the 48 KB
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        heavy, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shape.smem);
  if (err != cudaSuccess) return err;
  if (!all_heavy && shape.warps != kTeam) return cudaErrorInvalidValue;
  const long long teams = all_heavy ? shape.warps : shape.warps / kTeam;
  const long long per_block = teams * (all_heavy ? 1 : kScan);
  const long long blocks = (n_rows + per_block - 1) / per_block;
  heavy<<<(unsigned)blocks, shape.warps * 32, shape.smem, st>>>(
      nb, rw, dg, fd, (int32_t*)out, n_rows, ld, C, all_heavy);
  return cudaGetLastError();
}

}  // namespace pairs
