// mirror_hindex.cu — the h-index merge of a hub-split graph's replica
// groups: every group's h-index over its whole logical neighbourhood,
// written to every row of the group.
//
// Replaces no TPU kernel: the JAX package merges a mirrored run's partials
// in jnp outside its kernels (`_mirror_merge` in src/repro/kernels/ops.py,
// an (Rp, Cd, Km) comparison cube).  The port's plain version,
// `hindex_mirror_plain` in kernels/mirror_hindex.py, counts every group's
// values into its own segment of top + 1 bins of one flat histogram.  For
// group g, with rows grp_rows[offsets[g] .. offsets[g + 1]) and logical
// degree top = ldeg[its first row] (every row of a group carries it),
//
//     h[g] = max{t in [0, top] : #{v in V_g : v >= t} >= t},
//     V_g  = {field[nbr[r, j]] : r a row of g, j < deg[r], nbr[r, j] >= 0}.
//
// A row is read up to its length deg[r], which on a GraphBlocks row (valid
// slots first, the sorted-ELL invariant) holds every valid slot.
//
// What bounds it on the card: bytes.  A group reads its rows' valid slots
// (4 B each) and gathers one field value a slot, and writes one value a
// row: at kron23's shapes 0.94 GB a superstep at least (858 MB of slots,
// 215M gathers from a 50 MB field), 0.28 ms at 3.35 TB/s.  A launch takes
// about 3 ms on an H100, the per-slot rate of ell_hindex.cu, which gathers
// the same way: each gather moves a whole 32 B sector of a field that the
// 50 MB L2 cannot hold beside the slots streaming through, so the gathers
// most likely set the pace (no hardware counter was read).  The design
// keeps everything else out of device memory:
//
//  * Groups are taken in `order`, the plan's groups by logical degree,
//    largest first (made once a run on the card).  The first `*nbig` of
//    them get a whole CTA each, on the CTAs of the lowest indices, so the
//    longest groups start first; every other group gets one warp, eight
//    groups of like size to a CTA.
//  * Counts live in shared memory, over a window of thresholds [lo, hi].
//    The lowest kReg thresholds (where most neighbours of a hub sit) and
//    the top one count in registers and are summed once, so the heaviest
//    bins take no atomics; each threshold between counts into a bin of its
//    own with a shared atomic.
//  * h is read from a suffix sum over the window's bins: each thread sums
//    kChunk contiguous bins (kChunk + 1 words apart from thread to thread,
//    so no two lanes of a warp hit one bank), one team scan of those sums,
//    then each thread looks down its own bins for the largest t with
//    #{v >= t} >= t.
//  * A warp's window spans 1 + kReg + kWarpBins thresholds, which covers
//    every group a warp is given (the wrapper's WARP_TOP); a CTA's spans
//    4,096 bins above lo + kReg.  Where h reaches a window's top and the
//    group's degree lies beyond it, the team counts the group again over
//    the next window, and so on up to top: exact for any values, with no
//    clamp at an estimate.  Each group that takes a further window adds one
//    to `wide`.
//
// Integers only, so the result is deterministic and equals the plain
// version's, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                    // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;                   // bins a thread sums
constexpr int kReg = 4;                      // thresholds lo .. lo + 3 in registers
constexpr int kBatch = 4;                    // slots a thread loads before it counts
constexpr int kWarpBins = 32 * kChunk;       // a warp's window: 512 bins
constexpr int kCtaBins = kThreads * kChunk;  // a CTA's: 4,096 bins

// Where bin b lives: thread i's bins [kChunk i, kChunk i + kChunk) start
// (kChunk + 1) i words in, so the lanes of a warp reading their k-th bins
// hit 32 different banks.
__host__ __device__ constexpr int skew(int b) { return b + b / kChunk; }

// The threads that count one group: one warp (T = 32) or the CTA.
template <int T>
struct Team {
  int tid;           // 0 .. T - 1
  int32_t* scratch;  // the CTA's kWarps * (kReg + 1) ints; unused by a warp

  __device__ __forceinline__ void sync() const {
    if constexpr (T == 32) __syncwarp(); else __syncthreads();
  }

  // the team's sums of x[0 .. K), in place, on every thread
  template <int K>
  __device__ __forceinline__ void sum(int (&x)[K]) const {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = __reduce_add_sync(kFull, x[i]);
    if constexpr (T > 32) {
      const int w = tid >> 5;
      if ((tid & 31) == 0) {
#pragma unroll
        for (int i = 0; i < K; ++i) scratch[w * K + i] = x[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < K; ++i) {
        int s = 0;
        for (int j = 0; j < T / 32; ++j) s += scratch[j * K + i];
        x[i] = s;
      }
      __syncthreads();  // every thread has read the scratch
    }
  }

  // the sum of x over the team's threads above this one (tid' > tid)
  __device__ __forceinline__ int above(int x) const {
    const int lane = tid & 31;
    int s = x;  // inclusive suffix sum over the warp's lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_down_sync(kFull, s, off);
      if (lane + off < 32) s += t;
    }
    int out = s - x;
    if constexpr (T > 32) {
      const int w = tid >> 5;
      if (lane == 0) scratch[w] = s;  // lane 0's suffix: the warp's sum
      __syncthreads();
      for (int j = w + 1; j < T / 32; ++j) out += scratch[j];
      __syncthreads();
    }
    return out;
  }

  __device__ __forceinline__ int max(int x) const {
    x = __reduce_max_sync(kFull, x);
    if constexpr (T > 32) {
      const int w = tid >> 5;
      if ((tid & 31) == 0) scratch[w] = x;
      __syncthreads();
      x = scratch[0];
      for (int j = 1; j < T / 32; ++j) x = scratch[j] > x ? scratch[j] : x;
      __syncthreads();
    }
    return x;
  }
};

// One count of the group's entries [s, e) (e > s) over the thresholds
// [lo, hi], 1 <= lo <= hi: the largest t there with #{v >= t} >= t, or
// lo - 1 if none.  c[i] counts v >= lo + i (i < kReg) and c[kReg] v >= hi;
// bin b counts v == lo + kReg + b, for the nb thresholds between.  The
// group's rows are staged T at a time with their lengths; then each thread
// loads kBatch slots, gathers their values, and counts them.
template <int T>
__device__ int window_hindex(const Team<T>& tm,
                             const int32_t* __restrict__ nbr,
                             const int32_t* __restrict__ deg,
                             const int32_t* __restrict__ field,
                             const int32_t* __restrict__ grp_rows,
                             long long s, long long e, int ld, int lo,
                             int hi, int32_t* bins, int32_t* rows_s,
                             int32_t* len_s) {
  const int nb = hi - lo - kReg > 0 ? hi - lo - kReg : 0;
  tm.sync();  // a window before this one has read its bins
  for (int b = tm.tid; b < nb; b += T) bins[skew(b)] = 0;
  int c[kReg + 1];
#pragma unroll
  for (int i = 0; i <= kReg; ++i) c[i] = 0;
  for (long long r0 = s; r0 < e; r0 += T) {
    const int nr = e - r0 < T ? (int)(e - r0) : T;
    if (tm.tid < nr) {
      const int r = __ldg(grp_rows + r0 + tm.tid);
      const int d = __ldg(deg + r);
      rows_s[tm.tid] = r;
      len_s[tm.tid] = d < 0 ? 0 : (d < ld ? d : ld);
    }
    tm.sync();  // the rows are staged, and the bins clear
    const int total = nr * ld;
    for (int p0 = 0; p0 < total; p0 += T * kBatch) {
      int32_t x[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int p = p0 + k * T + tm.tid;
        x[k] = -1;
        if (p < total) {
          const int i = p / ld, j = p - i * ld;
          if (j < len_s[i])
            x[k] = __ldg(nbr + (long long)rows_s[i] * ld + j);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        x[k] = x[k] >= 0 ? __ldg(field + x[k]) : 0;  // PAD counts nowhere
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int v = x[k];
#pragma unroll
        for (int i = 0; i < kReg; ++i) c[i] += v >= lo + i;
        c[kReg] += v >= hi;
        const int b = v - lo - kReg;
        if (b >= 0 && b < nb) atomicAdd(bins + skew(b), 1);
      }
    }
    tm.sync();  // the adds are done and the stage read
  }
  tm.sum(c);
  if (c[kReg] >= hi) return hi;
  if (nb > 0) {  // the thresholds in the bins, from the top down
    const int b0 = tm.tid * kChunk;
    int part = 0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      part += b0 + k < nb ? bins[skew(b0 + k)] : 0;
    int run = c[kReg] + tm.above(part);  // #{v >= lo + kReg + b0 + kChunk}
    int found = -1;
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      const int b = b0 + k;
      if (b < nb) {
        run += bins[skew(b)];  // now #{v >= lo + kReg + b}
        if (found < 0 && run >= lo + kReg + b) found = lo + kReg + b;
      }
    }
    found = tm.max(found);
    if (found >= 0) return found;
  }
  // the thresholds in registers, below the bins and below hi
  for (int i = hi - lo - 1 < kReg - 1 ? hi - lo - 1 : kReg - 1; i >= 0; --i)
    if (c[i] >= lo + i) return lo + i;
  return lo - 1;
}

// The group's h over windows of `width` bins, from [1, ...] up while h
// reaches a window's top below the group's degree `top` (top >= 1).
template <int T>
__device__ int group_hindex(const Team<T>& tm, const int32_t* nbr,
                            const int32_t* deg, const int32_t* field,
                            const int32_t* grp_rows, long long s,
                            long long e, int ld, int top, int width,
                            int32_t* bins, int32_t* rows_s, int32_t* len_s,
                            unsigned long long* wide) {
  const int span = kReg + width;
  int lo = 1, hi = top - lo > span ? lo + span : top;
  for (;;) {
    const int h = window_hindex<T>(tm, nbr, deg, field, grp_rows, s, e, ld,
                                   lo, hi, bins, rows_s, len_s);
    if (h < hi || hi == top) return h;
    if (lo == 1 && tm.tid == 0) atomicAdd(wide, 1ull);
    lo = hi;
    hi = top - lo > span ? lo + span : top;
  }
}

// four CTAs an SM: at most 64 registers a thread
__global__ void __launch_bounds__(kThreads, 4)
mirror_hindex_kernel(const int32_t* __restrict__ nbr,
                     const int32_t* __restrict__ deg,
                     const int32_t* __restrict__ field,
                     const int32_t* __restrict__ ldeg,
                     const int32_t* __restrict__ grp_rows,
                     const int64_t* __restrict__ offsets,
                     const int64_t* __restrict__ order,
                     const int64_t* __restrict__ nbig_p,
                     int32_t* __restrict__ out,
                     unsigned long long* __restrict__ wide,
                     long long n_groups, int ld) {
  __shared__ int32_t bins[skew(kCtaBins)];
  __shared__ int32_t rows_s[kThreads], len_s[kThreads];
  __shared__ int32_t scratch[kWarps * (kReg + 1)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nbig = *nbig_p;

  // the long groups, one a CTA (round robin should they outnumber the CTAs)
  const Team<kThreads> cta{(int)threadIdx.x, scratch};
  for (long long k = blockIdx.x; k < nbig; k += gridDim.x) {
    const long long g = order[k];
    const long long s = offsets[g], e = offsets[g + 1];
    if (e > s) {  // CTA-uniform
      const int top = __ldg(ldeg + __ldg(grp_rows + s));
      const int h = top < 1 ? 0
          : group_hindex<kThreads>(cta, nbr, deg, field, grp_rows, s, e, ld,
                                   top, kCtaBins, bins, rows_s, len_s, wide);
      for (long long i = s + threadIdx.x; i < e; i += kThreads)
        out[__ldg(grp_rows + i)] = h;
    }
    __syncthreads();  // the shared arrays are free again
  }

  // every other group, one a warp, in the warp's own part of the arrays
  const long long k = nbig + (long long)blockIdx.x * kWarps + warp;
  if (k >= n_groups) return;
  const long long g = order[k];
  const long long s = offsets[g], e = offsets[g + 1];
  if (e <= s) return;  // a pad group
  const int top = __ldg(ldeg + __ldg(grp_rows + s));
  const Team<32> tm{lane, nullptr};
  const int h = top < 1 ? 0
      : group_hindex<32>(tm, nbr, deg, field, grp_rows, s, e, ld, top,
                         kWarpBins, bins + warp * skew(kWarpBins),
                         rows_s + 32 * warp, len_s + 32 * warp, wide);
  for (long long i = s + lane; i < e; i += 32) out[__ldg(grp_rows + i)] = h;
}

}  // namespace

// nbr: (N, ld) int32, -1 = PAD, valid slots first; deg: (N,) int32 row
// lengths; field: (>= N,) int32; ldeg: (N,) int32 logical degrees;
// grp_rows: the plan's group entries, int32, group by group; offsets:
// (n_groups + 1,) int64, group g's entries [offsets[g], offsets[g + 1]);
// order: (n_groups,) int64, a permutation of the groups, those of logical
// degree above the wrapper's WARP_TOP first; nbig: one int64 on the card,
// how many such groups; out: (N,) int32, written at every group row and
// nowhere else; wide: one uint64 on the card, added to.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int mirror_hindex_launch(const void* nbr, const void* deg,
                                    const void* field, const void* ldeg,
                                    const void* grp_rows, const void* offsets,
                                    const void* order, const void* nbig,
                                    void* out, void* wide, long long n_groups,
                                    int ld, void* stream) {
  if (n_groups <= 0) return 0;
  if (ld <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_groups + kWarps - 1) / kWarps;
  mirror_hindex_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)nbr, (const int32_t*)deg, (const int32_t*)field,
      (const int32_t*)ldeg, (const int32_t*)grp_rows,
      (const int64_t*)offsets, (const int64_t*)order, (const int64_t*)nbig,
      (int32_t*)out, (unsigned long long*)wide, n_groups, ld);
  return (int)cudaGetLastError();
}
