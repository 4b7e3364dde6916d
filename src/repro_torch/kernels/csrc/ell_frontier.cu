// ell_frontier.cu — one masked BFS hop for R stacked frontiers over ELL.
//
// Replaces the TPU kernel `frontier_step_ell` of
// src/repro/kernels/ell_frontier.py (Pallas body `_ell_frontier_kernel`).
// For nbr (N, ld) int32 with -1 = PAD and f, eligible, visited (N, R) bytes
// (uint8 views of bool tensors), it computes
//
//     next[u, r] = (OR_{j < C, nbr[u, j] >= 0} f[nbr[u, j], r])
//                  & eligible[u, r] & !visited[u, r]
//
// for any slot order.  R is the window width (8 on the main path) and is
// not padded: the TPU's 128-lane padding has no use here.  `deg` (N,)
// int32 is optional: each row's count of valid slots, as a GraphBlocks
// keeps it.  With it a row stops once it has seen min(deg[u], valid slots
// of its first C columns) valid slots — on a left-filled row it reads
// exactly nbr[u, :min(deg[u], C)] — and the result is the same.  Without
// it a row reads up to its C columns.
//
// What bounds it on the card: at the main path's shapes, latency.  The
// stream's hops run at R = 8 (a batch's candidate search) and, for the
// updates a batch defers, at R = 1.  At the first hop of a batch 40,410
// of DS1's 50,048 rows need a column and almost none hits one, so with
// deg a launch needs the masks, deg, the output and each such row's valid
// slots (3.3 on average) with their frontier rows: under a microsecond of
// HBM time.  What is left is the launch and each row's chain of dependent
// loads (masks and deg, its slots, their frontier rows).  For R <= 8 the
// kernel keeps that chain short:
//
//  * eligible, visited and deg are loaded together; at R = 8 eligible and
//    visited are one 8-byte load each.  `need` is an R-bit mask, and a
//    row that needs no column writes zeros and reads no nbr.
//  * kGroup = 4 lanes per row, 8 rows per warp.  Each step a lane issues
//    kSlots = 8 slot loads, then the frontier gathers of the valid ones
//    (one 8-byte load each at R = 8), before it consumes any: a step
//    covers 32 columns (the whole of 49,980 of DS1's 50,048 rows) for
//    about one load and one gather of latency.  The group ORs its bits
//    with shuffles and stops once every needed column is hit or the row's
//    slots are done (with deg: a group count of its valid slots reaches
//    deg; a row whose first min(deg, C) columns hold a PAD reads on to C).
//    Both exits are exact: the output is the hit mask ANDed with `need`.
//    Every lane runs the warp's steps, so a warp never diverges.
//  * at R = 8 the output row is one 8-byte store.
//
// R > 8 (13 in the tests, R > 32 in general) takes the generic kernel:
// one warp per row, lanes over 32 slots a step, frontier bytes read one
// by one, the same exits.  A frontier not 8-byte aligned at R = 8 takes
// the byte loads of the R <= 8 kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                   // warps per block
constexpr int kGroup = 4;                   // lanes per row (R <= 8 kernel)
constexpr int kRowsPerWarp = 32 / kGroup;
constexpr int kSlots = 8;                   // slot loads per lane per step
constexpr int kStep = kGroup * kSlots;      // columns per step

// bit b set where byte b of x is nonzero
__device__ __forceinline__ unsigned byte_mask(unsigned long long x) {
  unsigned m = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    m |= (unsigned)(((x >> (8 * b)) & 0xffull) != 0) << b;
  return m;
}

// byte b = bit b of m (0 or 1)
__device__ __forceinline__ unsigned long long mask_bytes(unsigned m) {
  unsigned long long x = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) x |= (unsigned long long)((m >> b) & 1u)
                                   << (8 * b);
  return x;
}

// OR / sum of x over the kGroup lanes of this lane's group; all 32 lanes
// call them together
__device__ __forceinline__ unsigned group_or(unsigned x) {
#pragma unroll
  for (int off = kGroup / 2; off >= 1; off >>= 1)
    x |= __shfl_xor_sync(kFull, x, off);
  return x;
}
__device__ __forceinline__ int group_sum(int x) {
#pragma unroll
  for (int off = kGroup / 2; off >= 1; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// bit b set where byte b of the R <= 8 bytes at p is nonzero
__device__ __forceinline__ unsigned bytes_mask(const uint8_t* p, int R) {
  unsigned m = 0;
  for (int b = 0; b < R; ++b) m |= (unsigned)(__ldg(p + b) != 0) << b;
  return m;
}

// R <= 8 frontiers, 4 rows a warp.  kVec8: R = 8 with every mask 8-byte
// aligned, so a mask row is one 8-byte load or store; otherwise R byte
// loads (R = 1 on the stream's sequential updates).
template <bool kVec8>
__global__ void ell_frontier_rows_kernel(const int32_t* __restrict__ nbr,
                                         const uint8_t* __restrict__ f,
                                         const uint8_t* __restrict__ elig,
                                         const uint8_t* __restrict__ vis,
                                         const int32_t* __restrict__ deg,
                                         uint8_t* __restrict__ out,
                                         long long n_rows, int ld, int C,
                                         int R) {
  using u64 = unsigned long long;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gl = lane % kGroup;
  const long long row =
      ((long long)blockIdx.x * kWarps + warp) * kRowsPerWarp + lane / kGroup;
  const bool live = row < n_rows;

  // eligible, visited and the row's length, loaded together: `target`
  // valid slots end the row, and the columns read first are min(deg, C),
  // a left-filled row's valid slots
  unsigned need = 0;
  int target = C;
  if (live) {
    if (kVec8) {
      const u64 e = __ldg(reinterpret_cast<const u64*>(elig) + row);
      const u64 x = __ldg(reinterpret_cast<const u64*>(vis) + row);
      need = byte_mask(e) & ~byte_mask(x);
    } else {
      need = bytes_mask(elig + row * R, R) & ~bytes_mask(vis + row * R, R);
    }
    if (deg != nullptr) target = __ldg(deg + row);
  }
  const int32_t* r = nbr + row * (long long)ld;
  unsigned hit = 0;
  int seen = 0, j0 = 0;
  int end = need == 0 ? 0 : (target < C ? (target > 0 ? target : 0) : C);
  // every lane runs the warp's steps, so the warp never diverges (groups
  // of one warp that diverge run one after another); a group that is done
  // loads nothing
  bool active = j0 < end;
  while (__any_sync(kFull, active)) {
    int32_t v[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {  // every slot load first
      const int j = j0 + gl + i * kGroup;
      v[i] = active && j < end ? __ldg(r + j) : -1;
    }
    unsigned bits = 0;
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {  // then every frontier gather
      if (v[i] >= 0) {
        ++cnt;
        bits |= kVec8 ? byte_mask(__ldg(reinterpret_cast<const u64*>(f) +
                                        v[i]))
                      : bytes_mask(f + (long long)v[i] * R, R);
      }
    }
    hit |= group_or(bits);
    seen += group_sum(cnt);
    if (active) {
      j0 += kStep;
      if (j0 >= end && end < C) {  // a PAD among the first columns:
        j0 = end;                  // the row's valid slots go on past them
        end = C;
      }
      active = (hit & need) != need && seen < target && j0 < end;
    }
  }
  if (live && gl == 0) {
    if (kVec8) {
      reinterpret_cast<u64*>(out)[row] = mask_bytes(hit & need);
    } else {
      for (int b = 0; b < R; ++b)
        out[row * R + b] = (uint8_t)(((hit & need) >> b) & 1u);
    }
  }
}

__global__ void ell_frontier_kernel(const int32_t* __restrict__ nbr,
                                    const uint8_t* __restrict__ f,
                                    const uint8_t* __restrict__ elig,
                                    const uint8_t* __restrict__ vis,
                                    const int32_t* __restrict__ deg,
                                    uint8_t* __restrict__ out,
                                    long long n_rows, int ld, int C, int R) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // the whole warp leaves; no block-wide sync

  const int target = deg != nullptr ? __ldg(deg + row) : C;
  const int32_t* r = nbr + row * (long long)ld;
  for (int c0 = 0; c0 < R; c0 += 32) {
    const int c = c0 + lane;
    const long long o = row * (long long)R + c;
    const bool want = c < R && elig[o] != 0 && vis[o] == 0;
    const unsigned need = __ballot_sync(kFull, want);
    unsigned hit = 0;
    if (need) {
      const int width = R - c0 < 32 ? R - c0 : 32;
      int seen = 0;
      for (int j0 = 0; j0 < C && seen < target; j0 += 32) {
        const int j = j0 + lane;
        unsigned bits = 0;
        const int32_t v = j < C ? r[j] : -1;
        if (v >= 0) {
          const uint8_t* fr = f + (long long)v * R + c0;
          for (int b = 0; b < width; ++b)
            bits |= (unsigned)(__ldg(fr + b) != 0) << b;
        }
        hit |= __reduce_or_sync(kFull, bits);
        seen += __popc(__ballot_sync(kFull, v >= 0));
        if ((hit & need) == need) break;  // every needed column is hit
      }
    }
    if (c < R) out[o] = (uint8_t)(((hit & need) >> lane) & 1u);
  }
}

bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

}  // namespace

// nbr: (n_rows, ld) int32; f, elig, vis, out: (n_rows, R) uint8, row-major
// and contiguous; deg: (n_rows,) int32 valid slots per row, or NULL.
// Reads columns [0, C) of each nbr row, C <= ld.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int ell_frontier_launch(const void* nbr, const void* f,
                                   const void* elig, const void* vis,
                                   const void* deg, void* out,
                                   long long n_rows, int ld, int C, int R,
                                   void* stream) {
  if (n_rows <= 0 || R <= 0) return 0;
  if (C < 0 || C > ld) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 8) {
    const long long rows = (long long)kWarps * kRowsPerWarp;
    const long long blocks = (n_rows + rows - 1) / rows;
    auto* kernel = R == 8 && aligned8(f) && aligned8(elig) &&
                           aligned8(vis) && aligned8(out)
                       ? ell_frontier_rows_kernel<true>
                       : ell_frontier_rows_kernel<false>;
    kernel<<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        (const int32_t*)nbr, (const uint8_t*)f, (const uint8_t*)elig,
        (const uint8_t*)vis, (const int32_t*)deg, (uint8_t*)out, n_rows, ld,
        C, R);
  } else {
    const long long blocks = (n_rows + kWarps - 1) / kWarps;
    ell_frontier_kernel<<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        (const int32_t*)nbr, (const uint8_t*)f, (const uint8_t*)elig,
        (const uint8_t*)vis, (const int32_t*)deg, (uint8_t*)out, n_rows, ld,
        C, R);
  }
  return (int)cudaGetLastError();
}
