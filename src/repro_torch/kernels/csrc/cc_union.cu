// cc_union.cu — connected-component labels by union-find, in one pass over
// the valid slots of an ELL adjacency (ECL-CC: Jaiganesh and Burtscher, "A
// High-Performance Connected Components Implementation for GPUs", HPDC
// 2018).
//
// Replaces no TPU kernel: the JAX package labels components only by
// min-label propagation (`connected_components`, a `while_loop` of
// `neighbor_min_ell` supersteps, src/repro/kernels/ell_cc.py), which the
// port keeps as it is (kernels/ell_cc.py, csrc/ell_cc.cu) for the
// analytics.  Propagation takes as many supersteps as the least id's
// eccentricity, each over every row: 2,052 on a 2^23-point random
// geometric graph.  This kernel serves the stream session's label
// recompute on one device (`StreamSession._recompute_labels`).  For every
// row u of nbr (N, ld) int32 with -1 = PAD, deg (N,) int32 its count of
// valid slots and node_mask (N,) bool,
//
//     out[u] = min{w : w in u's component}   if node_mask[u], else -1,
//
// on an undirected graph (v in row u iff u in row v) whose padding rows
// have no slots, as every GraphBlocks: what `connected_components` gives,
// bit for bit.
//
// Three launches, no host read between or after them, no convergence flag:
//  1. init: parent[u] = nbr[u, 0] where that slot is valid and smaller than
//     u (a sorted row's least neighbour), else u.  Every parent is at most
//     its child, so every tree's root is its least member.
//  2. hook: every valid slot v < u of every row u (each undirected edge
//     once) finds the roots of u and v, pointing each node it walks past at
//     its grandparent (`find`, ECL-CC's intermediate pointer jumping), and
//     puts the larger root under the smaller by an atomicCAS on the larger
//     one's parent; a CAS that fails (that root was hooked meanwhile) goes
//     on from its new parent until the two roots meet.  Every hook puts a
//     larger root under a smaller one, so each final root is its tree's
//     least member whatever order the atomics take: the output is the same
//     on every run.
//  3. label: out[u] = the root of u's tree, -1 on a padding row.
//
// What bounds it on the card: the valid slots of nbr, read once (4 B each:
// 508 MB at rgg23's 127M slots, where a superstep of propagation reads the
// same and its least bytes are 0.609 GB, 0.18 ms at 3.35 TB/s), and the
// random reads, CASes and writes of `parent`, one int a row (33.5 MB at
// 2^23, which the 50 MB L2 holds once the init has written it).  Design:
// the hook pass takes rows as ell_rows.cuh's tier 1 does (8 lanes a row, 4
// rows a warp, every slot load in flight before any is used), and each
// lane issues the parent reads of all its slots and of its row before it
// walks any chain.  A row longer than a group's registers, or one whose
// first deg columns hold a PAD, is taken by the whole warp, 32 slots a
// step, until deg valid slots have been seen (any slot order).  A slot
// whose parent is already the lane's root of u is skipped.  Reads of
// `parent` are plain loads, which L1 caches: the nodes near the roots,
// which every walk ends on, are read there.  Another SM's write may be
// missed, but a stale pointer still names a smaller node of the same tree,
// and the atomicCAS, which reads L2, settles every join.  At rgg23's shape
// the three launches took 2.2 ms against 3.7 ms with every read from L2
// (`__ldcg`), on an H100 80GB HBM3 at 700 W.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_rows.cuh"

namespace {

constexpr int kThreads = 256;
// rows a block of the hook pass takes: 8 warps of 4 groups
constexpr int kHookRows = (kThreads / 32) * ell::kRowsPerWarp;

// The root of x's tree, given cur = parent[x].  Each node walked past is
// pointed at its grandparent: every value written is a smaller node of the
// same tree, so a racing write never undoes a join or makes a cycle.
__device__ __forceinline__ int32_t find(int32_t* __restrict__ parent,
                                        int32_t x, int32_t cur) {
  int32_t next;
  while (cur < x && cur > (next = parent[cur])) {
    __stcg(parent + x, next);
    x = cur;
    cur = next;
  }
  return cur;
}

// Joins the trees of a and b (their roots, or nodes that were roots when
// read), the larger root under the smaller; returns the smaller root.
__device__ __forceinline__ int32_t hook(int32_t* __restrict__ parent,
                                        int32_t a, int32_t b) {
  while (a != b) {
    const int32_t hi = a > b ? a : b;
    const int32_t lo = a > b ? b : a;
    const int32_t seen = atomicCAS(parent + hi, hi, lo);
    if (seen == hi) return lo;  // hi was a root: its tree is now lo's
    a = seen;                   // hi was hooked meanwhile: on from there
    b = lo;
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
    cc_init_kernel(const int32_t* __restrict__ nbr,
                   const int32_t* __restrict__ deg,
                   int32_t* __restrict__ parent, long long n_rows, int ld) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u >= n_rows) return;
  int32_t p = (int32_t)u;
  if (ld > 0 && __ldg(deg + u) > 0) {
    const int32_t v = __ldg(nbr + u * (long long)ld);
    if (v >= 0 && v < p) p = v;
  }
  parent[u] = p;
}

// Hooks row u's slots held in this lane's registers (v, `steps` of them):
// the parent of every slot below u and of u are read before any chain is
// walked.
__device__ __forceinline__ void hook_slots(int32_t* __restrict__ parent,
                                           int32_t u,
                                           const int32_t (&v)[ell::kSlots],
                                           int steps) {
  int32_t pv[ell::kSlots];
  bool any = false;
#pragma unroll
  for (int i = 0; i < ell::kSlots; ++i) {
    if (i >= steps) break;
    const bool take = v[i] >= 0 && v[i] < u;
    pv[i] = take ? parent[v[i]] : -1;
    any |= take;
  }
  if (!any) return;
  int32_t ru = find(parent, u, parent[u]);
#pragma unroll
  for (int i = 0; i < ell::kSlots; ++i) {
    if (i >= steps) break;
    if (pv[i] >= 0 && pv[i] != ru)  // else v is already under ru
      ru = hook(parent, ru, find(parent, v[i], pv[i]));
  }
}

__global__ void __launch_bounds__(kThreads)
    cc_hook_kernel(const int32_t* __restrict__ nbr,
                   const int32_t* __restrict__ deg,
                   int32_t* __restrict__ parent, long long n_rows, int ld) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / ell::kGroup;
  const int gl = lane % ell::kGroup;
  const long long base =
      ((long long)blockIdx.x * (kThreads / 32) + warp) * ell::kRowsPerWarp;
  const long long row = base + grp;

  // S: the columns read first, min(deg, ld); a group holds up to 64
  int S = 0;
  if (row < n_rows) {
    const int d = __ldg(deg + row);
    S = d < ld ? (d > 0 ? d : 0) : ld;
  }
  const bool fits = S <= ell::kGroup * ell::kSlots;
  int32_t v[ell::kSlots];
  const int steps = ell::load_slots<ell::kGroup>(
      nbr + row * (long long)ld, fits ? S : 0, gl, v);
  int c = 0;
#pragma unroll
  for (int i = 0; i < ell::kSlots; ++i) {
    if (i >= steps) break;
    c += v[i] >= 0;
  }
  // a PAD among the first S < ld columns: the row's valid slots go on
  // past them, so the warp reads it to its length.  Every lane sums (the
  // shuffles take the whole warp), whether its row fits or not.
  const int n = ell::group_sum<ell::kGroup>(c);
  const bool held = fits && !(n < S && S < ld);
  if (held) hook_slots(parent, (int32_t)row, v, steps);

  unsigned loop = __ballot_sync(ell::kFull, gl == 0 && !held);
  while (loop) {  // warp-uniform
    const long long u = base + (__ffs(loop) - 1) / ell::kGroup;
    loop &= loop - 1;
    const int32_t* r = nbr + u * (long long)ld;
    const int target = __ldg(deg + u);
    int32_t ru = -1;  // this lane's root of u, found at its first slot
    int seen = 0;     // warp-uniform
    for (int j0 = 0; j0 < ld && seen < target; j0 += 32) {
      const int j = j0 + lane;
      const int32_t w = j < ld ? __ldg(r + j) : -1;
      seen += __popc(__ballot_sync(ell::kFull, w >= 0));
      if (w >= 0 && w < u) {
        if (ru < 0) ru = find(parent, (int32_t)u, parent[u]);
        const int32_t pw = parent[w];
        if (pw != ru) ru = hook(parent, ru, find(parent, w, pw));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    cc_label_kernel(const int32_t* __restrict__ parent,
                    const uint8_t* __restrict__ node_mask,
                    int32_t* __restrict__ out, long long n_rows) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u >= n_rows) return;
  if (!__ldg(node_mask + u)) {
    out[u] = -1;
    return;
  }
  int32_t r = __ldg(parent + u), next;
  while (r > (next = __ldg(parent + r))) r = next;
  out[u] = r;
}

}  // namespace

// nbr: (n_rows, ld) int32; deg, out: (n_rows,) int32; node_mask: (n_rows,)
// bool, one byte each; parent: (n_rows,) int32 scratch, overwritten.
// Returns the first launch's cudaError_t that is not cudaSuccess.
extern "C" int cc_union_launch(const void* nbr, const void* deg,
                               const void* node_mask, void* parent,
                               void* out, long long n_rows, int ld,
                               void* stream) {
  if (n_rows <= 0) return 0;
  if (ld < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n_rows + kThreads - 1) / kThreads);
  cc_init_kernel<<<blocks, kThreads, 0, s>>>(
      (const int32_t*)nbr, (const int32_t*)deg, (int32_t*)parent, n_rows, ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_hook_kernel<<<(unsigned)((n_rows + kHookRows - 1) / kHookRows),
                   kThreads, 0, s>>>(
      (const int32_t*)nbr, (const int32_t*)deg, (int32_t*)parent, n_rows, ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_label_kernel<<<blocks, kThreads, 0, s>>>(
      (const int32_t*)parent, (const uint8_t*)node_mask, (int32_t*)out,
      n_rows);
  return (int)cudaGetLastError();
}
