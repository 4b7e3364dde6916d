"""Dense h-index sweep (the "dense" backend's hot loop): CUDA kernel and
plain version.

    adj[N, N]  bfloat16  0/1 adjacency (`ref.ell_to_dense`)
    est[N]     int32     current coreness estimates
    h[u] = sum_{k=1..K} [ #{v : adj[u, v] != 0, est[v] >= k} >= k ]

the h-index of u's neighbour estimates, capped at K: exact when
K >= max(est) + 1, or when K is at least every row's degree, which every
caller arranges.  The JAX package pads K up to a multiple of 128 and so
caps at the padded K; the port caps at K itself, so the two agree
wherever K >= max(est) + 1.

`hindex_counts` launches the hand-written CUDA kernel
(`csrc/kcore_hindex.cu`, a streaming per-row histogram) on CUDA tensors
and runs `hindex_counts_plain` (the JAX package's threshold-count product
in float32, over row chunks) on CPU tensors; any other device raises.  It
replaces the TPU kernel `hindex_counts` of the JAX package's
`kernels/kcore_hindex.py`.  Neither N nor K is padded.
"""
from __future__ import annotations

import torch

from . import _build
from .ell_hindex import on_cuda

#: elements of the float32 adjacency rows the plain dense versions convert
#: at once (1 GiB): a whole float32 copy would be 10 GB at N = 50,048
DENSE_CHUNK = 1 << 28


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32.  Raises for CUDA tensors while PyTorch
    lets matmuls use TF32 (`torch.backends.cuda.matmul.allow_tf32`), which
    keeps 10 mantissa bits: the dense sums would drift from the others."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the dense "
            "backend's float32 products must run in full float32")
    return a @ b


def row_chunks(N: int):
    """Row slices of an (N, N) adjacency whose float32 copy stays within
    `DENSE_CHUNK` elements."""
    step = max(1, DENSE_CHUNK // max(1, N))
    return (slice(s, s + step) for s in range(0, N, step))


def hindex_counts_plain(adj: torch.Tensor, est: torch.Tensor,
                        K: int) -> torch.Tensor:
    """The plain PyTorch version: cnt = adj @ B with B[v, k-1] =
    (est[v] >= k), in float32 (counts below 2^24 are exact), then
    h = sum_k [cnt[:, k-1] >= k]; over row chunks of the adjacency."""
    N = adj.shape[0]
    ks = torch.arange(1, int(K) + 1, dtype=torch.int32, device=adj.device)
    B = (est.to(torch.int32)[:, None] >= ks[None, :]).to(torch.float32)
    kf = ks.to(torch.float32)
    out = torch.empty(N, dtype=torch.int32, device=adj.device)
    for rows in row_chunks(N):
        cnt = matmul_f32(adj[rows].to(torch.float32), B)
        out[rows] = (cnt >= kf).sum(dim=1).to(torch.int32)
    return out


def check_adj(adj: torch.Tensor) -> int:
    """Raise unless adj is a contiguous (N, N) bfloat16 tensor; return N."""
    N = adj.shape[0] if adj.dim() == 2 else -1
    if adj.shape != (N, N) or adj.dtype != torch.bfloat16 \
            or not adj.is_contiguous():
        raise ValueError(f"adj must be a contiguous (N, N) bfloat16 tensor, "
                         f"got {tuple(adj.shape)} {adj.dtype}")
    return N


def hindex_counts(adj: torch.Tensor, est: torch.Tensor,
                  K: int) -> torch.Tensor:
    """h-index of every row of the dense adjacency over `est`, capped at
    K >= 1: (N,) int32.

    CUDA tensors launch the CUDA kernel (and bump
    `hindex_counts.launches`); CPU tensors take `hindex_counts_plain`.
    """
    if not on_cuda(adj, "hindex_counts"):
        return hindex_counts_plain(adj, est, K)
    N = check_adj(adj)
    if est.shape != (N,) or est.dtype != torch.int32 \
            or not est.is_contiguous() or est.device != adj.device:
        raise ValueError(f"est must be a contiguous ({N},) int32 tensor on "
                         f"{adj.device}, got {tuple(est.shape)} {est.dtype} "
                         f"on {est.device}")
    if int(K) < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    out = torch.empty(N, dtype=torch.int32, device=adj.device)
    _build.launch("kcore_hindex", adj.device, adj.data_ptr(), est.data_ptr(),
                  out.data_ptr(), N, int(K))
    hindex_counts.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
hindex_counts.launches = 0
