"""Dense frontier expansion (the "dense" backend's BFS hop): CUDA kernel and
plain version.

One masked hop for R stacked frontiers over a dense 0/1 adjacency:

    next[u, r] = (exists v: adj[u, v] != 0 and f[v, r]) & eligible[u]
                 & ~visited[u, r]

with ONE eligibility per node, shared by all R columns, as in the JAX
package.  `ops.frontier_blocks` folds per-column eligibility into
`visited` and passes all ones here.

`frontier_step` launches the hand-written CUDA kernel (`csrc/frontier.cu`)
on CUDA tensors — the bool masks go in as ``uint8`` views, which copy
nothing — and runs the plain PyTorch version, `frontier_step_plain` (the
JAX package's product ``adj @ f > 0`` in float32, over row chunks), on CPU
tensors; any other device raises.  It replaces the TPU kernel
`frontier_step` of the JAX package's `kernels/frontier.py`.  Neither N nor
R is padded.
"""
from __future__ import annotations

import torch

from . import _build
from .ell_hindex import on_cuda
from .kcore_hindex import check_adj, matmul_f32, row_chunks


def frontier_step_plain(adj: torch.Tensor, f: torch.Tensor,
                        eligible: torch.Tensor,
                        visited: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: hit = adj @ f > 0 in float32, masked."""
    N, R = f.shape
    fm = f.to(torch.float32)
    elig = eligible.to(torch.bool)
    vis = visited.to(torch.bool)
    out = torch.empty((N, R), dtype=torch.bool, device=adj.device)
    for rows in row_chunks(N):
        hit = matmul_f32(adj[rows].to(torch.float32), fm) > 0
        out[rows] = hit & elig[rows, None] & ~vis[rows]
    return out


def frontier_step(adj: torch.Tensor, f: torch.Tensor, eligible: torch.Tensor,
                  visited: torch.Tensor) -> torch.Tensor:
    """Next frontier (N, R) bool for frontiers f (N, R) bool.

    adj: (N, N) bfloat16; eligible: (N,) bool; visited: (N, R) bool.  CUDA
    tensors launch the CUDA kernel (and bump `frontier_step.launches`);
    CPU tensors take `frontier_step_plain`.
    """
    if not on_cuda(adj, "frontier_step"):
        return frontier_step_plain(adj, f, eligible, visited)
    N = check_adj(adj)
    R = f.shape[1] if f.dim() == 2 else -1
    for name, t, shape in (("f", f, (N, R)), ("eligible", eligible, (N,)),
                           ("visited", visited, (N, R))):
        if tuple(t.shape) != shape or t.dtype != torch.bool \
                or not t.is_contiguous() or t.device != adj.device:
            raise ValueError(
                f"{name} must be a contiguous {shape} bool tensor on "
                f"{adj.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    out = torch.empty((N, R), dtype=torch.bool, device=adj.device)
    u8 = torch.uint8
    _build.launch("frontier", adj.device, adj.data_ptr(),
                  f.view(u8).data_ptr(), eligible.view(u8).data_ptr(),
                  visited.view(u8).data_ptr(), out.view(u8).data_ptr(), N, R)
    frontier_step.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
frontier_step.launches = 0
