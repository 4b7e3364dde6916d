"""ELL frontier expansion (batched BFS hop): CUDA kernel and plain version.

One masked hop for R stacked frontiers (R concurrent updates, the batched
maintenance axis of `core.kcore_dynamic.maintain_batch`):

    next[u, r] = (exists j < C: f[nbr[u, j], r]) & eligible[u, r] & ~visited[u, r]

For undirected ELL storage (every edge stored in both endpoint rows) this
gather formulation equals the scatter-or over outgoing slots.  `eligible`
carries a per-frontier column axis, because batched maintenance stacks
updates with different k levels.

`frontier_step_ell` launches the hand-written CUDA kernel
(`csrc/ell_frontier.cu`) on CUDA tensors — the bool masks go in as
``uint8`` views, which copy nothing — and runs the plain PyTorch version,
`frontier_step_ell_plain`, on CPU tensors; any other device raises.  It
replaces the TPU kernel `frontier_step_ell` of the JAX package's
`kernels/ell_frontier.py`.  R is not padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ell_hindex import columns


def frontier_step_ell_plain(nbr: torch.Tensor, f: torch.Tensor,
                            eligible: torch.Tensor, visited: torch.Tensor,
                            K: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version: gather whole frontier rows, OR, mask."""
    N = nbr.shape[0]
    C = columns(nbr.shape[1], K)
    f_pad = torch.cat([f.to(torch.bool),
                       torch.zeros((1, f.shape[1]), dtype=torch.bool,
                                   device=f.device)])
    sub = nbr[:, :C]
    idx = torch.where(sub >= 0, sub, N).long()  # PAD -> the all-False row
    hit = f_pad[idx].any(dim=1)  # (N, C, R) -> (N, R)
    return hit & eligible.to(torch.bool) & ~visited.to(torch.bool)


def _check(nbr, f, eligible, visited) -> None:
    if nbr.dim() != 2 or nbr.dtype != torch.int32 or not nbr.is_contiguous():
        raise ValueError("nbr must be a contiguous (N, Cd) int32 tensor")
    shape = (nbr.shape[0], f.shape[-1] if f.dim() == 2 else -1)
    for name, t in (("f", f), ("eligible", eligible), ("visited", visited)):
        if tuple(t.shape) != shape or t.dtype != torch.bool \
                or not t.is_contiguous() or t.device != nbr.device:
            raise ValueError(
                f"{name} must be a contiguous {shape} bool tensor on "
                f"{nbr.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def frontier_step_ell(nbr: torch.Tensor, f: torch.Tensor,
                      eligible: torch.Tensor, visited: torch.Tensor,
                      K: Optional[int] = None) -> torch.Tensor:
    """Next frontier (N, R) bool for frontiers f (N, R) bool.

    eligible, visited: (N, R) bool.  CUDA tensors launch the CUDA kernel
    (and bump `frontier_step_ell.launches`); CPU tensors take
    `frontier_step_ell_plain`.
    """
    if nbr.device.type == "cpu":
        return frontier_step_ell_plain(nbr, f, eligible, visited, K)
    if nbr.device.type != "cuda":
        raise ValueError(
            f"frontier_step_ell runs on cuda or cpu, not {nbr.device}")
    _check(nbr, f, eligible, visited)
    N, Cd = nbr.shape
    R = f.shape[1]
    out = torch.empty((N, R), dtype=torch.bool, device=nbr.device)
    u8 = torch.uint8
    with torch.cuda.device(nbr.device):  # launch on the tensors' card
        err = _build.launcher("ell_frontier")(
            nbr.data_ptr(), f.view(u8).data_ptr(),
            eligible.view(u8).data_ptr(), visited.view(u8).data_ptr(),
            out.view(u8).data_ptr(), N, Cd, columns(Cd, K), R,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_frontier launch failed: cudaError {err}")
    frontier_step_ell.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
frontier_step_ell.launches = 0
