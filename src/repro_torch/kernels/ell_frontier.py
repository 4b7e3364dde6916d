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
`kernels/ell_frontier.py`.  R is not padded.  `deg` (optional, (N,)
int32, each row's count of valid slots, a `GraphBlocks`' ``deg``) lets
the kernel stop a row at its length — on left-filled rows it reads
``nbr[u, :min(deg[u], C)]`` — and never changes the result; the plain
version takes it and does not need it.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ell_hindex import check_deg, columns, deg_ptr, on_cuda


def frontier_step_ell_plain(nbr: torch.Tensor, f: torch.Tensor,
                            eligible: torch.Tensor, visited: torch.Tensor,
                            K: Optional[int] = None,
                            deg: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain PyTorch version: gather whole frontier rows, OR, mask.
    `deg` is accepted and not read: the value does not depend on it."""
    C = columns(nbr.shape[1], K)
    f_pad = torch.cat([f.to(torch.bool),
                       torch.zeros((1, f.shape[1]), dtype=torch.bool,
                                   device=f.device)])
    sub = nbr[:, :C]
    # PAD -> the all-False row appended after f's last (f may be longer
    # than nbr, so nbr.shape[0] can be a real row)
    idx = torch.where(sub >= 0, sub, f.shape[0]).long()
    hit = f_pad[idx].any(dim=1)  # (N, C, R) -> (N, R)
    return hit & eligible.to(torch.bool) & ~visited.to(torch.bool)


def _check(nbr, f, eligible, visited) -> None:
    """Raise unless the kernel can take these: eligible and visited
    (N, R) and f (M, R) with M >= N (the kernel reads ``f[nbr[u, j]]``
    with no bound on N, so a worker's rows may index its frontier
    followed by its halo buffer, `runtime.spmd`), all contiguous bool on
    nbr's device."""
    if nbr.dim() != 2 or nbr.dtype != torch.int32 or not nbr.is_contiguous():
        raise ValueError("nbr must be a contiguous (N, Cd) int32 tensor")
    N = nbr.shape[0]
    R = f.shape[-1] if f.dim() == 2 else -1
    for name, t in (("f", f), ("eligible", eligible), ("visited", visited)):
        rows_ok = t.dim() == 2 and (t.shape[0] >= N if name == "f"
                                    else t.shape[0] == N)
        if not rows_ok or t.shape[-1] != R or t.dtype != torch.bool \
                or not t.is_contiguous() or t.device != nbr.device:
            want = f"({'>= ' if name == 'f' else ''}{N}, {R})"
            raise ValueError(
                f"{name} must be a contiguous {want} bool tensor on "
                f"{nbr.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def frontier_step_ell(nbr: torch.Tensor, f: torch.Tensor,
                      eligible: torch.Tensor, visited: torch.Tensor,
                      K: Optional[int] = None,
                      deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next frontier (N, R) bool for frontiers f (N, R) bool.

    eligible, visited: (N, R) bool; deg: None or (N,) int32 row lengths.
    `f` may have more rows than `nbr` (a worker's frontier and halo
    buffer, `runtime.spmd`): the ids in `nbr` index it.  CUDA tensors
    launch the CUDA kernel (and bump `frontier_step_ell.launches`); CPU
    tensors take `frontier_step_ell_plain`.
    """
    check_deg(nbr, deg)
    if not on_cuda(nbr, "frontier_step_ell"):
        return frontier_step_ell_plain(nbr, f, eligible, visited, K, deg)
    _check(nbr, f, eligible, visited)
    N, Cd = nbr.shape
    R = f.shape[1]
    out = torch.empty((N, R), dtype=torch.bool, device=nbr.device)
    u8 = torch.uint8
    _build.launch("ell_frontier", nbr.device, nbr.data_ptr(),
                  f.view(u8).data_ptr(), eligible.view(u8).data_ptr(),
                  visited.view(u8).data_ptr(), deg_ptr(deg),
                  out.view(u8).data_ptr(), N, Cd, columns(Cd, K), R)
    frontier_step_ell.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
frontier_step_ell.launches = 0
