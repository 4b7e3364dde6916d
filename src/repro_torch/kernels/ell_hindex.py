"""ELL h-index sweep (the k-core hot loop): CUDA kernel and plain version.

    nbr[N, Cd] int32   padded neighbor ids (-1 = empty slot)
    est[N]     int32   current coreness estimates
    h[u] = h-index of {est[v] : v in nbr[u, :C]},  C = min(Cd, K)

`hindex_ell` launches the hand-written CUDA kernel (`csrc/ell_hindex.cu`)
on CUDA tensors and runs the plain PyTorch version, `hindex_ell_plain`,
on CPU tensors; any other device raises.  It replaces the TPU kernel
`hindex_ell` of the JAX package's `kernels/ell_hindex.py`.

Column bound K: h(u) <= deg(u), so any K >= max degree is exact when the
rows are left-filled (valid slots before PAD slots), which the sorted-ELL
invariant of `core.graph` guarantees.  K = None reads all Cd columns and
assumes nothing about slot order.  No padding of N or Cd is needed.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build


def columns(Cd: int, K: Optional[int]) -> int:
    """Neighbor columns read: min(Cd, K), or Cd when K is None."""
    return Cd if K is None else max(0, min(Cd, int(K)))


def ell_gather(nbr: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """Gather est over the ELL adjacency; PAD slots -> -1 (ignored by hindex)."""
    vals = est[nbr.clamp(min=0).long()]
    return torch.where(nbr >= 0, vals, torch.full_like(vals, -1))


def hindex_rows(vals: torch.Tensor) -> torch.Tensor:
    """Row-wise h-index of a padded value matrix (PAD/-1 entries ignored).

    h = max{k : at least k entries >= k}, by descending sort + position
    compare (the indicator is prefix-monotone, so its sum is h).
    """
    C = vals.shape[-1]
    s = torch.sort(vals, dim=-1, descending=True).values
    ranks = torch.arange(1, C + 1, dtype=vals.dtype, device=vals.device)
    return (s >= ranks).sum(dim=-1).to(vals.dtype)


def hindex_ell_plain(nbr: torch.Tensor, est: torch.Tensor,
                     K: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version: gather the first C columns, sort, count."""
    C = columns(nbr.shape[1], K)
    return hindex_rows(ell_gather(nbr[:, :C], est.to(torch.int32)))


def _check(nbr: torch.Tensor, est: torch.Tensor) -> None:
    if nbr.dim() != 2 or nbr.dtype != torch.int32 or not nbr.is_contiguous():
        raise ValueError("nbr must be a contiguous (N, Cd) int32 tensor")
    if est.shape != (nbr.shape[0],) or est.dtype != torch.int32 \
            or not est.is_contiguous():
        raise ValueError(f"est must be a contiguous ({nbr.shape[0]},) int32 "
                         f"tensor, got {tuple(est.shape)} {est.dtype}")
    if est.device != nbr.device:
        raise ValueError(f"est on {est.device}, nbr on {nbr.device}")


def hindex_ell(nbr: torch.Tensor, est: torch.Tensor,
               K: Optional[int] = None) -> torch.Tensor:
    """h-index of every row of `nbr` over `est`: (N,) int32.

    CUDA tensors launch the CUDA kernel (and bump `hindex_ell.launches`);
    CPU tensors take `hindex_ell_plain`.
    """
    if nbr.device.type == "cpu":
        return hindex_ell_plain(nbr, est, K)
    if nbr.device.type != "cuda":
        raise ValueError(f"hindex_ell runs on cuda or cpu, not {nbr.device}")
    _check(nbr, est)
    N, Cd = nbr.shape
    out = torch.empty(N, dtype=torch.int32, device=nbr.device)
    with torch.cuda.device(nbr.device):  # launch on the tensors' card
        err = _build.launcher("ell_hindex")(
            nbr.data_ptr(), est.data_ptr(), out.data_ptr(), N, Cd,
            columns(Cd, K), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_hindex launch failed: cudaError {err}")
    hindex_ell.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
hindex_ell.launches = 0
