"""ELL h-index sweep (the k-core hot loop): CUDA kernel and plain version.

    nbr[N, Cd] int32   padded neighbor ids (-1 = empty slot)
    est[N]     int32   current coreness estimates
    h[u] = h-index of {est[v] : v in nbr[u, :C]},  C = min(Cd, K)

Two variants compute the same integers, as in the JAX package:

  "sort" (default)  `hindex_ell_plain` sorts each row;
                    `csrc/ell_hindex.cu` counts a per-row histogram.
  "count"           a threshold-count matrix
                    cnt[u, k-1] = #{j : vals[u, j] >= k}, k = 1..C, then
                    h = sum_k [cnt[u, k-1] >= k]: `hindex_count_ell_plain`
                    and `csrc/ell_hindex_count.cu`.

`hindex_ell` launches the variant's hand-written CUDA kernel on CUDA
tensors and runs its plain PyTorch version on CPU tensors; any other
device raises.  Each kernel has its own launch count
(`hindex_ell.launches`, `hindex_count_ell.launches`).  They replace the
TPU kernel `hindex_ell` of the JAX package's `kernels/ell_hindex.py`.

Column bound K: h(u) <= deg(u), so any K >= max degree is exact when the
rows are left-filled (valid slots before PAD slots), which the sorted-ELL
invariant of `core.graph` guarantees.  K = None reads all Cd columns and
assumes nothing about slot order.  No padding of N or Cd is needed.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build


#: the h-index variants ("count" is the JAX package's kernel-sweep twin)
VARIANTS = ("sort", "count")

#: elements of the (rows, C, C) threshold tensor `hindex_count_ell_plain`
#: holds at once
_COUNT_CHUNK = 1 << 24


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


def hindex_count_ell_plain(nbr: torch.Tensor, est: torch.Tensor,
                           K: Optional[int] = None) -> torch.Tensor:
    """The "count" variant's plain version: gather the first C columns,
    count each threshold k = 1..C over row chunks, sum [cnt >= k]."""
    N = nbr.shape[0]
    C = columns(nbr.shape[1], K)
    vals = ell_gather(nbr[:, :C], est.to(torch.int32))
    ks = torch.arange(1, C + 1, dtype=torch.int32, device=nbr.device)
    out = torch.empty(N, dtype=torch.int32, device=nbr.device)
    step = max(1, _COUNT_CHUNK // max(1, C * C))
    for s in range(0, N, step):
        cnt = (vals[s:s + step, :, None] >= ks).sum(dim=1)  # (rows, C)
        out[s:s + step] = (cnt >= ks).sum(dim=1).to(torch.int32)
    return out


def check_field(nbr: torch.Tensor, field: torch.Tensor,
                dtype: torch.dtype = torch.int32, name: str = "est") -> None:
    """Raise unless nbr is a contiguous (N, Cd) int32 tensor and field a
    contiguous (N,) tensor of `dtype` on the same device (what the kernels
    take)."""
    if nbr.dim() != 2 or nbr.dtype != torch.int32 or not nbr.is_contiguous():
        raise ValueError("nbr must be a contiguous (N, Cd) int32 tensor")
    if field.shape != (nbr.shape[0],) or field.dtype != dtype \
            or not field.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({nbr.shape[0]},) "
                         f"{dtype} tensor, got {tuple(field.shape)} "
                         f"{field.dtype}")
    if field.device != nbr.device:
        raise ValueError(f"{name} on {field.device}, nbr on {nbr.device}")


def on_cuda(nbr: torch.Tensor, kernel: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version's
    device); raise for any other device."""
    if nbr.device.type in ("cpu", "cuda"):
        return nbr.device.type == "cuda"
    raise ValueError(f"{kernel} runs on cuda or cpu, not {nbr.device}")


def hindex_ell(nbr: torch.Tensor, est: torch.Tensor,
               K: Optional[int] = None, variant: str = "sort") -> torch.Tensor:
    """h-index of every row of `nbr` over `est`: (N,) int32.

    CUDA tensors launch the variant's CUDA kernel ("sort" bumps
    `hindex_ell.launches`, "count" `hindex_count_ell.launches`); CPU
    tensors take the variant's plain version.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    if variant == "count":
        return hindex_count_ell(nbr, est, K)
    if not on_cuda(nbr, "hindex_ell"):
        return hindex_ell_plain(nbr, est, K)
    out = _launch("ell_hindex", nbr, est, K)
    hindex_ell.launches += 1
    return out


def hindex_count_ell(nbr: torch.Tensor, est: torch.Tensor,
                     K: Optional[int] = None) -> torch.Tensor:
    """`hindex_ell(variant="count")`: CUDA tensors launch
    `csrc/ell_hindex_count.cu` (and bump `hindex_count_ell.launches`); CPU
    tensors take `hindex_count_ell_plain`."""
    if not on_cuda(nbr, "hindex_ell"):
        return hindex_count_ell_plain(nbr, est, K)
    out = _launch("ell_hindex_count", nbr, est, K)
    hindex_count_ell.launches += 1
    return out


def _launch(kernel: str, nbr: torch.Tensor, est: torch.Tensor,
            K: Optional[int]) -> torch.Tensor:
    check_field(nbr, est)
    N, Cd = nbr.shape
    out = torch.empty(N, dtype=torch.int32, device=nbr.device)
    _build.launch(kernel, nbr.device, nbr.data_ptr(), est.data_ptr(),
                  out.data_ptr(), N, Cd, columns(Cd, K))
    return out


#: kernel launches so far (the CPU path does not count)
hindex_ell.launches = 0
hindex_count_ell.launches = 0
