"""ELL neighbor-row intersection (triangles): CUDA kernel and plain version.

    nbr[N, Cd]   int32  padded neighbor ids (-1 = empty slot), the swept
                        adjacency
    rows[N, Cd]  int32  the per-node row field intersected (`nbr` itself
                        for whole-graph use)
    red[u] = sum over valid j < C of |rows[u, :C] ∩ rows[nbr[u, j], :C]|

with C = min(Cd, K) bounding both column axes, and the intersection
counted as a multiset (duplicate ids count as in the JAX package).  For an
undirected graph red[u] is twice the triangles through u.  The
"count_common" combine of `ops.COMBINES`: `core.algorithms.triangle_counts`.

Two variants compute the same integers, as in the JAX package; both are
exact for any slot order:

  "merge" (default)  keys PAD to int32 max and sorts the first C columns
      of each row of the field (a no-op permutation under the sorted-ELL
      invariant, as in the JAX wrapper), then launches
      `csrc/ell_triangles.cu` (binary probes into the sorted rows);
      `common_sorted_ell` is that launch alone, on rows sorted
      beforehand.  Plain version: `neighbor_common_ell_plain`.
  "allpairs"  matches every id of u's row against every id of each
      neighbour's row, as given, with no sort: `csrc/ell_allpairs.cu`
      (`common_allpairs_ell`), plain version `common_allpairs_ell_plain`.
      The JAX package keeps it as the yardstick of its kernel sweep.

`neighbor_common_ell` launches the variant's CUDA kernel on CUDA tensors
and runs its plain version on CPU tensors; any other device raises.  Each
kernel has its own launch count (`neighbor_common_ell.launches`,
`common_allpairs_ell.launches`).  They replace the TPU kernel
`neighbor_common_ell` of the JAX package's `kernels/ell_triangles.py`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .ell_hindex import columns, on_cuda

#: the intersection variants
VARIANTS = ("merge", "allpairs")

#: elements of the (rows, C, C, C) match tensor `common_allpairs_ell_plain`
#: holds at once
_ALLPAIRS_CHUNK = 1 << 26


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")


def _check_rows(nbr: torch.Tensor, rows: torch.Tensor) -> None:
    if nbr.dim() != 2 or nbr.dtype != torch.int32 or not nbr.is_contiguous():
        raise ValueError("nbr must be a contiguous (N, Cd) int32 tensor")
    if rows.shape != nbr.shape or rows.dtype != torch.int32 \
            or rows.device != nbr.device:
        raise ValueError(f"rows must be a {tuple(nbr.shape)} int32 tensor on "
                         f"{nbr.device}, got {tuple(rows.shape)} {rows.dtype} "
                         f"on {rows.device}")


def neighbor_common_ell_plain(nbr: torch.Tensor, rows: torch.Tensor,
                              K: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version: `ref.ell_common_ref` over the first C
    columns of both (sorted rows, searchsorted bounds, chunked)."""
    C = columns(nbr.shape[1], K)
    return ref.ell_common_ref(nbr[:, :C], rows[:, :C])


def neighbor_common_ell(nbr: torch.Tensor, rows: torch.Tensor,
                        K: Optional[int] = None,
                        variant: str = "merge") -> torch.Tensor:
    """Directed common-neighbor counts: (N,) int32.

    CUDA tensors launch the variant's CUDA kernel ("merge" bumps
    `neighbor_common_ell.launches`, "allpairs"
    `common_allpairs_ell.launches`); CPU tensors take its plain version.
    """
    _check_variant(variant)
    if variant == "allpairs":
        return common_allpairs_ell(nbr, rows, K)
    if not on_cuda(nbr, "neighbor_common_ell"):
        return neighbor_common_ell_plain(nbr, rows, K)
    _check_rows(nbr, rows)
    return common_sorted_ell(
        nbr, ref.key_sort_rows(rows[:, :columns(nbr.shape[1], K)]))


def common_sorted_ell(nbr: torch.Tensor, keyed: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel alone, on a row field already keyed and sorted
    (`ref.key_sort_rows` of its first C columns, C <= Cd): (N,) int32.

    `neighbor_common_ell` calls it after its sort; it bumps
    `neighbor_common_ell.launches`.  CUDA tensors only.
    """
    N, Cd = nbr.shape
    if keyed.dim() != 2 or keyed.shape[0] != N or keyed.shape[1] > Cd \
            or keyed.dtype != torch.int32 or keyed.device != nbr.device:
        raise ValueError(f"keyed must be an (N={N}, C<={Cd}) int32 tensor on "
                         f"{nbr.device}, got {tuple(keyed.shape)} "
                         f"{keyed.dtype} on {keyed.device}")
    keyed = keyed.contiguous()
    out = torch.empty(N, dtype=torch.int32, device=nbr.device)
    _build.launch("ell_triangles", nbr.device, nbr.data_ptr(),
                  keyed.data_ptr(), out.data_ptr(), N, Cd, keyed.shape[1])
    neighbor_common_ell.launches += 1
    return out


def common_allpairs_ell_plain(nbr: torch.Tensor, rows: torch.Tensor,
                              K: Optional[int] = None) -> torch.Tensor:
    """The "allpairs" variant's plain version: over row chunks, match every
    valid id of u's row against every valid id of each valid neighbour's
    row ((rows, C, C, C) at a time; PAD is any negative id)."""
    N = nbr.shape[0]
    C = columns(nbr.shape[1], K)
    nb, field = nbr[:, :C], rows[:, :C]
    own = torch.where(field >= 0, field, -1)  # never equals `theirs` below
    out = torch.zeros(N, dtype=torch.int32, device=nbr.device)
    step = max(1, _ALLPAIRS_CHUNK // max(1, C * C * C))
    for s in range(0, N, step):
        j = nb[s:s + step]
        theirs = field[j.clamp(min=0).long()]                 # (b, C, C)
        theirs = torch.where((j >= 0)[:, :, None] & (theirs >= 0), theirs, -2)
        match = own[s:s + step, None, :, None] == theirs[:, :, None, :]
        out[s:s + step] = match.sum(dim=(1, 2, 3)).to(torch.int32)
    return out


def common_allpairs_ell(nbr: torch.Tensor, rows: torch.Tensor,
                        K: Optional[int] = None) -> torch.Tensor:
    """`neighbor_common_ell(variant="allpairs")`: CUDA tensors launch
    `csrc/ell_allpairs.cu` on the rows as given (and bump
    `common_allpairs_ell.launches`); CPU tensors take
    `common_allpairs_ell_plain`."""
    if not on_cuda(nbr, "neighbor_common_ell"):
        return common_allpairs_ell_plain(nbr, rows, K)
    _check_rows(nbr, rows)
    rows = rows.contiguous()
    N, Cd = nbr.shape
    out = torch.empty(N, dtype=torch.int32, device=nbr.device)
    _build.launch("ell_allpairs", nbr.device, nbr.data_ptr(), rows.data_ptr(),
                  out.data_ptr(), N, Cd, columns(Cd, K))
    common_allpairs_ell.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
neighbor_common_ell.launches = 0
common_allpairs_ell.launches = 0
