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

`neighbor_common_ell` keys PAD to int32 max and sorts the first C columns
of each row of the field (a no-op permutation under the sorted-ELL
invariant, as in the JAX wrapper), then launches the hand-written CUDA
kernel (`csrc/ell_triangles.cu`, binary probes into the sorted rows) on
CUDA tensors; on CPU tensors it runs `neighbor_common_ell_plain`; any
other device raises.  So it is exact for any slot order.
`common_sorted_ell` is the launch alone, on rows sorted beforehand.  It replaces the
TPU kernel `neighbor_common_ell` of the JAX package's
`kernels/ell_triangles.py`, variant "merge"; the "allpairs" variant, a
benchmark yardstick, is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .ell_hindex import columns, on_cuda

#: intersection variants ported so far ("allpairs" is still to port)
VARIANTS = ("merge",)


def _check_variant(variant: str) -> None:
    if variant == "allpairs":
        raise NotImplementedError(
            "neighbor_common_ell variant 'allpairs' is not ported to "
            "PyTorch yet; see ROADMAP.md (Queue 2)")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")


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

    CUDA tensors launch the CUDA kernel (and bump
    `neighbor_common_ell.launches`); CPU tensors take the plain version.
    """
    _check_variant(variant)
    if not on_cuda(nbr, "neighbor_common_ell"):
        return neighbor_common_ell_plain(nbr, rows, K)
    if nbr.dim() != 2 or nbr.dtype != torch.int32 or not nbr.is_contiguous():
        raise ValueError("nbr must be a contiguous (N, Cd) int32 tensor")
    if rows.shape != nbr.shape or rows.dtype != torch.int32 \
            or rows.device != nbr.device:
        raise ValueError(f"rows must be a {tuple(nbr.shape)} int32 tensor on "
                         f"{nbr.device}, got {tuple(rows.shape)} {rows.dtype} "
                         f"on {rows.device}")
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


#: kernel launches so far (the CPU path does not count)
neighbor_common_ell.launches = 0
