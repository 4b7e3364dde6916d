"""ELL neighbor-row intersection (triangles): CUDA kernel and plain version.

    nbr[N, Cd]   int32  padded neighbor ids (-1 = empty slot), the swept
                        adjacency
    rows[M, Cd]  int32  the per-node row field intersected, M >= N (`nbr`
                        itself for whole-graph use)
    red[u] = sum over valid j < C of |rows[u, :C] ∩ rows[nbr[u, j], :C]|

u's own set is rows[u], never nbr[u]: on a mesh worker (`runtime.spmd`)
`nbr` holds local-frame ids into the shard followed by its halo buffer,
and `rows` holds the global ids the intersection compares.

with C = min(Cd, K) bounding both column axes, and the intersection
counted as a multiset (duplicate ids count as in the JAX package).  For an
undirected graph red[u] is twice the triangles through u.  The
"count_common" combine of `ops.COMBINES`: `core.algorithms.triangle_counts`.

Two variants compute the same integers, as in the JAX package; both are
exact for any slot order:

  "merge" (default)  the JAX package sorts each row of the field and probes
      it; `csrc/ell_triangles.cu` sorts nothing: it loads u's valid field
      entries into a hash table of (id, multiplicity) in shared memory and
      adds mult_u(y) for every valid entry y of each neighbour's row.
      Plain version: `neighbor_common_ell_plain`.
  "allpairs"  matches every id of u's row against every id of each
      neighbour's row, as given, with no sort and no table:
      `csrc/ell_allpairs.cu` (`common_allpairs_ell`), plain version
      `common_allpairs_ell_plain`.
      The JAX package keeps it as the yardstick of its kernel sweep.

Both kernels run one row split (`csrc/ell_pairs.cuh`): 8 lanes a short
row, a team of 8 warps for each row with many (neighbour, entry) pairs;
only the work per pair differs.

Row lengths: both variants take `deg` (optional, (N,) int32, each row's
count of valid nbr slots, a `GraphBlocks`' ``deg``).  It bounds the rows
of `nbr`; it bounds the rows of the field too only when `rows` is `nbr`
itself, the same memory with the same strides (`field_deg`), as for
whole-graph triangles, where `TriangleCountProgram.halo_field` hands over
`g.nbr`.  Any other field is read over its C columns.  The kernels stop
each row at its length, and a PAD met before it sends the row on to C, so
the result never depends on `deg`; the plain versions take it and do not
read it.

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
from .ell_hindex import check_deg, columns, deg_ptr, on_cuda

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
    """Raise unless nbr is a contiguous (N, Cd) int32 tensor and rows an
    (M, Cd) int32 tensor on its device with M >= N (a mesh worker's shard
    and halo rows, indexed by its local-frame `nbr`)."""
    if nbr.dim() != 2 or nbr.dtype != torch.int32 or not nbr.is_contiguous():
        raise ValueError("nbr must be a contiguous (N, Cd) int32 tensor")
    N, Cd = nbr.shape
    if rows.dim() != 2 or rows.shape[0] < N or rows.shape[1] != Cd \
            or rows.dtype != torch.int32 or rows.device != nbr.device:
        raise ValueError(f"rows must be a (>= {N}, {Cd}) int32 tensor on "
                         f"{nbr.device}, got {tuple(rows.shape)} {rows.dtype} "
                         f"on {rows.device}")


def neighbor_common_ell_plain(nbr: torch.Tensor, rows: torch.Tensor,
                              K: Optional[int] = None,
                              deg: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain PyTorch version: `ref.ell_common_ref` over the first C
    columns of both (sorted rows, searchsorted bounds, chunked).  `deg` is
    accepted and not read: the value does not depend on it."""
    C = columns(nbr.shape[1], K)
    return ref.ell_common_ref(nbr[:, :C], rows[:, :C])


def field_deg(nbr: torch.Tensor, rows: torch.Tensor,
              deg: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The row lengths of the field: `deg` when `rows` is `nbr` itself
    (the same memory, shape and strides, so the same rows), else None (the
    field's rows are read over their C columns)."""
    same = (rows.data_ptr() == nbr.data_ptr() and rows.shape == nbr.shape
            and rows.stride() == nbr.stride())
    return deg if same else None


def neighbor_common_ell(nbr: torch.Tensor, rows: torch.Tensor,
                        K: Optional[int] = None, variant: str = "merge",
                        deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Directed common-neighbor counts: (N,) int32.

    CUDA tensors launch the variant's CUDA kernel ("merge" bumps
    `neighbor_common_ell.launches`, "allpairs"
    `common_allpairs_ell.launches`); CPU tensors take its plain version.
    `deg` (optional, (N,) int32 row lengths of `nbr`) lets either kernel
    stop each row of `nbr`, and of the field when `rows` is `nbr`
    (`field_deg`), at its length; it never changes the result.
    """
    _check_variant(variant)
    if variant == "allpairs":
        return common_allpairs_ell(nbr, rows, K, deg)
    check_deg(nbr, deg)
    if not on_cuda(nbr, "neighbor_common_ell"):
        return neighbor_common_ell_plain(nbr, rows, K, deg)
    out = _launch("ell_triangles", nbr, rows, K, deg)
    neighbor_common_ell.launches += 1
    return out


def _launch(kernel: str, nbr: torch.Tensor, rows: torch.Tensor,
            K: Optional[int], deg: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch `kernel` on (nbr, rows, deg, the field's deg) into a new
    (N,) int32."""
    _check_rows(nbr, rows)
    fdeg = field_deg(nbr, rows, deg)
    rows = rows.contiguous()
    N, Cd = nbr.shape
    out = torch.empty(N, dtype=torch.int32, device=nbr.device)
    _build.launch(kernel, nbr.device, nbr.data_ptr(), rows.data_ptr(),
                  deg_ptr(deg), deg_ptr(fdeg), out.data_ptr(), N, Cd,
                  columns(Cd, K))
    return out


def common_allpairs_ell_plain(nbr: torch.Tensor, rows: torch.Tensor,
                              K: Optional[int] = None,
                              deg: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The "allpairs" variant's plain version: over row chunks, match every
    valid id of u's row against every valid id of each valid neighbour's
    row ((rows, C, C, C) at a time; PAD is any negative id).  `deg` is
    accepted and not read: the value does not depend on it."""
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
        # u's own rows only: the field may run past N (a mesh worker's halo)
        match = own[s:s + j.shape[0], None, :, None] == theirs[:, :, None, :]
        out[s:s + step] = match.sum(dim=(1, 2, 3)).to(torch.int32)
    return out


def common_allpairs_ell(nbr: torch.Tensor, rows: torch.Tensor,
                        K: Optional[int] = None,
                        deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`neighbor_common_ell(variant="allpairs")`: CUDA tensors launch
    `csrc/ell_allpairs.cu` on the rows as given (and bump
    `common_allpairs_ell.launches`), each row stopped at its length as
    "merge" stops it when `deg` is given; CPU tensors take
    `common_allpairs_ell_plain`."""
    check_deg(nbr, deg)
    if not on_cuda(nbr, "neighbor_common_ell"):
        return common_allpairs_ell_plain(nbr, rows, K, deg)
    out = _launch("ell_allpairs", nbr, rows, K, deg)
    common_allpairs_ell.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
neighbor_common_ell.launches = 0
common_allpairs_ell.launches = 0
