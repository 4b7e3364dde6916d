"""Fused multi-field ELL superstep (one nbr read): CUDA kernel and plain
version.

A `MultiProgram` (`core.engine`) advances several `BlockProgram`s in
lockstep, e.g. coreness + CC labels + PageRank in
`core.algorithms.fused_analytics`.  Run separately, every sub-program
re-reads the (N, Cd) adjacency; `neighbor_multi_ell` reads each nbr slot
once and serves 1 to 3 fields from it, each reduced by its combine:

    "min"     int32 field    row min,      INT32_MAX on an empty row
    "sum"     float32 field  row sum,      0.0 on an empty row
    "hindex"  int32 field    row h-index,  0 on an empty row

Each CUDA output is bit-identical to the port's standalone kernel for its
combine (`ell_cc`, `ell_pagerank`, `ell_hindex`), the float sum included:
`csrc/ell_multi.cu` runs the row tiers of `csrc/ell_rows.cuh`, as
`ell_cc` and `ell_pagerank` do, folds every slot of a row into the
accumulator of the lane the standalone kernel gives it and reduces through
the functions of `csrc/ell_reduce.cuh`, so every addition has the same
operands.  Likewise the plain version's outputs equal the standalone plain
versions'.

Row lengths: `deg` (optional, (N,) int32, each row's count of valid
slots, a `GraphBlocks`' ``deg``) lets the kernel stop each row at its
length, as `ell_hindex.hindex_ell` does; the result is the same, and the
plain version takes it and does not read it.

`neighbor_multi_ell` launches the CUDA kernel on CUDA tensors and runs
`neighbor_multi_ell_plain` on CPU tensors; any other device raises.  It
replaces the TPU kernel `neighbor_multi_ell` of the JAX package's
`kernels/ell_multi.py`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build, ref
from .ell_cc import MIN_FILL
from .ell_hindex import (
    check_deg, check_field, columns, deg_ptr, hindex_rows, on_cuda)

#: combines the fused kernel serves: (field dtype, PAD fill, kernel code)
FIELD_SPEC = {
    "min": (torch.int32, MIN_FILL, 0),
    "sum": (torch.float32, 0.0, 1),
    "hindex": (torch.int32, -1, 2),
}
MAX_FIELDS = 3


def _check_combines(fields: Sequence[torch.Tensor],
                    combines: Sequence[str]) -> None:
    if not 1 <= len(combines) <= MAX_FIELDS or len(fields) != len(combines):
        raise ValueError(f"need 1 to {MAX_FIELDS} fields, one per combine; "
                         f"got {len(fields)} fields for {tuple(combines)}")
    for c in combines:
        if c not in FIELD_SPEC:
            raise ValueError(f"combine {c!r} not fusable; expected one of "
                             f"{tuple(FIELD_SPEC)}")


def neighbor_multi_ell_plain(
    nbr: torch.Tensor, fields: Sequence[torch.Tensor],
    combines: Sequence[str], K: Optional[int] = None,
    deg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version: one clamp and validity mask of the first
    C columns, then each field's gather and row reduction.  `deg` is
    accepted and not read: the value does not depend on it."""
    _check_combines(fields, combines)
    sub = nbr[:, :columns(nbr.shape[1], K)]
    valid = sub >= 0
    idx = sub.clamp(min=0).long()
    outs = []
    for c, f in zip(combines, fields):
        dtype, fill, _ = FIELD_SPEC[c]
        vals = f.to(dtype)[idx]
        vals = torch.where(valid, vals, torch.full_like(vals, fill))
        if c == "min":
            outs.append(ref.min_rows(vals))
        elif c == "sum":
            outs.append(ref.sum_rows(vals))
        else:
            outs.append(hindex_rows(vals))
    return tuple(outs)


def neighbor_multi_ell(
    nbr: torch.Tensor, fields: Sequence[torch.Tensor],
    combines: Sequence[str], K: Optional[int] = None,
    deg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One (N,) reduction per field, off ONE read of `nbr`.

    fields: one (M,) tensor per combine, M >= N (int32 for "min"/"hindex",
    float32 for "sum"; longer than `nbr` on a mesh worker, whose rows
    index its shard followed by its halo buffer, `runtime.spmd`).  deg: optional (N,) int32 row lengths; they never change
    the result.  CUDA tensors launch the CUDA kernel (and bump
    `neighbor_multi_ell.launches`); CPU tensors take the plain version.
    """
    check_deg(nbr, deg)
    if not on_cuda(nbr, "neighbor_multi_ell"):
        return neighbor_multi_ell_plain(nbr, fields, combines, K, deg)
    _check_combines(fields, combines)
    for c, f in zip(combines, fields):
        check_field(nbr, f, FIELD_SPEC[c][0], f"{c!r} field", longer=True)
    N, Cd = nbr.shape
    k = len(combines)
    outs = tuple(torch.empty(N, dtype=FIELD_SPEC[c][0], device=nbr.device)
                 for c in combines)
    pad = [None] * (MAX_FIELDS - k)  # NULL for the unused slots
    ins = [f.data_ptr() for f in fields] + pad
    outp = [o.data_ptr() for o in outs] + pad
    codes = [FIELD_SPEC[c][2] for c in combines] + [0] * (MAX_FIELDS - k)
    # one argument each (MAX_FIELDS = 3), as `_build.SOURCES` declares them
    _build.launch("ell_multi", nbr.device, nbr.data_ptr(), deg_ptr(deg),
                  ins[0], ins[1], ins[2], outp[0], outp[1], outp[2],
                  codes[0], codes[1], codes[2], k, N, Cd, columns(Cd, K))
    neighbor_multi_ell.launches += 1
    return outs


#: kernel launches so far (the CPU path does not count)
neighbor_multi_ell.launches = 0
