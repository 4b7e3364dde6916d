"""ELL neighbor-min sweep (label propagation): CUDA kernel and plain version.

    nbr[N, Cd]  int32   padded neighbor ids (-1 = empty slot)
    field[M]    int32   current labels, M >= N
    out[u] = min{field[v] : v in nbr[u, :C]},  C = min(Cd, K)

The field may have more rows than `nbr` (a mesh worker's shard followed
by its halo buffer, `runtime.spmd`): the ids in `nbr` index it.

PAD slots and neighborless rows give INT32_MAX (`MIN_FILL`, the min
combine's absorbing fill); `BlockProgram.update` takes min(own, out), so
the fill is harmless.  The "min" combine of `ops.COMBINES`: each superstep
of `core.algorithms.connected_components`.

`neighbor_min_ell` launches the hand-written CUDA kernel (`csrc/ell_cc.cu`)
on CUDA tensors and runs the plain PyTorch version,
`neighbor_min_ell_plain`, on CPU tensors; any other device raises.  It
replaces the TPU kernel `neighbor_min_ell` of the JAX package's
`kernels/ell_cc.py`.  K as in `ell_hindex`: any K >= max degree is exact on
left-filled rows; K = None reads all Cd columns, any slot order.

Row lengths: the kernel also takes `deg`, each row's count of valid slots
(a `GraphBlocks`' ``deg``).  With it a row stops once it has seen
min(deg[u], valid slots of its first C columns) valid slots, which on
left-filled rows is exactly ``nbr[u, :min(deg[u], C)]``; the result is
the same for any slot order.  The plain version takes `deg` and does not
need it.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .ell_hindex import check_deg, check_field, columns, deg_ptr, on_cuda

#: what PAD slots and neighborless rows give
MIN_FILL = torch.iinfo(torch.int32).max


def neighbor_min_ell_plain(
        nbr: torch.Tensor, field: torch.Tensor, K: Optional[int] = None,
        deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: gather the first C columns, row min.
    `deg` is accepted and not read: the value does not depend on it."""
    C = columns(nbr.shape[1], K)
    return ref.ell_min_ref(nbr[:, :C], field.to(torch.int32))


def neighbor_min_ell(nbr: torch.Tensor, field: torch.Tensor,
                     K: Optional[int] = None,
                     deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-wise min of `field` over each row of `nbr`: (N,) int32.

    CUDA tensors launch the CUDA kernel (and bump
    `neighbor_min_ell.launches`); CPU tensors take `neighbor_min_ell_plain`.
    `deg` (optional, (N,) int32, each row's valid slots) lets the kernel
    stop each row at its length; it never changes the result.
    """
    check_deg(nbr, deg)
    if not on_cuda(nbr, "neighbor_min_ell"):
        return neighbor_min_ell_plain(nbr, field, K, deg)
    check_field(nbr, field, torch.int32, "field", longer=True)
    N, Cd = nbr.shape
    out = torch.empty(N, dtype=torch.int32, device=nbr.device)
    _build.launch("ell_cc", nbr.device, nbr.data_ptr(), field.data_ptr(),
                  deg_ptr(deg), out.data_ptr(), N, Cd, columns(Cd, K))
    neighbor_min_ell.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
neighbor_min_ell.launches = 0
