"""ELL neighbor-sum sweep (PageRank push): CUDA kernel and plain version.

    nbr[N, Cd]  int32    padded neighbor ids (-1 = empty slot)
    field[M]    float32  per-node contribution (rank[u] / deg[u]), M >= N
    out[u] = sum{field[v] : v in nbr[u, :C]},  C = min(Cd, K)

The field may have more rows than `nbr` (a mesh worker's shard followed
by its halo buffer, `runtime.spmd`): the ids in `nbr` index it.

PAD slots add 0.0; neighborless rows give 0.0.  The "sum" combine of
`ops.COMBINES`: each superstep of `core.algorithms.pagerank`.

`neighbor_sum_ell` launches the hand-written CUDA kernel
(`csrc/ell_pagerank.cu`) on CUDA tensors and runs the plain PyTorch
version, `neighbor_sum_ell_plain`, on CPU tensors; any other device
raises.  It replaces the TPU kernel `neighbor_sum_ell` of the JAX
package's `kernels/ell_pagerank.py`.  The kernel adds in a fixed order of
its own (lanes over slots, then a butterfly), so it is deterministic and
bit-equal to the "sum" output of `ell_multi.neighbor_multi_ell`, but
agrees with the plain version's `torch.sum` only to float32 rounding.

Row lengths: the kernel also takes `deg`, each row's count of valid slots
(a `GraphBlocks`' ``deg``).  With it a row stops once it has seen
min(deg[u], valid slots of its first C columns) valid slots, which on
left-filled rows is exactly ``nbr[u, :min(deg[u], C)]``; the result is
the same for any slot order, bit for bit.  The plain version takes `deg`
and does not need it.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .ell_hindex import check_deg, check_field, columns, deg_ptr, on_cuda


def neighbor_sum_ell_plain(
        nbr: torch.Tensor, field: torch.Tensor, K: Optional[int] = None,
        deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: gather the first C columns, row sum.
    `deg` is accepted and not read: the value does not depend on it."""
    C = columns(nbr.shape[1], K)
    return ref.ell_sum_ref(nbr[:, :C], field.to(torch.float32))


def neighbor_sum_ell(nbr: torch.Tensor, field: torch.Tensor,
                     K: Optional[int] = None,
                     deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-wise float32 sum of `field` over each row of `nbr`: (N,).

    CUDA tensors launch the CUDA kernel (and bump
    `neighbor_sum_ell.launches`); CPU tensors take `neighbor_sum_ell_plain`.
    `deg` (optional, (N,) int32, each row's valid slots) lets the kernel
    stop each row at its length; it never changes the result.
    """
    check_deg(nbr, deg)
    if not on_cuda(nbr, "neighbor_sum_ell"):
        return neighbor_sum_ell_plain(nbr, field, K, deg)
    check_field(nbr, field, torch.float32, "field", longer=True)
    N, Cd = nbr.shape
    out = torch.empty(N, dtype=torch.float32, device=nbr.device)
    _build.launch("ell_pagerank", nbr.device, nbr.data_ptr(),
                  field.data_ptr(), deg_ptr(deg), out.data_ptr(), N, Cd,
                  columns(Cd, K))
    neighbor_sum_ell.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
neighbor_sum_ell.launches = 0
