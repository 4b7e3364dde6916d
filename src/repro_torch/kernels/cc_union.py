"""Connected-component labels by union-find: CUDA kernel and plain version.

    nbr[N, Cd]    int32  padded neighbor ids (-1 = empty slot)
    deg[N]        int32  each row's count of valid slots
    node_mask[N]  bool   real rows
    out[u] = the least padded id of u's component on a real row, else -1

on an undirected graph (v in row u iff u in row v) whose padding rows have
no slots, as every `GraphBlocks`: what `core.algorithms.
connected_components` returns, bit for bit, in one pass over the slots
instead of one superstep per hop of the least id's eccentricity.

`union_find_labels` launches the hand-written CUDA kernel
(`csrc/cc_union.cu`, ECL-CC's init, hook and finalize: Jaiganesh and
Burtscher, HPDC 2018) on CUDA tensors and runs the plain PyTorch version,
`union_find_labels_plain`, on CPU tensors; any other device raises.  The
kernel reads no value back to the host and keeps no convergence flag: its
three launches are fixed.  Its hooks always put the larger root under the
smaller, so each root ends as its tree's least id whatever the order of
the atomics, and the output is the same on every run.

It replaces no TPU kernel: the JAX package labels components only by
min-label propagation (`neighbor_min_ell` supersteps), which the port keeps
for `connected_components`, whose superstep count is the JAX package's.
The stream session's label recompute on one device
(`runtime.stream.StreamSession`) takes this instead.

The plain version hooks every edge's larger root under its smaller one
(a scatter-min over the edges), then jumps pointers until every node
points at a root, and repeats until nothing moves; it reads `deg` not at
all, since it takes every valid slot of every row.  Each test of a round
is a host read, made under a `bladyg.sync` span.
"""
from __future__ import annotations

import torch

from . import _build
from .ell_hindex import check_deg, check_field, on_cuda
from ..tracing import SYNC, span


def _check_mask(nbr: torch.Tensor, node_mask: torch.Tensor) -> None:
    if (node_mask.shape != nbr.shape[:1] or node_mask.dtype != torch.bool
            or node_mask.device != nbr.device
            or not node_mask.is_contiguous()):
        raise ValueError(f"node_mask must be a contiguous ({nbr.shape[0]},) "
                         f"bool tensor on {nbr.device}, got "
                         f"{tuple(node_mask.shape)} {node_mask.dtype}")


def union_find_labels_plain(nbr: torch.Tensor, deg: torch.Tensor,
                            node_mask: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: hooking and pointer jumping to a
    fixpoint over every valid slot; (N,) int32.  `deg` is accepted and
    not read."""
    N, Cd = nbr.shape
    rows = torch.arange(N, device=nbr.device)
    # every slot an edge; a PAD slot joins its row to itself, which hooks
    # nothing
    src = rows[:, None].expand(N, Cd).reshape(-1)
    dst = torch.where(nbr >= 0, nbr.long(), rows[:, None]).reshape(-1)
    parent = torch.arange(N, device=nbr.device)
    while True:
        a, b = parent[src], parent[dst]
        hooked = parent.scatter_reduce(0, torch.maximum(a, b),
                                       torch.minimum(a, b), "amin")
        while True:
            jumped = hooked[hooked]
            with span(SYNC):
                done = torch.equal(jumped, hooked)
            if done:
                break
            hooked = jumped
        with span(SYNC):
            done = torch.equal(hooked, parent)
        if done:
            break
        parent = hooked
    return torch.where(node_mask, parent, -1).to(torch.int32)


def union_find_labels(nbr: torch.Tensor, deg: torch.Tensor,
                      node_mask: torch.Tensor) -> torch.Tensor:
    """Each real row's component's least padded id, -1 on padding rows:
    (N,) int32.

    CUDA tensors launch `csrc/cc_union.cu` (and bump
    `union_find_labels.launches`): `nbr` a contiguous (N, Cd) int32
    tensor, `deg` its rows' valid slots ((N,) int32, read to bound each
    row), `node_mask` (N,) bool.  CPU tensors take
    `union_find_labels_plain`.  Both give the same integers.
    """
    if deg is None:
        raise ValueError("union_find_labels reads each row up to its "
                         "length: pass deg")
    check_deg(nbr, deg)
    _check_mask(nbr, node_mask)
    if not on_cuda(nbr, "union_find_labels"):
        return union_find_labels_plain(nbr, deg, node_mask)
    check_field(nbr, deg, name="deg")
    N, Cd = nbr.shape
    parent = torch.empty(N, dtype=torch.int32, device=nbr.device)
    out = torch.empty(N, dtype=torch.int32, device=nbr.device)
    _build.launch("cc_union", nbr.device, nbr.data_ptr(), deg.data_ptr(),
                  node_mask.data_ptr(), parent.data_ptr(), out.data_ptr(), N,
                  Cd)
    union_find_labels.launches += 1
    return out


#: kernel launches so far (the CPU path does not count)
union_find_labels.launches = 0
