"""Triangles through every node, by looking up the closing edge.

For every edge (a, b) with a < b and every neighbour c of a with c > b,
(a, b, c) is a triangle exactly when (b, c) is an edge: each triangle is
found once, at its least two nodes' edge, and counted at all three.
"""
from __future__ import annotations

import torch

from .graph import _member, directed


def triangles(keys: torch.Tensor, N: int, wedges_per_block: int = 1 << 24
              ) -> torch.Tensor:
    """(N,) int64 count of triangles through each node, in blocks of
    about `wedges_per_block` wedges."""
    dev = keys.device
    src, dst = directed(keys, N)
    deg = torch.bincount(src, minlength=N)
    start = torch.cumsum(deg, 0) - deg
    count = torch.zeros(N, dtype=torch.int64, device=dev)
    step = max(1, wedges_per_block // max(1, int(deg.max())))
    for lo in range(0, keys.numel(), step):
        k = keys[lo:lo + step]
        a, b = k // N, k % N
        w = deg[a]   # one wedge (a, b, c) per slot c of a's row
        e = torch.repeat_interleave(torch.arange(k.numel(), device=dev), w)
        slot = (start[a] - (torch.cumsum(w, 0) - w))[e] \
            + torch.arange(e.numel(), device=dev)
        a, b, c = a[e], b[e], dst[slot]
        hit = (c > b) & _member(b * N + c, keys)
        for ends in (a[hit], b[hit], c[hit]):
            count += torch.bincount(ends, minlength=N)
    return count
