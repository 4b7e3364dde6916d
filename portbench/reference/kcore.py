"""Coreness by peeling (Batagelj and Zaversnik's order, in rounds).

At level k every node of remaining degree <= k is removed, round after
round, and gets coreness k; then k rises to the least remaining degree.
"""
from __future__ import annotations

import torch

from .graph import directed, degrees


def coreness(keys: torch.Tensor, N: int) -> torch.Tensor:
    """(N,) int64 coreness of every node of the edge set (0 for nodes
    without edges)."""
    src, dst = directed(keys, N)
    deg = degrees(keys, N)
    alive = deg > 0
    core = torch.zeros(N, dtype=torch.int64, device=keys.device)
    k = 0
    while bool(alive.any()):
        k = max(k, int(deg[alive].min()))
        while True:
            gone = alive & (deg <= k)
            if not bool(gone.any()):
                break
            core[gone] = k
            alive &= ~gone
            lost = gone[src]
            deg -= torch.bincount(dst[lost], minlength=N)
    return core
