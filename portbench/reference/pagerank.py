"""PageRank on the undirected graph, by its definition.

rank_0 = 1/n on the n real nodes; each step
rank'(u) = (1 - alpha)/n + alpha * sum over neighbours v of rank(v)/deg(v)
on real nodes (0 elsewhere; the mass of nodes without edges is not
redistributed).  A step is applied and counted, and the iteration stops
after the first step in which no node moved more than `tol`, or after
`max_steps` steps; with `tol` None it runs exactly `max_steps` steps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .graph import directed, degrees


def pagerank(keys: torch.Tensor, N: int, node_mask: torch.Tensor,
             alpha: float, tol: Optional[float], max_steps: int,
             dtype: torch.dtype = torch.float64) -> Tuple[torch.Tensor, int]:
    """((N,) ranks in `dtype`, steps taken)."""
    src, dst = directed(keys, N)
    deg = degrees(keys, N).to(dtype)
    n = int(node_mask.sum())
    zero = torch.zeros((), dtype=dtype, device=keys.device)
    rank = torch.where(node_mask, torch.full_like(deg, 1.0 / n), zero)
    steps = 0
    while steps < max_steps:
        contrib = torch.where(deg > 0, rank / deg.clamp(min=1), zero)
        total = torch.zeros_like(rank).index_add_(0, dst, contrib[src])
        new = torch.where(node_mask, (1.0 - alpha) / n + alpha * total, zero)
        moved = tol is None or bool(((new - rank).abs() > tol).any())
        rank, steps = new, steps + 1
        if not moved:
            break
    return rank, steps
