"""Plain PyTorch oracles for the ELL primitives.

The semantic ground truth the kernels are held to, and the ``"torch"``
backend of the `ops.py` registry (the counterpart of the JAX package's
``"jnp"``).  The h-index and frontier oracles are the kernels' own plain
versions, which live beside each kernel; nothing here imports
`repro_torch.core`.
"""
from __future__ import annotations

import torch

from .ell_frontier import frontier_step_ell_plain
from .ell_hindex import ell_gather, hindex_ell_plain, hindex_rows

__all__ = ["ell_gather", "hindex_rows", "ell_hindex_ref",
           "ell_frontier_hop_ref"]


def ell_hindex_ref(nbr: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """h-index of every node over the ELL adjacency (gather + row h-index)."""
    return hindex_ell_plain(nbr, est)


def ell_frontier_hop_ref(
    nbr: torch.Tensor, f: torch.Tensor, eligible: torch.Tensor,
    visited: torch.Tensor,
) -> torch.Tensor:
    """One masked BFS hop for R stacked frontiers over the ELL adjacency.

    nbr: (N, Cd) int32 (-1 padded); f, visited: (N, R) bool;
    eligible: (N, R) bool (per-frontier k-level masks).
    next[u, r] = (exists j: f[nbr[u, j], r]) & eligible[u, r] & ~visited[u, r]
    """
    return frontier_step_ell_plain(nbr, f, eligible, visited)
