"""Distributed k-core decomposition — BLADYG application #1 (paper §4.1).

Algorithm: the locality-based distributed coreness computation of
[Montresor, De Pellegrini, Miorandi, TPDS'13], expressed as BLADYG
supersteps.  Each node keeps a coreness *estimate*; one superstep applies

    est' = min(est, H(est))        H(est)(u) = h-index of {est(v) : v ~ u}

est starts at the degree, H is monotone and H(core) = core, so the
pointwise non-increasing sequence converges, and its fixpoint is exactly
the coreness.  The same argument is *local*: clamping any set of nodes at
their true coreness and iterating only on the rest still converges to the
true coreness of the rest — that is what makes the incremental
maintenance in `kcore_dynamic.py` exact.

The H(est) primitive comes only through the kernel backend registry
(`repro_torch.kernels.ops`): ``backend="torch"|"ell"|"auto"``, all exact
and bit-identical; see `ops` for the sync policy of the fixpoint loop.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import ops
from .graph import GraphBlocks


def coreness_step(
    g: GraphBlocks, est: torch.Tensor, active: torch.Tensor,
    backend: str = "torch",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One BLADYG superstep on an `active` node mask; returns (est', changed)
    with `changed` a 0-dim bool tensor on the graph's device."""
    h = ops.hindex_blocks(g, est, backend=backend)
    new = torch.where(active & g.node_mask, torch.minimum(est, h), est)
    return new, (new != est).any()


def coreness(
    g: GraphBlocks, max_steps: int = 10_000, backend: str = "auto",
) -> torch.Tensor:
    """Coreness of every node (0 on padding rows), (N,) int32, via the
    chosen backend.  All backends return identical integers."""
    return ops.coreness_blocks(g, backend=backend, max_steps=max_steps)


def coreness_with_stats(
    g: GraphBlocks, max_steps: int = 10_000, backend: str = "torch",
) -> Tuple[torch.Tensor, int]:
    """Coreness plus the superstep count (a host int)."""
    return ops.coreness_blocks(g, backend=backend, max_steps=max_steps,
                               with_steps=True)


def max_coreness(g: GraphBlocks) -> int:
    return int(coreness(g).max())
