"""Degree computation + incremental maintenance — the paper's running example
(§3.2, Figs. 4-6), expressed as a BladygProgram.

Step 1 (static): every worker computes the degree of its block's nodes in
parallel (Local mode) and reports completion (W2M).
Step 2 (dynamic): for an inserted/deleted edge (u, v) the master sends M2W
directives to the blocks of u and v, which bump the two degrees and notify
back (the MSG1/MSG2 exchange of Fig. 5).

Everything runs on the device of the graph (or degree tensor) it is given.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .engine import BladygProgram, Mode
from .graph import GraphBlocks


class DegreeProgram(BladygProgram):
    modes = Mode.LOCAL | Mode.W2M

    def worker_compute(self, g: GraphBlocks, wstate, directive) -> Tuple[Any, Any]:
        # Local: degree = #valid neighbor slots (deg is authoritative, but
        # we recompute from adjacency to exercise the data path).
        deg = (g.nbr >= 0).sum(dim=1).to(torch.int32)
        per_block_done = torch.ones(g.P, dtype=torch.bool, device=g.device)
        return deg, per_block_done

    def master_compute(self, mstate, summary):
        halt = summary.all()
        return mstate, None, halt


def compute_degrees(g: GraphBlocks) -> torch.Tensor:
    """Static degree of every node, (N,) int32 (padding rows -> 0)."""
    deg, _ = DegreeProgram().worker_compute(g, None, None)
    return torch.where(g.node_mask, deg, 0)


def _bump(deg: torch.Tensor, u, v, d: int) -> torch.Tensor:
    out = deg.clone()  # a new tensor: the caller's `deg` is never written
    out[u] += d
    out[v] += d
    return out


def maintain_degrees_insert(deg: torch.Tensor, u, v) -> torch.Tensor:
    """The master's M2W directive for an inserted edge: bump deg[u], deg[v]."""
    return _bump(deg, u, v, 1)


def maintain_degrees_delete(deg: torch.Tensor, u, v) -> torch.Tensor:
    return _bump(deg, u, v, -1)
