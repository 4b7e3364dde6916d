"""Connected components by hooking and pointer jumping.

Every node points at a parent; each round hooks, for every edge, the
larger of its endpoints' roots under the smaller, then jumps pointers
until every node points at a root.  Labels only fall and stay inside a
component, and the least id of a component is a root from the start, so
at the fixpoint every node is labelled with its component's least id.
"""
from __future__ import annotations

import torch

from .graph import directed


def component_labels(keys: torch.Tensor, N: int,
                     node_mask: torch.Tensor) -> torch.Tensor:
    """(N,) int64: each real node's component's least id; -1 on rows
    where `node_mask` is False."""
    src, dst = directed(keys, N)
    parent = torch.arange(N, device=keys.device)
    while True:
        a, b = parent[src], parent[dst]
        hooked = parent.clone()
        hooked.scatter_reduce_(0, torch.maximum(a, b), torch.minimum(a, b),
                               "amin")
        while True:
            jumped = hooked[hooked]
            if torch.equal(jumped, hooked):
                break
            hooked = jumped
        if torch.equal(hooked, parent):
            break
        parent = hooked
    return torch.where(node_mask, parent, -1)
