"""Edge sets as sorted undirected keys, and the replay of updates."""
from __future__ import annotations

from typing import Tuple

import torch


def directed(keys: torch.Tensor, N: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of every edge, sorted by (src, dst): (src, dst)."""
    lo, hi = keys // N, keys % N
    d = torch.sort(torch.cat([lo * N + hi, hi * N + lo])).values
    return d // N, d % N


def degrees(keys: torch.Tensor, N: int) -> torch.Tensor:
    lo, hi = keys // N, keys % N
    return torch.bincount(torch.cat([lo, hi]), minlength=N)


def _member(x: torch.Tensor, sorted_keys: torch.Tensor) -> torch.Tensor:
    if sorted_keys.numel() == 0:
        return torch.zeros_like(x, dtype=torch.bool)
    i = torch.searchsorted(sorted_keys, x).clamp(max=sorted_keys.numel() - 1)
    return sorted_keys[i] == x


def replay(keys: torch.Tensor, updates: torch.Tensor, N: int) -> torch.Tensor:
    """The edge set after `updates` ((k, 3) rows ``(u, v, op)``, op +1
    insert, -1 delete) in order, as sorted keys.

    Exact for any sequence in which no pair occurs twice (each update
    then acts on the set as it was before the stream); raises on a pair
    that repeats, an insert of a present edge or a delete of an absent
    one, or a self loop."""
    u, v, op = updates[:, 0], updates[:, 1], updates[:, 2]
    if bool((u == v).any()):
        raise ValueError("self loop in the updates")
    k = torch.minimum(u, v) * N + torch.maximum(u, v)
    if torch.unique(k).numel() != k.numel():
        raise ValueError("a pair occurs twice in the updates")
    present = _member(k, keys)
    if bool((present & (op > 0)).any()) or bool((~present & (op < 0)).any()):
        raise ValueError("an insert of a present edge or a delete of an "
                         "absent one")
    kept = keys[~_member(keys, torch.sort(k[op < 0]).values)]
    return torch.sort(torch.cat([kept, k[op > 0]])).values
