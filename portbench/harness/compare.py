"""The comparisons that decide `correct`: each gives one number, which is
held against its limit in the traffic file."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def slots(nbr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The program's rows as sorted directed keys ``row * N + id`` of
    every valid slot, and each row's count of valid slots."""
    N = nbr.shape[0]
    valid = nbr >= 0
    rows = torch.arange(N, device=nbr.device)[:, None].expand_as(nbr)
    keys = torch.sort(rows[valid] * N + nbr[valid].long()).values
    return keys, valid.sum(dim=1)


def edge_diff(prog: torch.Tensor, ref: torch.Tensor) -> int:
    """Directed slots on one side only, plus slots the program holds
    twice (`prog`, `ref`: sorted directed keys; `ref` has no repeats)."""
    uniq = torch.unique(prog)
    return int(prog.numel() - uniq.numel()
               + (~torch.isin(uniq, ref)).sum()
               + (~torch.isin(ref, uniq)).sum())


def count_diff(prog: torch.Tensor, ref: torch.Tensor) -> int:
    """Entries where two integer vectors differ (all, if shapes differ)."""
    if prog.shape != ref.shape:
        return max(prog.numel(), ref.numel())
    return int((prog.long() != ref.long()).sum())


def rel_err(prog: torch.Tensor, ref: torch.Tensor,
            mask: torch.Tensor) -> float:
    """Largest |prog - ref| / |ref| over `mask` (inf if shapes differ or
    a value is not finite)."""
    if prog.shape != ref.shape:
        return float("inf")
    p, r = prog[mask].double(), ref[mask].double()
    err = ((p - r).abs() / r.abs()).max()
    return float(err) if bool(torch.isfinite(err)) else float("inf")


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and at most its limit."""
    if set(numbers) != set(limits):
        raise KeyError(f"compared {sorted(numbers)} but limits are for "
                       f"{sorted(limits)}")
    table = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
             for k in numbers}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
