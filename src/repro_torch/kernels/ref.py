"""Plain PyTorch oracles for the ELL and dense primitives.

The semantic ground truth the kernels are held to, and the ``"torch"``
backend of the `ops.py` registry (the counterpart of the JAX package's
``"jnp"``).  The h-index and frontier oracles, ELL and dense, are the
kernels' own plain versions, which live beside each kernel; the
neighbor-combine oracles below are what the other kernels' plain versions
call; `ell_to_dense` builds the dense backend's adjacency.  Nothing here
imports `repro_torch.core`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ell_frontier import frontier_step_ell_plain
from .ell_hindex import ell_gather, hindex_ell_plain, hindex_rows
from .frontier import frontier_step_plain
from .kcore_hindex import hindex_counts_plain

__all__ = ["ell_gather", "hindex_rows", "ell_hindex_ref",
           "ell_frontier_hop_ref", "PAD_KEY", "key_sort_rows", "min_rows",
           "sum_rows", "common_rows", "combine_rows", "ell_min_ref",
           "ell_sum_ref", "ell_common_ref", "hindex_counts_ref",
           "frontier_step_ref", "coreness_dense_ref", "ell_to_dense"]

#: what a PAD slot is keyed to before a row sort: above every node id
PAD_KEY = torch.iinfo(torch.int32).max

#: elements of the (rows, C, C) probe tensors `ell_common_ref` holds at once
_COMMON_CHUNK = 1 << 22


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


def hindex_counts_ref(adj: torch.Tensor, est: torch.Tensor,
                      K: int) -> torch.Tensor:
    """h-index of every node from a dense 0/1 adjacency, capped at K:
    cnt[u, k-1] = #{v ~ u : est[v] >= k}, h[u] = sum_k [cnt[u, k-1] >= k].
    Exact for K >= max(est) + 1."""
    return hindex_counts_plain(adj, est, K)


def frontier_step_ref(adj: torch.Tensor, f: torch.Tensor,
                      eligible: torch.Tensor,
                      visited: torch.Tensor) -> torch.Tensor:
    """One BFS hop for R stacked frontiers over a dense adjacency:
    next[u, r] = (exists v ~ u: f[v, r]) & eligible[u] & ~visited[u, r],
    with eligible (N,) shared by the R columns."""
    return frontier_step_plain(adj, f, eligible, visited)


def coreness_dense_ref(adj: torch.Tensor,
                       max_steps: int = 10_000) -> torch.Tensor:
    """Full min-H coreness iteration on a dense adjacency (the oracle: one
    host read per superstep)."""
    deg = (adj > 0).sum(dim=1).to(torch.int32)
    K = int(deg.max()) + 1 if deg.numel() else 1
    est = deg
    for _ in range(max_steps):
        new = torch.minimum(est, hindex_counts_ref(adj, est, K))
        if torch.equal(new, est):
            break
        est = new
    return est


def ell_to_dense(nbr: torch.Tensor, N: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ELL adjacency (rows of padded neighbor ids) -> dense 0/1 (N, N) of
    `dtype`, built directly in that type (bfloat16 for the dense kernels:
    no float32 (N, N) intermediate, which would be 10 GB at N = 50,048).
    Each valid slot writes 1, so a duplicate id gives 1, not 2 (the JAX
    package's scatter-max)."""
    rows, C = nbr.shape
    N = rows if N is None else int(N)
    dense = torch.zeros((rows, N), dtype=dtype, device=nbr.device)
    u, j = torch.nonzero(nbr >= 0, as_tuple=True)
    dense[u, nbr[u, j].long()] = 1
    return dense


# ---------------------------------------------------------------------------
# Neighbor-combine oracles (the BlockProgram reductions of `ops.COMBINES`).
# The *_rows forms reduce already-gathered (n, Cd, ...) neighbor values; the
# ell_* forms bundle the ELL gather for whole-graph use.
# ---------------------------------------------------------------------------


def _fill(dtype: torch.dtype) -> float:
    """The min combine's absorbing fill: the dtype's max (inf for floats)."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def min_rows(vals: torch.Tensor) -> torch.Tensor:
    """Row-wise min of gathered neighbor values: (n, Cd) -> (n,).

    PAD slots must already hold an absorbing fill (int32 max for the CC
    label exchange); a row with no column at all gives that fill.
    """
    if vals.shape[-1] == 0:
        return torch.full(vals.shape[:-1], _fill(vals.dtype), dtype=vals.dtype,
                          device=vals.device)
    return vals.amin(dim=-1)


def sum_rows(vals: torch.Tensor) -> torch.Tensor:
    """Row-wise sum of gathered neighbor values (PAD slots hold 0)."""
    return vals.sum(dim=-1, dtype=vals.dtype)


def common_rows(own_rows: torch.Tensor, nb_rows: torch.Tensor) -> torch.Tensor:
    """Directed common-neighbor counts: ((n, Cd), (n, Cd, Cd)) -> (n,) int32.

    own_rows[u] is u's padded neighbor list; nb_rows[u, j] is the padded
    list of u's j-th neighbor (-1 = PAD never matches).  Materializes the
    (n, Cd, Cd, Cd) match tensor, as the JAX package's form does: for small
    inputs only (`ell_common_ref` is the chunked whole-graph form).
    """
    own = own_rows[:, None, :, None]
    nb = nb_rows[:, :, None, :]
    match = (own == nb) & (own >= 0) & (nb >= 0)
    return match.sum(dim=(1, 2, 3)).to(torch.int32)


def combine_rows(combine: str, field: torch.Tensor,
                 nb_vals: torch.Tensor) -> torch.Tensor:
    """Reduce already-gathered neighbor values by combine name.

    field: (n, ...) this node's own values; nb_vals: (n, Cd, ...) the
    neighbors' values with PAD slots holding the combine's absorbing fill.
    """
    if combine == "min":
        return min_rows(nb_vals)
    if combine == "sum":
        return sum_rows(nb_vals)
    if combine == "hindex":
        return hindex_rows(nb_vals)
    if combine == "count_common":
        return common_rows(field, nb_vals)
    raise ValueError(f"unknown combine {combine!r}")


def _gather(nbr: torch.Tensor, field: torch.Tensor, fill) -> torch.Tensor:
    vals = field[nbr.clamp(min=0).long()]
    return torch.where(nbr >= 0, vals, torch.full_like(vals, fill))


def ell_min_ref(nbr: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """Gather + row-min over the ELL adjacency (PAD -> dtype max)."""
    return min_rows(_gather(nbr, field, _fill(field.dtype)))


def ell_sum_ref(nbr: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """Gather + row-sum over the ELL adjacency (PAD -> 0)."""
    return sum_rows(_gather(nbr, field, 0))


def key_sort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Key PAD (any negative id) to `PAD_KEY` and sort each row ascending."""
    keyed = torch.where(rows >= 0, rows, torch.full_like(rows, PAD_KEY))
    return torch.sort(keyed, dim=1).values


def ell_common_ref(nbr: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Common-neighbor counts over the ELL adjacency: (N,) int32,

        red[u] = sum over valid slots j of |rows[u] ∩ rows[nbr[u, j]]|

    counted as a multiset intersection (duplicate ids count as in the JAX
    package's all-pairs match).  `rows` is the (N, Cr) row field (`nbr`
    itself for whole-graph use).  Rows are keyed and sorted once; then,
    over chunks of rows, every element of u's row is located in each
    neighbor's sorted row by a lower and an upper `searchsorted`, whose
    difference is its count there.  Memory is O(chunk * C * Cr), never
    the (N, C, Cr, Cr) match tensor of `common_rows`.
    """
    N, C = nbr.shape
    keyed = key_sort_rows(rows)
    Cr = keyed.shape[1]
    own_ok = keyed != PAD_KEY
    out = torch.zeros(N, dtype=torch.int32, device=nbr.device)
    step = max(1, _COMMON_CHUNK // max(1, C * Cr))
    for s in range(0, N, step):
        nb = nbr[s:s + step]
        v_rows = keyed[nb.clamp(min=0).long()]                  # (b, C, Cr)
        own = keyed[s:s + step, None, :].expand_as(v_rows).contiguous()
        lo = torch.searchsorted(v_rows, own)
        hi = torch.searchsorted(v_rows, own, right=True)
        occ = torch.where(own_ok[s:s + step, None, :], hi - lo, 0).sum(dim=2)
        out[s:s + step] = torch.where(nb >= 0, occ, 0).sum(dim=1).to(
            torch.int32)
    return out
