"""Typed graph queries: batched gathers over an epoch snapshot.

Every query kind is answered for a whole same-kind batch at once: ONE
host->device copy of the batch's ids (pow2-padded, `BATCH_FLOOR` 8, so
the padded widths stay few), one gather on the snapshot's device, and
ONE device->host copy of the compact answers through `_to_host` —
queries never pull whole analytics vectors to the host.  Top-k widths
are pow2-bucketed the same way (`topk_bucket`).

The JAX package counts the jit traces of its query functions
(`query_trace_count`); the port has no counterpart: eager PyTorch traces
and compiles nothing, so there is nothing to count (as `kernels.ops` has
no `gather_trace_count`).

Addressing: node arguments are global padded ids of the SNAPSHOT's
epoch (the session's id space when the snapshot was cut; migrations make
later epochs' spaces differ — `EpochSnapshot.orig_id` maps back to input
ids).  Out-of-range ids are rejected at submit time by the server;
padding-row ids are legal and answer with the padding conventions
(core 0, degree 0, label -1).  A hub-split snapshot carries a host-side
`primary` map that queried ids resolve through (a replica row answers
with its hub's values) and a pre-merged `nbr_max` field that
`nbr_max_core` reads; on other snapshots both are None and the
resolution is a no-op.

Query kinds:

  core            — coreness of u                       -> int
  degree          — degree of u                          -> int
  nbr_max_core    — max coreness among u's neighbors     -> int (-1 if
                    isolated; exercises the (N, Cd) adjacency gather)
  same_component  — are u and v in one CC                -> bool
  topk_pagerank   — ids + ranks of the k highest-rank    -> ([ids], [ranks])
                    nodes, PageRank-descending; equal ranks list the
                    lower id first, as `jax.lax.top_k` does
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels.ops import _pow2_bucket
from .state import EpochSnapshot

#: every query kind the service answers (the server's bucket axis)
KINDS = ("core", "degree", "nbr_max_core", "same_component",
         "topk_pagerank")

#: smallest padded batch — tiny buckets would multiply the padded widths
BATCH_FLOOR = 8


class Query(NamedTuple):
    """One typed request; build via the constructors below."""

    kind: str
    u: int = 0
    v: int = 0
    k: int = 0


def core_of(u: int) -> Query:
    return Query("core", u=int(u))


def degree_of(u: int) -> Query:
    return Query("degree", u=int(u))


def nbr_max_core_of(u: int) -> Query:
    return Query("nbr_max_core", u=int(u))


def same_component(u: int, v: int) -> Query:
    return Query("same_component", u=int(u), v=int(v))


def topk_pagerank(k: int) -> Query:
    if k < 1:
        raise ValueError(f"topk_pagerank needs k >= 1, got {k}")
    return Query("topk_pagerank", k=int(k))


# ---------------------------------------------------------------------------
# The batch gathers — one per kind, on the snapshot's device.
# ---------------------------------------------------------------------------


def _batch_nbr_max_core(core: torch.Tensor, nbr: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """Max coreness over each queried node's neighbor row; -1 if none."""
    rows = nbr[ids]                          # (B, Cd)
    vals = torch.where(rows >= 0, core[rows.clamp(min=0).long()], -1)
    return vals.max(dim=1).values


def _batch_topk(rank: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(values, ids) of the k highest-rank nodes, rank-descending.

    `torch.topk` promises no order among equal values; a stable
    descending sort keeps equal ranks in id order, which is
    `jax.lax.top_k`'s order, down to which tied ids make the cut at k.
    """
    vals, ids = torch.sort(rank, descending=True, stable=True)
    return vals[:k], ids[:k]


def _to_host(x: torch.Tensor) -> np.ndarray:
    """THE device->host copy of a batch's compact answers (one per batch)."""
    return x.cpu().numpy()


def batch_bucket(n: int) -> int:
    """Padded batch width for an n-query batch (pow2, floor 8)."""
    return _pow2_bucket(n, floor=BATCH_FLOOR)


def topk_bucket(k: int, N: int) -> int:
    """Top-k width for a requested k (pow2-bucketed, capped at N)."""
    return min(_pow2_bucket(k, floor=BATCH_FLOOR), N)


def _pad_ids(cols: List[List[int]], B: int,
             device: torch.device) -> torch.Tensor:
    """(len(cols), B) int64 ids on `device`, zero-padded: one copy."""
    out = np.zeros((len(cols), B), np.int64)
    for i, vals in enumerate(cols):
        out[i, :len(vals)] = vals
    return torch.from_numpy(out).to(device)


def _resolve(snap: EpochSnapshot, ids: List[int]) -> List[int]:
    """Map queried ids through the hub-split primary map (host-side,
    no-op on unsplit snapshots)."""
    if snap.primary is None:
        return ids
    return [int(snap.primary[i]) for i in ids]


def run_batch(snap: EpochSnapshot, kind: str, queries: List[Query],
              k: int = 0) -> list:
    """Answer one same-kind batch against a snapshot.

    Pads to the pow2 bucket, gathers on the snapshot's device, pulls the
    compact answers with exactly ONE `_to_host`, and returns one python
    answer per query (ints/bools; `topk_pagerank` returns ([ids],
    [ranks]) sliced to each query's own k).  For `topk_pagerank` the
    caller passes the shared bucketed width `k` (`topk_bucket`); the
    server's bucketing guarantees every query in the batch fits it.
    """
    n = len(queries)
    if n == 0:
        return []
    if kind == "topk_pagerank":
        vals, ids = _batch_topk(snap.rank, k=k)
        # one copy: the float32 ranks travel as their int32 bit patterns
        both = _to_host(torch.cat([vals.view(torch.int32),
                                   ids.to(torch.int32)]))
        m = vals.numel()
        vals_h, ids_h = both[:m].view(np.float32), both[m:]
        return [(ids_h[:q.k].tolist(), vals_h[:q.k].tolist())
                for q in queries]
    B = batch_bucket(n)
    dev = snap.core.device
    us = _resolve(snap, [q.u for q in queries])
    if kind == "core":
        out = snap.core[_pad_ids([us], B, dev)[0]]
    elif kind == "degree":
        out = snap.deg[_pad_ids([us], B, dev)[0]]
    elif kind == "nbr_max_core":
        if snap.nbr_max is not None:  # hub-split: merged over the slices
            out = snap.nbr_max[_pad_ids([us], B, dev)[0]]
        else:
            out = _batch_nbr_max_core(snap.core, snap.nbr,
                                      _pad_ids([us], B, dev)[0])
    elif kind == "same_component":
        uv = _pad_ids([us, _resolve(snap, [q.v for q in queries])], B, dev)
        out = snap.labels[uv[0]] == snap.labels[uv[1]]
    else:
        raise ValueError(f"unknown query kind {kind!r}; expected {KINDS}")
    return _to_host(out)[:n].tolist()
