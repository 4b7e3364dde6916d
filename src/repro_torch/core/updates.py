"""Incremental-change plumbing: update batches, scenario sampling, checks.

A deterministic sampler produces the two experimental scenarios of the
paper's §5.2.1:

  * inter-partition — endpoints in *different* blocks,
  * intra-partition — endpoints in *the same* block,

for both insertions (non-adjacent pairs) and deletions (existing edges).
The samplers draw from explicit `np.random.default_rng` generators in the
same order as the JAX package, so both packages sample the same updates
from the same seed.  `apply_updates_host` is the checked host boundary:
capacity / duplicate / existence validation happens here, never on the
device path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..tracing import SYNC, VALIDATE, span
from .graph import (  # noqa: F401 (insert_edge, delete_edge: re-export)
    PAD, CapacityError, GraphBlocks, delete_edge, insert_edge)

Update = Tuple[int, int, int]  # (u, v, op)  op=+1 insert, -1 delete


def classify(g: GraphBlocks, u: int, v: int) -> str:
    return "intra" if (u // g.Cn) == (v // g.Cn) else "inter"


def _real_nodes_by_block(g: GraphBlocks) -> List[np.ndarray]:
    mask = g.node_mask.cpu().numpy()
    ids = np.arange(g.N)
    return [ids[(ids // g.Cn == b) & mask] for b in range(g.P)]


def _adjacent(nbr_np: np.ndarray, u: int, v: int) -> bool:
    return bool((nbr_np[u] == v).any())


def sample_insertions(
    g: GraphBlocks, count: int, scenario: str, seed: int = 0
) -> List[Update]:
    """Sample `count` non-adjacent node pairs for insertion.

    scenario: 'intra' -> same block, 'inter' -> different blocks.
    """
    rng = np.random.default_rng(seed)
    nbr_np = g.nbr.cpu().numpy()
    by_block = _real_nodes_by_block(g)
    nonempty = [b for b in range(g.P) if len(by_block[b]) >= 1]
    out: List[Update] = []
    taken: set = set()
    guard = 0
    while len(out) < count:
        guard += 1
        if guard > count * 1000:
            raise RuntimeError(f"could not sample {count} {scenario} insertions")
        if scenario == "intra":
            b = int(rng.choice([b for b in nonempty if len(by_block[b]) >= 2]))
            u, v = rng.choice(by_block[b], size=2, replace=False)
        else:
            b1, b2 = rng.choice(nonempty, size=2, replace=False)
            u = int(rng.choice(by_block[b1]))
            v = int(rng.choice(by_block[b2]))
        u, v = int(u), int(v)
        key = (min(u, v), max(u, v))
        if u == v or key in taken or _adjacent(nbr_np, u, v):
            continue
        taken.add(key)
        out.append((u, v, +1))
    return out


def sample_deletions(
    g: GraphBlocks, count: int, scenario: str, seed: int = 0
) -> List[Update]:
    """Sample `count` existing edges to delete, by scenario."""
    rng = np.random.default_rng(seed)
    nbr_np = g.nbr.cpu().numpy()
    src = np.repeat(np.arange(g.N), g.Cd)
    dst = nbr_np.reshape(-1)
    ok = (dst >= 0) & (src < dst)
    src, dst = src[ok], dst[ok]
    same = (src // g.Cn) == (dst // g.Cn)
    pick = same if scenario == "intra" else ~same
    src, dst = src[pick], dst[pick]
    if len(src) < count:
        raise RuntimeError(
            f"only {len(src)} {scenario} edges available, need {count}"
        )
    idx = rng.choice(len(src), size=count, replace=False)
    return [(int(src[i]), int(dst[i]), -1) for i in idx]


def _insert_sorted(nbr: np.ndarray, deg: np.ndarray, u: int, v: int) -> None:
    """Splice v into row u at its sorted position (sorted-ELL invariant)."""
    d = deg[u]
    pos = int(np.searchsorted(nbr[u, :d], v))
    nbr[u, pos + 1:d + 1] = nbr[u, pos:d]
    nbr[u, pos] = v
    deg[u] += 1


def _delete_sorted(nbr: np.ndarray, deg: np.ndarray, u: int, v: int) -> None:
    """Remove v from row u, shifting left over the hole (invariant kept)."""
    d = deg[u]
    pos = int(np.searchsorted(nbr[u, :d], v))
    nbr[u, pos:d - 1] = nbr[u, pos + 1:d]
    nbr[u, d - 1] = PAD
    deg[u] -= 1


def _apply_checked(nbr: np.ndarray, deg: np.ndarray, N: int, Cd: int,
                   updates: List[Update], row=None) -> None:
    """Validate and apply `updates` to host rows, in place.

    `row` maps a global id to its row of `nbr` / `deg`; None is the
    identity (the whole arrays).  Messages give global ids."""
    at = (lambda x: x) if row is None else row.__getitem__
    for u, v, op in updates:
        if not (0 <= u < N and 0 <= v < N):
            # negative ids would silently wrap under numpy/torch indexing
            raise ValueError(f"update ({u},{v}) out of range [0, {N})")
        if u == v:
            # the device insert_edge/delete_edge assume no self-loops
            raise ValueError(f"self-loop update ({u},{v}) rejected")
        ru, rv = at(u), at(v)
        if op > 0:
            if (nbr[ru] == v).any():
                raise ValueError(f"edge ({u},{v}) already present")
            if deg[ru] >= Cd or deg[rv] >= Cd:
                raise CapacityError(
                    f"degree capacity Cd={Cd} exceeded at ({u},{v})")
            _insert_sorted(nbr, deg, ru, v)
            _insert_sorted(nbr, deg, rv, u)
        else:
            if not (nbr[ru] == v).any():
                raise ValueError(f"edge ({u},{v}) not present")
            _delete_sorted(nbr, deg, ru, v)
            _delete_sorted(nbr, deg, rv, u)


def validate_updates(g: GraphBlocks, updates: List[Update]) -> None:
    """Raise on the first update that `apply_updates_host` would reject
    (out of range, self-loop, duplicate insert, missing delete, capacity
    overflow), replaying the batch on a host copy of the rows it touches
    and discarding the result.

    Only the endpoints' rows cross to the host: gathered on the device
    and read in one copy of (k, Cd + 1) values, k <= 2 * len(updates).
    The endpoints gathered are those of the updates before the first one
    that fails without a row (out of range, self-loop); the replay stops
    there or earlier, and an out-of-range id never indexes the device."""
    updates = list(updates)
    with span(VALIDATE):
        ends = set()
        for u, v, _ in updates:
            if not (0 <= u < g.N and 0 <= v < g.N) or u == v:
                break
            ends.update((u, v))
        ids = sorted(ends)
        rows = np.zeros((0, g.Cd + 1), np.int32)
        if ids:
            idx = torch.tensor(ids, dtype=torch.long, device=g.device)
            both = torch.cat([g.nbr.index_select(0, idx),
                              g.deg.index_select(0, idx)[:, None]], dim=1)
            with span(SYNC):
                rows = both.cpu().numpy()
        _apply_checked(rows[:, :g.Cd], rows[:, g.Cd], g.N, g.Cd, updates,
                       row={x: i for i, x in enumerate(ids)})


def apply_updates_host(g: GraphBlocks, updates: List[Update]) -> GraphBlocks:
    """Apply updates with host-side validation (capacity, dup, existence).

    Returns a new graph on `g`'s device; `g` is left as it was.  Produces
    the same sorted canonical rows as the device `insert_edge` /
    `delete_edge` path, so replaying a batch through either path yields
    bit-identical `nbr` arrays.
    """
    deg = g.deg.cpu().numpy().copy()
    nbr = g.nbr.cpu().numpy().copy()
    _apply_checked(nbr, deg, g.N, g.Cd, list(updates))
    return dataclasses.replace(
        g, nbr=torch.as_tensor(nbr).to(g.device),
        deg=torch.as_tensor(deg.astype(np.int32)).to(g.device))
