"""Block-partitioned graph representation, as PyTorch tensors.

The paper's *block* (a connected subgraph held by one worker) becomes a
fixed-capacity, padded slice of the node axis:

- Nodes are **relabeled block-contiguously**: block ``b`` owns the global
  padded index range ``[b*Cn, (b+1)*Cn)``, so ``block_of(u) = u // Cn``.
- Adjacency is **ELL-padded**: ``nbr[N, Cd]`` holds global padded neighbor
  ids, ``-1`` for padding.  Undirected edges are stored twice (once per
  endpoint), matching the degree semantics of the paper.
- Rows obey the **sorted-ELL invariant**: the valid slots of every row are
  in strictly ascending id order and the ``-1`` pads sit on the right
  (``nbr[u, :deg[u]]`` ascending, ``nbr[u, deg[u]:] == PAD``).
  `build_blocks`, `build_ell_random`, `insert_edge`, `delete_edge` and
  `updates.apply_updates_host` all keep it, so the host and device update
  paths produce bit-identical arrays, and the kernels may bound the
  columns they read by the max degree (`kernels.ops.degree_bound`).
- Capacity overflow is checked at the host boundary (`build_blocks`,
  `updates.apply_updates_host`) and raises; the device path never
  reallocates.

Public tensors keep the JAX package's dtypes: ``nbr``, ``deg`` and
``orig_id`` are int32, ``node_mask`` is bool.  `GraphBlocks.from_numpy` /
`to_numpy` carry a graph across from and back to the JAX package's
`GraphBlocks` fields.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

PAD = -1  # padding sentinel for neighbor slots / node ids

#: sort key for PAD slots — larger than any node id, so an ascending sort
#: leaves valid ids first (in order) and pads on the right
_PAD_KEY = np.iinfo(np.int32).max

#: the four per-node arrays a graph carries, in the JAX package's names
FIELDS = ("nbr", "deg", "node_mask", "orig_id")


class CapacityError(ValueError):
    """An operation needs more node (Cn) or degree (Cd) capacity than the
    blocks hold."""


def sort_nbr_rows(nbr: np.ndarray) -> np.ndarray:
    """Canonicalize ELL rows to the sorted-ELL invariant (host-side).

    Maps pads to +inf (int32 max), sorts each row ascending, and maps the
    pads back — valid slots end up ascending with pads on the right.  A
    no-op on rows that already satisfy the invariant.
    """
    keyed = np.where(nbr >= 0, nbr, _PAD_KEY)
    keyed = np.sort(keyed, axis=-1)
    return np.where(keyed == _PAD_KEY, PAD, keyed).astype(nbr.dtype)


@dataclasses.dataclass
class GraphBlocks:
    """A block-partitioned undirected graph with static capacities.

    Attributes
    ----------
    nbr:       (P*Cn, Cd) int32 — padded neighbor lists (global padded ids).
    deg:       (P*Cn,)    int32 — true degree of each node (0 for padding).
    node_mask: (P*Cn,)    bool  — True for real nodes.
    orig_id:   (P*Cn,)    int32 — original node id (PAD for padding rows).
    P, Cn, Cd: ints — #blocks, node capacity / block, degree capacity.

    All four tensors live on one device, `device`.
    """

    nbr: torch.Tensor
    deg: torch.Tensor
    node_mask: torch.Tensor
    orig_id: torch.Tensor
    P: int
    Cn: int
    Cd: int

    @property
    def N(self) -> int:
        """Padded node count (P*Cn)."""
        return self.P * self.Cn

    @property
    def device(self) -> torch.device:
        return self.nbr.device

    @property
    def n_real(self) -> int:
        return int(self.node_mask.sum())

    @property
    def m_real(self) -> int:
        return int(self.deg.sum()) // 2

    def edge_cut(self) -> int:
        """Number of undirected edges crossing blocks."""
        own = (torch.arange(self.N, device=self.device) // self.Cn)[:, None]
        cross = (torch.div(self.nbr, self.Cn, rounding_mode="floor") != own) \
            & (self.nbr >= 0)
        return int(cross.sum()) // 2

    def clone(self) -> "GraphBlocks":
        """Deep copy: the update paths write rows in place."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).clone() for f in FIELDS})

    @classmethod
    def from_numpy(cls, arrays, P: int, Cn: int, Cd: int,
                   device: DeviceLike = None) -> "GraphBlocks":
        """Build from arrays named as `FIELDS` (a mapping, or any object
        with those attributes, such as the JAX package's graph).  The
        tensors are copies: the update paths write them in place."""
        get = arrays.__getitem__ if isinstance(arrays, dict) else \
            (lambda k: getattr(arrays, k))
        dev = resolve_device(device)
        dtypes = dict(nbr=np.int32, deg=np.int32, node_mask=bool,
                      orig_id=np.int32)
        return cls(
            **{f: torch.from_numpy(np.array(get(f), dt, copy=True)).to(dev)
               for f, dt in dtypes.items()},
            P=int(P), Cn=int(Cn), Cd=int(Cd),
        )

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The four arrays as host numpy, keyed by `FIELDS`."""
        return {f: getattr(self, f).cpu().numpy() for f in FIELDS}


def halo_slot_counts(g: GraphBlocks) -> Tuple[int, int]:
    """(intra, inter) valid neighbor-slot counts — the W2W halo payload.

    A superstep that gathers one value per neighbor slot (e.g. the min-H
    estimate exchange) moves exactly `intra` values inside blocks and
    `inter` values across block boundaries.  Host ints (one read).
    """
    valid = g.nbr >= 0
    own = (torch.arange(g.N, device=g.device) // g.Cn)[:, None]
    cross = valid & (torch.div(g.nbr, g.Cn, rounding_mode="floor") != own)
    total, inter = torch.stack([valid.sum(), cross.sum()]).tolist()
    return int(total) - int(inter), int(inter)


def halo_pair_counts(g: GraphBlocks) -> np.ndarray:
    """(P, P) int64 matrix: valid neighbor slots in block-row b reading
    block b'.  The diagonal is the intra-block traffic; `halo_slot_counts`
    is (trace, off-diagonal sum)."""
    valid = g.nbr >= 0
    own = (torch.arange(g.N, device=g.device) // g.Cn)[:, None].expand_as(
        g.nbr)
    dst = torch.div(g.nbr, g.Cn, rounding_mode="floor")
    pair = own[valid].long() * g.P + dst[valid].long()
    return torch.bincount(pair, minlength=g.P * g.P).reshape(
        g.P, g.P).cpu().numpy()


def _relabel(
    n: int, assign: np.ndarray, P: int, Cn: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Map original ids -> block-contiguous padded ids.

    Returns (new_of_old (n,), old_of_new (P*Cn,)).
    """
    new_of_old = np.full(n, PAD, dtype=np.int64)
    old_of_new = np.full(P * Cn, PAD, dtype=np.int64)
    counts = np.zeros(P, dtype=np.int64)
    order = np.argsort(assign, kind="stable")
    for old in order:
        b = assign[old]
        slot = counts[b]
        if slot >= Cn:
            raise ValueError(
                f"block {b} overflows node capacity Cn={Cn} "
                f"(needs at least {np.sum(assign == b)})"
            )
        new = b * Cn + slot
        new_of_old[old] = new
        old_of_new[new] = old
        counts[b] += 1
    return new_of_old, old_of_new


def build_blocks(
    edges: np.ndarray,
    n: int,
    assign: np.ndarray,
    P: int,
    Cn: Optional[int] = None,
    Cd: Optional[int] = None,
    deg_slack: int = 8,
    node_slack: int = 0,
    device: DeviceLike = None,
) -> GraphBlocks:
    """Construct GraphBlocks from an edge list and a node->block assignment.

    Parameters
    ----------
    edges: (m, 2) int array of original node ids (undirected, no dups/loops
           required; they are cleaned here).
    n:     number of original nodes.
    assign:(n,) block id per node in [0, P).
    Cn:    node capacity per block (default: max block population plus
           `node_slack`, padded to a multiple of 8).
    Cd:    degree capacity (default: max degree + deg_slack) — insertions
           beyond this raise at the host boundary.
    device: where the tensors go (default CUDA, see `resolve_device`).
    """
    edges = np.asarray(edges, dtype=np.int64)
    if edges.size:
        # canonicalize: drop self loops + duplicates
        u, v = edges[:, 0], edges[:, 1]
        keep = u != v
        lo = np.minimum(u[keep], v[keep])
        hi = np.maximum(u[keep], v[keep])
        edges = np.unique(np.stack([lo, hi], 1), axis=0)
    assign = np.asarray(assign, dtype=np.int64)
    if assign.shape != (n,):
        raise ValueError(f"assign has shape {assign.shape}, expected ({n},)")
    if P < 1 or not ((assign >= 0).all() and (assign < P).all()):
        raise ValueError(f"assign must hold block ids in [0, {P})")

    pop = np.bincount(assign, minlength=P)
    if Cn is None:
        Cn = int(-(-(max(1, pop.max()) + max(0, int(node_slack))) // 8) * 8)
    deg = np.zeros(n, dtype=np.int64)
    if edges.size:
        np.add.at(deg, edges[:, 0], 1)
        np.add.at(deg, edges[:, 1], 1)
    if Cd is None:
        Cd = int(max(1, deg.max()) + deg_slack)
    if deg.size and deg.max() > Cd:
        raise ValueError(f"max degree {deg.max()} exceeds Cd={Cd}")

    new_of_old, old_of_new = _relabel(n, assign, P, Cn)
    N = P * Cn
    nbr = np.full((N, Cd), PAD, dtype=np.int64)
    fill = np.zeros(N, dtype=np.int64)
    for a, b in edges:
        na, nb_ = new_of_old[a], new_of_old[b]
        nbr[na, fill[na]] = nb_
        fill[na] += 1
        nbr[nb_, fill[nb_]] = na
        fill[nb_] += 1
    nbr = sort_nbr_rows(nbr)  # establish the sorted-ELL invariant
    return GraphBlocks.from_numpy(
        dict(nbr=nbr, deg=fill, node_mask=old_of_new >= 0,
             orig_id=old_of_new),
        P=P, Cn=Cn, Cd=Cd, device=device)


def _occurrence_ranks(ends: np.ndarray) -> np.ndarray:
    """rank[i] = how many earlier entries of `ends` equal ends[i] (O(m log m))."""
    order = np.argsort(ends, kind="stable")
    s = ends[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    counts = np.diff(np.r_[starts, len(s)])
    grouprank = np.arange(len(s)) - np.repeat(starts, counts)
    rank = np.empty(len(s), np.int64)
    rank[order] = grouprank
    return rank


def build_ell_random(
    N: int, Cd: int = 8, seed: int = 0, m_factor: float = 2.2,
    device: DeviceLike = None,
) -> GraphBlocks:
    """ER-style random graph built straight into ELL form (single block).

    Samples ~m_factor*N node pairs and fills neighbor rows with vectorized
    passes: canonicalize + `np.unique` kills self-loops and duplicates,
    then each pass ranks the surviving pairs per endpoint and accepts those
    whose rank still fits the remaining degree capacity; pairs rejected
    only because an *earlier* pair was itself rejected get another chance
    next pass (the loop ends when a pass accepts nothing).

    Deterministic per (N, Cd, seed, m_factor), and equal to the JAX
    package's graph for the same arguments.
    """
    rng = np.random.default_rng(seed)
    uv = rng.integers(0, N, (int(m_factor * N), 2))
    lo = np.minimum(uv[:, 0], uv[:, 1])
    hi = np.maximum(uv[:, 0], uv[:, 1])
    keep = lo != hi
    pending = np.unique(np.stack([lo[keep], hi[keep]], 1), axis=0)

    nbr = np.full((N, Cd), PAD, np.int32)
    deg = np.zeros(N, np.int64)
    while len(pending):
        u, v = pending[:, 0], pending[:, 1]
        ranks = _occurrence_ranks(np.concatenate([u, v]))
        ok = ((deg[u] + ranks[:len(u)] < Cd)
              & (deg[v] + ranks[len(u):] < Cd))
        if not ok.any():
            break
        acc = pending[ok]
        au, av = acc[:, 0], acc[:, 1]
        ranks = _occurrence_ranks(np.concatenate([au, av]))
        nbr[au, deg[au] + ranks[:len(au)]] = av
        nbr[av, deg[av] + ranks[len(au):]] = au
        np.add.at(deg, np.concatenate([au, av]), 1)
        pending = pending[~ok]
    nbr = sort_nbr_rows(nbr)  # establish the sorted-ELL invariant
    return GraphBlocks.from_numpy(
        dict(nbr=nbr, deg=deg, node_mask=np.ones(N, bool),
             orig_id=np.arange(N)),
        P=1, Cn=N, Cd=Cd, device=device)


# ---------------------------------------------------------------------------
# Single-edge device updates (the maintenance hot path).  Both keep the
# sorted-ELL invariant: insertion shifts the row right at the sorted
# position, deletion shifts it left over the hole.  Each is a handful of
# whole-row tensor ops on the graph's device — no host read, no
# data-dependent control flow.
# ---------------------------------------------------------------------------


def _sorted_insert_row(row: torch.Tensor, val: int) -> torch.Tensor:
    """Insert `val` into a sorted ELL row, keeping valid slots ascending."""
    key = torch.where(row >= 0, row, _PAD_KEY)
    pos = (key < val).sum()  # insertion point among the valid prefix
    idx = torch.arange(row.shape[0], device=row.device)
    shifted = row[(idx - 1).clamp(min=0)]  # row shifted right by one
    val_t = torch.full_like(row, val)
    return torch.where(idx < pos, row, torch.where(idx == pos, val_t, shifted))


def _sorted_delete_row(row: torch.Tensor, val: int,
                       deg: torch.Tensor) -> torch.Tensor:
    """Remove `val` from a sorted ELL row, shifting left over the hole.

    `deg` is the row's pre-delete degree (a 0-dim device tensor).
    """
    C = row.shape[0]
    pos = torch.argmax((row == val).to(torch.int32))  # first match
    idx = torch.arange(C, device=row.device)
    shifted = row[(idx + 1).clamp(max=C - 1)]  # row shifted left by one
    out = torch.where(idx >= pos, shifted, row)
    # the slot deg-1 (wrapped like an index, as the JAX version does)
    return torch.where(idx == (deg - 1) % C, PAD, out)


def insert_edge(g: GraphBlocks, u: int, v: int) -> GraphBlocks:
    """Insert undirected edge (u, v); ids are global padded host ints.

    Updates ``g.nbr`` and ``g.deg`` IN PLACE and returns `g` (the JAX
    version returns a new graph and donates the old one).  Assumes u != v,
    capacity available, and the edge absent — all validated at the host
    boundary (`updates.apply_updates_host`).
    """
    u, v = int(u), int(v)
    g.nbr[u] = _sorted_insert_row(g.nbr[u], v)
    g.nbr[v] = _sorted_insert_row(g.nbr[v], u)
    g.deg[u] += 1
    g.deg[v] += 1
    return g


def delete_edge(g: GraphBlocks, u: int, v: int) -> GraphBlocks:
    """Delete undirected edge (u, v) — shift-left in both sorted rows.

    Updates ``g.nbr`` and ``g.deg`` IN PLACE and returns `g`.
    """
    u, v = int(u), int(v)
    g.nbr[u] = _sorted_delete_row(g.nbr[u], v, g.deg[u])
    g.nbr[v] = _sorted_delete_row(g.nbr[v], u, g.deg[v])
    g.deg[u] -= 1
    g.deg[v] -= 1
    return g
