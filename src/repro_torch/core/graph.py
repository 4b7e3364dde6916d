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
  `build_blocks`, `build_ell_random`, `insert_edge`, `delete_edge`,
  `updates.apply_updates_host` and `migrate_vertices` all keep it, so the
  host and device update paths produce bit-identical arrays, and the
  kernels may bound the columns they read by the max degree
  (`kernels.ops.degree_bound`).
- Capacity overflow is checked at the host boundary (`build_blocks`,
  `updates.apply_updates_host`) and raises `CapacityError`; the device
  path never reallocates.  Capacity grows only through `grow_blocks`, a
  pad-and-rekey that returns a new graph.
- `migrate_vertices` (live §4.2 rebalancing), `grow_blocks` and
  `add_vertices_host` return graphs with fresh tensors: the update paths
  write a graph's rows in place, so nothing they return aliases their
  input.

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

    def block_of(self, u):
        """Owning block of a padded node id (an int or a tensor of ids)."""
        return u // self.Cn

    def valid_nbr_mask(self) -> torch.Tensor:
        """(N, Cd) bool: True at the valid (non-PAD) neighbor slots."""
        return self.nbr >= 0

    def is_boundary(self) -> torch.Tensor:
        """(N,) bool: True for nodes with a neighbor in another block."""
        own = (torch.arange(self.N, device=self.device) // self.Cn)[:, None]
        nb_block = torch.div(self.nbr, self.Cn, rounding_mode="floor")
        return ((nb_block != own) & (self.nbr >= 0)).any(dim=1)

    def grow(self, Cn: Optional[int] = None, Cd: Optional[int] = None):
        """Capacity escalation — see `grow_blocks`.  Returns (g2, rekey)."""
        return grow_blocks(self, Cn, Cd)

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
# Live migration and capacity growth: host-boundary operations that return
# a new graph (fresh tensors on the input's device) plus the old-id ->
# new-id map as host int64 numpy, as the JAX package's functions do.
# ---------------------------------------------------------------------------


def _sorted_rows(nbr: torch.Tensor) -> torch.Tensor:
    """`sort_nbr_rows` on the tensor's device: pads to int32 max, an
    ascending row sort, pads back.  The same bits as the host version."""
    keyed = torch.where(nbr >= 0, nbr, _PAD_KEY)
    keyed = torch.sort(keyed, dim=-1).values
    return torch.where(keyed == _PAD_KEY, PAD, keyed).to(nbr.dtype)


def _remap_ids(nbr: torch.Tensor, idmap: np.ndarray) -> torch.Tensor:
    """Map every valid id of `nbr` through the host map `idmap`, PAD kept;
    int32 on `nbr`'s device."""
    m = torch.from_numpy(np.asarray(idmap, np.int64)).to(nbr.device)
    return torch.where(nbr >= 0, m[nbr.clamp(min=0).long()],
                       PAD).to(torch.int32)


def migrate_vertices(g: GraphBlocks, moves, *arrays):
    """Live §4.2 rebalancing: move real nodes to other blocks.

    `moves` is a sequence of (u, dest_block) with `u` a global padded id
    of a real node.  Each move swaps the node's row with a *padding* row
    of the destination block, so the whole migration is a permutation of
    the node axis under fixed (P, Cn, Cd).  Node ids DO change — the
    returned `perm` (old id -> new id, host int64) lets the caller remap
    anything it holds; `orig_id` rides the permutation.

    Any extra `arrays` (coreness, per-node estimates, ...: tensors on the
    graph's device) are permuted along and returned in order.  Raises on
    moving padding/duplicate nodes, on no-op moves, and when a destination
    block has no free padding slots (slots vacated by this very migration
    do NOT count — capacity is checked against the pre-migration layout).
    The permuted rows are re-sorted on the device (`_sorted_rows`).

    Returns (g', perm, *arrays'), every tensor fresh.  Coreness is
    invariant under the permutation: ``core'[perm[u]] == core[u]``.
    """
    mask = g.node_mask.cpu().numpy()
    N, Cn = g.N, g.Cn
    perm = np.arange(N, dtype=np.int64)
    free = {
        b: list(np.flatnonzero(~mask[b * Cn:(b + 1) * Cn]) + b * Cn)
        for b in range(g.P)
    }
    seen: set = set()
    for u, b2 in moves:
        u, b2 = int(u), int(b2)
        if not (0 <= u < N) or not mask[u]:
            raise ValueError(f"cannot migrate non-real node {u}")
        if not (0 <= b2 < g.P):
            raise ValueError(f"destination block {b2} outside [0, {g.P})")
        if b2 == u // Cn:
            raise ValueError(f"no-op move: node {u} already in block {b2}")
        if u in seen:
            raise ValueError(f"duplicate move for node {u}")
        if not free[b2]:
            raise CapacityError(
                f"block {b2} has no free node capacity (Cn={Cn})")
        seen.add(u)
        t = free[b2].pop(0)
        perm[u], perm[t] = t, u  # swap node row with the padding row

    inv = np.empty(N, dtype=np.int64)
    inv[perm] = np.arange(N)
    inv_t = torch.from_numpy(inv).to(g.device)
    # remapping ids scrambles in-row order; re-sort to keep the invariant
    g2 = dataclasses.replace(
        g,
        nbr=_sorted_rows(_remap_ids(g.nbr, perm)[inv_t]),
        deg=g.deg[inv_t],
        node_mask=g.node_mask[inv_t],
        orig_id=g.orig_id[inv_t],
    )
    out = tuple(torch.as_tensor(a, device=g.device)[inv_t] for a in arrays)
    return (g2, perm) + out


def grow_blocks(g: GraphBlocks, Cn: Optional[int] = None,
                Cd: Optional[int] = None):
    """Capacity escalation: pure pad-and-rekey to new (Cn, Cd).

    Block ``b``'s rows move from ``[b*Cn, b*Cn+Cn)`` to ``[b*Cn2,
    b*Cn2+Cn2)`` keeping their in-block slot ``r``, so the id map is
    ``rekey[b*Cn + r] = b*Cn2 + r``: globally monotone whenever
    ``Cn2 >= Cn``, so remapped rows stay ascending without a re-sort.
    Growing is always legal; *shrinking* is legal exactly when the
    contents fit (every real node at ``r < Cn2``, every degree
    ``<= Cd2``), else `CapacityError`.

    Returns ``(g2, rekey)`` with ``rekey`` the (N_old,) host int64 old-id
    -> new-id map (-1 for rows a shrink drops, necessarily padding).
    Relocate per-node arrays with `relocate_rows`; CC labels also need
    their *values* rekeyed (they hold padded ids): relocation first, then
    ``rekey[label]``.
    """
    Cn2 = g.Cn if Cn is None else int(Cn)
    Cd2 = g.Cd if Cd is None else int(Cd)
    if Cn2 < 1 or Cd2 < 1:
        raise ValueError(f"capacities must be >= 1, got Cn={Cn2} Cd={Cd2}")
    mask = g.node_mask.cpu().numpy()
    deg = g.deg.cpu().numpy()
    if Cn2 < g.Cn:
        slots = np.flatnonzero(mask) % g.Cn
        if slots.size and slots.max() >= Cn2:
            raise CapacityError(
                f"cannot shrink Cn {g.Cn} -> {Cn2}: a real node occupies "
                f"slot {int(slots.max())}")
    if Cd2 < g.Cd and deg.size and deg.max() > Cd2:
        raise CapacityError(
            f"cannot shrink Cd {g.Cd} -> {Cd2}: max degree is "
            f"{int(deg.max())}")
    N2 = g.P * Cn2
    old_r = np.arange(g.N) % g.Cn
    rekey = np.where(old_r < Cn2,
                     (np.arange(g.N) // g.Cn) * Cn2 + old_r, -1)
    r2 = np.arange(N2) % Cn2
    src = np.where(r2 < g.Cn, (np.arange(N2) // Cn2) * g.Cn + r2, -1)
    dev = g.device
    have = torch.from_numpy(src >= 0).to(dev)
    srcc = torch.from_numpy(np.maximum(src, 0)).to(dev)
    Cmin = min(g.Cd, Cd2)
    vals = _remap_ids(g.nbr[srcc, :Cmin], rekey)
    nbr2 = torch.full((N2, Cd2), PAD, dtype=torch.int32, device=dev)
    nbr2[:, :Cmin] = torch.where(have[:, None], vals, PAD)
    g2 = GraphBlocks(
        nbr=nbr2,
        deg=torch.where(have, g.deg[srcc], 0),
        node_mask=have & g.node_mask[srcc],
        orig_id=torch.where(have, g.orig_id[srcc], PAD),
        P=g.P, Cn=Cn2, Cd=Cd2,
    )
    return g2, rekey


def relocate_rows(arr, rekey: np.ndarray, N2: int, fill=0) -> np.ndarray:
    """Scatter an (N_old, ...) per-node array onto the post-`grow_blocks`
    node axis: row ``u`` lands at ``rekey[u]``; unsourced rows get `fill`.
    Host-side (numpy in, numpy out)."""
    arr = np.asarray(arr)
    out = np.full((N2,) + arr.shape[1:], fill, arr.dtype)
    ok = rekey >= 0
    out[rekey[ok]] = arr[ok]
    return out


def add_vertices_host(g: GraphBlocks, block: int, count: int = 1,
                      orig_ids=None):
    """Vertex arrival: activate `count` padding rows of `block` as fresh
    real (degree-0) nodes.

    Rows are taken lowest-index-first (deterministic, so a replayed log
    reproduces the same ids).  New nodes get original ids `orig_ids`, or
    consecutive ids after the current max when omitted.  Raises
    `CapacityError` when the block lacks free rows — the caller's cue to
    `grow_blocks` and retry.  Returns ``(g2, new_ids)``: a graph of fresh
    tensors, and the (count,) host int64 padded ids of the new vertices.
    """
    b, count = int(block), int(count)
    if not 0 <= b < g.P:
        raise ValueError(f"block {b} outside [0, {g.P})")
    if count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    mask = g.node_mask.cpu().numpy().copy()
    free = np.flatnonzero(~mask[b * g.Cn:(b + 1) * g.Cn]) + b * g.Cn
    if len(free) < count:
        raise CapacityError(
            f"block {b} has {len(free)} free node rows, needs {count} "
            f"(Cn={g.Cn})")
    rows = free[:count]
    orig = g.orig_id.cpu().numpy().copy()
    if orig_ids is None:
        base = int(orig.max(initial=-1)) + 1
        orig_ids = np.arange(base, base + count)
    orig_ids = np.asarray(orig_ids, np.int64)
    if orig_ids.shape != (count,):
        raise ValueError(f"need {count} orig_ids, got {orig_ids.shape}")
    mask[rows] = True
    orig[rows] = orig_ids
    g2 = dataclasses.replace(
        g, nbr=g.nbr.clone(), deg=g.deg.clone(),
        node_mask=torch.from_numpy(mask).to(g.device),
        orig_id=torch.from_numpy(orig.astype(np.int32)).to(g.device))
    return g2, rows


def to_networkx_edges(g: GraphBlocks) -> np.ndarray:
    """Extract the (m, 2) edge list in *original* ids (test oracle helper;
    host numpy, rows sorted and unique)."""
    nbr = g.nbr.cpu().numpy()
    orig = g.orig_id.cpu().numpy()
    src = np.repeat(np.arange(g.N), g.Cd)
    dst = nbr.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    e = np.stack([orig[src], orig[dst]], 1)
    e = e[e[:, 0] < e[:, 1]]
    return np.unique(e, axis=0)


def has_edge(g: GraphBlocks, u, v) -> torch.Tensor:
    """Whether padded ids u and v are adjacent (0-d bool on the device)."""
    return (g.nbr[int(u)] == int(v)).any()


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
