"""Skew-aware hub mirroring: vertex-cut replicas inside the block runtime.

Power-law graphs break the ELL layout's economics: ONE celebrity vertex
sets ``Cd`` for every row of ``GraphBlocks.nbr``.  The vertex-cut answer,
without changing the block-centric runtime:

  * `split_hubs(g, threshold)` rewrites the graph so every vertex with
    ``deg > threshold`` becomes a **primary** row (its original row id)
    plus **mirror replica** rows, each holding one slice of at most
    ``threshold`` neighbors, so the split graph's ``Cd`` is the
    threshold, not the max degree.  Replicas occupy *existing padding
    rows*, preferentially in the block of the slice's readers, so every
    real row keeps its original index: CC label space, `orig_id` and
    `to_networkx_edges` are untouched.
  * The split graph is a **plain valid GraphBlocks** (sorted-ELL rows,
    exact row lengths): every kernel runs it unchanged.  Its rows are
    slices and its ids are *serving rows*: a hub appears under the id of
    the row that holds the slice its neighbor sits in.
  * The `MirrorPlan` carries the replica bookkeeping the runner needs:
    which rows form a group, each row's primary, and the *logical*
    degree.  `kernels.ops.run_block_program(..., mirror=plan)` inserts a
    merge stage between the neighbor combine and `BlockProgram.update`:
    per-slice partials are merged per group (min/sum; hindex through
    count histograms) and written back to every group row.  Program
    state is replicated onto mirror rows (`BlockProgram.mirror_state`),
    so replicas advance in lockstep with their primary and results
    equal the unsplit graph's (bit for bit for the integer combines,
    allclose for the float sum).
  * "count_common" (triangles) needs whole neighbor rows, which a slice
    cannot serve; `run_common_mirror` computes it exactly from a kernel
    pass on canonicalized rows plus per-slice corrections on the host.
  * `build_split_blocks(edges, ...)` builds the same split graph and plan
    straight from an edge list, never forming the unsplit rows (a
    power-law graph's hub makes those terabytes wide).  Both builders
    hand the sorted (row, neighbor) slot keys to one tensor core
    (`_split_slots`) on the graph's device.
  * `apply_mirrored_edits` is the mutation path: capacity-routed
    inserts, ON-LINE splits when an insert pushes a vertex over the
    threshold, and mirrored deletes, spliced on the host in the rows the
    edits touch.

Host-boundary module, as in the JAX package: the splices and the
triangle corrections are numpy; the construction and the plan's tensors
live on the graph's device, and every function returns fresh tensors (the
stream writes graph rows in place elsewhere, so nothing here may alias its
input).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..tracing import MIRROR_EDITS, SYNC, span
from .engine import BlockCtx, BlockProgram
from .graph import (PAD, CapacityError, GraphBlocks, halo_slot_counts,
                    relocate_rows, sort_nbr_rows)

#: plan identity: every plan built or restored gets a fresh number, as in
#: the JAX package (where compiled-step caches key on it)
_UIDS = itertools.count(1)


def _next_uid() -> int:
    return next(_UIDS)


def _pow2(x: int, floor: int = 8) -> int:
    """Smallest power of two >= x, floored."""
    k = floor
    while k < x:
        k *= 2
    return k


@dataclasses.dataclass(frozen=True)
class MirrorPlan:
    """Replica bookkeeping for a hub-split graph (see module docstring).

    Tensors on the split graph's device:

    primary_row:  (N,) int32 — primary row of each row's logical vertex
                  (self for non-replica rows, including padding).
    ldeg:         (N,) int32 — *logical* degree of the row's vertex (the
                  unsplit degree; 0 on padding rows).  What `BlockCtx.deg`
                  carries under a mirrored run; the kernels keep reading
                  the split graph's row lengths `g.deg`.
    primary_mask: (N,) bool — True for real non-replica rows.
    grp_rows:     (Rp,) int32 — rows of split groups, padded with 0.
    grp_gid:      (Rp,) int32 — group id per entry; Gmax on padding.
    row_gid:      (N,) int32 — group id of each row; Gmax off-group.

    Statics: `Gmax`, `Km` (pow2-bucketed group count and max logical hub
    degree, the h-index histogram width), `threshold` (the per-slice
    capacity), `n_logical` (the real logical vertex count) and `uid` (a
    fresh number per plan).
    """

    primary_row: torch.Tensor
    ldeg: torch.Tensor
    primary_mask: torch.Tensor
    grp_rows: torch.Tensor
    grp_gid: torch.Tensor
    row_gid: torch.Tensor
    Gmax: int
    Km: int
    threshold: int
    n_logical: int
    uid: int

    #: the tensor fields, in the JAX package's order
    ARRAYS = ("primary_row", "ldeg", "primary_mask", "grp_rows", "grp_gid",
              "row_gid")

    @property
    def n_groups(self) -> int:
        gid = self.grp_gid.cpu().numpy()
        return len(np.unique(gid[gid < self.Gmax]))


def group_arrays(plan: MirrorPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Host view of the split groups as two aligned int64 arrays
    ``(primary, row)``: one entry a group row, groups by ascending
    primary, each group's primary first and its replicas ascending."""
    with span(SYNC):
        rows = plan.grp_rows.cpu().numpy().astype(np.int64)
    with span(SYNC):
        gid = plan.grp_gid.cpu().numpy()
    with span(SYNC):
        prow = plan.primary_row.cpu().numpy().astype(np.int64)
    rows = rows[gid < plan.Gmax]
    heads = prow[rows]
    order = np.lexsort((rows, rows != heads, heads))
    return heads[order], rows[order]


def groups_of(plan: MirrorPlan) -> Dict[int, List[int]]:
    """Host view of the split groups: {primary row: [rows, primary first]}."""
    heads, rows = group_arrays(plan)
    cut = np.flatnonzero(np.diff(heads)) + 1
    return {int(rs[0]): rs.tolist() for rs in np.split(rows, cut)
            if rs.size}


class _FreeRows:
    """Free (padding) rows per block, taken lowest first: the replica
    allocation pool."""

    def __init__(self, mask: np.ndarray, Cn: int, P: int):
        self.rows = [np.flatnonzero(~mask[b * Cn:(b + 1) * Cn]) + b * Cn
                     for b in range(P)]
        self.next = [0] * P

    def has(self, b: int) -> bool:
        return 0 <= b < len(self.rows) and self.next[b] < len(self.rows[b])

    def pop(self, b: int) -> int:
        self.next[b] += 1
        return int(self.rows[b][self.next[b] - 1])


_NO_FREE_ROWS = (
    "no free padding rows left for hub mirror replicas; rebuild the "
    "graph with node capacity headroom (build_blocks(node_slack=...)) "
    "or grow Cn (graph.grow_blocks / MirrorStream auto_grow)")


def _alloc_replica(free: _FreeRows, pref: int, own: int) -> int:
    """Pop a free row: reader's block first, then the hub's, then any."""
    for b in (pref, own):
        if free.has(b):
            return free.pop(b)
    for b in range(len(free.rows)):
        if free.has(b):
            return free.pop(b)
    raise CapacityError(_NO_FREE_ROWS)


def _sorted_slice_insert(row: np.ndarray, fill: int, val: int) -> None:
    """Insert `val` into a sorted ELL row slice in place (fill = old
    count); the caller guarantees fill < len(row) and `val` absent."""
    pos = int(np.searchsorted(row[:fill], val))
    row[pos + 1:fill + 1] = row[pos:fill]
    row[pos] = val


def _sorted_slice_delete(row: np.ndarray, fill: int, val: int) -> None:
    """Remove `val` from a sorted ELL row slice in place (fill = old
    count), re-padding the vacated slot."""
    pos = int(np.searchsorted(row[:fill], val))
    row[pos:fill - 1] = row[pos + 1:fill]
    row[fill - 1] = PAD


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(dtype, copy=False)).to(
        device)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def split_hubs(g: GraphBlocks, threshold: int
               ) -> Tuple[GraphBlocks, MirrorPlan]:
    """Split every vertex with deg > threshold into primary + mirror rows.

    Returns ``(g2, plan)``: ``g2`` is a plain valid GraphBlocks with
    ``Cd == threshold`` and the same (P, Cn), on `g`'s device.  Hubs keep
    their original row as the primary (holding the first slice) and each
    further slice of at most `threshold` neighbors lands in an existing
    padding row, preferentially in the block its members live in.  Both
    endpoint sides of an edge re-point at the serving row of the other
    side, and every row is re-sorted.  Raises `CapacityError` when the
    padding rows run out.  Tensor code on `g`'s device (`_split_slots`).
    """
    t = _check_threshold(threshold)
    valid = g.nbr >= 0
    rows = torch.arange(g.N, device=g.device)[:, None].expand_as(g.nbr)
    slot = torch.sort(rows[valid] * g.N + g.nbr[valid].long()).values
    return _split_slots(slot, g.node_mask.clone(), g.orig_id.long(), g.P,
                        g.Cn, t, n_logical=int(g.node_mask.sum()))


def _check_threshold(threshold) -> int:
    t = int(threshold)
    if t < 1:
        raise ValueError(f"threshold must be >= 1, got {t}")
    return t


def _row_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum: where each row's run starts."""
    return torch.cumsum(counts, 0) - counts


def _allocate_replicas(pref: torch.Tensor, own: torch.Tensor,
                       free: torch.Tensor, Cn: int, P: int) -> torch.Tensor:
    """The rows `_alloc_replica` hands out for requests ``(pref, own)``
    taken in order from the ascending free rows `free`, in array code.

    Each round assumes that no block fills up, takes each request's block
    (its reader block, else the hub's, else the lowest block with room),
    and keeps the requests up to the first that would take from a block
    already emptied; that block is then full for the rest.  At most P + 1
    rounds."""
    dev = pref.device
    K = pref.numel()
    left = torch.bincount(free // Cn, minlength=P)
    start = _row_offsets(left)
    block = torch.empty(K, dtype=torch.int64, device=dev)
    i0 = 0
    while i0 < K:
        room = left > 0
        if not bool(room.any()):
            raise CapacityError(_NO_FREE_ROWS)
        anyb = int(torch.nonzero(room)[0, 0])
        p, o = pref[i0:], own[i0:]
        pick = torch.where(room[p], p, torch.where(room[o], o, anyb))
        taken = torch.cumsum(
            torch.nn.functional.one_hot(pick, P), 0)  # (K - i0, P)
        over = taken.gather(1, pick[:, None])[:, 0] > left[pick]
        j = int(torch.argmax(over.to(torch.int8))) if bool(over.any()) \
            else pick.numel()
        block[i0:i0 + j] = pick[:j]
        if j:
            left = left - taken[j - 1]
        i0 += j
    # the k-th request served by block b takes b's k-th free row
    order = torch.sort(block, stable=True).indices
    used = torch.bincount(block, minlength=P)
    rank = torch.empty(K, dtype=torch.int64, device=dev)
    rank[order] = (torch.arange(K, device=dev)
                   - _row_offsets(used)[block[order]])
    return free[start[block] + rank]


def build_split_blocks(
    edges, n: int, assign, P: int, threshold: int,
    Cn: Optional[int] = None, node_slack: int = 0,
    device: DeviceLike = None,
) -> Tuple[GraphBlocks, MirrorPlan]:
    """Build the hub-split graph and its plan straight from an edge list.

    Takes `graph.build_blocks`' inputs (`edges` an (m, 2) array or tensor
    of original ids, `assign` each node's block, `Cn` or `node_slack` the
    node capacity) and returns what ``split_hubs(build_blocks(...),
    threshold)`` returns, bit for bit, without ever forming the unsplit
    rows (whose width is the largest degree): tensor code on `device`
    (default CUDA).  The layout is `build_blocks`' (blocks contiguous,
    nodes in original order inside a block) and the split `split_hubs`':
    a hub's neighbors ordered own block first, then by id; slices of
    `threshold` consecutive neighbors, the first on the hub's row; each
    replica on the lowest free row of its slice's first member's block,
    else the hub's block, else any block, taken in (hub, slice) order;
    both sides of an edge pointing at the serving rows; rows sorted.
    Raises `CapacityError` where `split_hubs` would.
    """
    t = _check_threshold(threshold)
    dev = resolve_device(device)
    e = torch.as_tensor(edges).to(dev, torch.int64).reshape(-1, 2)
    blk = torch.as_tensor(assign).to(dev, torch.int64)
    if tuple(blk.shape) != (n,):
        raise ValueError(f"assign has shape {tuple(blk.shape)}, expected "
                         f"({n},)")
    if P < 1 or not bool(((blk >= 0) & (blk < P)).all()):
        raise ValueError(f"assign must hold block ids in [0, {P})")

    # canonical undirected keys: no self loops, no repeats
    keep = e[:, 0] != e[:, 1]
    lo = torch.minimum(e[keep, 0], e[keep, 1])
    hi = torch.maximum(e[keep, 0], e[keep, 1])
    keys = torch.unique(lo * n + hi)
    del e, keep, lo, hi

    # build_blocks' layout
    pop = torch.bincount(blk, minlength=P)
    if Cn is None:
        Cn = int(-(-(max(1, int(pop.max())) + max(0, int(node_slack)))
                   // 8) * 8)
    elif bool((pop > Cn).any()):
        b = int(torch.nonzero(pop > Cn)[0, 0])
        raise ValueError(f"block {b} overflows node capacity Cn={Cn} "
                         f"(needs at least {int(pop[b])})")
    N = P * Cn
    order = torch.sort(blk, stable=True).indices
    new_of_old = torch.empty(n, dtype=torch.int64, device=dev)
    new_of_old[order] = (blk[order] * Cn + torch.arange(n, device=dev)
                         - _row_offsets(pop)[blk[order]])
    mask = torch.zeros(N, dtype=torch.bool, device=dev)
    mask[new_of_old] = True
    orig = torch.full((N,), PAD, dtype=torch.int64, device=dev)
    orig[new_of_old] = torch.arange(n, device=dev)
    del order, blk

    # every directed slot, sorted by (row, neighbor): the unsplit rows
    a_, b_ = new_of_old[keys // n], new_of_old[keys % n]
    del keys, new_of_old
    slot = torch.sort(torch.cat([a_ * N + b_, b_ * N + a_])).values
    del a_, b_
    return _split_slots(slot, mask, orig, P, Cn, t, n_logical=n)


def _split_slots(slot: torch.Tensor, mask: torch.Tensor, orig: torch.Tensor,
                 P: int, Cn: int, t: int, n_logical: int
                 ) -> Tuple[GraphBlocks, MirrorPlan]:
    """The split of `split_hubs` and `build_split_blocks`, in tensor code
    on `slot`'s device.  `slot` holds every directed slot of the unsplit
    graph as a sorted int64 key ``row * N + neighbor``; `mask` and `orig`
    are its (N,) node mask and int64 original ids, both the caller's own
    (replicas are marked in them)."""
    dev = slot.device
    N = P * Cn
    src, dst = slot // N, slot % N
    deg = torch.bincount(src, minlength=N)
    M = slot.numel()

    # each slot's place in its row's hub order (own block first, then by
    # id), and so its slice
    pos = torch.arange(M, device=dev) - _row_offsets(deg)[src]
    own, nb_blk = src // Cn, dst // Cn
    inown = nb_blk == own
    below = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(
        0, src, (nb_blk < own).to(torch.int64))
    mine = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(
        0, src, inown.to(torch.int64))
    hpos = torch.where(inown, pos - below[src],
                       torch.where(nb_blk < own, pos + mine[src], pos))
    del pos, inown, below, mine
    piece = hpos // t

    # one replica request per slice past the first, in (hub, slice) order
    nreq = torch.where(deg > t, (deg + t - 1) // t - 1, 0)
    req0 = _row_offsets(nreq)
    K = int(nreq.sum())
    heads_at = (hpos % t == 0) & (piece > 0)
    del hpos
    req = req0[src[heads_at]] + piece[heads_at] - 1
    pref = torch.empty(K, dtype=torch.int64, device=dev)
    hub_of = torch.empty(K, dtype=torch.int64, device=dev)
    pref[req] = nb_blk[heads_at]
    hub_of[req] = src[heads_at]
    del heads_at, req, nb_blk, own
    rep = _allocate_replicas(pref, hub_of // Cn,
                             torch.nonzero(~mask)[:, 0], Cn, P)
    del pref
    mask[rep] = True
    orig[rep] = orig[hub_of]

    # serving rows: a slot's own row, and the row its partner serves it by
    serve = torch.where(piece == 0, src,
                        rep[(req0[src] + piece - 1).clamp(min=0)]
                        if K else src)
    del piece
    back = serve[torch.searchsorted(slot, dst * N + src)]
    del slot, dst
    key2 = torch.sort(serve * N + back).values
    del serve, back, src
    s2, v2 = key2 // N, key2 % N
    del key2
    deg2 = torch.bincount(s2, minlength=N)
    nbr2 = torch.full((N, t), PAD, dtype=torch.int32, device=dev)
    nbr2[s2, torch.arange(M, device=dev) - _row_offsets(deg2)[s2]] = \
        v2.to(torch.int32)
    del s2, v2
    g2 = GraphBlocks(nbr=nbr2, deg=deg2.to(torch.int32), node_mask=mask,
                     orig_id=orig.to(torch.int32), P=P, Cn=Cn, Cd=t)

    # plan entries: each hub's row, then its replicas in slice order
    hubs = torch.nonzero(deg > t)[:, 0]
    at = (torch.arange(hubs.numel(), device=dev) + req0[hubs])
    heads = torch.empty(hubs.numel() + K, dtype=torch.int64, device=dev)
    rows = torch.empty_like(heads)
    heads[at], rows[at] = hubs, hubs
    rpos = torch.arange(K, device=dev)
    hub_rank = torch.searchsorted(hubs, hub_of)
    heads[rpos + hub_rank + 1] = hub_of
    rows[rpos + hub_rank + 1] = rep
    plan = _plan_from_entries(N, deg, mask, heads, rows, threshold=t,
                              n_logical=n_logical, device=dev)
    return g2, plan


def _plan_from_entries(N: int, deg_logical_of_row, mask, heads, rows,
                       threshold: int, n_logical: int, device) -> MirrorPlan:
    """Assemble a MirrorPlan from its group entries: ``heads[i]`` is the
    primary of group row ``rows[i]``, entries ordered by primary, each
    group in the order its rows are to keep (primary first).  Takes numpy
    arrays or tensors of one device; array code throughout."""
    heads = torch.as_tensor(heads).to(torch.int64)
    rows = torch.as_tensor(rows).to(torch.int64)
    dev = heads.device
    mask = torch.as_tensor(mask).to(dev, torch.bool)
    deg_logical_of_row = torch.as_tensor(deg_logical_of_row).to(
        dev, torch.int64)
    ids = torch.arange(N, dtype=torch.int64, device=dev)
    prow = ids.clone()
    prow[rows] = heads
    ldeg = torch.where(mask, deg_logical_of_row[prow], 0)
    primary_mask = mask & (prow == ids)

    first = torch.ones_like(heads, dtype=torch.bool)
    first[1:] = heads[1:] != heads[:-1]
    gx = torch.cumsum(first.to(torch.int64), 0) - 1
    with span(SYNC):
        G = int(first.sum())
    n_rows = int(rows.numel())
    Gmax = _pow2(max(1, G))
    Rp = _pow2(max(1, n_rows))
    grp_rows = torch.zeros(Rp, dtype=torch.int64, device=dev)
    grp_gid = torch.full((Rp,), Gmax, dtype=torch.int64, device=dev)
    row_gid = torch.full((N,), Gmax, dtype=torch.int64, device=dev)
    grp_rows[:n_rows] = rows
    grp_gid[:n_rows] = gx
    row_gid[rows] = gx
    with span(SYNC):
        Km = _pow2(int(ldeg[heads[first]].max()) if G else 1)
    return MirrorPlan(
        primary_row=prow.to(device, torch.int32),
        ldeg=ldeg.to(device, torch.int32),
        primary_mask=primary_mask.to(device),
        grp_rows=grp_rows.to(device, torch.int32),
        grp_gid=grp_gid.to(device, torch.int32),
        row_gid=row_gid.to(device, torch.int32),
        Gmax=Gmax, Km=Km, threshold=int(threshold),
        n_logical=int(n_logical), uid=_next_uid(),
    )


def grow_plan(plan: MirrorPlan, rekey: np.ndarray, g2: GraphBlocks
              ) -> MirrorPlan:
    """Relocate a MirrorPlan onto the post-`graph.grow_blocks` node axis.

    `rekey` is the (N_old,) old-id -> new-id map `grow_blocks` returned
    and `g2` the grown graph.  The rekey is monotone, so group order and
    the canonical within-group row order survive; the result is a fresh
    plan (new tensors, new uid).  Host-side.
    """
    rekey = np.asarray(rekey, np.int64)
    heads, rows = group_arrays(plan)
    with span(SYNC):
        ldeg = relocate_rows(plan.ldeg.cpu().numpy(), rekey, g2.N, 0)
    with span(SYNC):
        mask = g2.node_mask.cpu().numpy()
    return _plan_from_entries(
        g2.N, ldeg, mask, rekey[heads], rekey[rows],
        threshold=plan.threshold, n_logical=plan.n_logical,
        device=g2.device)


# ---------------------------------------------------------------------------
# On-line mutation: capacity-routed inserts, threshold-triggered splits,
# mirrored deletes.
# ---------------------------------------------------------------------------


def apply_mirrored_edits(
    g2: GraphBlocks, plan: MirrorPlan,
    edits: Iterable[Tuple[int, int, int]],
) -> Tuple[GraphBlocks, MirrorPlan]:
    """Apply (u, v, op) edits to a split graph; ids are PRIMARY row ids.

    op = +1 insert / -1 delete, sequential in order, exact:

      * an insert routes each endpoint to its first row with slice
        capacity left; a vertex whose every row is full gets a fresh
        replica (an **on-line split** when it was single-row) and the new
        edge lands there, so no existing row is rewired;
      * a delete locates the ONE (row_u, row_v) pair holding the edge
        (slices partition the neighborhood) and splices both sides.

    Returns ``(g2', plan')`` of fresh tensors; the inputs are left as
    they were, also when an edit raises (`ValueError` for a bad edit,
    `CapacityError` when no padding row is left for a replica).  Empty
    replicas left behind by deletes are kept: every merge ignores them.

    Only the rows of the edits' endpoints cross to the host, where the
    splices run in order; the graph and the plan are then copied on
    their device with those rows written back, and the plan's groups
    re-listed there (each primary first, then its rows ascending, then
    the replicas made here in the order they were made).
    """
    with span(MIRROR_EDITS):
        return _apply_mirrored_edits(g2, plan, list(edits))


def _host(x: torch.Tensor) -> np.ndarray:
    """One host read of a device value, as int64 numpy."""
    with span(SYNC):
        return x.cpu().numpy().astype(np.int64)


def _group_rows(plan: MirrorPlan, ids: np.ndarray) -> Dict[int, List[int]]:
    """{primary: [its rows, primary first, then ascending]} for the
    primaries `ids` (a single-row vertex gets [itself]): the plan's
    entries are listed group by group, so each group is one slice."""
    dev = plan.grp_rows.device
    gid = _host(plan.row_gid[torch.as_tensor(ids, device=dev)])
    live = gid < plan.Gmax
    out = {int(u): [int(u)] for u in ids[~live]}
    if live.any():
        q = torch.as_tensor(gid[live], device=dev, dtype=plan.grp_gid.dtype)
        lo = _host(torch.searchsorted(plan.grp_gid, q))
        hi = _host(torch.searchsorted(plan.grp_gid, q, right=True))
        at = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
        rows = _host(plan.grp_rows[torch.as_tensor(at, device=dev)])
        for u, part in zip(ids[live], np.split(rows, np.cumsum(hi - lo)[:-1])):
            out[int(u)] = [int(u)] + sorted(int(r) for r in part if r != u)
    return out


def _apply_mirrored_edits(g2, plan, edits):
    N, Cn, Cd2, dev = g2.N, g2.Cn, g2.Cd, g2.device
    edits = [(int(u), int(v), int(op)) for u, v, op in edits]
    ends = np.unique(np.asarray([x for e in edits for x in e[:2]], np.int64))
    ids = ends[(ends >= 0) & (ends < N)]
    at = torch.as_tensor(ids, device=dev)
    primary = dict(zip(ids.tolist(), (
        (_host(g2.node_mask[at]) == 1)
        & (_host(plan.primary_row[at]) == ids)).tolist()))
    groups = _group_rows(plan, ids[np.asarray(
        [primary[x] for x in ids.tolist()], bool)])
    # the rows the edits can touch, on the host: their slots and lengths
    touched = sorted({r for rs in groups.values() for r in rs})
    local = {r: i for i, r in enumerate(touched)}
    rows_t = torch.as_tensor(np.asarray(touched, np.int64), device=dev)
    with span(SYNC):
        nbr = g2.nbr[rows_t].cpu().numpy().copy()
    deg = _host(g2.deg[rows_t])
    ldeg = {u: int(d) for u, d in zip(groups, _host(plan.ldeg[torch.as_tensor(
        np.asarray(list(groups), np.int64), device=dev)]))}
    #: replicas made here, per primary, in the order they were made
    added: Dict[int, List[int]] = {}
    free: Optional[_FreeRows] = None  # the padding rows, read at first need

    def rows_of(u: int) -> List[int]:
        return groups[u] + added.get(u, [])

    def edge_pair(u: int, v: int) -> Optional[Tuple[int, int]]:
        """The (row_u, row_v) holding edge (u, v), or None if absent."""
        ru = [local[r] for r in rows_of(u)]
        slots = nbr[ru]
        hit = np.isin(slots, rows_of(v)) & (
            np.arange(Cd2)[None, :] < deg[ru][:, None])
        if not hit.any():
            return None
        i, j = np.unravel_index(int(np.argmax(hit)), hit.shape)
        return rows_of(u)[i], int(slots[i, j])

    def route(u: int, pref_block: int) -> int:
        """Row of u taking one more neighbor; allocates a replica if full."""
        nonlocal nbr, deg, free
        rows = rows_of(u)
        room = np.flatnonzero(deg[[local[r] for r in rows]] < Cd2)
        if room.size:
            return rows[int(room[0])]
        if free is None:
            free = _FreeRows(_host(g2.node_mask) == 1, Cn, g2.P)
        r = _alloc_replica(free, pref_block, u // Cn)
        local[r] = len(local)
        nbr = np.vstack([nbr, np.full((1, Cd2), PAD, nbr.dtype)])
        deg = np.r_[deg, 0]
        added.setdefault(u, []).append(r)
        return r

    for u, v, op in edits:
        for x in (u, v):
            if not primary.get(x, False):
                raise ValueError(f"{x} is not a primary row of a real node")
        if u == v:
            raise ValueError(f"self-loop on {u}")
        pair = edge_pair(u, v)
        if op > 0:
            if pair is not None:
                raise ValueError(f"edge ({u}, {v}) already present")
            ru = route(u, v // Cn)
            rv = route(v, ru // Cn)
            _sorted_slice_insert(nbr[local[ru]], int(deg[local[ru]]), rv)
            _sorted_slice_insert(nbr[local[rv]], int(deg[local[rv]]), ru)
            deg[local[ru]] += 1
            deg[local[rv]] += 1
            ldeg[u] += 1
            ldeg[v] += 1
        elif op < 0:
            if pair is None:
                raise ValueError(f"edge ({u}, {v}) not present")
            ru, rv = pair
            _sorted_slice_delete(nbr[local[ru]], int(deg[local[ru]]), rv)
            _sorted_slice_delete(nbr[local[rv]], int(deg[local[rv]]), ru)
            deg[local[ru]] -= 1
            deg[local[rv]] -= 1
            ldeg[u] -= 1
            ldeg[v] -= 1
        else:
            raise ValueError(f"op must be +1/-1, got {op}")

    # the copies on the device, the edited rows written back
    rows_all = torch.as_tensor(np.asarray(list(local), np.int64), device=dev)
    g3 = GraphBlocks(
        nbr=g2.nbr.clone().index_put_(
            (rows_all,), torch.as_tensor(nbr, device=dev).to(g2.nbr.dtype)),
        deg=g2.deg.clone().index_put_(
            (rows_all,), torch.as_tensor(deg, device=dev).to(g2.deg.dtype)),
        node_mask=g2.node_mask.clone(), orig_id=g2.orig_id.clone(),
        P=g2.P, Cn=Cn, Cd=Cd2)
    new_h = [u for u, rs in added.items() for _ in rs]
    new_r = [r for rs in added.values() for r in rs]
    if new_r:
        nr = torch.as_tensor(new_r, device=dev)
        g3.node_mask[nr] = True
        g3.orig_id[nr] = g2.orig_id[torch.as_tensor(new_h, device=dev)]
    ldeg_row = plan.ldeg.to(torch.int64, copy=True)  # primaries matter
    if ldeg:
        ldeg_row[torch.as_tensor(list(ldeg), device=dev)] = torch.as_tensor(
            list(ldeg.values()), device=dev)
    # the groups as they were (each primary first, then ascending), then
    # each primary's new replicas in the order they were made (a primary
    # split here heads its new group)
    live = plan.grp_gid < plan.Gmax
    rows = plan.grp_rows[live].to(torch.int64)
    heads = plan.primary_row.to(torch.int64)[rows]
    sub = (rows != heads).to(torch.int64) * N + rows
    fresh = [u for u in added if len(groups[u]) == 1]
    heads = torch.cat([heads, torch.as_tensor(fresh + new_h, dtype=torch.int64,
                                              device=dev)])
    rows = torch.cat([rows, torch.as_tensor(fresh + new_r, dtype=torch.int64,
                                            device=dev)])
    seq = [2 * N + i for u in added for i in range(len(added[u]))]
    sub = torch.cat([sub, torch.as_tensor([0] * len(fresh) + seq,
                                          dtype=torch.int64, device=dev)])
    order = torch.sort(sub, stable=True).indices
    order = order[torch.sort(heads[order], stable=True).indices]
    plan2 = _plan_from_entries(
        N, ldeg_row, g3.node_mask, heads[order], rows[order],
        threshold=plan.threshold, n_logical=plan.n_logical, device=dev)
    return g3, plan2


# ---------------------------------------------------------------------------
# Exact triangle counting on a split graph ("count_common" route).
# ---------------------------------------------------------------------------


class _RawCommonProgram(BlockProgram):
    """One "count_common" superstep that keeps the raw reduction, so
    `run_common_mirror` can correct and merge it before the real
    program's single `update`."""

    combine = "count_common"
    halo_fill = -1
    max_steps = 1

    def init(self, g):
        return (torch.zeros(g.N, dtype=torch.int32, device=g.device),
                g.nbr.to(torch.int32))

    def halo_field(self, state):
        return state[1]

    def update(self, ctx, state, red):
        return red.to(torch.int32), state[1]

    def changed(self, old, new):
        return torch.ones((), dtype=torch.bool, device=new[0].device)


def _slice_sets(nbr: np.ndarray, deg: np.ndarray, rows: List[int]):
    """Canonical (primary-id, sorted, unique) member sets of given rows."""
    return [nbr[r, :deg[r]] for r in rows]


def run_common_mirror(g2: GraphBlocks, plan: MirrorPlan, program,
                      backend: str = "auto", with_steps: bool = False,
                      state0=None):
    """Exact "count_common" (triangles) on a split graph, any backend.

    The slice rows make the plain pass wrong twice over: row contents are
    *serving-row* ids (a hub appears under several ids), and a slot
    (u -> v) only intersects u's own slice with ONE slice of v.  So:

      1. **canonicalize** — map every stored id to its primary and
         re-sort; the backend's pass (the `ell_triangles` kernel on a
         CUDA graph) then counts, per directed slot held by row a
         pointing at logical B, ``|C(a) ∩ C(primary_B)|`` with C(x) row
         x's canonical member set;
      2. **correct** (host numpy) — each such slot needs the full grid
         ``Σ_{a'∈rows(A), b'∈rows(B)} |C(a') ∩ C(b')|``; the shortfall is
         credited to the row holding the slot.  Only slots with a hub
         endpoint need it: O(Σ_hub deg · slices);
      3. **merge + update** — group-sum the corrected reduction and run
         the program's single `update` with the logical ctx.

    Returns like `run_block_program` (state, plus a superstep count of 1
    when `with_steps=True`).  `state0` seeds the program's state in place
    of `program.init` of the canonical graph.
    """
    from ..kernels.ops import run_block_program  # lazy: ops imports us

    a = g2.to_numpy()
    nbr = a["nbr"].astype(np.int64)
    deg = a["deg"].astype(np.int64)
    prow_np = plan.primary_row.cpu().numpy().astype(np.int64)
    canon = sort_nbr_rows(
        np.where(nbr >= 0, prow_np[np.maximum(nbr, 0)], PAD))
    gc = dataclasses.replace(g2, nbr=_tensor(canon, np.int32, g2.device))

    # 1. the backend's pass on the canonical rows (on "ell_spmd" with an
    #    executor built for it: the halo plan derives from gc's adjacency)
    raw_state = run_block_program(gc, _RawCommonProgram(), backend=backend)
    red = raw_state[0].cpu().numpy().astype(np.int64)

    # 2. per-slot corrections for hub-incident edges
    groups = groups_of(plan)
    corr = np.zeros(g2.N, np.int64)
    for h, rows_h in groups.items():
        sets_h = _slice_sets(canon, deg, rows_h)
        union_pos = {r: i for i, r in enumerate(rows_h)}
        for r in rows_h:
            for xrow in nbr[r, :deg[r]]:
                xrow = int(xrow)
                W = int(prow_np[xrow])
                cx = canon[xrow, :deg[xrow]]
                inter = [len(np.intersect1d(cx, s, assume_unique=True))
                         for s in sets_h]
                if W in groups:
                    # hub–hub edge: only the (xrow -> h) direction here;
                    # the reverse comes when W's group is walked
                    grid = sum(
                        len(np.intersect1d(
                            canon[y, :deg[y]], s, assume_unique=True))
                        for y in groups[W] for s in sets_h)
                    corr[xrow] += grid - inter[0]
                else:
                    # hub–nonhub edge: both directed slots settled here
                    corr[xrow] += sum(inter) - inter[0]
                    corr[r] += sum(inter) - inter[union_pos[r]]
    red = red + corr

    # 3. group-sum merge: every row of a group carries the logical count
    for h, rows_h in groups.items():
        red[rows_h] = red[rows_h].sum()

    ctx = BlockCtx(deg=plan.ldeg, node_mask=g2.node_mask,
                   n_real=plan.n_logical)
    if state0 is None:
        state0 = program.init(gc)
    state = program.update(ctx, state0, _tensor(red, np.int32, g2.device))
    return (state, 1) if with_steps else state


# ---------------------------------------------------------------------------
# Accounting: allocation and halo payload, unsplit vs split.
# ---------------------------------------------------------------------------


def mirror_report(g: GraphBlocks, g2: GraphBlocks,
                  plan: MirrorPlan) -> Dict[str, float]:
    """Allocation + per-superstep W2W payload, unsplit vs split.

    `slots_*` are the N·Cd ELL allocations (the memory the gather kernels
    sweep); `inter_*`/`intra_*` the cross-/in-block valid neighbor slots
    (`halo_slot_counts`); `merge_payload` the extra per-superstep
    elements the mirror merge moves (`runtime.halo.mirror_merge_payload`).
    """
    from ..runtime.halo import mirror_merge_payload  # lazy: no cycle

    intra_u, inter_u = halo_slot_counts(g)
    intra_s, inter_s = halo_slot_counts(g2)
    return dict(
        slots_unsplit=g.N * g.Cd,
        slots_split=g2.N * g2.Cd,
        alloc_ratio=(g.N * g.Cd) / max(1, g2.N * g2.Cd),
        inter_unsplit=inter_u,
        inter_split=inter_s,
        intra_unsplit=intra_u,
        intra_split=intra_s,
        merge_payload=mirror_merge_payload(plan),
        n_groups=len(groups_of(plan)),
    )
