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
  * `apply_mirrored_edits` is the host mutation path: capacity-routed
    inserts, ON-LINE splits when an insert pushes a vertex over the
    threshold, and mirrored deletes.

Host-boundary module, as in the JAX package: construction, mutation and
the triangle corrections are numpy; the plan's tensors live on the
graph's device, and every function returns fresh tensors (the stream
writes graph rows in place elsewhere, so nothing here may alias its
input).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .engine import BlockCtx, BlockProgram
from .graph import (PAD, CapacityError, GraphBlocks, _occurrence_ranks,
                    halo_slot_counts, relocate_rows, sort_nbr_rows)

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


def groups_of(plan: MirrorPlan) -> Dict[int, List[int]]:
    """Host view of the split groups: {primary row: [rows, primary first]}."""
    rows = plan.grp_rows.cpu().numpy()
    gid = plan.grp_gid.cpu().numpy()
    prow = plan.primary_row.cpu().numpy()
    out: Dict[int, List[int]] = {}
    for r, gx in zip(rows, gid):
        if gx >= plan.Gmax:
            continue
        out.setdefault(int(prow[r]), []).append(int(r))
    return {h: sorted(rs, key=lambda r: (r != h, r)) for h, rs in out.items()}


def _free_rows(mask: np.ndarray, Cn: int, P: int) -> Dict[int, List[int]]:
    """Free (padding) rows per block, ascending — replica allocation pool."""
    return {
        b: list(np.flatnonzero(~mask[b * Cn:(b + 1) * Cn]) + b * Cn)
        for b in range(P)
    }


def _alloc_replica(free: Dict[int, List[int]], pref: int, own: int) -> int:
    """Pop a free row: reader's block first, then the hub's, then any."""
    for b in (pref, own):
        if free.get(b):
            return free[b].pop(0)
    for b in sorted(free):
        if free[b]:
            return free[b].pop(0)
    raise CapacityError(
        "no free padding rows left for hub mirror replicas; rebuild the "
        "graph with node capacity headroom (build_blocks(node_slack=...)) "
        "or grow Cn (graph.grow_blocks / MirrorStream auto_grow)")


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
    return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)


def _graph(like: GraphBlocks, nbr, deg, mask, orig, Cd: int) -> GraphBlocks:
    """A GraphBlocks of fresh tensors on `like`'s device."""
    dev = like.device
    return GraphBlocks(
        nbr=_tensor(nbr, np.int32, dev), deg=_tensor(deg, np.int32, dev),
        node_mask=_tensor(mask, bool, dev), orig_id=_tensor(orig, np.int32, dev),
        P=like.P, Cn=like.Cn, Cd=int(Cd))


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
    side, and every row is re-sorted (`sort_nbr_rows`).  Raises
    `CapacityError` when the padding rows run out.  Host-side.
    """
    t = int(threshold)
    if t < 1:
        raise ValueError(f"threshold must be >= 1, got {t}")
    a = g.to_numpy()
    nbr = a["nbr"].astype(np.int64)
    deg = a["deg"].astype(np.int64)
    mask = a["node_mask"].copy()
    orig = a["orig_id"].astype(np.int64)
    N, Cn, Cd = g.N, g.Cn, g.Cd

    hubs = np.flatnonzero(mask & (deg > t))
    free = _free_rows(mask, Cn, g.P)

    # per directed slot of the ORIGINAL graph: rew[u, j] is the row that
    # holds u's slot j after the split, rew2[u, j] the row the slot's
    # content re-points to (the partner's serving row for this edge)
    rew = np.repeat(np.arange(N, dtype=np.int64), Cd).reshape(N, Cd)
    rew2 = nbr.copy()
    groups: Dict[int, List[int]] = {}
    for h in hubs:
        d = int(deg[h])
        nb = nbr[h, :d]  # sorted (ELL invariant)
        own = h // Cn
        blk = nb // Cn
        # own-block members first, then grouped by reader block
        order = np.lexsort((nb, np.where(blk == own, -1, blk)))
        nb_o = nb[order]
        rows_h = [int(h)]
        for ci in range(1, -(-d // t)):
            chunk = nb_o[ci * t:(ci + 1) * t]
            r = _alloc_replica(free, int(chunk[0] // Cn), int(own))
            rows_h.append(r)
            mask[r] = True
            orig[r] = orig[h]
        groups[int(h)] = rows_h
        for ci, r in enumerate(rows_h):
            chunk = nb_o[ci * t:(ci + 1) * t]
            rew[h, np.searchsorted(nb, chunk)] = r
            for w in chunk:
                rew2[w, np.searchsorted(nbr[w, :deg[w]], h)] = r

    valid = nbr >= 0
    src = rew[valid]
    dst = rew2[valid]
    nbr2 = np.full((N, t), PAD, np.int64)
    ranks = _occurrence_ranks(src)
    if ranks.size and ranks.max() >= t:
        raise AssertionError("slice overflow — split_hubs chunking bug")
    nbr2[src, ranks] = dst
    deg2 = np.bincount(src, minlength=N)
    g2 = _graph(g, sort_nbr_rows(nbr2), deg2, mask, orig, t)
    plan = _plan_from_groups(
        N=N, deg_logical_of_row=deg, mask=mask, groups=groups, threshold=t,
        n_logical=int(a["node_mask"].sum()), device=g.device)
    return g2, plan


def _plan_from_groups(N: int, deg_logical_of_row: np.ndarray,
                      mask: np.ndarray, groups: Dict[int, List[int]],
                      threshold: int, n_logical: int,
                      device) -> MirrorPlan:
    """Assemble a MirrorPlan from {primary: [rows]} (host bookkeeping)."""
    prow = np.arange(N, dtype=np.int64)
    for h, rows_h in groups.items():
        prow[rows_h] = h
    ldeg = np.where(mask, deg_logical_of_row[prow], 0)
    primary_mask = mask & (prow == np.arange(N))

    n_rows = sum(len(rs) for rs in groups.values())
    Gmax = _pow2(max(1, len(groups)))
    Rp = _pow2(max(1, n_rows))
    grp_rows = np.zeros(Rp, np.int64)
    grp_gid = np.full(Rp, Gmax, np.int64)
    row_gid = np.full(N, Gmax, np.int64)
    i = 0
    for gx, (h, rows_h) in enumerate(sorted(groups.items())):
        for r in rows_h:
            grp_rows[i] = r
            grp_gid[i] = gx
            row_gid[r] = gx
            i += 1
    Km = _pow2(int(ldeg[list(groups)].max()) if groups else 1)
    return MirrorPlan(
        primary_row=_tensor(prow, np.int32, device),
        ldeg=_tensor(ldeg, np.int32, device),
        primary_mask=_tensor(primary_mask, bool, device),
        grp_rows=_tensor(grp_rows, np.int32, device),
        grp_gid=_tensor(grp_gid, np.int32, device),
        row_gid=_tensor(row_gid, np.int32, device),
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
    groups = {int(rekey[h]): [int(rekey[r]) for r in rs]
              for h, rs in groups_of(plan).items()}
    ldeg = relocate_rows(plan.ldeg.cpu().numpy(), rekey, g2.N, 0)
    return _plan_from_groups(
        N=g2.N, deg_logical_of_row=ldeg, mask=g2.node_mask.cpu().numpy(),
        groups=groups, threshold=plan.threshold, n_logical=plan.n_logical,
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
    Host-side.
    """
    a = g2.to_numpy()
    nbr = a["nbr"].astype(np.int64)
    deg = a["deg"].astype(np.int64)
    mask = a["node_mask"].copy()
    orig = a["orig_id"].astype(np.int64)
    prow = plan.primary_row.cpu().numpy().astype(np.int64)
    ldeg = plan.ldeg.cpu().numpy().astype(np.int64)
    N, Cn, Cd2 = g2.N, g2.Cn, g2.Cd
    groups = groups_of(plan)
    free = _free_rows(mask, Cn, g2.P)

    def rows_of(u: int) -> List[int]:
        return groups.get(u, [u])

    def edge_pair(u: int, v: int) -> Optional[Tuple[int, int]]:
        """The (row_u, row_v) holding edge (u, v), or None if absent."""
        rv_set = set(rows_of(v))
        for ru in rows_of(u):
            for x in nbr[ru, :deg[ru]]:
                if int(x) in rv_set:
                    return ru, int(x)
        return None

    def route(u: int, pref_block: int) -> int:
        """Row of u taking one more neighbor; allocates a replica if full."""
        for r in rows_of(u):
            if deg[r] < Cd2:
                return r
        r = _alloc_replica(free, pref_block, u // Cn)
        mask[r] = True
        orig[r] = orig[u]
        prow[r] = u
        groups[u] = rows_of(u) + [r]
        return r

    for u, v, op in edits:
        u, v, op = int(u), int(v), int(op)
        for x in (u, v):
            if not (0 <= x < N) or not mask[x] or prow[x] != x:
                raise ValueError(f"{x} is not a primary row of a real node")
        if u == v:
            raise ValueError(f"self-loop on {u}")
        pair = edge_pair(u, v)
        if op > 0:
            if pair is not None:
                raise ValueError(f"edge ({u}, {v}) already present")
            ru = route(u, v // Cn)
            rv = route(v, ru // Cn)
            _sorted_slice_insert(nbr[ru], int(deg[ru]), rv)
            _sorted_slice_insert(nbr[rv], int(deg[rv]), ru)
            deg[ru] += 1
            deg[rv] += 1
            ldeg[rows_of(u)] += 1
            ldeg[rows_of(v)] += 1
        elif op < 0:
            if pair is None:
                raise ValueError(f"edge ({u}, {v}) not present")
            ru, rv = pair
            _sorted_slice_delete(nbr[ru], int(deg[ru]), rv)
            _sorted_slice_delete(nbr[rv], int(deg[rv]), ru)
            deg[ru] -= 1
            deg[rv] -= 1
            ldeg[rows_of(u)] -= 1
            ldeg[rows_of(v)] -= 1
        else:
            raise ValueError(f"op must be +1/-1, got {op}")

    g3 = _graph(g2, nbr, deg, mask, orig, Cd2)
    plan2 = _plan_from_groups(
        N=N, deg_logical_of_row=ldeg, mask=mask, groups=groups,
        threshold=plan.threshold, n_logical=plan.n_logical,
        device=g2.device)
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
