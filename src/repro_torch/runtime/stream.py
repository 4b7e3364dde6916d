"""Streaming update ingestion: route windows to owner blocks, escalate
cross-block work to the coordinator (one device).

BLADYG's dynamic side is a *stream* of edge updates arriving at the
coordinator.  Per window of up to R updates:

  1. the window is validated at the host boundary against the *current*
     graph (streams may be generators, so there is no whole-stream pass);
  2. one batched Theorem-1 candidate search (on the frontier kernel's R
     axis) determines each update's candidate set;
  3. updates that are **block-local** — both endpoints in one block and
     the candidate set confined to it — and independent of everything
     earlier in the window are applied together, with ONE joint clamped
     recompute (the paper's workerCompute-only fast path);
  4. everything else escalates to the coordinator path (exact sequential
     maintenance, original stream order): cross-block endpoints,
     candidate sets that spill over the block boundary, and conflicts
     with earlier in-window updates.

An update is only hoisted into the block-local batch if its candidate set
is disjoint from every *earlier* window column, so the final coreness
equals processing the stream one update at a time.  The routing verdict
is computed on the device (`_route_window`); only compact (R,)/(P,)
results cross to the host, in one transfer per window.

With `cc_labels=` the session also keeps connected-component labels
exact, window by window, on the post-window graph: a window with a delete
or a migration recomputes them, an insert-only window merges them
(`merge_labels`, inserts only join components).  On one device the
recompute is one union-find pass (`kernels.cc_union.union_find_labels`,
its plain version on the plain backend); on the mesh it is
`connected_components`.  `StreamSession.cc_steps` counts 1 a union-find
recompute and the supersteps of a mesh one.

The stream is elastic:

  * **Live rebalancing** (`rebalance_threshold`) — after each window the
    §4.2 threshold protocol runs: when the max/mean of the per-block loads
    (`partition_dynamic.block_balance`) exceeds the threshold, the
    coordinator picks boundary-vertex moves (`choose_node_moves`, ordered
    by `graph.halo_pair_counts`) and executes them with
    `graph.migrate_vertices`, a node-axis permutation under fixed
    (P, Cn, Cd) that keeps coreness bit for bit.
  * **Capacity growth** (`auto_grow`, `grow`, `add_vertices`) — a window
    that overflows the degree capacity grows Cd to the next power of two
    and re-keys its ids before it is applied; `add_vertices` grows Cn when
    a block has no free row (`graph.grow_blocks`, a pad-and-rekey).
  * **Checkpoints** (`state_dict`, `from_state`; `checkpoint.elastic`).

Window ids stay those of the graph at open (or `add_vertices` handles):
the session composes every migration's permutation and every grow's rekey
into one open-time id map (`_compose_perm`) and resolves each id on
ingest (`_cur`).

`StreamSession` is the resumable stepper (open -> `apply_window` ->
`result`); `run_stream` drains an iterable through one.  Both return a
`StreamResult`, a NamedTuple as in the reference: read its named fields;
unpacking it yields the reference's legacy arity behind its
DeprecationWarning.  `MirrorStream` is the sibling session over a
hub-split graph (`core.hub_split`).

With ``backend="ell_spmd"`` the stream runs on the worker mesh
(`runtime.spmd`): every superstep of every window (the batched candidate
search, the joint recompute, the coordinator path, CC recomputes) goes
through ONE long-lived `SpmdExecutor` (`executor=`, or one of `W`
workers built at open), whose halo plan is maintained incrementally per
window (`apply_updates`), rebuilt after a migration (`rebuild`), refit
after a grow (`grow`) and re-staged after a vertex arrival
(`refresh_fields`); `StreamStats.plan_updates` / `plan_rebuilds` count
them.  Every rank of the mesh runs the same session on the same windows.
"""
from __future__ import annotations

import warnings
from itertools import islice
from typing import (
    Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple,
)

import numpy as np
import torch

from ..core import kcore_dynamic as kd
from ..core import partition_dynamic as pd
from ..core import hub_split
from ..core.algorithms import connected_components, merge_labels
from ..core.graph import (
    CapacityError, GraphBlocks, add_vertices_host, grow_blocks,
    halo_pair_counts, migrate_vertices, relocate_rows,
)
from ..core.updates import validate_updates
from ..device import DeviceLike, resolve_device
from ..kernels.cc_union import union_find_labels, union_find_labels_plain
from ..kernels.ops import SPMD_BACKEND
from ..tracing import (
    CC, LOCAL, MIRROR_REFRESH, MIRROR_WINDOW, SYNC, WINDOW, settle, span,
)
from .halo import _pow2_ceil


class StreamStats(NamedTuple):
    """Routing + superstep accounting for one `run_stream` pass."""

    updates: int                 # total updates ingested
    batches: int                 # windows taken off the stream
    block_local: int             # applied on the block-local batched path
    escalated_cross_block: int   # endpoints in two blocks -> coordinator
    escalated_spill: int         # candidates left the owner block
    escalated_conflict: int      # overlapped an earlier window column
    bfs_steps: int               # frontier supersteps (all paths)
    recompute_steps: int         # clamped min-H supersteps (all paths)
    per_block: Tuple[int, ...]   # block-local updates applied per block
    plan_updates: int = 0        # incremental halo-plan maintenances (mesh)
    plan_rebuilds: int = 0       # full halo-plan rebuilds (mesh)
    migrations: int = 0          # §4.2 rebalance rounds executed
    migrated_vertices: int = 0   # vertices moved across blocks in total
    cc_merges: int = 0           # CC labels maintained by O(1) label merges
    cc_recomputes: int = 0       # CC label recomputations (delete/migration)
    grows: int = 0               # capacity escalations (Cn/Cd pad-and-rekey)

    @property
    def escalated(self) -> int:
        return (self.escalated_cross_block + self.escalated_spill
                + self.escalated_conflict)


class StreamResult(NamedTuple):
    """`run_stream` / `StreamSession.result` return value, the reference's
    tuple.

    `labels` is None unless CC maintenance was armed (`cc_labels=`).
    Tuple-unpacking yields the legacy arity (3 fields, or 4 when labels
    were kept) with a DeprecationWarning, as in the reference; indexing
    and `len()` see all 4 fields.  Read the named fields.
    """

    g: GraphBlocks               # post-stream graph
    core: torch.Tensor           # (N,) int32 maintained coreness
    stats: StreamStats
    labels: Optional[torch.Tensor] = None  # (N,) int32 CC labels, if kept

    def __iter__(self):
        warnings.warn(
            "tuple-unpacking run_stream's result is deprecated; read "
            ".g/.core/.stats/.labels on the returned StreamResult",
            DeprecationWarning, stacklevel=2)
        legacy = (self.g, self.core, self.stats)
        if self.labels is not None:
            legacy += (self.labels,)
        return iter(legacy)


def owner_block(g, u: int) -> int:
    """Owning block of a global padded node id (host-side routing key):
    block-contiguous relabeling makes ownership pure arithmetic."""
    return int(u) // g.Cn


def route_updates(
    g, updates: Iterable[Tuple[int, int, int]]
) -> Tuple[Dict[int, List[Tuple[int, int, int]]], List[Tuple[int, int, int]]]:
    """Host-side router: split a batch into per-owner-block queues plus the
    cross-block remainder the coordinator must handle itself.

    Returns ({block: [updates]}, cross_block_updates).
    """
    per_block: Dict[int, List[Tuple[int, int, int]]] = {}
    cross: List[Tuple[int, int, int]] = []
    for u, v, op in updates:
        bu, bv = owner_block(g, u), owner_block(g, v)
        if bu == bv:
            per_block.setdefault(bu, []).append((u, v, op))
        else:
            cross.append((u, v, op))
    return per_block, cross


class RouteMasks(NamedTuple):
    """Device-side routing verdict for one update window.

    accept/cross/spill/conflict partition the valid columns by escalation
    precedence (cross-block wins over spill wins over conflict).
    """

    accept: torch.Tensor     # (R,) bool — block-local, no spill, no conflict
    cross: torch.Tensor      # (R,) bool — endpoints in two blocks
    spill: torch.Tensor      # (R,) bool — intra-block, candidates left block
    conflict: torch.Tensor   # (R,) bool — intra-block, no spill, overlapped
                             #             an earlier window column
    cand_ins: torch.Tensor   # (N,) bool — union candidates of accepted inserts
    cand_del: torch.Tensor   # (N,) bool — union candidates of accepted deletes
    per_block: torch.Tensor  # (P,) int32 — accepted updates per owner block


def _route_window(cand: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
                  ops_: torch.Tensor, valid: torch.Tensor,
                  Cn: int) -> RouteMasks:
    """Device-side window routing: the candidate-overlap product, the spill
    test and the accept/escalate rule, where the (N, R) candidate matrix
    already lives.

    A column conflicts iff its candidate set overlaps ANY earlier valid
    column (accepted or escalated).  The overlap is a float32 product of
    0/1 matrices (CUDA has no integer matmul): each entry is a sum of
    non-negative terms, so ``> 0`` is exact at any N.
    """
    N, R = cand.shape
    owner = torch.div(us, Cn, rounding_mode="floor")   # (R,) owning blocks
    intra = owner == torch.div(vs, Cn, rounding_mode="floor")
    block_of = torch.arange(N, device=cand.device) // Cn
    candv = cand & valid[None, :]
    spill = (candv & (block_of[:, None] != owner[None, :])).any(dim=0)
    cf = candv.to(torch.float32)
    overlap = cf.T @ cf
    earlier = torch.ones((R, R), dtype=torch.bool,
                         device=cand.device).tril(-1)  # strictly lower
    conflict = ((overlap > 0) & earlier).any(dim=1)
    accept = valid & intra & ~spill & ~conflict
    cross = valid & ~intra
    esc_spill = valid & intra & spill
    esc_conflict = valid & intra & ~spill & conflict
    cand_ins = (candv & (accept & (ops_ > 0))[None, :]).any(dim=1)
    cand_del = (candv & (accept & (ops_ < 0))[None, :]).any(dim=1)
    # owners repeat across columns: accumulate, never assign
    per_block = torch.zeros(N // Cn, dtype=torch.int32, device=cand.device)
    per_block.index_add_(0, owner, accept.to(torch.int32))
    return RouteMasks(accept, cross, esc_spill, esc_conflict,
                      cand_ins, cand_del, per_block)


def _iter_windows(updates, R: int) -> Iterator[list]:
    it = iter(updates)
    while True:
        window = list(islice(it, R))
        if not window:
            return
        yield window


class StreamSession:
    """Resumable stream stepper: open -> `apply_window` -> `result`.

    Holds the current graph, the maintained coreness (and optionally CC
    labels), the open-time id map and the routing / superstep counters, so
    a caller can interleave other device work between windows.
    `apply_window` takes a list of at most `R` updates `(u, v, op)` with
    ids global padded *as of session open* (or `add_vertices` handles);
    later migrations and grows are remapped internally.  Windows narrower
    than R are padded to the fixed width.

    `cc_labels` (optional) arms CC maintenance: the canonical labels of
    the graph at open, as `core.algorithms.connected_components` returns
    them; `.labels` then stays equal to a recompute after every window,
    and `cc_steps` counts those recomputes' passes over the slots (see
    `cc_steps`).
    `rebalance_threshold` arms the §4.2 protocol after every window (None
    disables it), moving at most `rebalance_max_moves` vertices a round.
    `auto_grow` grows the capacities instead of raising `CapacityError`.
    ``backend="ell_spmd"`` runs the session on the worker mesh through
    `.executor`: `executor` (a `runtime.spmd.SpmdExecutor` of `g`), or
    one of `W` workers built here; `executor` with any other backend
    raises ValueError, as in the JAX package (its plan would go stale).
    `.executor` is None on one device (the service and
    `runtime.recovery` read it).

    The graph passed at open is updated IN PLACE until a migration or a
    grow replaces it with a new one; read `.g` back.
    """

    def __init__(self, g: GraphBlocks, core: torch.Tensor, R: int = 8,
                 backend: str = "auto", W=None, executor=None,
                 rebalance_threshold: Optional[float] = None,
                 rebalance_max_moves: int = 8,
                 cc_labels: Optional[torch.Tensor] = None,
                 auto_grow: bool = False):
        if R < 1:
            raise ValueError(f"R must be >= 1, got {R}")
        spmd = backend == SPMD_BACKEND
        if executor is not None and not spmd:
            raise ValueError(
                f"executor= requires backend={SPMD_BACKEND!r} (got "
                f"{backend!r}); a non-mesh stream would leave the "
                "executor's halo plan stale.")
        self.R = int(R)
        self.backend = backend
        self._W = W
        #: the mesh executor (None on one device)
        self.executor = kd._spmd_executor(g, W, executor) if spmd else None
        # the executor's counters at open: the stats count from here
        self._ex_updates0 = self.executor.plan_updates if spmd else 0
        self._ex_rebuilds0 = self.executor.full_rebuilds if spmd else 0
        self.g = g
        self.core = torch.as_tensor(core, device=g.device)
        self._tot = dict(bfs=0, rec=0, cand=0, batched=0, seq=0, batches=0)
        self._n_updates = 0
        self._n_local = 0
        #: candidates of the joint block-local recomputes, on the device
        #: so that a window reads nothing more (`local_candidates`)
        self._local_cand = torch.zeros((), dtype=torch.int64,
                                       device=g.device)
        self._esc_cross = self._esc_spill = self._esc_conflict = 0
        self._per_block = np.zeros(g.P, np.int64)
        self.labels = (None if cc_labels is None
                       else torch.as_tensor(cc_labels, device=g.device))
        self._cc_merges = self._cc_recomputes = self._cc_steps = 0
        self._rebalance_threshold = rebalance_threshold
        self._rebalance_max_moves = int(rebalance_max_moves)
        self._migrations = self._migrated = 0
        self._remap: Optional[np.ndarray] = None  # open-time -> current ids
        self._auto_grow = bool(auto_grow)
        self._grows = 0
        #: id space size at open: window ids below it are open-time padded
        #: ids; ids at/above it are `add_vertices` handles, resolved
        #: through `_virtual` (their current padded ids)
        self._n_open = g.N
        self._virtual: List[int] = []
        #: hub-split plan slot: always None here; the service reads
        #: `.mirror` the same way from either kind of session
        self.mirror = None

    @property
    def windows_applied(self) -> int:
        """Windows ingested so far."""
        return self._tot["batches"]

    @property
    def local_candidates(self) -> int:
        """Candidates of every joint block-local recompute since open (each
        window's union of its accepted columns' candidate sets, summed
        over the windows; a restored session counts from 0).  Kept on the
        device; this read is a host read, for callers off the stream's
        path."""
        return int(self._local_cand)

    @property
    def cc_steps(self) -> int:
        """Passes over the slots of every CC label recompute since open: 1
        a recompute on one device (the union-find's hook pass; its init
        and finalize read no slot), the supersteps
        `connected_components(..., with_steps=True)` gives on the mesh; 0
        where labels are not kept.  The port's own count: the JAX package
        keeps none."""
        return self._cc_steps

    def _recompute_labels(self, g: GraphBlocks) -> None:
        """Canonical labels of `g`: by union-find on one device (its plain
        version on the plain backend, "torch", as every kernel there), by
        `connected_components` on the mesh."""
        if self.executor is None:
            find = (union_find_labels_plain if self.backend == "torch"
                    else union_find_labels)
            self.labels = find(g.nbr, g.deg, g.node_mask)
            steps = 1
        else:
            self.labels, steps = connected_components(
                g, backend=self.backend, executor=self.executor,
                with_steps=True)
        self._cc_recomputes += 1
        self._cc_steps += steps

    def apply_window(self, window: List[Tuple[int, int, int]]) -> None:
        """Ingest ONE window of at most R updates (see class docstring)."""
        with span(WINDOW):
            if len(window) > self.R:
                raise ValueError(
                    f"window of {len(window)} updates exceeds R={self.R}")
            if not window:
                return
            window = [(self._cur(u), self._cur(v), int(op))
                      for u, v, op in window]
            while True:
                try:
                    validate_updates(self.g, window)
                    break
                except CapacityError:
                    if not self._auto_grow:
                        raise
                    # a row of this window is out of degree capacity: grow Cd
                    # to the next power of two, re-key the window (the grow
                    # relocates every row) and validate again
                    rekey = self.grow(Cd=_pow2_ceil(self.g.Cd + 1))
                    window = [(int(rekey[u]), int(rekey[v]), op)
                              for u, v, op in window]
            g, core, tot, backend = self.g, self.core, self._tot, self.backend
            W, ex = self._W, self.executor
            tot["batches"] += 1
            R, n = self.R, len(window)
            self._n_updates += n
            us = np.zeros(R, np.int64)
            vs = np.zeros(R, np.int64)
            ops_ = np.zeros(R, np.int64)
            us[:n] = [u for u, _, _ in window]
            vs[:n] = [v for _, v, _ in window]
            ops_[:n] = [op for _, _, op in window]
            valid = np.zeros(R, bool)
            valid[:n] = True

            dev = g.device
            us_d, vs_d, ops_d, valid_d = (torch.as_tensor(a, device=dev)
                                          for a in (us, vs, ops_, valid))
            cand, steps = kd._batch_candidates(g, core, us_d, vs_d, valid_d,
                                               backend=backend, executor=ex)
            route = _route_window(cand, us_d, vs_d, ops_d, valid_d, Cn=g.Cn)
            # ONE transfer per window pulls the compact verdict
            with span(SYNC):
                verdict = torch.cat([
                    torch.stack([route.accept, route.cross, route.spill,
                                 route.conflict]).to(torch.int32).reshape(-1),
                    route.per_block]).cpu().numpy()
            accept, cross, spl, conf = (verdict[:4 * R].reshape(4, R)
                                        .astype(bool))
            nblk = verdict[4 * R:]
            tot["bfs"] += steps
            self._esc_cross += int(cross.sum())
            self._esc_spill += int(spl.sum())
            self._esc_conflict += int(conf.sum())

            if accept.any():
                # accepted updates keep their window order
                acc = np.flatnonzero(accept)
                with span(LOCAL):
                    self._local_cand += (route.cand_ins
                                         | route.cand_del).sum()
                    g, core, rec = kd._apply_and_recompute(
                        g, core, us[acc], vs[acc], ops_[acc], route.cand_ins,
                        route.cand_del, backend=backend, W=W, ex=ex)
                tot["rec"] += rec
                self._n_local += len(acc)
                self._per_block += nblk.astype(np.int64)

            # coordinator path, original stream order within the window
            for r in np.flatnonzero(cross | spl | conf):
                g, core = kd._maintain_one(g, core, window[r], tot, backend,
                                           W=W, ex=ex)

            # §4.2 repartition-threshold protocol, live: per-block load
            # summaries -> threshold + move selection -> a node migration
            migrated_now = False
            if (self._rebalance_threshold is not None
                    and pd.block_balance(g) > self._rebalance_threshold):
                moves = pd.choose_node_moves(
                    g, max_moves=self._rebalance_max_moves,
                    pair_counts=halo_pair_counts(g))
                if moves:
                    g, perm, core = migrate_vertices(g, moves, core)
                    self._compose_perm(perm)
                    self._migrations += 1
                    self._migrated += len(moves)
                    migrated_now = True
                    if ex is not None:
                        ex.rebuild(g)

            # CC labels on the post-window graph: inserts only ever JOIN
            # components, so an insert-only window is an on-device label merge;
            # a delete may split one, and a migration renames the padded ids
            # the canonical labels are, so such a window recomputes them
            if self.labels is not None:
                with span(CC):
                    ins = valid & (ops_ > 0)
                    if (valid & (ops_ < 0)).any() or migrated_now:
                        self._recompute_labels(g)
                    elif ins.any():
                        self.labels = merge_labels(
                            self.labels, us_d, vs_d,
                            torch.as_tensor(ins, device=dev))
                        self._cc_merges += int(ins.sum())
                    # the upkeep reads nothing back: under a profiler the
                    # span waits for its kernels, so that it holds them
                    settle(dev)
            self.g, self.core = g, core

    # ---- elastic growth / recovery surface ------------------------------

    def _cur(self, u) -> int:
        """Resolve an open-time id (or `add_vertices` handle) to the
        CURRENT padded id, through the composed migration/grow remap."""
        u = int(u)
        if u >= self._n_open:
            i = u - self._n_open
            if i >= len(self._virtual):
                raise ValueError(
                    f"unknown vertex handle {u} (have "
                    f"{len(self._virtual)} post-open vertices)")
            return self._virtual[i]
        if self._remap is None:
            return u
        cur = int(self._remap[u])
        if cur < 0:
            raise ValueError(f"open-time id {u} no longer exists")
        return cur

    def _compose_perm(self, perm: np.ndarray) -> None:
        """Fold a node-axis permutation/rekey (host int64, -1 for dropped
        rows) into the open-time id maps."""
        perm = np.asarray(perm, np.int64)
        if self._remap is None:
            self._remap = perm.copy()
        else:
            self._remap = np.where(
                self._remap >= 0, perm[np.maximum(self._remap, 0)], -1)
        self._virtual = [int(perm[x]) for x in self._virtual]

    def grow(self, Cn: Optional[int] = None,
             Cd: Optional[int] = None) -> np.ndarray:
        """Capacity escalation on the live session: pad-and-rekey the
        blocks to (Cn, Cd) (`core.graph.grow_blocks`), relocating the
        maintained coreness and CC labels along (label *values* are padded
        ids, so they ride the same monotone rekey and stay canonical), and
        folding the rekey into the open-time id map; on the mesh the
        executor refits to the grown graph (`SpmdExecutor.grow`).  Returns
        the rekey map (host int64)."""
        g2, rekey = grow_blocks(self.g, Cn, Cd)
        dev = g2.device
        core = relocate_rows(self.core.cpu().numpy(), rekey, g2.N, 0)
        self.core = torch.from_numpy(core).to(dev)
        if self.labels is not None:
            lab = relocate_rows(self.labels.cpu().numpy(), rekey, g2.N, -1)
            lab = np.where(lab >= 0, rekey[np.maximum(lab, 0)], -1)
            self.labels = torch.from_numpy(lab.astype(np.int32)).to(dev)
        self._compose_perm(rekey)
        self.g = g2
        if self.executor is not None:
            self.executor.grow(g2)
        self._grows += 1
        return rekey

    def add_vertices(self, block: int, count: int = 1) -> List[int]:
        """Vertex arrival: activate `count` fresh degree-0 nodes in
        `block` (`core.graph.add_vertices_host`), growing Cn first when
        the block is full and auto-grow is armed.  Returns stable HANDLES:
        ids in the session's open-time id space, usable in later windows
        like any open-time id (they survive migrations and grows;
        allocation is deterministic, so a replayed log hands back the same
        handles)."""
        while True:
            try:
                g2, rows = add_vertices_host(self.g, block, count)
                break
            except CapacityError:
                if not self._auto_grow:
                    raise
                self.grow(Cn=_pow2_ceil(self.g.Cn + 1))
        self.g = g2
        if self.executor is not None:
            self.executor.refresh_fields(g2)
        if self.labels is not None:
            # a fresh isolated vertex is its own component (canonical
            # label == own padded id); coreness 0 already holds
            r = torch.from_numpy(rows).to(g2.device)
            self.labels = self.labels.index_put((r,), r.to(self.labels.dtype))
        base = self._n_open + len(self._virtual)
        self._virtual.extend(int(x) for x in rows)
        return list(range(base, base + len(rows)))

    def migrate(self, moves) -> np.ndarray:
        """Execute an explicit vertex migration (caller-chosen moves).
        Same machinery as the §4.2 rebalance: a node-axis permutation
        composed into the id map, a plan rebuild on the mesh, and one CC
        recompute when labels are kept.  Returns the permutation
        (host int64)."""
        g, perm, core = migrate_vertices(self.g, moves, self.core)
        self.g, self.core = g, core
        self._compose_perm(perm)
        self._migrations += 1
        self._migrated += len(moves)
        if self.executor is not None:
            self.executor.rebuild(g)
        if self.labels is not None:
            self._recompute_labels(g)
        return perm

    def state_dict(self):
        """Everything needed to resume this stream elsewhere: a flat dict
        of tensors (which `checkpoint.CheckpointManager` saves) plus a
        JSON-able meta dict of statics and counters, the JAX package's
        keys and layout.  Every tensor is a CLONE: the session updates the
        live graph in place, so a snapshot sharing storage would change
        with the next window.

        The recompute supersteps are counted on the host, so ``rec_dev``
        (the JAX package's on-device counter) is written as a 0-d int32
        zero and the count rides in ``meta["tot"]``.  ``remap`` is int32
        on disk, as the JAX package writes it."""
        g = self.g
        plan_updates, plan_rebuilds = self._plan_counts()
        arrays = {
            "core": self.core.clone(),
            "g.deg": g.deg.clone(),
            "g.nbr": g.nbr.clone(),
            "g.node_mask": g.node_mask.clone(),
            "g.orig_id": g.orig_id.clone(),
            "rec_dev": torch.zeros((), dtype=torch.int32, device=g.device),
        }
        if self.labels is not None:
            arrays["labels"] = self.labels.clone()
        if self._remap is not None:
            arrays["remap"] = torch.from_numpy(
                self._remap.astype(np.int32)).to(g.device)
        meta = {
            "kind": "stream_session",
            "P": g.P, "Cn": g.Cn, "Cd": g.Cd,
            "R": self.R, "backend": self.backend,
            "auto_grow": self._auto_grow,
            "track_labels": self.labels is not None,
            "has_remap": self._remap is not None,
            "n_open": self._n_open,
            "virtual": [int(x) for x in self._virtual],
            "rebalance_threshold": self._rebalance_threshold,
            "rebalance_max_moves": self._rebalance_max_moves,
            "tot": {k: int(v) for k, v in self._tot.items()},
            "counters": {
                "n_updates": self._n_updates,
                "n_local": self._n_local,
                "esc_cross": self._esc_cross,
                "esc_spill": self._esc_spill,
                "esc_conflict": self._esc_conflict,
                "migrations": self._migrations,
                "migrated": self._migrated,
                "cc_merges": self._cc_merges,
                "cc_recomputes": self._cc_recomputes,
                "cc_steps": self._cc_steps,
                "grows": self._grows,
                "plan_updates": plan_updates,
                "plan_rebuilds": plan_rebuilds,
                "per_block": [int(x) for x in self._per_block],
            },
        }
        return arrays, meta

    def _plan_counts(self) -> Tuple[int, int]:
        """(plan updates, full plan rebuilds) of the executor since open
        (both 0 on one device)."""
        if self.executor is None:
            return 0, 0
        ex = self.executor
        return (ex.plan_updates - self._ex_updates0,
                ex.full_rebuilds - self._ex_rebuilds0)

    @classmethod
    def from_state(cls, arrays, meta, W=None, backend: Optional[str] = None,
                   executor=None, device: DeviceLike = None
                   ) -> "StreamSession":
        """Rebuild a session from `state_dict` output, this package's or
        the JAX package's (arrays may be tensors or numpy arrays).  The
        session gets copies on `device` (default CUDA, see
        `device.resolve_device`), never the snapshot's storage.
        `backend` overrides the snapshot's, and `W`/`executor` give the
        mesh to restore onto (the remesh path: the arrays are global, so
        any W with W | P adopts them; every rank restores the same
        snapshot and stages its shard).  A snapshot's ``rec_dev`` is added
        to the recompute count, and the plan counters carry on from the
        snapshot's."""
        dev = resolve_device(device)

        def tensor(key, dtype):
            x = arrays[key]
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x))
            return x.to(device=dev, dtype=dtype, copy=True)

        g = GraphBlocks(
            nbr=tensor("g.nbr", torch.int32),
            deg=tensor("g.deg", torch.int32),
            node_mask=tensor("g.node_mask", torch.bool),
            orig_id=tensor("g.orig_id", torch.int32),
            P=int(meta["P"]), Cn=int(meta["Cn"]), Cd=int(meta["Cd"]))
        sess = cls(
            g, tensor("core", torch.int32), R=int(meta["R"]),
            backend=meta["backend"] if backend is None else backend,
            W=W, executor=executor,
            rebalance_threshold=meta["rebalance_threshold"],
            rebalance_max_moves=int(meta["rebalance_max_moves"]),
            cc_labels=(tensor("labels", torch.int32)
                       if meta["track_labels"] else None),
            auto_grow=bool(meta["auto_grow"]))
        sess._remap = (np.asarray(tensor("remap", torch.int64).cpu())
                       if meta["has_remap"] else None)
        sess._n_open = int(meta["n_open"])
        sess._virtual = [int(x) for x in meta["virtual"]]
        sess._tot = {k: int(v) for k, v in meta["tot"].items()}
        sess._tot["rec"] += int(tensor("rec_dev", torch.int64))
        c = meta["counters"]
        sess._n_updates = int(c["n_updates"])
        sess._n_local = int(c["n_local"])
        sess._esc_cross = int(c["esc_cross"])
        sess._esc_spill = int(c["esc_spill"])
        sess._esc_conflict = int(c["esc_conflict"])
        sess._migrations = int(c["migrations"])
        sess._migrated = int(c["migrated"])
        sess._cc_merges = int(c["cc_merges"])
        sess._cc_recomputes = int(c["cc_recomputes"])
        # the JAX package's snapshots do not count the supersteps
        sess._cc_steps = int(c.get("cc_steps", 0))
        sess._grows = int(c["grows"])
        sess._per_block = np.asarray(c["per_block"], np.int64)
        if sess.executor is not None:
            # re-base the executor offsets: the counts go on from the
            # snapshot's totals
            sess._ex_updates0 = (sess.executor.plan_updates
                                 - int(c["plan_updates"]))
            sess._ex_rebuilds0 = (sess.executor.full_rebuilds
                                  - int(c["plan_rebuilds"]))
        return sess

    def stats(self) -> StreamStats:
        """Routing/superstep accounting over every window applied so far.
        `plan_updates` and `plan_rebuilds` count the executor's halo-plan
        maintenance on the mesh (0 on one device)."""
        plan_updates, plan_rebuilds = self._plan_counts()
        return StreamStats(
            updates=self._n_updates,
            batches=self._tot["batches"],
            block_local=self._n_local,
            escalated_cross_block=self._esc_cross,
            escalated_spill=self._esc_spill,
            escalated_conflict=self._esc_conflict,
            bfs_steps=self._tot["bfs"],
            recompute_steps=self._tot["rec"],
            per_block=tuple(int(x) for x in self._per_block),
            plan_updates=plan_updates,
            plan_rebuilds=plan_rebuilds,
            migrations=self._migrations,
            migrated_vertices=self._migrated,
            cc_merges=self._cc_merges,
            cc_recomputes=self._cc_recomputes,
            grows=self._grows,
        )

    def result(self) -> StreamResult:
        """The session's state as a `StreamResult` snapshot (the session
        stays usable; `close` is the self-documenting alias)."""
        return StreamResult(g=self.g, core=self.core, stats=self.stats(),
                            labels=self.labels)

    close = result


def run_stream(
    g: GraphBlocks,
    core: torch.Tensor,
    updates: Iterable[Tuple[int, int, int]],
    R: int = 8,
    backend: str = "auto",
    W=None,
    executor=None,
    rebalance_threshold: Optional[float] = None,
    rebalance_max_moves: int = 8,
    cc_labels: Optional[torch.Tensor] = None,
    auto_grow: bool = False,
) -> StreamResult:
    """Ingest an update stream; returns a `StreamResult` (g, core, stats,
    labels).

    g: GraphBlocks (P blocks of Cn rows, nbr (N, Cd)); core: (N,) int32
    coreness of `g` (as `core.kcore.coreness` returns it).  `updates` may
    be any iterable (including a generator) of (u, v, op) with op = +1
    insert / -1 delete and ids global padded *as of the call* (migrations
    and grows remap later windows internally).  R is the window width (the
    stacked-frontier axis of the batched candidate search).  `backend` is
    any of `kernels.ops.BACKENDS` or "auto" (the default); "dense" builds
    its (N, N) bfloat16 adjacency once per candidate search and once per
    recompute (CC labels are recomputed by union-find on every
    single-device backend).  The final coreness equals sequential
    per-update maintenance — under live rebalancing up to the node-axis
    permutation, i.e. equal when read through `orig_id`.  `g` is updated in place until a migration or grow
    replaces it; use the returned graph.  With ``backend="ell_spmd"``
    every superstep runs on the worker mesh through ONE long-lived
    executor (`executor`, to thread one across calls, or one of `W`
    workers) whose halo plan is maintained incrementally per window.

    `rebalance_threshold` (e.g. 1.2) arms the §4.2 protocol after every
    window, moving at most `rebalance_max_moves` vertices a round; None
    disables it.  `auto_grow` grows Cd when a window overflows it.

    `cc_labels` (optional): the canonical CC labels of the pre-stream
    graph (as `core.algorithms.connected_components` returns them).  The
    stream then keeps them exact in `result.labels`, bit-identical to
    `connected_components` of the final graph; `StreamStats.cc_merges` /
    `cc_recomputes` count the merge and recompute paths.  Without it,
    `result.labels` is None.
    """
    session = StreamSession(
        g, core, R=R, backend=backend, W=W, executor=executor,
        rebalance_threshold=rebalance_threshold,
        rebalance_max_moves=rebalance_max_moves, cc_labels=cc_labels,
        auto_grow=auto_grow)
    for window in _iter_windows(updates, R):
        session.apply_window(window)
    return session.result()


class MirrorStream:
    """Stream ingestion over a hub-split graph (vertex-cut maintenance).

    `StreamSession`'s sibling for graphs that went through
    `core.hub_split.split_hubs`: holds the split `GraphBlocks` and its
    `MirrorPlan` and ingests `(u, v, op)` edit windows whose ids are
    PRIMARY row ids of the split graph at open.  Each window goes through
    `hub_split.apply_mirrored_edits` at the host boundary (capacity-routed
    inserts, on-line splits, mirrored deletes), then the analytics are
    recomputed mirror-aware — `kcore.coreness(..., mirror=plan)` and, with
    `cc_labels`, `connected_components(..., mirror=plan)` — which is exact
    by the split == unsplit parity; on ``backend="ell_spmd"`` each
    recompute runs on the worker mesh with an executor built for it, as
    in the JAX package (`.executor` stays None).  (A candidate-bounded
    mirrored maintenance pass is future work in the JAX package too.)

    `auto_grow` grows Cn when the replica pool runs dry mid-window: the
    edit path works on copies, so the failed attempt leaves nothing half
    applied and the whole window re-applies on the grown graph.

    Duck-types the slice of `StreamSession` the service consumes: `.g`,
    `.core`, `.labels`, `.backend`, `.executor` (always None),
    `.windows_applied`, `.mirror` and `result()`.  `refresh_steps` counts
    the supersteps of every mirror-aware coreness it ran, the one at open
    included (`StreamStats` keeps the JAX package's fields, which read 0
    here).  The coreness at open and after a grow starts from the logical
    degrees; after a window it starts from
    `kcore_dynamic.window_core_bound` of the coreness before it, which is
    exact on the same rows (edits and on-line splits keep every primary
    where it was), and `warm_refreshes` counts those refreshes.  Labels
    are recomputed from scratch: deletes can split a component;
    `cc_steps` counts those recomputes' supersteps.  Every
    graph and plan
    it holds is made of fresh tensors (the edit path never writes in
    place), and `state_dict` clones besides.
    """

    def __init__(self, g: GraphBlocks, plan, backend: str = "auto",
                 cc_labels: bool = False, auto_grow: bool = False):
        self.g = g
        self.mirror = plan
        self.backend = backend
        self.executor = None
        self._windows = 0
        self._n_updates = 0
        self._track_labels = bool(cc_labels)
        self._auto_grow = bool(auto_grow)
        self._grows = 0
        #: open-time row ids -> current (grows rekey every row)
        self._remap: Optional[np.ndarray] = None
        self.refresh_steps = 0
        self.warm_refreshes = 0
        self.cc_steps = 0
        self._refresh()

    @property
    def windows_applied(self) -> int:
        return self._windows

    def _refresh(self, window=None) -> None:
        """Recompute the maintained analytics mirror-aware; after
        `window`, applied to the graph whose coreness `self.core` holds,
        the coreness starts from the window's bound."""
        from ..core.kcore import coreness_with_stats

        with span(MIRROR_REFRESH):
            state0 = None
            if window is not None:
                state0 = kd.window_core_bound(
                    self.core, self.mirror.ldeg, self.mirror.primary_mask,
                    [(u, v) for u, v, op in window if op > 0])
                self.warm_refreshes += 1
            self.core, steps = coreness_with_stats(
                self.g, backend=self.backend, mirror=self.mirror,
                state0=state0)
            self.refresh_steps += steps
            if not self._track_labels:
                self.labels = None
                return
            with span(CC):
                self.labels, steps = connected_components(
                    self.g, backend=self.backend, mirror=self.mirror,
                    with_steps=True)
                self.cc_steps += steps

    def grow(self, Cn: Optional[int] = None,
             Cd: Optional[int] = None) -> np.ndarray:
        """Capacity escalation under the vertex cut: pad-and-rekey the split
        graph (`core.graph.grow_blocks`), relocate the plan along
        (`hub_split.grow_plan`), fold the rekey into the open-time id map
        and recompute the analytics.  Returns the rekey map."""
        g2, rekey = grow_blocks(self.g, Cn, Cd)
        self.mirror = hub_split.grow_plan(self.mirror, rekey, g2)
        self.g = g2
        self._remap = (rekey.astype(np.int64) if self._remap is None
                       else np.where(self._remap >= 0,
                                     rekey[np.maximum(self._remap, 0)], -1))
        self._grows += 1
        self._refresh()
        return rekey

    def apply_window(self, window: List[Tuple[int, int, int]]) -> None:
        """Apply one edit window (open-time primary-row ids) and refresh
        the analytics, growing Cn in flight when auto-grow is armed and
        the replica pool runs dry."""
        if not window:
            return
        with span(MIRROR_WINDOW):
            self._apply_window(window)

    def _apply_window(self, window) -> None:
        if self._remap is not None:
            window = [(int(self._remap[u]), int(self._remap[v]), op)
                      for u, v, op in window]
        while True:
            try:
                g2, plan2 = hub_split.apply_mirrored_edits(
                    self.g, self.mirror, window)
                break
            except CapacityError:
                if not self._auto_grow:
                    raise
                rekey = self.grow(Cn=_pow2_ceil(self.g.Cn + 1))
                window = [(int(rekey[u]), int(rekey[v]), op)
                          for u, v, op in window]
        self.g, self.mirror = g2, plan2
        self._windows += 1
        self._n_updates += len(window)
        self._refresh(window)

    def state_dict(self):
        """Snapshot tensors + meta in the JAX package's layout: graph and
        plan leaves in the flat dict (``g.*``, ``plan.*``), statics and
        counters in meta.  Every tensor is a clone; ``remap`` is written
        int32, as the JAX package writes it."""
        g, p = self.g, self.mirror
        arrays = {"core": self.core.clone()}
        arrays.update({f"g.{f}": getattr(g, f).clone()
                       for f in ("deg", "nbr", "node_mask", "orig_id")})
        arrays.update({f"plan.{f}": getattr(p, f).clone()
                       for f in sorted(p.ARRAYS)})
        if self.labels is not None:
            arrays["labels"] = self.labels.clone()
        if self._remap is not None:
            arrays["remap"] = torch.from_numpy(
                self._remap.astype(np.int32)).to(g.device)
        meta = {
            "kind": "mirror_stream",
            "P": g.P, "Cn": g.Cn, "Cd": g.Cd,
            "backend": self.backend,
            "auto_grow": self._auto_grow,
            "track_labels": self._track_labels,
            "has_remap": self._remap is not None,
            "Gmax": p.Gmax, "Km": p.Km, "threshold": p.threshold,
            "n_logical": p.n_logical,
            "windows": self._windows,
            "n_updates": self._n_updates,
            "grows": self._grows,
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays, meta, backend: Optional[str] = None,
                   device: DeviceLike = None) -> "MirrorStream":
        """Rebuild a mirrored session from `state_dict` output, this
        package's or the JAX package's (tensors or numpy arrays), with
        copies on `device` (default CUDA, see `device.resolve_device`).
        The plan gets a fresh uid; the maintained analytics are restored
        verbatim, the snapshot being the source of truth."""
        dev = resolve_device(device)

        def tensor(key, dtype):
            x = arrays[key]
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x))
            return x.to(device=dev, dtype=dtype, copy=True)

        def dtype_of(name):
            return torch.bool if name.endswith("mask") else torch.int32

        g = GraphBlocks(
            **{f: tensor(f"g.{f}", dtype_of(f))
               for f in ("nbr", "deg", "node_mask", "orig_id")},
            P=int(meta["P"]), Cn=int(meta["Cn"]), Cd=int(meta["Cd"]))
        plan = hub_split.MirrorPlan(
            **{f: tensor(f"plan.{f}", dtype_of(f))
               for f in hub_split.MirrorPlan.ARRAYS},
            Gmax=int(meta["Gmax"]), Km=int(meta["Km"]),
            threshold=int(meta["threshold"]),
            n_logical=int(meta["n_logical"]), uid=hub_split._next_uid())
        sess = cls(g, plan,
                   backend=meta["backend"] if backend is None else backend,
                   cc_labels=bool(meta["track_labels"]),
                   auto_grow=bool(meta["auto_grow"]))
        sess.core = tensor("core", torch.int32)
        if meta["track_labels"]:
            sess.labels = tensor("labels", torch.int32)
        sess._remap = (np.asarray(tensor("remap", torch.int64).cpu())
                       if meta["has_remap"] else None)
        sess._windows = int(meta["windows"])
        sess._n_updates = int(meta["n_updates"])
        sess._grows = int(meta["grows"])
        return sess

    def result(self) -> StreamResult:
        """Current state as a `StreamResult`; routing and superstep stats
        are not metered on the mirrored path and read 0."""
        stats = StreamStats(
            updates=self._n_updates, batches=self._windows, block_local=0,
            escalated_cross_block=0, escalated_spill=0,
            escalated_conflict=0, bfs_steps=0, recompute_steps=0,
            per_block=tuple(0 for _ in range(self.g.P)),
            grows=self._grows)
        return StreamResult(g=self.g, core=self.core, stats=stats,
                            labels=self.labels)

    close = result
