"""Incremental k-core maintenance — the heart of BLADYG (paper §4.1).

On an edge update the coordinator does NOT recompute coreness from scratch.
Per Theorem 1 [Li, Yu, Mao, TKDE'14] only nodes *k-reachable* from the
lower-coreness endpoint can change, where k = min(core(u), core(v)):
a node w is k-reachable from r if there is a path r ~> w whose nodes all
have coreness exactly k.

Execution plan:
  1. the update (u, v) goes to the blocks owning u and v;
  2. a frontier search finds the candidate set (`k_reachable_batch`, one
     `ops.frontier_blocks` hop per superstep);
  3. the edge is applied and a restricted recomputation runs on the
     candidates only (`_restricted_recompute`: clamped min-H supersteps
     through `ops.hindex_blocks`; see kcore.py for why it is exact).

Insertion can only *raise* a candidate's coreness, by at most 1; deletion
can only *lower* it, by at most 1.  So the restricted iteration starts from
`core + 1` (insert) / `core` (delete) on candidates, capped by the new
degree, and clamps everyone else.  The candidate set is the union of the
k-reachable sets from both endpoints plus the endpoints, searched in the
pre-update graph.

Batched maintenance (`maintain_batch`): R updates whose candidate sets are
pairwise disjoint are independent, so their searches stack on the frontier
R axis (supersteps = max instead of sum), the accepted edges apply
together, and ONE joint clamped recompute finishes the chunk.  Conflicting
updates fall back to the exact sequential path.  The result equals
sequential maintenance; only the superstep count drops.

With ``backend="ell_spmd"`` every superstep (the batched k-reachability
search and the joint clamped recompute) runs on the worker mesh
(`runtime.spmd.SpmdExecutor`): `maintain_batch` threads ONE executor
through the stream and maintains its halo plan after every applied edit
(`SpmdExecutor.apply_updates`, dirty workers only), as the JAX package
does; `k_reachable_batch` and `_restricted_recompute` run on an executor
given as `executor=` or built for the call.  The per-edge entry points
(`insert_edge_maintain`, `delete_edge_maintain`, `maintain_batch_host`)
refuse the mesh backend with a ValueError, as the JAX package's do.

Unlike the JAX package, whose jitted functions donate `g`, the functions
here update the graph's rows IN PLACE (`graph.insert_edge` /
`delete_edge`) and return the same object: do not keep using a graph you
passed in as if it were the old one.  Superstep counts and stats come
back as host ints.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ops import SPMD_BACKEND
from .graph import GraphBlocks, delete_edge, insert_edge
from .updates import validate_updates


def _reject_spmd(backend: str, fn_name: str) -> None:
    """The JAX package's refusal of the mesh backend on a per-edge entry
    point, with its ValueError."""
    if backend == SPMD_BACKEND:
        raise ValueError(
            f"{fn_name} does not support backend={SPMD_BACKEND!r}: it runs "
            "under jit, where the runtime's halo plan cannot be built from "
            "traced arrays. Use maintain_batch(..., backend='ell_spmd') or "
            "runtime.run_stream for mesh-executed maintenance.")


class MaintenanceStats(NamedTuple):
    candidates: int        # |candidate set|
    bfs_steps: int         # frontier supersteps (W2W rounds)
    recompute_steps: int   # clamped min-H supersteps
    blocks_touched: int    # #blocks containing candidates
    inter_partition: bool  # update crossed a block boundary


class BatchMaintenanceStats(NamedTuple):
    """Aggregate accounting for one `maintain_batch` stream."""

    updates: int           # total updates processed
    batches: int           # number of batched chunks executed
    batched_updates: int   # updates that rode a batched chunk
    sequential_updates: int  # updates deferred to the sequential path
    bfs_steps: int         # total frontier supersteps (batched + sequential)
    recompute_steps: int   # total clamped min-H supersteps
    candidates: int        # total candidate-set size across updates


def k_reachable(
    g: GraphBlocks, core: torch.Tensor, roots: torch.Tensor, k: torch.Tensor,
    max_steps: int = 10_000, backend: str = "auto", executor=None,
) -> Tuple[torch.Tensor, int]:
    """Mask of nodes k-reachable from `roots` (incl. roots with core==k).

    Returns (visited mask (N,), number of supersteps).
    """
    visited, steps = k_reachable_batch(
        g, core, roots[:, None], k.reshape(1), max_steps=max_steps,
        backend=backend, executor=executor)
    return visited[:, 0], steps


def k_reachable_batch(
    g: GraphBlocks, core: torch.Tensor, roots: torch.Tensor, ks: torch.Tensor,
    max_steps: int = 10_000, backend: str = "auto", executor=None,
) -> Tuple[torch.Tensor, int]:
    """R stacked k-reachability searches sharing one superstep sequence.

    roots: (N, R) bool — per-search root sets; ks: (R,) int32 — per-search
    k level.  Column r expands only through nodes with core == ks[r].
    Returns (visited (N, R) bool, supersteps = max over searches).  Each
    hop first adds any(frontier) into a device counter; the host checks
    the frontier once every `ops.SYNC_EVERY` hops.  The "dense" backend
    densifies once per call, not per hop.  "ell_spmd" runs the search on
    the worker mesh (`SpmdExecutor.k_reachable_batch`) through `executor`,
    or one built for the call.
    """
    if backend == SPMD_BACKEND:
        return _spmd_executor(g, ex=executor).k_reachable_batch(
            core, roots, ks, max_steps=max_steps)
    eligible = (core[:, None] == ks[None, :]) & g.node_mask[:, None]
    visited = roots & eligible
    frontier = visited
    adj = ops.dense_adj(g, backend)
    steps = torch.zeros((), dtype=torch.int32, device=core.device)
    done = 0
    while done < max_steps:
        n = min(ops.SYNC_EVERY, max_steps - done)
        for _ in range(n):
            steps += frontier.any().to(torch.int32)
            frontier = ops.frontier_blocks(g, frontier, eligible, visited,
                                           backend=backend, adj=adj)
            visited = visited | frontier
        done += n
        if not bool(frontier.any()):  # the one host read of this chunk
            break
    return visited, int(steps)


def _restricted_recompute(
    g: GraphBlocks, est0: torch.Tensor, cand: torch.Tensor,
    max_steps: int = 10_000, backend: str = "auto", executor=None,
) -> Tuple[torch.Tensor, int]:
    """Clamped min-H iteration: only `cand` nodes move; returns (core', steps).
    The "dense" backend densifies once per call, not per superstep;
    "ell_spmd" runs on the worker mesh through `executor`, or one built
    for the call."""
    if backend == SPMD_BACKEND:
        return _spmd_executor(g, ex=executor).restricted_recompute(
            est0, cand, max_steps=max_steps)
    adj = ops.dense_adj(g, backend)
    return ops.minh_fixpoint(
        est0, lambda e: ops.hindex_blocks(g, e, backend=backend, adj=adj),
        cand & g.node_mask, max_steps)


def _stats(g: GraphBlocks, cand: torch.Tensor, bfs_steps: int,
           rec_steps: int, u: int, v: int) -> MaintenanceStats:
    blocks = cand.view(g.P, g.Cn).any(dim=1)
    n_cand, n_blocks = torch.stack([cand.sum(), blocks.sum()]).tolist()
    return MaintenanceStats(
        candidates=int(n_cand), bfs_steps=int(bfs_steps),
        recompute_steps=int(rec_steps), blocks_touched=int(n_blocks),
        inter_partition=(u // g.Cn) != (v // g.Cn))


def _maintain_edge(g: GraphBlocks, core: torch.Tensor, u: int, v: int,
                   op: int, backend: str, ex=None):
    """Shared body of `insert_edge_maintain` / `delete_edge_maintain`, and
    of the mesh's sequential path (`_maintain_one`: the executor `ex`
    searches on the pre-update plan, which is maintained before the
    recompute)."""
    u, v = int(u), int(v)
    k = torch.minimum(core[u], core[v])
    roots = torch.zeros(g.N, dtype=torch.bool, device=g.device)
    roots[u] = True
    roots[v] = True
    cand, bfs_steps = k_reachable(g, core, roots, k, backend=backend,
                                  executor=ex)
    # the endpoints themselves are always candidates (their degree changed)
    cand = cand | roots
    if op > 0:
        g2 = insert_edge(g, u, v)
        bump = core + 1  # insertion raises candidates by at most 1
    else:
        g2 = delete_edge(g, u, v)
        bump = core  # deletion can only lower; the new degree may be lower
    if ex is not None:
        ex.apply_updates(g2, [(u, v, op)])
    ub = torch.where(cand, torch.minimum(bump, g2.deg), core)
    new_core, rec_steps = _restricted_recompute(g2, ub, cand, backend=backend,
                                                executor=ex)
    return g2, new_core, _stats(g2, cand, bfs_steps, rec_steps, u, v)


def insert_edge_maintain(
    g: GraphBlocks, core: torch.Tensor, u: int, v: int, backend: str = "auto",
) -> Tuple[GraphBlocks, torch.Tensor, MaintenanceStats]:
    """Insert (u, v) and maintain coreness.  u, v are global padded ids.
    Updates `g` in place and returns it.  "ell_spmd" raises ValueError."""
    _reject_spmd(backend, "insert_edge_maintain")
    return _maintain_edge(g, core, u, v, +1, backend)


def delete_edge_maintain(
    g: GraphBlocks, core: torch.Tensor, u: int, v: int, backend: str = "auto",
) -> Tuple[GraphBlocks, torch.Tensor, MaintenanceStats]:
    """Delete (u, v) and maintain coreness.  Updates `g` in place.
    "ell_spmd" raises ValueError."""
    _reject_spmd(backend, "delete_edge_maintain")
    return _maintain_edge(g, core, u, v, -1, backend)


def maintain_batch_host(g, core, updates, backend: str = "auto"):
    """Host loop applying a sequence of (u, v, op) updates (op: +1 ins, -1 del).

    Returns (g, core, list_of_stats): per-edge maintenance, as in the
    paper's experiment; `maintain_batch` is the amortized path.  The stream
    is validated first (self-loops, duplicates, missing deletes, capacity).
    Updates `g` in place.  "ell_spmd" raises ValueError: the JAX package's
    host loop takes no backend, and mesh maintenance is `maintain_batch`'s.
    """
    if backend == SPMD_BACKEND:
        raise ValueError(
            f"maintain_batch_host has no backend={SPMD_BACKEND!r} path: use "
            "maintain_batch(..., backend='ell_spmd') for mesh-executed "
            "maintenance")
    validate_updates(g, updates)
    stats = []
    for u, v, op in updates:
        g, core, s = _maintain_edge(g, core, u, v, op, backend)
        stats.append(s)
    return g, core, stats


# ---------------------------------------------------------------------------
# Batched maintenance: amortize supersteps over independent updates.
# ---------------------------------------------------------------------------


def _batch_candidates(
    g: GraphBlocks, core: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
    valid: torch.Tensor, backend: str = "auto", executor=None,
) -> Tuple[torch.Tensor, int]:
    """Candidate sets for up to R updates via one batched frontier search.

    us, vs: (R,) int64 endpoint ids on the graph's device (arbitrary on
    invalid columns); valid: (R,) bool.  The per-update k levels are
    derived on device (-1 on invalid columns keeps them empty).
    Returns (cand (N, R) bool, supersteps).  "ell_spmd" searches through
    `executor` (see `k_reachable_batch`).
    """
    R = us.shape[0]
    cols = torch.arange(R, device=g.device)
    ks = torch.where(valid, torch.minimum(core[us], core[vs]), -1)
    roots = torch.zeros((g.N, R), dtype=torch.bool, device=g.device)
    # each (id, column) pair occurs once per scatter, so OR-ing in place
    # is exact even where us[r] == vs[r]
    roots[us, cols] |= valid
    roots[vs, cols] |= valid
    visited, steps = k_reachable_batch(g, core, roots, ks, backend=backend,
                                       executor=executor)
    # endpoints are always candidates (their degree changes)
    return (visited | roots) & valid[None, :], steps


def _independent_prefix(cand: np.ndarray, valid: int) -> Tuple[List[int], List[int]]:
    """Greedily split update columns into (accepted, deferred).

    A column is accepted iff its candidate set is disjoint from every
    earlier column — accepted or deferred.  Disjointness covers shared
    endpoints too (endpoints are always in their own candidate set).
    Deferred updates run *after* the accepted batch, so accepting a column
    that conflicts with an earlier deferred one would swap two dependent
    updates; conflict-free pairs commute.
    """
    overlap = cand.T.astype(np.int64) @ cand.astype(np.int64)  # (R, R)
    accepted: List[int] = []
    deferred: List[int] = []
    for r in range(valid):
        if not overlap[r, :r].any():
            accepted.append(r)
        else:
            deferred.append(r)
    return accepted, deferred


def _apply_edges(g: GraphBlocks, us, vs, ops_) -> GraphBlocks:
    """Apply fixed-width host updates in order: op = +1 insert / -1 delete /
    0 no-op.  In place."""
    for u, v, op in zip(us, vs, ops_):
        if op > 0:
            insert_edge(g, u, v)
        elif op < 0:
            delete_edge(g, u, v)
    return g


def _apply_and_recompute(
    g: GraphBlocks, core: torch.Tensor, us, vs, ops_,
    cand_ins: torch.Tensor, cand_del: torch.Tensor, backend: str = "auto",
    W=None, ex=None,
) -> Tuple[GraphBlocks, torch.Tensor, int]:
    """Apply accepted edges and run ONE joint clamped recompute.

    us, vs, ops_: host int sequences of the accepted updates (op = 0 marks
    a no-op column).  cand_ins / cand_del: (N,) union masks of the accepted
    insert / delete candidate sets (disjoint by construction).  On
    "ell_spmd" the halo plan of a threaded executor `ex` is maintained on
    the post-update graph (`SpmdExecutor.apply_updates`); without one an
    executor of `W` workers is built on it.
    """
    g2 = _apply_edges(g, us, vs, ops_)
    if backend == SPMD_BACKEND:
        if ex is None:
            ex = _spmd_executor(g2, W)
        else:
            ex.apply_updates(g2, list(zip(us, vs, ops_)))
    # per-update upper bounds (valid because the candidate sets are disjoint:
    # no node gets both an insert and a delete bound)
    ub = torch.where(cand_ins, torch.minimum(core + 1, g2.deg), core)
    ub = torch.where(cand_del, torch.minimum(core, g2.deg), ub)
    new_core, rec_steps = _restricted_recompute(
        g2, ub, cand_ins | cand_del, backend=backend, executor=ex)
    return g2, new_core, rec_steps


def _spmd_executor(g: GraphBlocks, W=None, ex=None):
    """The mesh executor of `g` (`runtime.spmd.SpmdExecutor` of `W`
    workers), or `ex` as it is when one is threaded through: its caller
    keeps the plan in step (`SpmdExecutor.apply_updates`)."""
    if ex is not None:
        return ex
    from ..runtime.spmd import SpmdExecutor  # lazy: runtime imports core

    return SpmdExecutor(g, W=W)


def maintain_batch(
    g: GraphBlocks,
    core: torch.Tensor,
    updates: Sequence[Tuple[int, int, int]],
    R: int = 8,
    backend: str = "auto",
    W=None,
) -> Tuple[GraphBlocks, torch.Tensor, BatchMaintenanceStats]:
    """Maintain coreness over a stream of updates, R at a time.

    g: GraphBlocks (nbr (N, Cd), N = P*Cn); core: (N,) int32 coreness of
    `g`; updates: sequence of (u, v, op) with op = +1 insert / -1 delete
    and u, v global padded ids.  Returns (g', (N,) int32 core',
    BatchMaintenanceStats); g' is `g`, updated in place.

    Chunks of up to R updates share one batched k-reachability search.
    Updates whose candidate sets are pairwise disjoint are applied together
    with a single joint clamped recompute; the rest fall back to exact
    sequential maintenance within the chunk.  The stream is validated here
    (self-loops, duplicates, missing deletes, capacity).

    With ``backend="ell_spmd"`` every superstep runs on the worker mesh
    (`W` workers; default: the process group's size, or 1 without one)
    through ONE executor, its halo plan maintained after every applied
    edit (zero full rebuilds).  The results equal every other backend's.
    """
    if R < 1:
        raise ValueError(f"R must be >= 1, got {R}")
    validate_updates(g, updates)
    # ONE executor threads through the whole stream on the mesh path
    ex = _spmd_executor(g, W) if backend == SPMD_BACKEND else None
    tot = dict(bfs=0, rec=0, cand=0, batched=0, seq=0, batches=0)
    for start in range(0, len(updates), R):
        chunk = list(updates[start:start + R])
        if len(chunk) == 1:
            g, core = _maintain_one(g, core, chunk[0], tot, backend, W, ex)
            continue
        n = len(chunk)
        us = np.zeros(R, np.int64)
        vs = np.zeros(R, np.int64)
        ops_ = np.zeros(R, np.int64)
        us[:n] = [u for u, _, _ in chunk]
        vs[:n] = [v for _, v, _ in chunk]
        ops_[:n] = [op for _, _, op in chunk]
        valid = np.zeros(R, bool)
        valid[:n] = True

        dev = g.device
        cand, steps = _batch_candidates(
            g, core, torch.as_tensor(us, device=dev),
            torch.as_tensor(vs, device=dev),
            torch.as_tensor(valid, device=dev), backend=backend, executor=ex)
        tot["bfs"] += steps
        tot["batches"] += 1
        cand_np = cand.cpu().numpy()
        accepted, deferred = _independent_prefix(cand_np, n)

        if accepted:
            acc = np.asarray(accepted)
            ins_cols = acc[ops_[acc] > 0]
            del_cols = acc[ops_[acc] < 0]
            cand_ins = torch.as_tensor(cand_np[:, ins_cols].any(axis=1),
                                       device=dev)
            cand_del = torch.as_tensor(cand_np[:, del_cols].any(axis=1),
                                       device=dev)
            g, core, rec_steps = _apply_and_recompute(
                g, core, us[acc], vs[acc], ops_[acc], cand_ins, cand_del,
                backend=backend, W=W, ex=ex)
            tot["rec"] += rec_steps
            tot["cand"] += int(cand_np[:, acc].sum())
            tot["batched"] += len(accepted)

        for r in deferred:
            g, core = _maintain_one(g, core, chunk[r], tot, backend, W, ex)

    stats = BatchMaintenanceStats(
        updates=len(updates),
        batches=tot["batches"],
        batched_updates=tot["batched"],
        sequential_updates=tot["seq"],
        bfs_steps=tot["bfs"],
        recompute_steps=tot["rec"],
        candidates=tot["cand"],
    )
    return g, core, stats


def _maintain_one(g, core, update, tot, backend, W=None, ex=None):
    """Sequential fallback for one update; accumulates into `tot`.  On the
    mesh it runs through the threaded executor `ex` (one of `W` workers
    when none is given), whose plan follows the edit."""
    u, v, op = update
    if backend == SPMD_BACKEND:
        ex = _spmd_executor(g, W, ex)
    g, core, s = _maintain_edge(g, core, u, v, op, backend, ex=ex)
    tot["bfs"] += s.bfs_steps
    tot["rec"] += s.recompute_steps
    tot["cand"] += s.candidates
    tot["seq"] += 1
    return g, core
