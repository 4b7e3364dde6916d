"""Superstep execution on the worker mesh: BLADYG's modes as collectives.

`SpmdExecutor` runs the graph primitives over the worker mesh
(`runtime.mesh`, one process per worker on `torch.distributed`) with
the halo plan (`runtime.halo`) staged on each worker's device:

  W2W   — `_exchange`: gather the send buffer ``x[send_idx[rank]]``,
          `dist.all_to_all_single`, scatter into the (H + 2, ...) halo
          buffer at ``recv_pos[rank]`` (the dump slot H and the PAD
          sentinel H + 1 pinned at the fill value).  At W = 1 with no
          process group the exchange is the identity copy a one-rank
          all-to-all is.
  W2M   — `_any_global`: an `all_reduce(MAX)` of an int32 flag on the
          device, so every rank reads the same convergence verdict.
  Local — the hand-written kernels on the shard: `ell_hindex` ("sort")
          and `ell_frontier` read the field ``cat([x_local, halo_buf])``
          of S + H + 2 rows through the shard's local-frame rows
          (`HaloPlan.nbr_local` with the PAD sentinel mapped back to -1,
          so the kernels' PAD rule and the sorted-ELL prefix hold), with
          the shard's row lengths `deg` and K the pow2 bucket of the
          shard's degree bound (`ops.column_bound`).

`overlap=True` (the default) issues the all-to-all with ``async_op=True``
and stages the local part of the field before ``wait()``;
`overlap=False` waits first.  Both give the same bits.  (The JAX
package's split-phase read keeps local slots independent of the halo
inside one compiled step; here the kernel reads one concatenated field
after the wait, so what overlaps the collective is the staging copy.)

Public methods take and return global (N,) / (N, R) tensors on every
rank, as the JAX package's sharded arrays read; inside, each rank works
on its (S,) shard.  The fixpoints (`coreness`, `k_reachable_batch`,
`restricted_recompute`) keep their state sharded and all-gather once at
the end.  They follow the port's sync policy (`kernels.ops.live_loop`):
one host read of the all-reduced flag every `ops.SYNC_EVERY`
supersteps, so all ranks stop together, and the superstep counts equal
the JAX package's ``while_loop`` counts.

Bit-exactness: all math is int32/bool, so `coreness_spmd` equals
`ops.coreness_blocks` on one device exactly for any worker count,
including the blocks-per-worker fold and W = 1.

Not ported yet (ROADMAP.md, Queue 1 item 6): the program-level executor
(`SpmdEngine`, `SpmdProgram`, `SpmdCorenessProgram`, `SpmdBlockProgram`)
is step 3; the maintenance, stream and restore paths on the mesh are
step 4.  The JAX package's `step_build_count` has no counterpart: eager
PyTorch builds no compiled step functions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.graph import PAD
from ..kernels import ops
from ..kernels.ell_frontier import frontier_step_ell
from ..kernels.ell_hindex import hindex_ell
from .halo import HaloPlan, build_halo_plan
from .mesh import WorkerMesh, make_worker_mesh


class SpmdExecutor:
    """Halo-exchange primitives for one (graph, worker mesh) pair.

    Holds the worker mesh, the halo plan, and this rank's shard of the
    plan tables and per-node fields on its device.  The plan is a function
    of `nbr` *contents*: after structural updates keep ONE executor alive
    and call `apply_updates` (dirty-worker incremental plan maintenance,
    the streaming hot path) or, after wholesale changes such as a vertex
    migration, `rebuild`; `grow` follows a capacity escalation.
    `full_rebuilds`, `plan_updates` and `grows` count which path ran.

    `overlap` (default True) issues the all-to-all asynchronously and
    stages the local values while it is in flight; `overlap=False` waits
    first.  Both produce the same bits.  `wm` defaults to
    `runtime.mesh.make_worker_mesh(g, W)` (the default process group, or
    none); pass one built on another group.
    """

    def __init__(self, g, W: Optional[int] = None,
                 wm: Optional[WorkerMesh] = None,
                 plan: Optional[HaloPlan] = None,
                 overlap: bool = True):
        self.wm = wm if wm is not None else make_worker_mesh(g, W=W)
        self.plan = plan if plan is not None else build_halo_plan(g, self.wm)
        #: async all-to-all with the local staging in flight (False: wait
        #: first)
        self.overlap = bool(overlap)
        #: full from-scratch plan rebuilds after construction (`rebuild`)
        self.full_rebuilds = 0
        #: incremental plan maintenance calls (`apply_updates`)
        self.plan_updates = 0
        #: capacity escalations followed (`grow`)
        self.grows = 0
        self._refresh(g)

    def _refresh(self, g) -> None:
        """Re-stage this rank's shard of the plan tables and of the
        per-node fields on its device (one host read of the shard's
        degree bound)."""
        wm, plan = self.wm, self.plan
        dev = wm.device
        lo, hi = wm.rank * wm.S, (wm.rank + 1) * wm.S
        self.node_mask = g.node_mask[lo:hi].to(dev).contiguous()
        self.deg = g.deg[lo:hi].to(dev, torch.int32).contiguous()
        rows = plan.nbr_local[lo:hi]
        rows = np.where(rows == plan.pad_slot, PAD, rows).astype(np.int32)
        #: the kernels' rows: local-frame ids, PAD = -1
        self._rows = torch.from_numpy(rows).to(dev)
        self._send = torch.from_numpy(
            plan.send_idx[wm.rank].reshape(-1).astype(np.int64)).to(dev)
        self._recv = torch.from_numpy(
            plan.recv_pos[wm.rank].reshape(-1).astype(np.int64)).to(dev)
        #: the kernels' column bound on this shard
        self._K = ops.column_bound(self.deg, g.Cd)

    def apply_updates(self, g, edits) -> None:
        """Incrementally maintain the halo plan after edge `edits`.

        `g` is the POST-update graph; `edits` are (u, v, op) triples
        (op = +1 insert / -1 delete / 0 padding no-op).  Only the workers
        owning an endpoint of a cross-worker edit are re-derived.
        """
        self.plan = self.plan.apply_updates(g, edits)
        self._refresh(g)
        self.plan_updates += 1

    def rebuild(self, g) -> None:
        """Full from-scratch plan rebuild (e.g. after `migrate_vertices`
        permuted the blocks), keeping the H/K capacity floors."""
        self.plan = build_halo_plan(
            g, self.wm, H_min=self.plan.H, K_min=self.plan.K)
        self._refresh(g)
        self.full_rebuilds += 1

    def grow(self, g) -> None:
        """Follow a capacity escalation (`core.graph.grow_blocks`): refit
        the worker mesh to the new Cn (same W, same group, only the
        block-fold geometry changes) and build a fresh plan at the new
        capacities (the old H/K floors describe the old id space)."""
        self.wm = make_worker_mesh(g, W=self.wm.W, group=self.wm.group)
        self.plan = build_halo_plan(g, self.wm)
        self._refresh(g)
        self.grows += 1

    def refresh_fields(self, g) -> None:
        """Re-stage per-node fields (node_mask/deg) after a change that
        leaves the adjacency, and hence the halo plan, untouched (e.g.
        vertex arrival on padding rows)."""
        self._refresh(g)

    # ---- the three modes -------------------------------------------------

    def _shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (S, ...) rows of a global (N, ...) tensor."""
        lo = self.wm.rank * self.wm.S
        return x[lo:lo + self.wm.S].to(self.wm.device).contiguous()

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather the (S, ...) shards into the global (N, ...) tensor
        on every rank (identity without a process group)."""
        if self.wm.group is None:
            return x
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(wire) for _ in range(self.wm.W)]
        dist.all_gather(parts, wire, group=self.wm.group)
        out = torch.cat(parts)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def _any_global(self, x: torch.Tensor) -> torch.Tensor:
        """W2M: 0-d bool, True iff any element of any rank's `x` is set."""
        flag = x.any().to(torch.int32).reshape(1)
        if self.wm.group is not None:
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.wm.group)
        return flag[0] > 0

    def _exchange(self, x: torch.Tensor, fill: int) -> torch.Tensor:
        """W2W: this rank's field ``cat([x, halo_buf])``, (S + H + 2, ...).

        The halo buffer gets each sender's values at ``recv_pos[rank]``;
        its dump slot H and PAD sentinel H + 1 hold `fill`.
        """
        S, H = self.wm.S, self.plan.H
        sendbuf = x[self._send]  # (W * K, ...): receiver r's K values at r
        recvbuf = torch.empty_like(sendbuf)
        work = None
        if self.wm.group is None:
            recvbuf.copy_(sendbuf)
        else:
            work = dist.all_to_all_single(recvbuf, sendbuf,
                                          group=self.wm.group,
                                          async_op=self.overlap)
        field = torch.empty((S + H + 2,) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device)
        if self.overlap:
            field[:S] = x  # staged while the all-to-all is in flight
        if work is not None:
            work.wait()
        if not self.overlap:
            field[:S] = x
        halo = field[S:]
        halo.index_put_((self._recv,), recvbuf)
        halo[H:] = fill  # the dump slot and the PAD sentinel
        return field

    # ---- local supersteps on the shard ------------------------------------

    def _hindex_local(self, est: torch.Tensor) -> torch.Tensor:
        """h-index of this shard's rows after one W2W round: (S,) int32."""
        field = self._exchange(est, -1)
        return hindex_ell(self._rows, field, K=self._K, deg=self.deg)

    def _frontier_local(self, f: torch.Tensor, elig: torch.Tensor,
                        vis: torch.Tensor) -> torch.Tensor:
        """One masked hop of this shard's rows after one W2W round (the
        frontier crosses as bytes): (S, R) bool."""
        field = self._exchange(f.to(torch.uint8), 0).view(torch.bool)
        return frontier_step_ell(self._rows, field, elig, vis, K=self._K,
                                 deg=self.deg)

    # ---- public primitives (global tensors in and out) ---------------------

    def hindex(self, est: torch.Tensor) -> torch.Tensor:
        """h-index of neighbor estimates — one executed W2W superstep.

        est: (N,) int32 on every rank; returns (N,) int32.
        """
        h = self._hindex_local(self._shard(est.to(torch.int32)))
        return self._gather(h)

    def frontier(self, f, eligible, visited) -> torch.Tensor:
        """One masked BFS hop for R stacked frontiers.

        f, eligible, visited: (N, R) bool; returns the next frontier as
        (N, R) bool (`f & eligible & ~visited` semantics of
        `ref.ell_frontier_hop_ref`).
        """
        nxt = self._frontier_local(*(self._shard(x.to(torch.bool))
                                     for x in (f, eligible, visited)))
        return self._gather(nxt)

    def _minh(self, est: torch.Tensor, move: torch.Tensor,
              max_steps: int) -> Tuple[torch.Tensor, int]:
        """Clamped min-H fixpoint on the shard (only `move` rows change);
        the global estimate and the superstep count."""
        def step(est):
            h = self._hindex_local(est)
            new = torch.where(move, torch.minimum(est, h), est)
            return new, self._any_global(new != est)

        est, steps = ops.live_loop(step, est, max_steps, self.wm.device)
        return self._gather(est), steps

    def coreness(self, max_steps: int = 10_000) -> Tuple[torch.Tensor, int]:
        """Full min-H coreness on the mesh: ((N,) int32, supersteps)."""
        est0 = torch.where(self.node_mask, self.deg, 0).to(torch.int32)
        return self._minh(est0, self.node_mask, max_steps)

    def k_reachable_batch(self, core, roots, ks, max_steps: int = 10_000):
        """R stacked k-reachability searches (semantics of
        `core.kcore_dynamic.k_reachable_batch`).

        core: (N,) int32; roots: (N, R) bool; ks: (R,) int32 per-search
        k levels.  Returns ((N, R) bool visited, supersteps).
        """
        core_l = self._shard(torch.as_tensor(core).to(torch.int32))
        ks = torch.as_tensor(ks).to(self.wm.device, torch.int32)
        elig = ((core_l[:, None] == ks[None, :])
                & self.node_mask[:, None]).contiguous()
        visited0 = self._shard(roots.to(torch.bool)) & elig

        def step(state):
            visited, frontier = state
            nxt = self._frontier_local(frontier, elig, visited)
            return (visited | nxt, nxt), self._any_global(nxt)

        (visited, _), steps = ops.live_loop(
            step, (visited0, visited0), max_steps, self.wm.device,
            live=self._any_global(visited0))
        return self._gather(visited), steps

    def restricted_recompute(self, est0, cand, max_steps: int = 10_000):
        """Clamped min-H iteration (only `cand` nodes move) on the mesh.

        est0: (N,) int32 upper bounds; cand: (N,) bool movable mask.
        Returns ((N,) int32 fixpoint, supersteps).
        """
        move = self._shard(cand.to(torch.bool)) & self.node_mask
        return self._minh(self._shard(torch.as_tensor(est0).to(torch.int32)),
                          move, max_steps)


# ---------------------------------------------------------------------------
# Functional entry points (what `kernels.ops` dispatches to).
# ---------------------------------------------------------------------------


def coreness_spmd(g, W: Optional[int] = None, max_steps: int = 10_000,
                  executor: Optional[SpmdExecutor] = None) -> torch.Tensor:
    """Full coreness on the worker mesh — equal to the one-device path."""
    ex = executor if executor is not None else SpmdExecutor(g, W=W)
    est, _ = ex.coreness(max_steps=max_steps)
    return est


def hindex_spmd(g, est, W: Optional[int] = None,
                executor: Optional[SpmdExecutor] = None) -> torch.Tensor:
    """One h-index superstep on the mesh.  Builds an executor per call —
    loops should construct `SpmdExecutor` once and call `.hindex`."""
    ex = executor if executor is not None else SpmdExecutor(g, W=W)
    return ex.hindex(est)


def frontier_spmd(g, f, eligible, visited, W: Optional[int] = None,
                  executor: Optional[SpmdExecutor] = None) -> torch.Tensor:
    """One masked BFS hop on the mesh (eligible may be (N,) or (N, R))."""
    ex = executor if executor is not None else SpmdExecutor(g, W=W)
    if eligible.dim() == 1:
        eligible = eligible[:, None].expand(f.shape)
    return ex.frontier(f, eligible, visited)
