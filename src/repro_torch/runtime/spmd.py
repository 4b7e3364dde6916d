"""Superstep execution on the worker mesh: BLADYG's modes as collectives.

`SpmdExecutor` runs the graph primitives over the worker mesh
(`runtime.mesh`, one process per worker on `torch.distributed`) with
the halo plan (`runtime.halo`) staged on each worker's device:

  W2W   — `_exchange`: gather the send buffer ``x[send_idx[rank]]``,
          `dist.all_to_all_single`, scatter into the (H + 2, ...) halo
          buffer at ``recv_pos[rank]`` (the dump slot H and the PAD
          sentinel H + 1 pinned at the fill value).  Any per-node field
          crosses: (S,) vectors, (S, Cd) neighbor rows, bool as bytes,
          and a tuple of fields as one exchange each with its own fill.
          At W = 1 with no process group the exchange is the identity
          copy a one-rank all-to-all is.
  W2M   — `_any_global`: an `all_reduce(MAX)` of an int32 flag on the
          device, so every rank reads the same convergence verdict; a
          program's per-worker summaries are all-gathered (`_gather`).
  Local — the hand-written kernels on the shard: `ell_hindex` ("sort"),
          `ell_frontier`, and a program's combine (`ell_cc`,
          `ell_pagerank`, `ell_multi`, `ell_triangles`) read the field
          ``cat([x_local, halo_buf])`` of S + H + 2 rows through the
          shard's local-frame rows (`HaloPlan.nbr_local` with the PAD
          sentinel mapped back to -1, so the kernels' PAD rule and the
          sorted-ELL prefix hold), with the shard's row lengths `deg` and
          K the pow2 bucket of the shard's degree bound
          (`ops.column_bound`).

`overlap=True` (the default) issues the all-to-all with ``async_op=True``
and stages the local part of the field before ``wait()``;
`overlap=False` waits first.  Both give the same bits.  (The JAX
package's split-phase read keeps local slots independent of the halo
inside one compiled step; here the kernel reads one concatenated field
after the wait, so what overlaps the collective is the staging copy.)

Public methods take and return global (N,) / (N, R) tensors on every
rank, as the JAX package's sharded arrays read; inside, each rank works
on its (S,) shard.  The fixpoints (`coreness`, `k_reachable_batch`,
`restricted_recompute`, `SpmdEngine.run_spmd`) keep their state sharded
and all-gather once at the end.  They follow the port's sync policy
(`kernels.ops.live_loop`): one host read of the all-reduced flag every
`ops.SYNC_EVERY` supersteps, so all ranks stop together, and the
superstep counts equal the JAX package's ``while_loop`` counts.

`SpmdEngine.run_spmd` is the program-level executor (the mesh
counterpart of `core.engine.BladygEngine.run`): it drives an
`SpmdProgram`'s worker/master ops and records per-superstep
`SuperstepTrace`s whose W2W numbers come from the executed halo plan
(`HaloPlan.slot_counts`).  `SpmdBlockProgram` runs any
`core.engine.BlockProgram` there (``backend="ell_spmd"`` of
`ops.run_block_program`), hub mirroring included: the replica-group
merge folds each worker's resident group rows into a partial table and
merges the tables with one `all_reduce` per field (`ops._mirror_merge`).

Bit-exactness: all math is int32/bool, so `coreness_spmd` equals
`ops.coreness_blocks` on one device exactly for any worker count,
including the blocks-per-worker fold and W = 1; so do the integer
programs (CC, triangles, coreness, mirrored or not).  Float sums
(PageRank) are allclose: the mirror merge adds per-worker partials.

Left out on purpose: the JAX package's compiled-step cache
(`SpmdEngine._step_cache`) and `step_build_count` — eager PyTorch
compiles no step functions.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.engine import (
    BladygEngine, MessageStats, Mode, SuperstepTrace, tree_map)
from ..core.graph import PAD
from ..kernels import ops
from ..kernels.ell_frontier import frontier_step_ell
from ..kernels.ell_hindex import hindex_ell
from ..kernels.ops import BlockCtx  # noqa: F401 (the reference's name)
from ..kernels.ref import combine_rows, hindex_rows  # noqa: F401 (ditto)
from .halo import HaloPlan, build_halo_plan
from .mesh import AXIS, WorkerMesh, make_worker_mesh  # noqa: F401


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
        #: the column bound of every row of the graph: a row field (the
        #: triangles' neighbor rows) holds other shards' rows in its halo
        self.field_bound = ops.column_bound(g.deg, g.Cd)

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

    def _all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """Element-wise "min" or "sum" of `x` over the ranks, on every rank
        (in place; the identity without a process group)."""
        if self.wm.group is not None:
            red = dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.SUM
            dist.all_reduce(x, op=red, group=self.wm.group)
        return x

    def _exchange_field(self, x: Any, fill: Any) -> Any:
        """`_exchange` of a field or of a tuple of fields, one exchange per
        field with its own fill (a `MultiProgram`'s)."""
        if isinstance(x, (tuple, list)):
            return tuple(self._exchange(f, fl) for f, fl in zip(x, fill))
        return self._exchange(x, fill)

    def _exchange(self, x: torch.Tensor, fill: Any) -> torch.Tensor:
        """W2W: this rank's field ``cat([x, halo_buf])``, (S + H + 2, ...).

        The halo buffer gets each sender's values at ``recv_pos[rank]``;
        its dump slot H and PAD sentinel H + 1 hold `fill`.  A bool field
        crosses as bytes.
        """
        if x.dtype == torch.bool:
            return self._exchange(x.to(torch.uint8), int(bool(fill))).view(
                torch.bool)
        x = x.contiguous()
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
        field = self._exchange(f, False)
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
# Program-level executor: the mesh BladygEngine.
# ---------------------------------------------------------------------------


class LocalCtx(NamedTuple):
    """Per-shard context handed to `SpmdProgram.worker_local`.

    The JAX package's fields (deg, node_mask, B, Cn, Cd), plus what the
    port's local step hands the kernels: the shard's local-frame rows
    with PAD = -1, their column bound, the shard's first global row and
    the executor (its collectives and `field_bound`).
    """

    deg: torch.Tensor        # (S,) int32 row lengths of the shard
    node_mask: torch.Tensor  # (S,) bool
    B: int                   # blocks on this worker (fold)
    Cn: int                  # nodes per block
    Cd: int
    rows: Optional[torch.Tensor] = None  # (S, Cd) int32 local-frame rows
    K: Optional[int] = None              # column bound of `rows`
    base: int = 0                        # global id of the shard's row 0
    ex: Any = None                       # the SpmdExecutor


class SpmdProgram:
    """A BLADYG program in per-shard form.

    `worker_local` sees only this worker's rows plus its exchanged field
    (the shard followed by the halo buffer, which the local-frame rows
    `ctx.rows` index; the JAX package hands the gathered (S, Cd, ...)
    neighbor values instead, the port's kernels gather themselves);
    `master_compute` runs replicated on the all-gathered per-worker
    summaries, exactly the paper's masterCompute.
    """

    #: value PAD / dump slots read as (must match the field dtype)
    halo_fill = -1

    #: True iff worker_local and master_compute keep the structure of the
    #: master state and directive across supersteps: `SpmdEngine.run_spmd`
    #: then runs the loop under `ops.live_loop` (one host read per
    #: `ops.SYNC_EVERY` supersteps); others read `halt` every superstep.
    fusable = False

    def halo_field(self, wstate) -> torch.Tensor:
        """The (S, ...) per-node tensor whose values neighbors read (W2W)."""
        return wstate

    def worker_local(self, ctx: LocalCtx, wstate, field, directive):
        """(ctx, local state, exchanged (S + H + 2, ...) field, directive)
        -> (local state', per-block summary with leading axis B)."""
        raise NotImplementedError

    def master_compute(self, mstate, summary):
        """(master state, gathered (P, ...) summaries)
        -> (master state', directive, halt)."""
        raise NotImplementedError


class SpmdCorenessProgram(SpmdProgram):
    """min-H coreness as an SPMD program (`core.kcore.CorenessProgram`
    routed through the mesh): the estimate vector is the exchanged field,
    the per-block changed flags are the W2M summary (P per superstep), the
    halt decision is the replicated M2W directive.  Each superstep runs
    `ell_hindex` on the shard."""

    halo_fill = -1
    fusable = True

    # stateless: any two instances are interchangeable
    def __hash__(self):
        return hash(type(self))

    def __eq__(self, other):
        return type(other) is type(self)

    def worker_local(self, ctx, est, field, directive):
        h = hindex_ell(ctx.rows, field, K=ctx.K, deg=ctx.deg)
        new = torch.where(ctx.node_mask, torch.minimum(est, h), est)
        changed = (new != est).view(ctx.B, ctx.Cn).any(dim=1)  # per block
        return new, changed

    def master_compute(self, mstate, summary):
        return mstate, None, torch.logical_not(summary.any())


def _shard_merge_index(index: ops.MergeIndex, lo: int,
                       S: int) -> ops.MergeIndex:
    """A plan's `ops.MergeIndex` restricted to the shard of rows
    [lo, lo + S): its resident group rows in local ids, and the table with
    every other entry sent to the fill slot S."""
    mine = (index.rows >= lo) & (index.rows < lo + S)
    local = (index.table >= lo) & (index.table < lo + S)
    return ops.MergeIndex(index.rows[mine] - lo, index.gid[mine],
                          torch.where(local, index.table - lo, S))


class SpmdBlockProgram(SpmdProgram):
    """Adapter: any `core.engine.BlockProgram` as an SPMD program.

    This is the "ell_spmd" execution of the structured superstep
    contract: the program's halo field is the exchanged W2W payload (a
    `MultiProgram`'s fields one exchange each, with their own fills), its
    combine runs through the ELL kernels on the shard's local-frame rows
    over the exchanged field ("min" `ell_cc`, "sum" `ell_pagerank`,
    "hindex" `ell_hindex`, "count_common" `ell_triangles`, "multi"
    `ell_multi`) with the shard's row lengths, its update is per-shard
    workerCompute, and its local changed verdict is the (1,) W2M summary
    that the replicated master folds into the halt decision.

    `mirror` (a `core.hub_split.MirrorPlan`) arms the vertex-cut
    dataflow: the update ctx carries the worker's slice of the LOGICAL
    degrees `mirror.ldeg`, every kernel the split graph's `deg`, and the
    replica-group merge (`ops._mirror_merge` with the executor's
    `all_reduce`) folds per-slice partials between combine and update.

    Hash/eq delegate to the wrapped program, the real-node count and the
    plan's uid, as in the JAX package.
    """

    fusable = True

    def __init__(self, prog, n_real: int, mirror=None):
        self.prog = prog
        self.n_real = int(n_real)
        self.halo_fill = prog.halo_fill
        self.mirror = mirror
        self.mirror_uid = None if mirror is None else mirror.uid
        #: the shard's MergeIndex and logical degrees, made at first use
        self._shard_mirror = None

    def __hash__(self):
        return hash((type(self), self.prog, self.n_real, self.mirror_uid))

    def __eq__(self, other):
        return (type(other) is type(self) and other.prog == self.prog
                and other.n_real == self.n_real
                and other.mirror_uid == self.mirror_uid)

    def summary_shape(self) -> torch.Tensor:
        """The W2M summary's shape and dtype, as a "meta" tensor: the
        per-worker changed flag, (1,) bool (what the JAX package meters on
        its fused loop)."""
        return torch.empty((1,), dtype=torch.bool, device="meta")

    def halo_field(self, wstate):
        return self.prog.halo_field(wstate)

    def worker_local(self, ctx: LocalCtx, state, field, directive):
        prog = self.prog
        if prog.combine == "multi":
            red = ops.neighbor_multi_ell(ctx.rows, field, prog.combines,
                                         K=ctx.K, deg=ctx.deg)
        else:
            # a row field holds other shards' rows: bound by every row's
            K = ctx.ex.field_bound if prog.combine == "count_common" \
                else ctx.K
            red = ops._combine_ell(ctx.rows, field, prog.combine, K,
                                   ctx.deg)
        deg = ctx.deg
        if self.mirror is not None:
            if self._shard_mirror is None:
                S, lo, m = ctx.deg.shape[0], ctx.base, self.mirror
                self._shard_mirror = (
                    _shard_merge_index(
                        ops.merge_index(m, m.primary_row.shape[0]), lo, S),
                    m.ldeg[lo:lo + S].to(ctx.deg.device, torch.int32))
            index, deg = self._shard_mirror
            red = ops._mirror_merged(red, field, ctx.rows, self.mirror, prog,
                                     index, all_reduce=ctx.ex._all_reduce)
        bctx = BlockCtx(deg=deg, node_mask=ctx.node_mask, n_real=self.n_real)
        new = prog.update(bctx, state, red)
        return new, prog.changed(state, new).reshape(1)  # per-worker W2M

    def master_compute(self, mstate, summary):
        return mstate, None, torch.logical_not(summary.any())


class SpmdEngine:
    """Superstep scheduler over the worker mesh (cf. `BladygEngine`).

    Differences from the single-device engine: workerCompute runs on each
    worker's shard after a real halo exchange, and the recorded
    per-superstep W2W counts come from the executed `HaloPlan`
    (`plan.slot_counts()`), not from declared shapes.  States go in and
    come out global on every rank.
    """

    def __init__(self, g, W: Optional[int] = None,
                 executor: Optional[SpmdExecutor] = None):
        self.g = g
        self.ex = executor if executor is not None else SpmdExecutor(g, W=W)
        self.traces = []

    def _ctx(self) -> LocalCtx:
        ex, wm = self.ex, self.ex.wm
        return LocalCtx(deg=ex.deg, node_mask=ex.node_mask, B=wm.B,
                        Cn=wm.Cn, Cd=ex._rows.shape[1], rows=ex._rows,
                        K=ex._K, base=wm.rank * wm.S, ex=ex)

    def _summary_shape(self, program: SpmdProgram, summary):
        """The gathered W2M summary at coordinator granularity (leading
        axis W x the per-worker one), as "meta" tensors, for the fused
        loop's traces; a program may declare it (`summary_shape`)."""
        hint = getattr(program, "summary_shape", None)
        if hint is not None:
            return hint()
        W = self.ex.wm.W
        return tree_map(lambda x: torch.empty(
            (W * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
            device="meta"), summary)

    def run_spmd(
        self,
        program: SpmdProgram,
        wstate: Any,
        mstate: Any,
        directive: Any = None,
        max_supersteps: int = 10_000,
        fuse: Optional[bool] = None,
    ) -> Tuple[Any, Any]:
        """Execute the program; worker steps run on the shards.

        `wstate` is the global state (tensors or tuples of tensors, N
        leading) on every rank; the returned one too.  `fuse=None`
        follows `program.fusable`: fusable programs run under
        `ops.live_loop` (each superstep all-gathers the summaries and
        runs masterCompute on every rank; the host reads the halt flag
        once per `ops.SYNC_EVERY` supersteps), the rest read `halt` every
        superstep.  Either way the trace's W2W numbers are the executed
        halo plan's slot counts, and the fused loop's traces meter the
        initial directive and the declared summary shape, as the JAX
        package's do.
        """
        ex = self.ex
        w2w = ex.plan.slot_counts()
        modes = getattr(program, "modes",
                        Mode.LOCAL | Mode.M2W | Mode.W2M | Mode.W2W)
        # collective phases the compute waited on per superstep
        ser = 0 if ex.overlap else 1
        if fuse is None:
            fuse = getattr(program, "fusable", False)
        ctx = self._ctx()
        dev = ex.wm.device
        local = tree_map(ex._shard, wstate)
        zero = torch.zeros((), dtype=torch.int32, device=dev)

        def superstep(w, d):
            field = ex._exchange_field(program.halo_field(w),
                                       program.halo_fill)
            return program.worker_local(ctx, w, field, d)

        if fuse:
            first = []

            def step(s):
                w, m, d = s
                w2, summary = superstep(w, d)
                if not first:
                    first.append(summary)
                m2, d2, halt = program.master_compute(
                    m, tree_map(ex._gather, summary))
                if d2 is None:  # keep carrying the placeholder
                    d2 = d
                return (w2, m2, d2), ~torch.as_tensor(halt, device=dev)

            d0 = directive if directive is not None else zero
            (local, mstate, _), n = ops.live_loop(
                step, (local, mstate, d0), max_supersteps, dev)
            if n:
                stats = BladygEngine._meter(
                    self._summary_shape(program, first[0]), directive, w2w)
                self.traces.extend(
                    SuperstepTrace(s, modes, stats,
                                   serialized_collectives=ser)
                    for s in range(n))
            return tree_map(ex._gather, local), mstate

        it = 0
        while it < max_supersteps:
            local, summary = superstep(
                local, directive if directive is not None else zero)
            summary = tree_map(ex._gather, summary)
            mstate, directive, halt = program.master_compute(mstate, summary)
            self.traces.append(SuperstepTrace(
                it, modes, BladygEngine._meter(summary, directive, w2w),
                serialized_collectives=ser))
            it += 1
            if bool(halt):
                break
        return tree_map(ex._gather, local), mstate

    def message_totals(self) -> MessageStats:
        tot = MessageStats()
        for t in self.traces:
            tot = tot + t.stats
        return tot


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
