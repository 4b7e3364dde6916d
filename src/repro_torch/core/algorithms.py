"""Workload library on the `BlockProgram` contract (BLADYG as a framework).

Each workload below is a short `BlockProgram` (state + halo field + named
neighbor combine + update + halt), and the SAME program object runs on
every backend of the kernel registry through `kernels.ops.run_block_program`
— the plain PyTorch oracle ("torch"), the hand-written ELL CUDA kernels
("ell") or the dense-adjacency forms ("dense").

  `ConnectedComponentsProgram` — min-label propagation: every node starts
      labeled with its own padded id and keeps the minimum label among
      itself and its neighbors, so each component converges to the minimum
      padded id of its members (the canonical labeling).  Edge insertions
      merge components in O(1) supersteps (`merge_labels`).
  `PageRankProgram` — push-style PageRank on the undirected graph: the
      exchanged field is each node's contribution rank/deg, the combine is
      "sum", the update applies teleport + damping.  `tol=None` runs
      exactly `max_steps` supersteps; a float tol halts when no node moved
      more than tol.  Mass at dangling (degree-0) real nodes is NOT
      redistributed, as in the JAX package.
  `TriangleCountProgram` — one "count_common" superstep over neighbor
      rows: red[u] = 2 × triangles through u.
  `CorenessBlockProgram` — the §4.1 min-H iteration on the contract
      (combine "hindex"); `ops.coreness_blocks` stays the production path.

Every entry point takes `mirror=` (a `core.hub_split.MirrorPlan` for a
hub-split graph) and then runs the vertex-cut dataflow of
`ops.run_block_program`: at primaries the integers equal the unsplit
graph's, PageRank is allclose.  On the mesh backend ("ell_spmd") every
entry point takes `executor=`, a long-lived `runtime.spmd.SpmdExecutor`
of `g` that one workload after another reuses (one is built per call
otherwise); the other backends do not read it.

Program states are tensors or tuples of tensors on the graph's device.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..kernels import ops
from .engine import BlockCtx, BlockProgram, MultiProgram
from .graph import GraphBlocks

#: the CC label of padding rows inside the program (and the min fill)
INT32_MAX = torch.iinfo(torch.int32).max


class ConnectedComponentsProgram(BlockProgram):
    """Min-label propagation; converges to each component's min padded id."""

    combine = "min"
    halo_fill = INT32_MAX
    max_steps = 10_000

    def init(self, g: GraphBlocks) -> torch.Tensor:
        ids = torch.arange(g.N, dtype=torch.int32, device=g.device)
        return torch.where(g.node_mask, ids, INT32_MAX)

    def halo_field(self, state: torch.Tensor) -> torch.Tensor:
        return state

    def update(self, ctx: BlockCtx, state: torch.Tensor,
               red: torch.Tensor) -> torch.Tensor:
        return torch.where(ctx.node_mask, torch.minimum(state, red), state)


class PageRankProgram(BlockProgram):
    """Push-style PageRank; state = (rank, contribution), field = contrib.

    rank'[u] = (1 - alpha)/n_real + alpha * sum_{v ~ u} rank[v]/deg[v]
    on real nodes (0 on padding).  `tol` is the per-node halt tolerance on
    |rank' - rank| (None = fixed-iteration: exactly `max_steps`
    supersteps).  Float32 throughout, so parity across backends is
    allclose, not bit equality.
    """

    combine = "sum"
    halo_fill = 0.0

    def __init__(self, alpha: float = 0.85, tol: Optional[float] = 1e-6,
                 max_steps: int = 100):
        self.alpha = float(alpha)
        self.tol = None if tol is None else float(tol)
        self.max_steps = int(max_steps)

    def _key(self):
        return (self.alpha, self.tol, self.max_steps)

    @staticmethod
    def _contrib(deg: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
        return torch.where(deg > 0, rank / deg.clamp(min=1), 0.0).to(
            torch.float32)

    def init(self, g: GraphBlocks) -> Tuple[torch.Tensor, torch.Tensor]:
        n = g.node_mask.to(torch.float32).sum().clamp(min=1.0)
        rank = torch.where(g.node_mask, 1.0 / n, 0.0).to(torch.float32)
        return rank, self._contrib(g.deg, rank)

    def halo_field(self, state) -> torch.Tensor:
        return state[1]

    def update(self, ctx: BlockCtx, state, red: torch.Tensor):
        base = (1.0 - self.alpha) / ctx.n_real
        rank = torch.where(ctx.node_mask, base + self.alpha * red, 0.0).to(
            torch.float32)
        return rank, self._contrib(ctx.deg, rank)

    def changed(self, old, new) -> torch.Tensor:
        if self.tol is None:  # fixed-iteration: max_steps bounds the loop
            return torch.ones((), dtype=torch.bool, device=new[0].device)
        return ((new[0] - old[0]).abs() > self.tol).any()


class TriangleCountProgram(BlockProgram):
    """One "count_common" superstep; state = (per-node counts, nbr rows)."""

    combine = "count_common"
    halo_fill = -1
    max_steps = 1  # a single exchange computes every count

    def init(self, g: GraphBlocks):
        return (torch.zeros(g.N, dtype=torch.int32, device=g.device),
                g.nbr.to(torch.int32))

    def halo_field(self, state) -> torch.Tensor:
        return state[1]

    def update(self, ctx: BlockCtx, state, red: torch.Tensor):
        # red[u] = ordered common-neighbor pairs = 2 * triangles at u
        return red // 2, state[1]

    def mirror_state(self, state, primary_row: torch.Tensor):
        # counts are per-vertex (replicate); neighbor rows are per-ROW
        # slices — gathering them through primaries would copy the
        # primary's slice onto every mirror
        return state[0][primary_row.long()], state[1]


class CorenessBlockProgram(BlockProgram):
    """§4.1 min-H coreness on the generic contract (parity witness)."""

    combine = "hindex"
    halo_fill = -1
    max_steps = 10_000

    def init(self, g: GraphBlocks) -> torch.Tensor:
        return torch.where(g.node_mask, g.deg, 0).to(torch.int32)

    def halo_field(self, state: torch.Tensor) -> torch.Tensor:
        return state

    def update(self, ctx: BlockCtx, state: torch.Tensor,
               red: torch.Tensor) -> torch.Tensor:
        return torch.where(ctx.node_mask, torch.minimum(state, red), state)


# ---------------------------------------------------------------------------
# Entry points (thin wrappers over `ops.run_block_program`).  Superstep
# counts come back as host ints.
# ---------------------------------------------------------------------------


def connected_components(
    g: GraphBlocks, backend: str = "auto", executor=None,
    max_steps: Optional[int] = None, with_steps: bool = False, mirror=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Canonical component labels: label[u] = min padded id of u's
    component; (N,) int32 with -1 on padding rows (plus the superstep
    count when `with_steps=True`).  Identical integers on every backend.
    Under `mirror` replica rows carry their primary's id, so labels stay
    in the unsplit id space."""
    state, steps = ops.run_block_program(
        g, ConnectedComponentsProgram(), backend=backend, executor=executor,
        max_steps=max_steps, with_steps=True, mirror=mirror)
    labels = torch.where(g.node_mask, state, -1)
    return (labels, steps) if with_steps else labels


def pagerank(
    g: GraphBlocks, alpha: float = 0.85, tol: Optional[float] = 1e-6,
    max_steps: int = 100, backend: str = "auto", executor=None,
    with_steps: bool = False, mirror=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Push-style PageRank over the undirected graph; (N,) float32 ranks,
    0.0 on padding rows.  `tol=None` runs exactly `max_steps` supersteps;
    otherwise the loop halts once no node moves more than `tol`.  Under
    `mirror` the slice partials re-associate the float sums: allclose to
    the unsplit run, not bit-equal."""
    prog = PageRankProgram(alpha=alpha, tol=tol, max_steps=max_steps)
    (rank, _), steps = ops.run_block_program(g, prog, backend=backend,
                                             executor=executor,
                                             with_steps=True, mirror=mirror)
    return (rank, steps) if with_steps else rank


def triangle_counts(
    g: GraphBlocks, backend: str = "auto", executor=None,
    with_steps: bool = False, mirror=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Per-node triangle counts ((N,) int32, 0 on padding rows); the
    global total is `triangle_total(counts)`.  One superstep.  Under
    `mirror` the runner routes through `hub_split.run_common_mirror`
    (canonicalized rows + per-slice corrections)."""
    (counts, _), steps = ops.run_block_program(
        g, TriangleCountProgram(), backend=backend, executor=executor,
        with_steps=True, mirror=mirror)
    return (counts, steps) if with_steps else counts


def fused_analytics(
    g: GraphBlocks, alpha: float = 0.85, steps: int = 30,
    backend: str = "auto", executor=None, with_steps: bool = False,
    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mirror=None,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
           Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], int]]:
    """Coreness + CC labels + PageRank from ONE fused superstep loop.

    A `MultiProgram` over `CorenessBlockProgram`,
    `ConnectedComponentsProgram` and fixed-iteration
    `PageRankProgram(alpha, tol=None)` runs exactly `steps` supersteps,
    each reading the adjacency once for all three fields.  Returns
    ``(coreness, labels, rank)`` — 0 / -1 / 0.0 on padding rows — each
    bit-identical to its standalone program for the same superstep count,
    provided `steps` covers the coreness and CC convergence.

    `init=(core, labels)` warm-starts the two monotone sub-programs from
    maintained values (labels as `connected_components` returns them);
    both are fixpoints of their updates, so exact inputs ride through
    unchanged while PageRank, always from its uniform init, runs its
    `steps` iterations.

    `mirror` runs the whole fused loop under the vertex-cut dataflow: one
    merge per field per superstep, PageRank's init read through the
    logical view (`ops._mirror_init_view`).
    """
    pr = PageRankProgram(alpha=alpha, tol=None, max_steps=steps)
    prog = MultiProgram(
        (CorenessBlockProgram(), ConnectedComponentsProgram(), pr),
        max_steps=steps)
    state0 = None
    if init is not None:
        core0, labels0 = init
        labels0 = torch.as_tensor(labels0, device=g.device).to(torch.int32)
        gi = g if mirror is None else ops._mirror_init_view(g, mirror)
        state0 = (torch.as_tensor(core0, device=g.device).to(torch.int32),
                  torch.where(g.node_mask, labels0, INT32_MAX),
                  pr.init(gi))
    state, n = ops.run_block_program(g, prog, backend=backend,
                                     executor=executor, with_steps=True,
                                     state0=state0, mirror=mirror)
    core, lab, (rank, _) = state
    results = (core, torch.where(g.node_mask, lab, -1), rank)
    return (results, n) if with_steps else results


def triangle_total(counts: torch.Tensor) -> torch.Tensor:
    """Global triangle count from per-node counts (device int scalar)."""
    return counts.sum() // 3


def merge_labels(labels: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Exact CC maintenance for a fixed-width batch of edge INSERTIONS.

    labels: (N,) canonical labels (min member padded id on real rows, as
    `connected_components` returns them); us, vs: (R,) endpoint ids;
    valid: (R,) bool (False columns are no-ops).  In window order, each
    insertion replaces the larger of its endpoints' labels with the smaller
    everywhere, so the merged component keeps its minimum member id and
    the result equals a recompute.  Runs on the device, no host read.
    Deletions cannot be maintained this way: the stream recomputes.
    """
    us, vs = us.long(), vs.long()
    for i in range(us.shape[0]):
        la = labels.gather(0, us[i:i + 1])
        lb = labels.gather(0, vs[i:i + 1])
        lo, hi = torch.minimum(la, lb), torch.maximum(la, lb)
        labels = torch.where(valid[i:i + 1] & (labels == hi), lo, labels)
    return labels
