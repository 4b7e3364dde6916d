"""Kernel backend registry: one dispatch layer for every BLADYG hot loop.

Three executions of the graph primitives — the h-index of neighbor
estimates, the masked frontier hop, and the named neighbor combines of
the `BlockProgram` contract (`COMBINES`) — exact and bit-identical except
for float sums, which agree to float32 rounding:

  "torch"  plain whole-graph PyTorch gather (`ref.py`) — the oracle, the
           counterpart of the JAX package's "jnp".
  "ell"    the hand-written CUDA kernels over the ELL rows
           (`ell_hindex.py`, `ell_frontier.py`, `ell_cc.py`,
           `ell_pagerank.py`, `ell_multi.py`, `ell_triangles.py`) on a
           CUDA graph; on a CPU graph the same wrappers run their plain
           versions.
  "dense"  an (N, N) bfloat16 0/1 adjacency (`dense_adj`; N^2 * 2 bytes,
           5.01 GB at N = 50,048), built once per loop: the h-index and
           the frontier hop through the hand-written CUDA kernels
           `kcore_hindex.py` and `frontier.py` (plain versions on a CPU
           graph); the combines "min" and "count_common" in plain
           PyTorch, and "sum" as a float32 matmul, as the JAX package
           computes them outside its kernels.
  "auto"   resolves to "ell" for a CUDA graph and "torch" for a CPU graph;
           it is every entry point's default and never picks "dense" (the
           JAX package's dense crossover was measured on a TPU only).

  "ell_spmd" the mesh runtime (`runtime.spmd`, one process per worker on
           `torch.distributed`): each worker runs the ELL kernels on its
           shard after a halo exchange.  `hindex_blocks`,
           `frontier_blocks`, `coreness_blocks` and `run_block_program`
           take it, with a long-lived `runtime.spmd.SpmdExecutor` as
           `executor=` (one is built per call otherwise), as in the JAX
           package; `neighbor_combine_blocks` refuses it with the JAX
           package's ValueError (a mesh combine only exists inside a
           program's superstep).  Never picked by "auto".

`core.kcore`, `core.kcore_dynamic` and `core.algorithms` reach the
primitives only through this layer.

**Sync policy.**  A min-H fixpoint or a frontier search ends when a
device-side flag says so, and reading that flag is a host sync.  The
port checks convergence every `SYNC_EVERY` = 8 supersteps:

  * in the min-H loops (`coreness_blocks`, and the clamped recompute of
    `core.kcore_dynamic`, both through `minh_fixpoint`) each superstep
    adds its ``changed`` flag into a device counter, which the host reads
    once per 8 supersteps.  The supersteps that change something form a
    prefix (past the fixpoint nothing changes), so the reference's count
    is ``min(max_steps, 1 + sum(changed))``, and the extra supersteps of
    the last chunk leave the estimates as they were;
  * in `core.kcore_dynamic.k_reachable_batch` each hop first adds
    ``any(frontier)`` into the counter; hops on an empty frontier stay
    empty, so the count and the result equal the reference's.

  * in `live_loop`, which runs any `BlockProgram` (`run_block_program`)
    and `core.engine.BladygEngine.run_jit`, a device-side ``live`` flag
    gates each superstep: ``new`` is applied only where ``live`` is
    set, ``live`` is added to the step counter, then ``live &= changed``.
    The quiet superstep itself is applied, as in the JAX package's
    ``while_loop``, and later supersteps of the chunk change nothing, so
    the state and the count equal the reference's even for programs whose
    update is not idempotent at the halt (PageRank with a tolerance).

No loop ever runs past `max_steps`.  One more host read per fixpoint is
`degree_bound`'s max degree (for a program, the real-node count).
Capturing the loop in a CUDA graph, to drop the per-chunk syncs and the
launch overhead, is later work.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..tracing import SYNC, span
from . import ref
from .ell_cc import neighbor_min_ell
from .ell_frontier import frontier_step_ell
from .ell_hindex import VARIANTS as HINDEX_VARIANTS, hindex_ell
from .ell_multi import neighbor_multi_ell, neighbor_multi_ell_plain
from .ell_pagerank import neighbor_sum_ell
from .ell_triangles import VARIANTS as TRIANGLE_VARIANTS  # noqa: F401
from .ell_triangles import neighbor_common_ell
from .frontier import frontier_step as frontier_step_dense
from .kcore_hindex import hindex_counts, matmul_f32, row_chunks

BACKENDS = ("torch", "ell", "dense", "ell_spmd")

#: the mesh backend (see the module docstring)
SPMD_BACKEND = "ell_spmd"

#: neighbor combines of the BlockProgram contract
COMBINES = ("min", "sum", "hindex", "count_common")

#: combines a fused MultiProgram superstep may bundle (`ell_multi`); the
#: meta-combine name "multi" dispatches to the fused paths
MULTI_COMBINES = ("min", "sum", "hindex")

#: supersteps between two host reads of a loop's convergence counter
SYNC_EVERY = 8


def _pow2_bucket(x: int, floor: int = 32) -> int:
    """Smallest power of two >= x, floored at `floor` (a warp's width: the
    kernels read slots 32 at a time, so a smaller bound saves nothing)."""
    k = floor
    while k < x:
        k *= 2
    return k


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """Resolve "auto" (or None) to a concrete backend for a device."""
    if backend in (None, "auto"):
        return "ell" if torch.device(device).type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS + ('auto',)}")
    return backend


def column_bound(deg: torch.Tensor, Cd: int) -> int:
    """pow2-bucketed max of `deg`, capped at Cd (Cd for no rows): one host
    read.  The column bound K of the kernels over rows of length `deg`."""
    if deg.numel() == 0:
        return Cd
    with span(SYNC):
        top = int(deg.max())
    return min(Cd, _pow2_bucket(max(1, top)))


def degree_bound(g) -> int:
    """pow2-bucketed max-degree column bound K for the kernels.

    ONE host read per call (made at the top of a fixpoint, never inside).
    h(u) <= deg(u), so any bound >= the max degree is exact on left-filled
    rows; bucketing to a power of two keeps the bound stable while a
    maintenance stream nudges the max degree.  Capped at Cd.
    """
    return column_bound(g.deg, g.Cd)


def dense_bytes(N: int) -> int:
    """Device bytes of the dense backend's (N, N) bfloat16 adjacency (the
    port pads nothing)."""
    return N * N * 2


def dense_adj(g, backend: str) -> Optional[torch.Tensor]:
    """Densify once for a loop over dense-backend calls; None otherwise."""
    if resolve_backend(backend, g.device) == "dense":
        return ref.ell_to_dense(g.nbr, g.N)
    return None


# ---------------------------------------------------------------------------
# Dense-path wrappers (the JAX package's adjacency-matrix API).
# ---------------------------------------------------------------------------


def hindex(adj: torch.Tensor, est: torch.Tensor,
           K: Optional[int] = None) -> torch.Tensor:
    """h-index per node over a dense adjacency (any dtype; 0/1 values),
    via `kcore_hindex.hindex_counts`: (N,) int32, capped at K.

    K=None uses the node-count bound N (h <= deg < N), as the JAX package
    does; loops pass a degree bound.  Exact for K >= max(est) + 1.
    """
    N = adj.shape[0]
    K = max(1, N) if K is None else int(K)
    return hindex_counts(adj.to(torch.bfloat16).contiguous(),
                         est.to(torch.int32).contiguous(), K)


def frontier_step(adj: torch.Tensor, f: torch.Tensor, eligible: torch.Tensor,
                  visited: torch.Tensor) -> torch.Tensor:
    """Masked BFS hop over a dense adjacency, via `frontier.frontier_step`:
    f, visited (N, R); eligible (N,) shared by the columns.  Returns the
    next frontier as (N, R) bool."""
    return frontier_step_dense(
        adj.to(torch.bfloat16).contiguous(), f.to(torch.bool).contiguous(),
        eligible.to(torch.bool).contiguous(),
        visited.to(torch.bool).contiguous())


def coreness_dense(
    adj: torch.Tensor, max_steps: int = 10_000, with_steps: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Full coreness of a dense adjacency via the kernelized min-H
    iteration: equal to `ref.coreness_dense_ref` and to `core.kcore`'s.
    K is the pow2-bucketed max degree + 1 (one host read); the fixpoint
    follows the sync policy of the module docstring.  `with_steps=True`
    also returns the superstep count (a host int)."""
    adj = adj.to(torch.bfloat16).contiguous()
    N = adj.shape[0]
    deg = (adj > 0).sum(dim=1).to(torch.int32)
    K = _pow2_bucket(int(deg.max()) + 1) if N else 1
    est, steps = minh_fixpoint(
        deg, lambda e: hindex_counts(adj, e, K),
        torch.ones(N, dtype=torch.bool, device=adj.device), max_steps)
    return (est, steps) if with_steps else est


# ---------------------------------------------------------------------------
# GraphBlocks-level dispatch — the only entry points core code may use.
# ---------------------------------------------------------------------------


def hindex_blocks(g, est: torch.Tensor, backend: str = "auto",
                  K: Optional[int] = None,
                  adj: Optional[torch.Tensor] = None,
                  variant: str = "sort", executor=None) -> torch.Tensor:
    """h-index of neighbor estimates for every node, via the chosen backend.

    g: a GraphBlocks (duck-typed: .nbr, .deg, .device, .N, .Cd); est:
    (N,) int32.  Returns (N,) int32 — h[u] = h-index of {est[v] : v ~ u},
    0 for neighborless rows.  K (optional) is the column bound of the
    "ell" path (see `degree_bound`; None reads all Cd columns, each row up
    to its length `g.deg`) and the threshold bound of the "dense" path
    (None: Cd + 1, exact because h <= deg <= Cd).
    Loops over the dense backend densify once and pass `adj` (see
    `dense_adj`).  `variant` picks the "ell" kernel ("sort" or "count").
    "ell_spmd" runs one superstep on the worker mesh; loops pass a
    long-lived `runtime.spmd.SpmdExecutor` as `executor` instead of
    paying a halo-plan build per call.
    """
    if backend == SPMD_BACKEND:
        from ..runtime.spmd import hindex_spmd  # lazy: no import cycle

        return hindex_spmd(g, est, executor=executor)
    b = resolve_backend(backend, g.device)
    if b == "torch":
        return ref.ell_hindex_ref(g.nbr, est)
    if b == "ell":
        return hindex_ell(g.nbr, est, K=K, variant=variant, deg=g.deg)
    if adj is None:
        adj = ref.ell_to_dense(g.nbr, g.N)
    return hindex(adj, est, K=g.Cd + 1 if K is None else K)


def _eligible_cols(eligible: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """A shared (N,) eligibility broadcast to f's (N, R) column form."""
    if eligible.dim() == 1 and eligible.shape[0] == f.shape[0]:
        return eligible[:, None].expand(f.shape)
    if eligible.shape != f.shape:
        raise ValueError(f"eligible must be (N,) or (N, R) like f "
                         f"{tuple(f.shape)}, got {tuple(eligible.shape)}")
    return eligible


def frontier_blocks(g, f: torch.Tensor, eligible: torch.Tensor,
                    visited: torch.Tensor, backend: str = "auto",
                    K: Optional[int] = None,
                    adj: Optional[torch.Tensor] = None,
                    executor=None) -> torch.Tensor:
    """One masked BFS hop for R stacked frontiers, via the chosen backend.

    f, visited: (N, R) bool; eligible: (N,) shared or (N, R) per column.
    Returns the next frontier as (N, R) bool.  K bounds the columns the
    "ell" path reads, and each row stops at its length `g.deg`.  Loops
    over the dense backend densify once and pass `adj`; its kernel takes
    one eligibility per node, so the per-column mask is folded into
    `visited` (a node ineligible for column r can never enter it) and all
    nodes are passed as eligible.  "ell_spmd" runs the hop on the worker
    mesh, through `executor` when one is given (see `hindex_blocks`).
    """
    elig = _eligible_cols(eligible, f)
    if backend == SPMD_BACKEND:
        from ..runtime.spmd import frontier_spmd  # lazy: no import cycle

        return frontier_spmd(g, f, elig, visited, executor=executor)
    b = resolve_backend(backend, g.device)
    if b == "torch":
        return ref.ell_frontier_hop_ref(g.nbr, f, elig, visited)
    if b == "ell":
        return frontier_step_ell(g.nbr, f.contiguous(), elig.contiguous(),
                                 visited.contiguous(), K=K, deg=g.deg)
    if adj is None:
        adj = ref.ell_to_dense(g.nbr, g.N)
    ones = torch.ones(g.N, dtype=torch.bool, device=g.device)
    return frontier_step(adj, f, ones, visited.to(torch.bool) | ~elig)


def minh_fixpoint(
    est: torch.Tensor, h_of: Callable[[torch.Tensor], torch.Tensor],
    active: torch.Tensor, max_steps: int,
) -> Tuple[torch.Tensor, int]:
    """Iterate est' = where(active, min(est, h_of(est)), est) to its fixpoint.

    Returns (est, supersteps) with the JAX package's superstep count (a
    superstep that changes nothing ends the loop and is counted).  The
    host reads the device counter of changing supersteps once every
    `SYNC_EVERY` supersteps (see the module docstring).
    """
    changed = torch.zeros((), dtype=torch.int32, device=est.device)
    done = 0
    while done < max_steps:
        n = min(SYNC_EVERY, max_steps - done)
        for _ in range(n):
            new = torch.where(active, torch.minimum(est, h_of(est)), est)
            changed += (new != est).any().to(torch.int32)
            est = new
        done += n
        with span(SYNC):  # the one host read of this chunk
            quiet = int(changed) < done
        if quiet:
            break
    with span(SYNC):
        return est, min(max_steps, 1 + int(changed))


def coreness_blocks(
    g, backend: str = "auto", max_steps: int = 10_000,
    with_steps: bool = False, variant: str = "sort", executor=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Full min-H coreness of every node (0 on padding rows), any backend.

    g: GraphBlocks; returns (N,) int32 coreness, plus the superstep count
    as a host int when `with_steps=True`.  The kernel paths read the
    degree bound once (`degree_bound`: the "ell" column bound, the "dense"
    threshold bound); "dense" densifies once per call.  `variant` picks
    the "ell" h-index kernel ("sort" or "count"; the same integers).
    "ell_spmd" runs the fixpoint on the worker mesh (`executor`, or one
    built for the call), the "sort" kernel on every shard.
    """
    if variant not in HINDEX_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{HINDEX_VARIANTS}")
    if backend == SPMD_BACKEND:
        from ..runtime.spmd import SpmdExecutor  # lazy: no import cycle

        ex = executor if executor is not None else SpmdExecutor(g)
        est, steps = ex.coreness(max_steps=max_steps)
        return (est, steps) if with_steps else est
    b = resolve_backend(backend, g.device)
    K = degree_bound(g) if b in ("ell", "dense") else None
    adj = dense_adj(g, b)
    est0 = torch.where(g.node_mask, g.deg, 0).to(torch.int32)
    est, steps = minh_fixpoint(
        est0, lambda e: hindex_blocks(g, e, backend=b, K=K, adj=adj,
                                      variant=variant),
        g.node_mask, max_steps)
    return (est, steps) if with_steps else est


# ---------------------------------------------------------------------------
# BlockProgram execution: the generic superstep runner.  The program
# contract itself lives in `core.engine.BlockProgram` (which imports the
# context type from here — kernels never import core); the workloads live
# in `core.algorithms`.
# ---------------------------------------------------------------------------


class BlockCtx(NamedTuple):
    """Per-node context handed to `BlockProgram.update`.

    deg:       (N,) int32 — true degree per node (0 on padding rows).
    node_mask: (N,) bool  — True for real nodes.
    n_real:    int        — real-node count (a host int; e.g. the PageRank
                            teleport denominator).
    """

    deg: torch.Tensor
    node_mask: torch.Tensor
    n_real: int


def _unknown(combine: str, allowed=COMBINES) -> ValueError:
    return ValueError(f"unknown combine {combine!r}; expected one of "
                      f"{allowed}")


def _combine_torch(nbr: torch.Tensor, field: torch.Tensor,
                   combine: str) -> torch.Tensor:
    """Whole-graph gather + reduce, plain PyTorch (the oracle execution)."""
    if combine == "min":
        return ref.ell_min_ref(nbr, field)
    if combine == "sum":
        return ref.ell_sum_ref(nbr, field)
    if combine == "hindex":
        return ref.ell_hindex_ref(nbr, field)
    if combine == "count_common":
        return ref.ell_common_ref(nbr, field)
    raise _unknown(combine)


def _combine_ell(nbr: torch.Tensor, field: torch.Tensor, combine: str,
                 K: Optional[int], deg: torch.Tensor) -> torch.Tensor:
    """Whole-graph gather + reduce via the ELL kernels; every combine
    stops each row at its length `deg` (the same result)."""
    if combine == "min":
        return neighbor_min_ell(nbr, field, K=K, deg=deg)
    if combine == "sum":
        return neighbor_sum_ell(nbr, field, K=K, deg=deg)
    if combine == "hindex":
        return hindex_ell(nbr, field, K=K, deg=deg)
    if combine == "count_common":
        return neighbor_common_ell(nbr, field, K=K, deg=deg)
    raise _unknown(combine)


def _combine_dense(adj: torch.Tensor, field: torch.Tensor, combine: str,
                   Cd: int) -> torch.Tensor:
    """Dense-adjacency forms of the combines (adj: (N, N) bfloat16 0/1),
    over row chunks of at most `kcore_hindex.DENSE_CHUNK` elements:

      min    masked row min over the adjacency (plain PyTorch);
      sum    adj @ field, a float32 matmul (not TF32: `matmul_f32`);
      hindex the threshold-count h-index, K = Cd + 1 (exact: h <= deg <=
             Cd), through the `kcore_hindex` kernel on a CUDA graph;
      count_common  diag(A^3) as sum(A * (A @ A), axis=1) in float32:
             every ordered common-neighbor pair at u, equal to the ELL
             intersection (the row field is not read).
    """
    N = adj.shape[0]
    if combine == "hindex":
        return hindex(adj, field, K=Cd + 1)
    if combine == "min":
        out = torch.empty(N, dtype=field.dtype, device=adj.device)
        for rows in row_chunks(N):
            out[rows] = torch.where(adj[rows] > 0, field[None, :],
                                    ref._fill(field.dtype)).amin(dim=1)
        return out
    if combine == "sum":
        x = field.to(torch.float32)
        out = torch.empty(N, dtype=torch.float32, device=adj.device)
        for rows in row_chunks(N):
            out[rows] = matmul_f32(adj[rows].to(torch.float32), x)
        return out
    if combine == "count_common":
        a = (adj > 0).to(torch.float32)
        out = torch.empty(N, dtype=torch.int32, device=adj.device)
        for rows in row_chunks(N):
            out[rows] = (a[rows] * matmul_f32(a[rows], a)).sum(dim=1).to(
                torch.int32)
        return out
    raise _unknown(combine)


def neighbor_combine_blocks(
    g, field: torch.Tensor, combine: str, backend: str = "auto",
    K: Optional[int] = None, adj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One gather + reduce superstep of a named combine, via a backend.

    g: a GraphBlocks (duck-typed: .nbr, .deg, .device, .Cd).  field: (N,)
    values for "min"/"sum"/"hindex", (N, Cd) neighbor rows for
    "count_common".  K (optional) bounds the columns the "ell" path reads,
    and each row stops at its length `g.deg`.  Loops over the dense
    backend densify once and pass `adj`.  "ell_spmd" raises ValueError, as
    in the JAX package: a mesh combine only exists downstream of a halo
    exchange, inside a program's superstep (`run_block_program`).
    """
    b = resolve_backend(backend, g.device)
    if b == "torch":
        return _combine_torch(g.nbr, field, combine)
    if b == "ell":
        return _combine_ell(g.nbr, field, combine, K, g.deg)
    if b == SPMD_BACKEND:
        raise ValueError(
            "neighbor_combine_blocks has no ell_spmd path: mesh combines "
            "only exist inside a halo-exchange superstep — run the whole "
            "program via run_block_program(backend='ell_spmd').")
    if adj is None:
        adj = ref.ell_to_dense(g.nbr, g.N)
    return _combine_dense(adj, field, combine, g.Cd)


def tree_where(cond: torch.Tensor, new: Any, old: Any) -> Any:
    """`torch.where(cond, new, old)` over matching tuples of tensors (None
    leaves stay None): the port's form of a pytree select."""
    if isinstance(new, (tuple, list)):
        return type(new)(tree_where(cond, n, o) for n, o in zip(new, old))
    if new is None:
        return None
    return torch.where(cond, new, old)


def live_loop(
    step: Callable[[Any], Tuple[Any, torch.Tensor]], state: Any,
    max_steps: int, device: torch.device,
    live: Optional[torch.Tensor] = None,
) -> Tuple[Any, int]:
    """Iterate ``new, changed = step(state)`` under a device ``live`` flag.

    The sync policy of the module docstring: ``new`` is applied only
    where ``live`` is set, ``live`` is added to the step counter, then
    ``live &= changed``; the host reads ``live`` once per `SYNC_EVERY`
    supersteps.  Returns (state, supersteps) with the count of the JAX
    package's ``while_loop`` (the quiet superstep applied and counted).
    `live` (a 0-d bool tensor, default True) is the loop condition before
    the first superstep, as a ``while_loop`` whose carry starts with it.
    """
    if live is None:
        live = torch.ones((), dtype=torch.bool, device=device)
    steps = torch.zeros((), dtype=torch.int32, device=device)
    done = 0
    while done < max_steps:
        n = min(SYNC_EVERY, max_steps - done)
        for _ in range(n):
            new, changed = step(state)
            state = tree_where(live, new, state)
            steps += live.to(torch.int32)
            live = live & changed
        done += n
        with span(SYNC):  # the one host read of this chunk
            more = bool(live)
        if not more:
            break
    with span(SYNC):
        return state, int(steps)


# ---------------------------------------------------------------------------
# Hub mirroring (`core.hub_split`): the merge stage of a mirrored run.
# Plain PyTorch on every backend, as the JAX package computes it in jnp
# outside its kernels.
# ---------------------------------------------------------------------------


class MergeIndex(NamedTuple):
    """A plan's replica groups in the merge's layout (`merge_index`).

    rows:  (R,) int64 — the rows of every split group.
    gid:   (R,) int64 — each row's group id, in [0, Gmax).
    table: (Gmax, S) int64 — each group's rows in the plan's order
           (primary first), padded with N: S is the most slices a group
           has.  A group's partials are reduced along its table row, in
           the same order on every run.
    """

    rows: torch.Tensor
    gid: torch.Tensor
    table: torch.Tensor


def merge_index(mirror, N: int) -> MergeIndex:
    """Build a plan's `MergeIndex` on its device: one host read of the
    plan's (Rp,) group entries, made once per mirrored run."""
    rows = mirror.grp_rows.cpu().numpy().astype(np.int64)
    gid = mirror.grp_gid.cpu().numpy().astype(np.int64)
    live = gid < mirror.Gmax
    order = np.argsort(gid[live], kind="stable")
    rows, gid = rows[live][order], gid[live][order]
    start = np.searchsorted(gid, gid)  # first entry of each row's group
    pos = np.arange(len(gid)) - start
    table = np.full((mirror.Gmax, max(1, int(pos.max(initial=0)) + 1)), N,
                    np.int64)
    table[gid, pos] = rows
    dev = mirror.grp_rows.device
    return MergeIndex(*(torch.from_numpy(a).to(dev)
                        for a in (rows, gid, table)))


def _mirror_merge(red: torch.Tensor, field: torch.Tensor, nbr: torch.Tensor,
                  mirror, combine: str,
                  index: Optional[MergeIndex] = None,
                  all_reduce: Optional[Callable] = None) -> torch.Tensor:
    """Merge per-slice partial aggregates across each hub replica group.

    Entries of `red` at group rows are replaced by the LOGICAL aggregate
    of the whole sliced neighborhood; every other row passes through.
    Returns a new tensor.  Per combine:

      min    — the group's partials reduced along its `MergeIndex.table`
               row (the slices partition the neighborhood: exact);
      sum    — the same with a sum, in the table's fixed row order, so
               repeated runs give the same bits (float sums re-associate
               against the unsplit graph: allclose, not bit-equal);
      hindex — partial h values do not compose, so the merge re-reads
               the group's neighbor values `field[nbr[rows]]` into one
               (Gmax, Km + 1) int32 histogram (value v counted in bin
               min(v, Km), values below 1 in bin 0; integer scatter-adds,
               order-free), gets cnt_t = #{v >= t} from its prefix sums
               and reads h = #{t in 1..Km : cnt_t >= t}.  Exact because
               a merged h-index never exceeds the logical degree <= Km.
               The JAX package compares every value with every threshold
               in an (Rp, Cd, Km) cube; this reads Rp * Cd values and
               writes Gmax * (Km + 1) counts.

    `index` is the plan's `merge_index` (built here when None).  Only
    live group rows are written: the JAX package drops pad entries by
    scattering past the end, which `index_put` would refuse.

    On a mesh worker (`runtime.spmd`) `red`, `field` and `nbr` are the
    worker's shard, its exchanged field and its local-frame rows, `index`
    holds the group rows resident in the shard (the table maps the others
    to the fill slot ``red.shape[0]``), and ``all_reduce(table, op)``
    (op "min" or "sum") merges each worker's partial table — the (Gmax,)
    reductions or the histogram — with one collective, before every
    worker writes the merged values back to its own group rows.
    """
    if index is None:
        index = merge_index(mirror, red.shape[0])
    if combine in ("min", "sum"):
        fill = ref._fill(red.dtype) if combine == "min" else 0
        ext = torch.cat([red, red.new_full((1,), fill)])[index.table]
        out = ext.amin(dim=1) if combine == "min" else ext.sum(dim=1)
        if all_reduce is not None:
            out = all_reduce(out, combine)
    elif combine == "hindex":
        Km = int(mirror.Km)
        nb = nbr[index.rows].long()
        vals = torch.where(nb >= 0, field[nb.clamp(min=0)], 0).clamp_(0, Km)
        bins = (index.gid[:, None] * (Km + 1) + vals).reshape(-1)
        hist = torch.zeros(mirror.Gmax * (Km + 1), dtype=torch.int32,
                           device=red.device).scatter_add_(
            0, bins, torch.ones_like(bins, dtype=torch.int32))
        if all_reduce is not None:
            hist = all_reduce(hist, "sum")
        # at_most[:, b] = #{v <= b}, so cnt_t = total - at_most[:, t - 1]
        at_most = hist.view(mirror.Gmax, Km + 1).cumsum(1, dtype=torch.int32)
        t = torch.arange(1, Km + 1, device=red.device, dtype=torch.int32)
        out = ((at_most[:, -1:] - at_most[:, :-1]) >= t).sum(dim=1)
    else:
        raise ValueError(
            f"combine {combine!r} has no mirror merge; count_common routes "
            "through core.hub_split.run_common_mirror")
    return red.index_put((index.rows,), out[index.gid].to(red.dtype))


def _mirror_merged(red, field, nbr, mirror, program, index: MergeIndex,
                   all_reduce: Optional[Callable] = None):
    """Apply `_mirror_merge` per field of a (possibly multi-) program."""
    if program.combine == "multi":
        return tuple(
            _mirror_merge(r, f, nbr, mirror, c, index, all_reduce)
            for r, f, c in zip(red, field, program.combines))
    return _mirror_merge(red, field, nbr, mirror, program.combine, index,
                         all_reduce)


def _mirror_init_view(g, mirror):
    """Logical facade for `program.init` under a mirrored run: the LOGICAL
    degrees and the primary mask (init formulas read degrees and the
    real-node mask, e.g. PageRank's 1/deg and teleport mass); then
    `program.mirror_state` replicates the per-primary values onto mirror
    rows."""
    return dataclasses.replace(g, deg=mirror.ldeg,
                               node_mask=mirror.primary_mask)


def run_block_program(
    g,  # GraphBlocks (duck-typed: .nbr, .deg, .node_mask, .n_real, .device)
    program,  # core.engine.BlockProgram
    backend: str = "auto",
    max_steps: Optional[int] = None,
    with_steps: bool = False,
    state0: Optional[Any] = None,
    executor=None,
    mirror=None,  # core.hub_split.MirrorPlan for a hub-split graph
) -> Union[Any, Tuple[Any, int]]:
    """Run a `BlockProgram` to its halt fixpoint.

    Each superstep is halo field -> backend combine -> block-local update
    -> halt verdict, with the sync policy of the module docstring: a
    device ``live`` flag, read on the host once per `SYNC_EVERY`
    supersteps.  The final state and the superstep count equal the JAX
    package's fused ``while_loop`` for every program.  `max_steps=None`
    takes the program's own bound; `state0` warm-starts from a caller's
    state (same structure as `program.init`'s).  Returns the final state,
    plus the superstep count (a host int) when `with_steps=True`.  The
    "dense" backend densifies once per run.

    "ell_spmd" runs the same program on the worker mesh
    (`runtime.spmd.SpmdEngine.run_spmd` over a `SpmdBlockProgram`): the
    halo field crosses workers by the executor's all-to-all, each worker
    runs the program's combine through the ELL kernels on its shard and
    its update, and the halt verdict is the all-gathered per-worker flag.
    Pass a long-lived `executor` (a `runtime.spmd.SpmdExecutor` of `g`);
    one is built for the call otherwise.  On the other backends
    `executor` is not read, as in the JAX package.  The superstep count is
    the engine's trace count.

    `mirror` (optional) declares `g` a hub-split graph (`core.hub_split`):
    init runs against the logical degree/mask view, the state replicates
    onto mirror rows (`program.mirror_state`), the update's ctx carries
    the LOGICAL degrees `mirror.ldeg` and vertex count while every kernel
    keeps the split graph's row lengths `g.deg`, and `_mirror_merge`
    folds per-slice partials per replica group between combine and
    update.  "count_common" programs route through
    `hub_split.run_common_mirror`.  Results equal the unsplit graph's
    (bit for bit for the integer combines).

    The real-node count (or, under a mirror, the plan's group entries) is
    read on the host once per run.
    """
    b = resolve_backend(backend, g.device)
    multi = program.combine == "multi"
    if not multi and program.combine not in COMBINES:
        raise _unknown(program.combine, COMBINES + ("multi",))
    if mirror is not None and program.combine == "count_common":
        from ..core.hub_split import run_common_mirror  # lazy: no cycle

        return run_common_mirror(g, mirror, program, backend=b,
                                 with_steps=with_steps, state0=state0)
    ms = int(program.max_steps if max_steps is None else max_steps)
    # the run's one extra host read: the (logical) real-node count
    with span(SYNC):
        n_real = int(g.n_real) if mirror is None else int(mirror.n_logical)
    if state0 is None:
        state0 = program.init(g if mirror is None
                              else _mirror_init_view(g, mirror))
    if mirror is not None:
        state0 = program.mirror_state(state0, mirror.primary_row)
    if b == SPMD_BACKEND:
        from ..runtime.spmd import (  # lazy: no import cycle
            SpmdBlockProgram, SpmdEngine, SpmdExecutor)

        ex = executor if executor is not None else SpmdExecutor(g)
        eng = SpmdEngine(g, executor=ex)
        state, _ = eng.run_spmd(
            SpmdBlockProgram(program, n_real, mirror=mirror), state0, None,
            max_supersteps=ms)
        steps = len(eng.traces)
        return (state, steps) if with_steps else state
    deg = g.deg.to(torch.int32) if mirror is None else mirror.ldeg
    ctx = BlockCtx(deg=deg, node_mask=g.node_mask, n_real=n_real)
    index = None if mirror is None else merge_index(mirror, g.N)
    adj = dense_adj(g, b)

    def step(state):
        field = program.halo_field(state)
        if not multi:
            red = neighbor_combine_blocks(g, field, program.combine, b,
                                          adj=adj)
        elif b == "torch":
            red = neighbor_multi_ell_plain(g.nbr, field, program.combines)
        elif b == "ell":  # the row lengths, never the logical degrees
            red = neighbor_multi_ell(g.nbr, field, program.combines,
                                     deg=g.deg)
        else:  # one resident adjacency serves every field
            red = tuple(_combine_dense(adj, f, c, g.Cd)
                        for c, f in zip(program.combines, field))
        if mirror is not None:
            red = _mirror_merged(red, field, g.nbr, mirror, program, index)
        new = program.update(ctx, state, red)
        return new, program.changed(state, new)

    state, steps = live_loop(step, state0, ms, g.device)
    return (state, steps) if with_steps else state
