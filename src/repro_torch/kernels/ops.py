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

"ell_spmd" is not ported yet and raises NotImplementedError (see
ROADMAP.md).  `core.kcore`, `core.kcore_dynamic` and `core.algorithms`
reach the primitives only through this layer.

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

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from . import ref
from .ell_cc import neighbor_min_ell
from .ell_frontier import frontier_step_ell
from .ell_hindex import VARIANTS as HINDEX_VARIANTS, hindex_ell
from .ell_multi import neighbor_multi_ell, neighbor_multi_ell_plain
from .ell_pagerank import neighbor_sum_ell
from .ell_triangles import neighbor_common_ell
from .frontier import frontier_step as frontier_step_dense
from .kcore_hindex import hindex_counts, matmul_f32, row_chunks

BACKENDS = ("torch", "ell", "dense")
NOT_PORTED = ("ell_spmd",)

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
    if backend in NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported to PyTorch yet; see "
            "ROADMAP.md (Queue 2) for the kernels still to port")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS + ('auto',)}")
    return backend


def degree_bound(g) -> int:
    """pow2-bucketed max-degree column bound K for the kernels.

    ONE host read per call (made at the top of a fixpoint, never inside).
    h(u) <= deg(u), so any bound >= the max degree is exact on left-filled
    rows; bucketing to a power of two keeps the bound stable while a
    maintenance stream nudges the max degree.  Capped at Cd.
    """
    if g.N == 0:
        return g.Cd
    d = int(g.deg.max())
    return min(g.Cd, _pow2_bucket(max(1, d)))


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
                  variant: str = "sort") -> torch.Tensor:
    """h-index of neighbor estimates for every node, via the chosen backend.

    g: a GraphBlocks (duck-typed: .nbr, .device, .N, .Cd); est: (N,)
    int32.  Returns (N,) int32 — h[u] = h-index of {est[v] : v ~ u}, 0
    for neighborless rows.  K (optional) is the column bound of the "ell"
    path (see `degree_bound`; None reads all Cd columns) and the threshold
    bound of the "dense" path (None: Cd + 1, exact because h <= deg <= Cd).
    Loops over the dense backend densify once and pass `adj` (see
    `dense_adj`).  `variant` picks the "ell" kernel ("sort" or "count").
    """
    b = resolve_backend(backend, g.device)
    if b == "torch":
        return ref.ell_hindex_ref(g.nbr, est)
    if b == "ell":
        return hindex_ell(g.nbr, est, K=K, variant=variant)
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
                    adj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One masked BFS hop for R stacked frontiers, via the chosen backend.

    f, visited: (N, R) bool; eligible: (N,) shared or (N, R) per column.
    Returns the next frontier as (N, R) bool.  K bounds the columns the
    "ell" path reads.  Loops over the dense backend densify once and pass
    `adj`; its kernel takes one eligibility per node, so the per-column
    mask is folded into `visited` (a node ineligible for column r can
    never enter it) and all nodes are passed as eligible.
    """
    elig = _eligible_cols(eligible, f)
    b = resolve_backend(backend, g.device)
    if b == "torch":
        return ref.ell_frontier_hop_ref(g.nbr, f, elig, visited)
    if b == "ell":
        return frontier_step_ell(g.nbr, f.contiguous(), elig.contiguous(),
                                 visited.contiguous(), K=K)
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
        if int(changed) < done:  # the one host read of this chunk
            break
    return est, min(max_steps, 1 + int(changed))


def coreness_blocks(
    g, backend: str = "auto", max_steps: int = 10_000,
    with_steps: bool = False, variant: str = "sort",
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Full min-H coreness of every node (0 on padding rows), any backend.

    g: GraphBlocks; returns (N,) int32 coreness, plus the superstep count
    as a host int when `with_steps=True`.  The kernel paths read the
    degree bound once (`degree_bound`: the "ell" column bound, the "dense"
    threshold bound); "dense" densifies once per call.  `variant` picks
    the "ell" h-index kernel ("sort" or "count"; the same integers).
    """
    if variant not in HINDEX_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{HINDEX_VARIANTS}")
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
                 K: Optional[int]) -> torch.Tensor:
    """Whole-graph gather + reduce via the ELL kernels."""
    if combine == "min":
        return neighbor_min_ell(nbr, field, K=K)
    if combine == "sum":
        return neighbor_sum_ell(nbr, field, K=K)
    if combine == "hindex":
        return hindex_ell(nbr, field, K=K)
    if combine == "count_common":
        return neighbor_common_ell(nbr, field, K=K)
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

    field: (N,) values for "min"/"sum"/"hindex", (N, Cd) neighbor rows for
    "count_common".  K (optional) bounds the columns the "ell" path reads.
    Loops over the dense backend densify once and pass `adj`.
    """
    b = resolve_backend(backend, g.device)
    if b == "torch":
        return _combine_torch(g.nbr, field, combine)
    if b == "ell":
        return _combine_ell(g.nbr, field, combine, K)
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
) -> Tuple[Any, int]:
    """Iterate ``new, changed = step(state)`` under a device ``live`` flag.

    The sync policy of the module docstring: ``new`` is applied only
    where ``live`` is set, ``live`` is added to the step counter, then
    ``live &= changed``; the host reads ``live`` once per `SYNC_EVERY`
    supersteps.  Returns (state, supersteps) with the count of the JAX
    package's ``while_loop`` (the quiet superstep applied and counted).
    """
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
        if not bool(live):  # the one host read of this chunk
            break
    return state, int(steps)


def run_block_program(
    g,  # GraphBlocks (duck-typed: .nbr, .deg, .node_mask, .n_real, .device)
    program,  # core.engine.BlockProgram
    backend: str = "auto",
    max_steps: Optional[int] = None,
    with_steps: bool = False,
    state0: Optional[Any] = None,
    executor=None,
    mirror=None,
) -> Union[Any, Tuple[Any, int]]:
    """Run a `BlockProgram` to its halt fixpoint on one device.

    Each superstep is halo field -> backend combine -> block-local update
    -> halt verdict, with the sync policy of the module docstring: a
    device ``live`` flag, read on the host once per `SYNC_EVERY`
    supersteps.  The final state and the superstep count equal the JAX
    package's fused ``while_loop`` for every program.  `max_steps=None`
    takes the program's own bound; `state0` warm-starts from a caller's
    state (same structure as `program.init`'s).  Returns the final state,
    plus the superstep count (a host int) when `with_steps=True`.  The
    "dense" backend densifies once per run.

    The real-node count is read on the host once per run.  `executor=`
    (the mesh runtime) and `mirror=` (hub splitting) are not ported yet.
    """
    if executor is not None or mirror is not None:
        raise NotImplementedError(
            "run_block_program's executor= (mesh runtime) and mirror= (hub "
            "split) are not ported to PyTorch yet; see ROADMAP.md (Queue 1)")
    b = resolve_backend(backend, g.device)
    multi = program.combine == "multi"
    if not multi and program.combine not in COMBINES:
        raise _unknown(program.combine, COMBINES + ("multi",))
    ms = int(program.max_steps if max_steps is None else max_steps)
    ctx = BlockCtx(deg=g.deg.to(torch.int32), node_mask=g.node_mask,
                   n_real=int(g.n_real))  # the run's one extra host read
    state = program.init(g) if state0 is None else state0
    adj = dense_adj(g, b)

    def step(state):
        field = program.halo_field(state)
        if not multi:
            red = neighbor_combine_blocks(g, field, program.combine, b,
                                          adj=adj)
        elif b == "torch":
            red = neighbor_multi_ell_plain(g.nbr, field, program.combines)
        elif b == "ell":
            red = neighbor_multi_ell(g.nbr, field, program.combines)
        else:  # one resident adjacency serves every field
            red = tuple(_combine_dense(adj, f, c, g.Cd)
                        for c, f in zip(program.combines, field))
        new = program.update(ctx, state, red)
        return new, program.changed(state, new)

    state, steps = live_loop(step, state, ms, g.device)
    return (state, steps) if with_steps else state
