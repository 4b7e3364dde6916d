"""Kernel backend registry: one dispatch layer for every BLADYG hot loop.

Two executions of the graph primitives — the h-index of neighbor
estimates, the masked frontier hop, and the named neighbor combines of
the `BlockProgram` contract (`COMBINES`) — exact and bit-identical except
for float sums, which agree to float32 rounding:

  "torch"  plain whole-graph PyTorch gather (`ref.py`) — the oracle, the
           counterpart of the JAX package's "jnp".
  "ell"    the hand-written CUDA kernels (`ell_hindex.py`,
           `ell_frontier.py`, `ell_cc.py`, `ell_pagerank.py`,
           `ell_multi.py`, `ell_triangles.py`) on a CUDA graph; on a CPU
           graph the same wrappers run their plain versions.
  "auto"   resolves to "ell" for a CUDA graph and "torch" for a CPU graph;
           it is every entry point's default.

"dense" and "ell_spmd" are not ported yet and raise NotImplementedError
(see ROADMAP.md).  `core.kcore`, `core.kcore_dynamic` and
`core.algorithms` reach the primitives only through this layer.

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
from .ell_hindex import hindex_ell
from .ell_multi import neighbor_multi_ell, neighbor_multi_ell_plain
from .ell_pagerank import neighbor_sum_ell
from .ell_triangles import neighbor_common_ell

BACKENDS = ("torch", "ell")
NOT_PORTED = ("dense", "ell_spmd")

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


def hindex_blocks(g, est: torch.Tensor, backend: str = "auto",
                  K: Optional[int] = None) -> torch.Tensor:
    """h-index of neighbor estimates for every node, via the chosen backend.

    g: a GraphBlocks (duck-typed: .nbr, .device); est: (N,) int32.
    Returns (N,) int32 — h[u] = h-index of {est[v] : v ~ u}, 0 for
    neighborless rows.  K (optional) is the column bound of the "ell"
    path (see `degree_bound`); None reads all Cd columns.
    """
    b = resolve_backend(backend, g.device)
    if b == "torch":
        return ref.ell_hindex_ref(g.nbr, est)
    return hindex_ell(g.nbr, est, K=K)


def frontier_blocks(g, f: torch.Tensor, eligible: torch.Tensor,
                    visited: torch.Tensor, backend: str = "auto",
                    K: Optional[int] = None) -> torch.Tensor:
    """One masked BFS hop for R stacked frontiers, via the chosen backend.

    f, eligible, visited: (N, R) bool (eligibility is per column; the
    shared (N,) form of the reference's dense backend is not ported).
    Returns the next frontier as (N, R) bool.
    """
    if eligible.shape != f.shape:
        raise ValueError(f"eligible must be (N, R) like f {tuple(f.shape)}, "
                         f"got {tuple(eligible.shape)}")
    b = resolve_backend(backend, g.device)
    if b == "torch":
        return ref.ell_frontier_hop_ref(g.nbr, f, eligible, visited)
    return frontier_step_ell(g.nbr, f.contiguous(), eligible.contiguous(),
                             visited.contiguous(), K=K)


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
    with_steps: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """Full min-H coreness of every node (0 on padding rows), any backend.

    g: GraphBlocks; returns (N,) int32 coreness, plus the superstep count
    as a host int when `with_steps=True`.  The "ell" path reads the column
    bound once (`degree_bound`).
    """
    b = resolve_backend(backend, g.device)
    K = degree_bound(g) if b == "ell" else None
    est0 = torch.where(g.node_mask, g.deg, 0).to(torch.int32)
    est, steps = minh_fixpoint(
        est0, lambda e: hindex_blocks(g, e, backend=b, K=K), g.node_mask,
        max_steps)
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


def neighbor_combine_blocks(
    g, field: torch.Tensor, combine: str, backend: str = "auto",
    K: Optional[int] = None,
) -> torch.Tensor:
    """One gather + reduce superstep of a named combine, via a backend.

    field: (N,) values for "min"/"sum"/"hindex", (N, Cd) neighbor rows for
    "count_common".  K (optional) bounds the columns the "ell" path reads.
    """
    b = resolve_backend(backend, g.device)
    if b == "torch":
        return _combine_torch(g.nbr, field, combine)
    return _combine_ell(g.nbr, field, combine, K)


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
    plus the superstep count (a host int) when `with_steps=True`.

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

    def step(state):
        field = program.halo_field(state)
        if not multi:
            red = neighbor_combine_blocks(g, field, program.combine, b)
        elif b == "torch":
            red = neighbor_multi_ell_plain(g.nbr, field, program.combines)
        else:
            red = neighbor_multi_ell(g.nbr, field, program.combines)
        new = program.update(ctx, state, red)
        return new, program.changed(state, new)

    state, steps = live_loop(step, state, ms, g.device)
    return (state, steps) if with_steps else state
