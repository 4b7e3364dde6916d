"""Kernel backend registry: one dispatch layer for the k-core hot loops.

Two executions of the two core graph primitives (h-index of neighbor
estimates; masked frontier hop), exact and bit-identical:

  "torch"  plain whole-graph PyTorch gather (`ref.py`) — the oracle, the
           counterpart of the JAX package's "jnp".
  "ell"    the hand-written CUDA kernels (`ell_hindex.py`,
           `ell_frontier.py`) on a CUDA graph; on a CPU graph the same
           wrappers run their plain versions.
  "auto"   resolves to "ell" for a CUDA graph and "torch" for a CPU graph.

"dense" and "ell_spmd" are not ported yet and raise NotImplementedError
(see ROADMAP.md).  `core.kcore` and `core.kcore_dynamic` reach the
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

Neither loop ever runs past `max_steps`.  One more host read per fixpoint
is `degree_bound`'s max degree.  Capturing the loop in a CUDA graph, to
drop the per-chunk syncs and the launch overhead, is later work.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from . import ref
from .ell_frontier import frontier_step_ell
from .ell_hindex import hindex_ell

BACKENDS = ("torch", "ell")
NOT_PORTED = ("dense", "ell_spmd")

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
