"""Distributed k-core decomposition — BLADYG application #1 (paper §4.1).

Algorithm: the locality-based distributed coreness computation of
[Montresor, De Pellegrini, Miorandi, TPDS'13], expressed as BLADYG
supersteps.  Each node keeps a coreness *estimate*; one superstep applies

    est' = min(est, H(est))        H(est)(u) = h-index of {est(v) : v ~ u}

est starts at the degree, H is monotone and H(core) = core, so the
pointwise non-increasing sequence converges, and its fixpoint is exactly
the coreness.  The same argument is *local*: clamping any set of nodes at
their true coreness and iterating only on the rest still converges to the
true coreness of the rest — that is what makes the incremental
maintenance in `kcore_dynamic.py` exact.

The H(est) primitive comes only through the kernel backend registry
(`repro_torch.kernels.ops`): ``backend="torch"|"ell"|"dense"|"auto"``, all
exact and bit-identical, "auto" (the default) picking the ELL CUDA
kernels on a CUDA graph ("dense", over an (N, N) bfloat16 adjacency, only
when asked for); see `ops` for the sync policy of the fixpoint loop.

`CorenessProgram` runs the same superstep through `BladygEngine` with the
halo payload declared, so the engine's per-mode message metering gives
the paper's inter- vs intra-partition accounting.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import ops
from ..kernels.ell_hindex import (  # noqa: F401 (hindex_rows: re-export)
    ell_gather, hindex_rows)
from .engine import BladygEngine, BladygProgram, Mode
from .graph import GraphBlocks, halo_slot_counts


def neighbor_estimates(g: GraphBlocks, est: torch.Tensor) -> torch.Tensor:
    """Gather est over the ELL adjacency, (N, Cd); PAD slots -> -1
    (ignored by hindex)."""
    return ell_gather(g.nbr, est)


def coreness_step(
    g: GraphBlocks, est: torch.Tensor, active: torch.Tensor,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One BLADYG superstep on an `active` node mask; returns (est', changed)
    with `changed` a 0-dim bool tensor on the graph's device."""
    h = ops.hindex_blocks(g, est, backend=backend)
    new = torch.where(active & g.node_mask, torch.minimum(est, h), est)
    return new, (new != est).any()


def coreness(
    g: GraphBlocks, max_steps: int = 10_000, backend: str = "auto",
    executor=None, mirror=None,
) -> torch.Tensor:
    """Coreness of every node (0 on padding rows), (N,) int32, via the
    chosen backend.  All backends return identical integers.  On the mesh
    backend ("ell_spmd") pass a long-lived `runtime.spmd.SpmdExecutor` as
    `executor` to skip the per-call halo plan build.

    `mirror` (a `core.hub_split.MirrorPlan` for a split `g`) runs the
    generic `CorenessBlockProgram` under the vertex-cut dataflow: per-slice
    h-index partials merge through count histograms, so every row of a
    replica group carries the hub's coreness, equal at primaries to the
    unsplit run."""
    if mirror is not None:
        from .algorithms import CorenessBlockProgram

        est = ops.run_block_program(g, CorenessBlockProgram(),
                                    backend=backend, max_steps=max_steps,
                                    executor=executor, mirror=mirror)
        return torch.where(g.node_mask, est, 0)
    return ops.coreness_blocks(g, backend=backend, max_steps=max_steps,
                               executor=executor)


def coreness_with_stats(
    g: GraphBlocks, max_steps: int = 10_000, backend: str = "auto",
) -> Tuple[torch.Tensor, int]:
    """Coreness plus the superstep count (a host int)."""
    return ops.coreness_blocks(g, backend=backend, max_steps=max_steps,
                               with_steps=True)


def max_coreness(g: GraphBlocks) -> int:
    return int(coreness(g).max())


class CorenessProgram(BladygProgram):
    """min-H coreness as an engine program (paper §4.1 step 1).

    Worker state is the estimate vector; each superstep gathers the neighbor
    halo (W2W — one estimate per valid neighbor slot, intra or inter by the
    slot's block), applies min-H, and reports the changed flag (W2M).  The
    master broadcasts continue/halt (M2W).
    """

    modes = Mode.LOCAL | Mode.M2W | Mode.W2M | Mode.W2W

    def __init__(self, backend: str = "auto"):
        self.backend = backend

    def worker_compute(self, g: GraphBlocks, est, directive):
        return coreness_step(g, est, g.node_mask, backend=self.backend)

    def master_compute(self, mstate, summary):
        return mstate, None, torch.logical_not(summary)

    def w2w_payload(self, g: GraphBlocks) -> Tuple[int, int]:
        # one estimate flows across every valid neighbor slot per superstep
        return halo_slot_counts(g)


def coreness_via_engine(g: GraphBlocks, backend: str = "auto"):
    """Run CorenessProgram through BladygEngine; returns (core, engine).

    The engine's traces carry the metered message counts per superstep.
    """
    est0 = torch.where(g.node_mask, g.deg, 0).to(torch.int32)
    eng = BladygEngine(g)
    est, _ = eng.run(CorenessProgram(backend=backend), est0, None)
    return torch.where(g.node_mask, est, 0), eng


def coreness_via_spmd(g: GraphBlocks, W=None):
    """CorenessProgram routed through the mesh runtime.

    Runs the same min-H supersteps under `runtime.SpmdEngine.run_spmd`
    (`SpmdCorenessProgram`): the neighbor read is an executed halo
    exchange on the worker mesh of `W` workers, and the returned engine's
    traces carry the *executed* W2W counts (`HaloPlan.slot_counts`)
    instead of the declared payload.  Returns (core, SpmdEngine); core
    equals `coreness_via_engine`'s.
    """
    from ..runtime.spmd import (  # lazy: runtime imports core
        SpmdCorenessProgram, SpmdEngine)

    est0 = torch.where(g.node_mask, g.deg, 0).to(torch.int32)
    eng = SpmdEngine(g, W=W)
    est, _ = eng.run_spmd(SpmdCorenessProgram(), est0, None)
    return torch.where(g.node_mask, est, 0), eng
