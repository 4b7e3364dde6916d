"""BLADYG computational model: master/worker supersteps + messaging modes.

The paper's abstractions on one device:

  workerCompute()  — a function of the block-partitioned tensors (all
                     blocks advance together).
  masterCompute()  — a function of per-block summaries; its result is the
                     directive broadcast to all workers.
  M2W / W2M        — the broadcast of the master directive / the gather of
                     per-block summaries around each superstep.
  W2W              — the neighbor-state exchange inside workerCompute
                     (gathers across the block boundary).
  Local            — block-local compute.

Two program notions live here:

  `BladygProgram`  — the free-form worker/master contract (any state
                     tuple).  Coreness uses it for the paper's message-
                     accounting runs (`core.kcore.coreness_via_engine`).
  `BlockProgram`   — the *structured* superstep contract every workload in
                     `core.algorithms` is written against: init state →
                     per-node halo field → named neighbor combine →
                     block-local update → halt reduction.  One runner,
                     `kernels.ops.run_block_program`, executes any of them
                     on any backend.

The engine meters messages per mode; the W2W numbers are *declared* by
the program (`w2w_payload`), as in the JAX package.  Program states are
tensors or tuples of tensors, where the JAX package takes any pytree.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from ..kernels.ops import (  # noqa: F401  (BlockCtx: re-export, contract)
    MULTI_COMBINES, SYNC_EVERY, BlockCtx, live_loop,
)
from .graph import GraphBlocks


class Mode(enum.Flag):
    LOCAL = enum.auto()
    M2W = enum.auto()
    W2M = enum.auto()
    W2W = enum.auto()


class MessageStats(NamedTuple):
    m2w: int = 0
    w2m: int = 0
    w2w_intra: int = 0
    w2w_inter: int = 0

    def __add__(self, o):  # type: ignore[override]
        return MessageStats(*(a + b for a, b in zip(self, o)))


@dataclasses.dataclass
class SuperstepTrace:
    step: int
    mode: Mode
    stats: MessageStats
    #: collective phases the step's compute waited on (0 on one device;
    #: on the mesh 1 when the executor waits on its all-to-all before
    #: staging the field, `SpmdExecutor(overlap=False)`)
    serialized_collectives: int = 0


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested tuple/list state (None has none)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    """`fn` over every tensor leaf of a nested tuple/list (None stays)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def _any_changed(old: Any, new: Any) -> torch.Tensor:
    """Device bool scalar: does any tensor leaf differ bit-wise?"""
    flags = [(a != b).any() for a, b in zip(tree_leaves(old),
                                            tree_leaves(new))]
    if not flags:
        return torch.tensor(False)
    return torch.stack(flags).any()


class BladygProgram:
    """Base class for user programs (paper's workerCompute/masterCompute)."""

    #: modes this program is allowed to activate
    modes: Mode = Mode.LOCAL | Mode.M2W | Mode.W2M | Mode.W2W

    def w2w_payload(self, g: GraphBlocks) -> Tuple[int, int]:
        """(intra, inter) W2W halo element counts moved per superstep.

        Programs *declare* their halo payload — e.g. via
        `graph.halo_slot_counts` for a one-value-per-neighbor-slot
        exchange.  Default: no W2W traffic.
        """
        return (0, 0)

    def worker_compute(
        self, g: GraphBlocks, wstate: Any, directive: Any
    ) -> Tuple[Any, Any]:
        """(graph, worker state, master directive) -> (worker state', summary).

        `summary` is the W2M payload: tensors with a leading P axis (one row
        per block) or global reductions.
        """
        raise NotImplementedError

    def master_compute(
        self, mstate: Any, summary: Any
    ) -> Tuple[Any, Any, torch.Tensor]:
        """(master state, summaries) -> (master state', directive, halt)."""
        raise NotImplementedError


class BlockProgram:
    """The structured BLADYG superstep contract.

    One superstep is four declared phases, which is what lets one runner
    (`kernels.ops.run_block_program`) execute any program on any backend:

      1. **init state**     — `init(g)`: the whole-graph state, a tensor or
         tuple of tensors, each with the padded node count N leading.
      2. **halo exchange**  — `halo_field(state)`: the per-node values
         neighbors read this superstep; `halo_fill` is what PAD slots read
         as.
      3. **kernel step**    — `combine` names the neighbor reduction
         (`kernels.ops.COMBINES`); `update(ctx, state, red)` is then
         block-local, elementwise math on the reduced values.
      4. **halt reduction** — `changed(old, new)`: a device bool scalar;
         the runner stops after the first superstep that changes nothing,
         or after `max_steps`.  Fixed-iteration programs return True.

    Equality and hash derive from `(type, _key())`, as in the JAX package
    (there programs are static jit arguments): include every
    behavior-changing constructor parameter in `_key()`.
    """

    #: neighbor combine name, resolved per backend by `kernels.ops`
    combine: str = "min"
    #: value PAD slots read as; absorbing for `combine`
    halo_fill: Any = -1
    #: superstep bound
    max_steps: int = 10_000

    def _key(self) -> Tuple:
        """Static identity: every parameter that changes behavior."""
        return ()

    def __hash__(self):
        return hash((type(self), self._key()))

    def __eq__(self, other):
        return type(other) is type(self) and other._key() == self._key()

    def init(self, g: GraphBlocks) -> Any:
        """Whole-graph initial state (every tensor leaf N-leading)."""
        raise NotImplementedError

    def halo_field(self, state: Any) -> torch.Tensor:
        """The (N, ...) per-node tensor whose values neighbors read (W2W)."""
        raise NotImplementedError

    def update(self, ctx: BlockCtx, state: Any, red: torch.Tensor) -> Any:
        """One block-local step: (ctx, state, reduced neighbor values) ->
        state'.  Elementwise over the node axis."""
        raise NotImplementedError

    def mirror_state(self, state: Any, primary_row: torch.Tensor) -> Any:
        """Replicate per-vertex state onto hub mirror rows (vertex cut).

        Under a hub-split graph (`core.hub_split`) every mirror row must
        carry its primary's state, so neighbors reading a replica see the
        logical value and replicas advance in lockstep through `update`.
        The default gathers every tensor leaf through `primary_row`,
        right whenever all leaves are per-VERTEX (N-leading) values;
        programs with per-ROW state (triangle counting's neighbor rows)
        override it.  Must be idempotent: the runner applies it to
        caller warm starts too.
        """
        prow = primary_row.long()
        return tree_map(lambda a: a[prow], state)

    def changed(self, old: Any, new: Any) -> torch.Tensor:
        """Local convergence verdict (device bool scalar).  Default: any
        tensor leaf differs bit-wise."""
        return _any_changed(old, new)


class MultiProgram(BlockProgram):
    """Several BlockPrograms advancing in lockstep off ONE neighbor gather.

    State, halo field and fill are tuples (one entry per sub-program); the
    combine is the sentinel ``"multi"`` with the per-field names in
    `combines`, which the runner serves from one read of the adjacency
    (`kernels.ell_multi`).  Each fused reduce equals its standalone
    formulation exactly, so per-field results are bit-identical to running
    the sub-programs alone for the same superstep count.  Sub-program
    combines must come from `kernels.ops.MULTI_COMBINES`.  The fused loop
    runs until EVERY sub-program is quiet or `max_steps` supersteps ran.
    """

    combine = "multi"

    def __init__(self, programs: Tuple[BlockProgram, ...],
                 max_steps: int = 10_000):
        programs = tuple(programs)
        if not programs:
            raise ValueError("MultiProgram needs at least one sub-program")
        for p in programs:
            if p.combine not in MULTI_COMBINES:
                raise ValueError(
                    f"sub-program combine {p.combine!r} not fusable; "
                    f"expected one of {MULTI_COMBINES}")
        self.programs = programs
        self.combines: Tuple[str, ...] = tuple(p.combine for p in programs)
        self.halo_fill = tuple(p.halo_fill for p in programs)
        self.max_steps = int(max_steps)

    def _key(self):
        return (self.programs, self.max_steps)

    def init(self, g: GraphBlocks) -> Tuple[Any, ...]:
        return tuple(p.init(g) for p in self.programs)

    def halo_field(self, state: Tuple[Any, ...]) -> Tuple[torch.Tensor, ...]:
        return tuple(p.halo_field(s) for p, s in zip(self.programs, state))

    def update(self, ctx: BlockCtx, state: Tuple[Any, ...],
               red: Tuple[torch.Tensor, ...]) -> Tuple[Any, ...]:
        return tuple(p.update(ctx, s, r)
                     for p, s, r in zip(self.programs, state, red))

    def changed(self, old: Tuple[Any, ...],
                new: Tuple[Any, ...]) -> torch.Tensor:
        return torch.stack([p.changed(o, n) for p, o, n in
                            zip(self.programs, old, new)]).any()

    def mirror_state(self, state: Tuple[Any, ...],
                     primary_row: torch.Tensor) -> Tuple[Any, ...]:
        return tuple(p.mirror_state(s, primary_row)
                     for p, s in zip(self.programs, state))


class BladygEngine:
    """Superstep scheduler over a block-partitioned graph."""

    def __init__(self, g: GraphBlocks):
        self.g = g
        self.traces: List[SuperstepTrace] = []

    def run(
        self,
        program: BladygProgram,
        wstate: Any,
        mstate: Any,
        directive: Any = None,
        max_supersteps: int = 10_000,
        w2w_override: Optional[Tuple[int, int]] = None,
    ) -> Tuple[Any, Any]:
        """Host-driven loop: one superstep, one trace and one host read of
        the halt flag at a time."""
        g = self.g
        w2w = w2w_override if w2w_override is not None \
            else program.w2w_payload(g)
        step = 0
        while step < max_supersteps:
            wstate, summary = program.worker_compute(g, wstate, directive)
            mstate, directive, halt = program.master_compute(mstate, summary)
            self.traces.append(SuperstepTrace(
                step, program.modes, self._meter(summary, directive, w2w)))
            step += 1
            if bool(halt):
                break
        return wstate, mstate

    def run_jit(
        self,
        program: BladygProgram,
        wstate: Any,
        mstate: Any,
        directive: Any,
        max_supersteps: int = 10_000,
        w2w_override: Optional[Tuple[int, int]] = None,
    ) -> Tuple[Any, Any]:
        """The same loop with one host read per `SYNC_EVERY` supersteps.

        A device ``live`` flag gates each superstep's results
        (`kernels.ops.live_loop`, the loop `run_block_program` runs too), so
        the states and the superstep count equal the JAX package's fused
        ``while_loop``.  Per-superstep
        message sizes are fixed by the shapes, so the traces are
        reconstructed after the loop from the first superstep's summary,
        the directive passed in and the declared W2W payload.
        """
        g = self.g
        w2w = w2w_override if w2w_override is not None \
            else program.w2w_payload(g)
        stats = []

        def step(s):
            wstate, mstate, directive = s
            w2, summary = program.worker_compute(g, wstate, directive)
            m2, d2, halt = program.master_compute(mstate, summary)
            if not stats:
                stats.append(self._meter(summary, directive, w2w))
            return (w2, m2, d2), ~halt

        (wstate, mstate, _), n = live_loop(
            step, (wstate, mstate, directive), max_supersteps, g.device)
        self.traces.extend(SuperstepTrace(i, program.modes, stats[0])
                           for i in range(n))
        return wstate, mstate

    @staticmethod
    def _meter(summary: Any, directive: Any,
               w2w: Tuple[int, int] = (0, 0)) -> MessageStats:
        def count(tree):
            return sum(leaf.numel() if isinstance(leaf, torch.Tensor)
                       else int(getattr(leaf, "size", 1))
                       for leaf in tree_leaves(tree))

        return MessageStats(m2w=count(directive), w2m=count(summary),
                            w2w_intra=int(w2w[0]), w2w_inter=int(w2w[1]))

    def message_totals(self) -> MessageStats:
        tot = MessageStats()
        for t in self.traces:
            tot = tot + t.stats
        return tot
