"""Streaming update ingestion: route windows to owner blocks, escalate
cross-block work to the coordinator (one device).

BLADYG's dynamic side is a *stream* of edge updates arriving at the
coordinator.  Per window of up to R updates:

  1. the window is validated at the host boundary against the *current*
     graph (streams may be generators, so there is no whole-stream pass);
  2. one batched Theorem-1 candidate search (on the frontier kernel's R
     axis) determines each update's candidate set;
  3. updates that are **block-local** — both endpoints in one block and
     the candidate set confined to it — and independent of everything
     earlier in the window are applied together, with ONE joint clamped
     recompute (the paper's workerCompute-only fast path);
  4. everything else escalates to the coordinator path (exact sequential
     maintenance, original stream order): cross-block endpoints,
     candidate sets that spill over the block boundary, and conflicts
     with earlier in-window updates.

An update is only hoisted into the block-local batch if its candidate set
is disjoint from every *earlier* window column, so the final coreness
equals processing the stream one update at a time.  The routing verdict
is computed on the device (`_route_window`); only compact (R,)/(P,)
results cross to the host, in one transfer per window.

With `cc_labels=` the session also keeps connected-component labels
exact, window by window, on the post-window graph: a window with a delete
recomputes them (`connected_components`), an insert-only window merges
them (`merge_labels`, inserts only join components).

`StreamSession` is the resumable stepper (open -> `apply_window` ->
`result`); `run_stream` drains an iterable through one.  Both return a
`StreamResult`, a NamedTuple as in the reference: read its named fields;
unpacking it yields the reference's legacy arity behind its
DeprecationWarning.  Not ported yet:
the mesh executor, live rebalancing, capacity growth, checkpoints, and
`MirrorStream` (see ROADMAP.md).
"""
from __future__ import annotations

import warnings
from itertools import islice
from typing import (
    Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple,
)

import numpy as np
import torch

from ..core import kcore_dynamic as kd
from ..core.algorithms import connected_components, merge_labels
from ..core.graph import GraphBlocks
from ..core.updates import validate_updates


class StreamStats(NamedTuple):
    """Routing + superstep accounting for one `run_stream` pass."""

    updates: int                 # total updates ingested
    batches: int                 # windows taken off the stream
    block_local: int             # applied on the block-local batched path
    escalated_cross_block: int   # endpoints in two blocks -> coordinator
    escalated_spill: int         # candidates left the owner block
    escalated_conflict: int      # overlapped an earlier window column
    bfs_steps: int               # frontier supersteps (all paths)
    recompute_steps: int         # clamped min-H supersteps (all paths)
    per_block: Tuple[int, ...]   # block-local updates applied per block
    cc_merges: int = 0           # CC labels maintained by O(1) label merges
    cc_recomputes: int = 0       # CC label recomputations (delete windows)

    @property
    def escalated(self) -> int:
        return (self.escalated_cross_block + self.escalated_spill
                + self.escalated_conflict)


class StreamResult(NamedTuple):
    """`run_stream` / `StreamSession.result` return value, the reference's
    tuple.

    `labels` is None unless CC maintenance was armed (`cc_labels=`).
    Tuple-unpacking yields the legacy arity (3 fields, or 4 when labels
    were kept) with a DeprecationWarning, as in the reference; indexing
    and `len()` see all 4 fields.  Read the named fields.
    """

    g: GraphBlocks               # post-stream graph
    core: torch.Tensor           # (N,) int32 maintained coreness
    stats: StreamStats
    labels: Optional[torch.Tensor] = None  # (N,) int32 CC labels, if kept

    def __iter__(self):
        warnings.warn(
            "tuple-unpacking run_stream's result is deprecated; read "
            ".g/.core/.stats/.labels on the returned StreamResult",
            DeprecationWarning, stacklevel=2)
        legacy = (self.g, self.core, self.stats)
        if self.labels is not None:
            legacy += (self.labels,)
        return iter(legacy)


def owner_block(g, u: int) -> int:
    """Owning block of a global padded node id (host-side routing key):
    block-contiguous relabeling makes ownership pure arithmetic."""
    return int(u) // g.Cn


def route_updates(
    g, updates: Iterable[Tuple[int, int, int]]
) -> Tuple[Dict[int, List[Tuple[int, int, int]]], List[Tuple[int, int, int]]]:
    """Host-side router: split a batch into per-owner-block queues plus the
    cross-block remainder the coordinator must handle itself.

    Returns ({block: [updates]}, cross_block_updates).
    """
    per_block: Dict[int, List[Tuple[int, int, int]]] = {}
    cross: List[Tuple[int, int, int]] = []
    for u, v, op in updates:
        bu, bv = owner_block(g, u), owner_block(g, v)
        if bu == bv:
            per_block.setdefault(bu, []).append((u, v, op))
        else:
            cross.append((u, v, op))
    return per_block, cross


class RouteMasks(NamedTuple):
    """Device-side routing verdict for one update window.

    accept/cross/spill/conflict partition the valid columns by escalation
    precedence (cross-block wins over spill wins over conflict).
    """

    accept: torch.Tensor     # (R,) bool — block-local, no spill, no conflict
    cross: torch.Tensor      # (R,) bool — endpoints in two blocks
    spill: torch.Tensor      # (R,) bool — intra-block, candidates left block
    conflict: torch.Tensor   # (R,) bool — intra-block, no spill, overlapped
                             #             an earlier window column
    cand_ins: torch.Tensor   # (N,) bool — union candidates of accepted inserts
    cand_del: torch.Tensor   # (N,) bool — union candidates of accepted deletes
    per_block: torch.Tensor  # (P,) int32 — accepted updates per owner block


def _route_window(cand: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
                  ops_: torch.Tensor, valid: torch.Tensor,
                  Cn: int) -> RouteMasks:
    """Device-side window routing: the candidate-overlap product, the spill
    test and the accept/escalate rule, where the (N, R) candidate matrix
    already lives.

    A column conflicts iff its candidate set overlaps ANY earlier valid
    column (accepted or escalated).  The overlap is a float32 product of
    0/1 matrices (CUDA has no integer matmul): each entry is a sum of
    non-negative terms, so ``> 0`` is exact at any N.
    """
    N, R = cand.shape
    owner = torch.div(us, Cn, rounding_mode="floor")   # (R,) owning blocks
    intra = owner == torch.div(vs, Cn, rounding_mode="floor")
    block_of = torch.arange(N, device=cand.device) // Cn
    candv = cand & valid[None, :]
    spill = (candv & (block_of[:, None] != owner[None, :])).any(dim=0)
    cf = candv.to(torch.float32)
    overlap = cf.T @ cf
    earlier = torch.ones((R, R), dtype=torch.bool,
                         device=cand.device).tril(-1)  # strictly lower
    conflict = ((overlap > 0) & earlier).any(dim=1)
    accept = valid & intra & ~spill & ~conflict
    cross = valid & ~intra
    esc_spill = valid & intra & spill
    esc_conflict = valid & intra & ~spill & conflict
    cand_ins = (candv & (accept & (ops_ > 0))[None, :]).any(dim=1)
    cand_del = (candv & (accept & (ops_ < 0))[None, :]).any(dim=1)
    # owners repeat across columns: accumulate, never assign
    per_block = torch.zeros(N // Cn, dtype=torch.int32, device=cand.device)
    per_block.index_add_(0, owner, accept.to(torch.int32))
    return RouteMasks(accept, cross, esc_spill, esc_conflict,
                      cand_ins, cand_del, per_block)


def _iter_windows(updates, R: int) -> Iterator[list]:
    it = iter(updates)
    while True:
        window = list(islice(it, R))
        if not window:
            return
        yield window


class StreamSession:
    """Resumable stream stepper: open -> `apply_window` -> `result`.

    Holds the current graph, the maintained coreness and the routing /
    superstep counters, so a caller can interleave other device work
    between windows.  `apply_window` takes a list of at most `R` updates
    `(u, v, op)` with global padded ids; windows narrower than R are
    padded to the fixed width.

    `cc_labels` (optional) arms CC maintenance: the canonical labels of
    the graph at open, as `core.algorithms.connected_components` returns
    them; `.labels` then stays equal to a recompute after every window.

    The graph passed at open is updated IN PLACE; read `.g` back.
    """

    def __init__(self, g: GraphBlocks, core: torch.Tensor, R: int = 8,
                 backend: str = "auto",
                 cc_labels: Optional[torch.Tensor] = None):
        if R < 1:
            raise ValueError(f"R must be >= 1, got {R}")
        self.R = int(R)
        self.backend = backend
        self.g = g
        self.core = torch.as_tensor(core, device=g.device)
        self._tot = dict(bfs=0, rec=0, cand=0, batched=0, seq=0, batches=0)
        self._n_updates = 0
        self._n_local = 0
        self._esc_cross = self._esc_spill = self._esc_conflict = 0
        self._per_block = np.zeros(g.P, np.int64)
        self.labels = (None if cc_labels is None
                       else torch.as_tensor(cc_labels, device=g.device))
        self._cc_merges = self._cc_recomputes = 0

    @property
    def windows_applied(self) -> int:
        """Windows ingested so far."""
        return self._tot["batches"]

    def apply_window(self, window: List[Tuple[int, int, int]]) -> None:
        """Ingest ONE window of at most R updates (see class docstring)."""
        if len(window) > self.R:
            raise ValueError(
                f"window of {len(window)} updates exceeds R={self.R}")
        if not window:
            return
        window = [(int(u), int(v), int(op)) for u, v, op in window]
        validate_updates(self.g, window)
        g, core, tot, backend = self.g, self.core, self._tot, self.backend
        tot["batches"] += 1
        R, n = self.R, len(window)
        self._n_updates += n
        us = np.zeros(R, np.int64)
        vs = np.zeros(R, np.int64)
        ops_ = np.zeros(R, np.int64)
        us[:n] = [u for u, _, _ in window]
        vs[:n] = [v for _, v, _ in window]
        ops_[:n] = [op for _, _, op in window]
        valid = np.zeros(R, bool)
        valid[:n] = True

        dev = g.device
        us_d, vs_d, ops_d, valid_d = (torch.as_tensor(a, device=dev)
                                      for a in (us, vs, ops_, valid))
        cand, steps = kd._batch_candidates(g, core, us_d, vs_d, valid_d,
                                           backend=backend)
        route = _route_window(cand, us_d, vs_d, ops_d, valid_d, Cn=g.Cn)
        # ONE transfer per window pulls the compact verdict
        verdict = torch.cat([
            torch.stack([route.accept, route.cross, route.spill,
                         route.conflict]).to(torch.int32).reshape(-1),
            route.per_block]).cpu().numpy()
        accept, cross, spl, conf = (verdict[:4 * R].reshape(4, R)
                                    .astype(bool))
        nblk = verdict[4 * R:]
        tot["bfs"] += steps
        self._esc_cross += int(cross.sum())
        self._esc_spill += int(spl.sum())
        self._esc_conflict += int(conf.sum())

        if accept.any():
            # accepted updates keep their window order
            acc = np.flatnonzero(accept)
            g, core, rec = kd._apply_and_recompute(
                g, core, us[acc], vs[acc], ops_[acc], route.cand_ins,
                route.cand_del, backend=backend)
            tot["rec"] += rec
            self._n_local += len(acc)
            self._per_block += nblk.astype(np.int64)

        # coordinator path, original stream order within the window
        for r in np.flatnonzero(cross | spl | conf):
            g, core = kd._maintain_one(g, core, window[r], tot, backend)

        # CC labels on the post-window graph: inserts only ever JOIN
        # components, so an insert-only window is an on-device label merge;
        # a delete may split one, so such a window re-propagates
        if self.labels is not None:
            ins = valid & (ops_ > 0)
            if (valid & (ops_ < 0)).any():
                self.labels = connected_components(g, backend=backend)
                self._cc_recomputes += 1
            elif ins.any():
                self.labels = merge_labels(
                    self.labels, us_d, vs_d, torch.as_tensor(ins, device=dev))
                self._cc_merges += int(ins.sum())
        self.g, self.core = g, core

    def stats(self) -> StreamStats:
        """Routing/superstep accounting over every window applied so far."""
        return StreamStats(
            updates=self._n_updates,
            batches=self._tot["batches"],
            block_local=self._n_local,
            escalated_cross_block=self._esc_cross,
            escalated_spill=self._esc_spill,
            escalated_conflict=self._esc_conflict,
            bfs_steps=self._tot["bfs"],
            recompute_steps=self._tot["rec"],
            per_block=tuple(int(x) for x in self._per_block),
            cc_merges=self._cc_merges,
            cc_recomputes=self._cc_recomputes,
        )

    def result(self) -> StreamResult:
        """The session's state as a `StreamResult` snapshot (the session
        stays usable; `close` is the self-documenting alias)."""
        return StreamResult(g=self.g, core=self.core, stats=self.stats(),
                            labels=self.labels)

    close = result


def run_stream(
    g: GraphBlocks,
    core: torch.Tensor,
    updates: Iterable[Tuple[int, int, int]],
    R: int = 8,
    backend: str = "auto",
    cc_labels: Optional[torch.Tensor] = None,
) -> StreamResult:
    """Ingest an update stream; returns a `StreamResult` (g, core, stats,
    labels).

    g: GraphBlocks (P blocks of Cn rows, nbr (N, Cd)); core: (N,) int32
    coreness of `g` (as `core.kcore.coreness` returns it).  `updates` may
    be any iterable (including a generator) of (u, v, op) with op = +1
    insert / -1 delete and global padded ids.  R is the window width (the
    stacked-frontier axis of the batched candidate search).  `backend` is
    any of `kernels.ops.BACKENDS` or "auto" (the default); "dense" builds
    its (N, N) bfloat16 adjacency once per candidate search and once per
    recompute, and keeps CC labels with the dense combines.  The final
    coreness equals sequential per-update maintenance.  `g` is updated in
    place; use the returned graph.

    `cc_labels` (optional): the canonical CC labels of the pre-stream
    graph (as `core.algorithms.connected_components` returns them).  The
    stream then keeps them exact in `result.labels`, bit-identical to
    `connected_components` of the final graph; `StreamStats.cc_merges` /
    `cc_recomputes` count the merge and recompute paths.  Without it,
    `result.labels` is None.
    """
    session = StreamSession(g, core, R=R, backend=backend,
                            cc_labels=cc_labels)
    for window in _iter_windows(updates, R):
        session.apply_window(window)
    return session.result()
