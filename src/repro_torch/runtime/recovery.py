"""Coordinator-style crash recovery: window log, worker loss, replay.

BLADYG's coordinator treats worker join/leave as first-class protocol
(Aridhi et al. §4): when a worker disappears, its blocks are re-assigned
across the survivors and processing resumes.  This module is that
protocol over the elastic stream (`runtime.stream.StreamSession`) and
its checkpoints (`checkpoint`), on one device or on the worker mesh:

  * `WindowLog` — the coordinator's record of every mutation it fed the
    session since open (edit windows and vertex arrivals, in order).
    Entries hold OPEN-TIME ids — exactly what the caller handed in — so
    replay after a restore goes through the same `StreamSession` id
    resolution as the original run.
  * `ElasticCoordinator` — wraps a `StreamSession` + `CheckpointManager`:
    feeds windows (applied to the session first, logged on success, so a
    rejected window never pollutes the log), cuts snapshots that embed
    the log cursor, and performs `recover_worker`.
  * `recover_worker` — the failure drill: restore the last COMMITTED
    snapshot, evacuate the dead worker's blocks across the survivors with
    the §4.2 `migrate_vertices` permutation (growing Cn first when the
    survivors lack free rows), then replay the log tail.  Replay is
    deterministic and the snapshot carries the composed id remap, so the
    recovered session holds the logical state of one that never crashed.

`kill_session` makes the dead session unusable, so a caller that keeps
serving from pre-loss state fails loudly: recovery must come from the
snapshot, never the corpse.  The JAX package deletes the device buffers
(`jax.Array.delete`); torch tensors have no such call, and freeing a
tensor's storage in place makes a later read crash the process instead
of raising.  So the port replaces the session's graph, coreness and
labels with `KilledState` sentinels: every attribute read through one,
every tensor operation on one and every conversion of one raises
RuntimeError, and the last references to the tensors go, so the
device's memory is freed.

On the mesh (``backend="ell_spmd"``) the restore may target another
worker count (`recover_worker(W=)`, W | P; every rank restores the same
snapshot), and the coordinator reads the old fold `W_old` from the live
session's executor, as the JAX package does.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import CapacityError
from .halo import _pow2_ceil


class WindowLog:
    """Ordered record of the mutations fed to a session since open.

    Two entry kinds: ``("window", [(u, v, op), ...])`` and
    ``("vertices", block, count)``.  The coordinator's snapshots embed
    the entry count at save time (the *cursor*); recovery replays
    ``entries[cursor:]``.  Entries are plain python values (JSON-able),
    so a production log could be a durable queue — here it lives in
    memory, which is exactly the simulated-loss model: the coordinator
    survives, the workers' device state does not.
    """

    def __init__(self):
        self.entries: List[tuple] = []

    def __len__(self) -> int:
        return len(self.entries)

    def append_window(self, window) -> None:
        self.entries.append(
            ("window", [(int(u), int(v), int(op)) for u, v, op in window]))

    def append_vertices(self, block: int, count: int) -> None:
        self.entries.append(("vertices", int(block), int(count)))

    def replay(self, session, cursor: int = 0) -> int:
        """Re-apply ``entries[cursor:]`` to `session` in order.  Returns
        the number of entries replayed."""
        tail = self.entries[cursor:]
        for entry in tail:
            if entry[0] == "window":
                session.apply_window(entry[1])
            elif entry[0] == "vertices":
                session.add_vertices(entry[1], entry[2])
            else:
                raise ValueError(f"unknown log entry kind {entry[0]!r}")
        return len(tail)


def blocks_of_worker(w: int, P: int, W: int) -> List[int]:
    """Blocks owned by worker `w` under the W-worker fold of P blocks
    (`runtime.mesh`: B = P // W consecutive blocks per worker)."""
    if W < 1 or P % W:
        raise ValueError(f"W={W} must divide P={P}")
    if not 0 <= w < W:
        raise ValueError(f"worker {w} outside [0, {W})")
    B = P // W
    return list(range(w * B, (w + 1) * B))


def plan_evacuation(g, dead_blocks: Sequence[int]
                    ) -> List[Tuple[int, int]]:
    """Moves re-assigning every real node of `dead_blocks` across the
    survivors, most-free-block-first (balanced, deterministic; ties go to
    the lower block id).  Raises `CapacityError` when the survivors lack
    free rows in total — the caller's cue to grow Cn first.  One host
    read of the node mask."""
    mask = g.node_mask.cpu().numpy()
    dead = set(int(b) for b in dead_blocks)
    if not dead:
        return []
    if not all(0 <= b < g.P for b in dead):
        raise ValueError(f"dead blocks {sorted(dead)} outside [0, {g.P})")
    survivors = [b for b in range(g.P) if b not in dead]
    if not survivors:
        raise ValueError("cannot evacuate every block at once")
    # max-heap of free rows per survivor; ties broken by block id
    heap = [(-int(g.Cn - mask[b * g.Cn:(b + 1) * g.Cn].sum()), b)
            for b in survivors]
    heapq.heapify(heap)
    moves: List[Tuple[int, int]] = []
    for b in sorted(dead):
        for u in np.flatnonzero(mask[b * g.Cn:(b + 1) * g.Cn]) + b * g.Cn:
            negfree, dest = heapq.heappop(heap)
            if negfree == 0:
                raise CapacityError(
                    f"survivors out of free node rows after {len(moves)} "
                    f"moves (Cn={g.Cn}); grow Cn and retry")
            moves.append((int(u), dest))
            heapq.heappush(heap, (negfree + 1, dest))
    return moves


def evacuate_blocks(session, dead_blocks: Sequence[int]) -> int:
    """Move every real node out of `dead_blocks` onto the survivors via
    `StreamSession.migrate`, growing Cn (pad-and-rekey) until the
    survivors can take them.  Returns the number of vertices moved."""
    while True:
        try:
            moves = plan_evacuation(session.g, dead_blocks)
            break
        except CapacityError:
            session.grow(Cn=_pow2_ceil(session.g.Cn + 1))
    if moves:
        session.migrate(moves)
    return len(moves)


def _killed(*_args, **_kwargs):
    raise RuntimeError("read of a session killed by kill_session: recover "
                       "from the snapshot (recover_worker), not the corpse")


class KilledState:
    """What a killed session holds in place of its graph and tensors.

    Every attribute read, tensor operation (``__torch_function__``),
    conversion (numpy, int, bool, len, iteration, indexing) and
    arithmetic on it raises RuntimeError."""

    def __init__(self, what: str):
        object.__setattr__(self, "_what", what)

    def __repr__(self) -> str:
        return f"<{self._what} killed by kill_session>"

    def __getattr__(self, name):
        _killed()

    def __setattr__(self, name, value):
        _killed()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        _killed()


for _name in ("__array__", "__len__", "__iter__", "__getitem__",
              "__setitem__", "__bool__", "__int__", "__float__", "__index__",
              "__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__eq__", "__ne__", "__lt__", "__le__", "__gt__",
              "__ge__", "__and__", "__or__", "__invert__", "__neg__"):
    setattr(KilledState, _name, _killed)
KilledState.__hash__ = None


def kill_session(session) -> None:
    """Simulate the worker loss on the LIVE session: replace its graph,
    coreness and labels with `KilledState` sentinels (see the module
    docstring).  Anything that keeps reading the dead session afterwards
    raises RuntimeError — recovery must serve from the snapshot."""
    session.g = KilledState("graph")
    session.core = KilledState("coreness")
    if getattr(session, "labels", None) is not None:
        session.labels = KilledState("labels")


def recover_worker(mgr, log: WindowLog, dead_worker: int,
                   W_old: Optional[int] = None, W: Optional[int] = None,
                   backend: Optional[str] = None, step: Optional[int] = None,
                   device=None):
    """The coordinator's failure drill, as a standalone function.

    1. restore the last committed snapshot from `mgr` on `device`
       (default CUDA, see `device.resolve_device`), onto the surviving
       mesh of `W` workers on "ell_spmd" (default: the process group's
       size) — torn ``step_XXXX.tmp`` directories are never considered;
    2. evacuate the blocks worker `dead_worker` owned under the old
       `W_old`-worker fold (default: one block per worker, the paper's
       deployment) across the survivors;
    3. replay the log tail recorded after the snapshot's cursor.

    Returns ``(session, replayed)``.  Exactness: the snapshot is exact,
    `migrate_vertices` is a pure permutation, and replay runs the same
    maintenance path on the same values.
    """
    from ..checkpoint import restore_session

    step, session, meta = restore_session(
        mgr, step=step, W=W, backend=backend, device=device)
    P = session.g.P
    W_old = P if W_old is None else int(W_old)
    evacuate_blocks(session, blocks_of_worker(int(dead_worker), P, W_old))
    cursor = int((meta.get("extra") or {}).get("log_cursor", 0))
    replayed = log.replay(session, cursor)
    return session, replayed


class ElasticCoordinator:
    """Coordinator wrapper: one session, one checkpoint dir, one log.

    Feed mutations through `apply_window` / `add_vertices` (applied to
    the session first, logged on success), cut snapshots with
    `checkpoint` (embeds the log cursor), and on a simulated worker loss
    call `recover_worker(w)` — the coordinator swaps in the recovered
    session and keeps going; the stream never notices.
    """

    def __init__(self, session, mgr, log: Optional[WindowLog] = None):
        self.session = session
        self.mgr = mgr
        self.log = WindowLog() if log is None else log

    def apply_window(self, window) -> None:
        self.session.apply_window(window)
        self.log.append_window(window)

    def add_vertices(self, block: int, count: int = 1) -> List[int]:
        handles = self.session.add_vertices(block, count)
        self.log.append_vertices(block, count)
        return handles

    def checkpoint(self, blocking: bool = True) -> int:
        """Snapshot the session; the manifest meta records how much of
        the log the snapshot already contains."""
        from ..checkpoint import save_session

        return save_session(
            self.mgr, self.session, blocking=blocking,
            extra_meta={"log_cursor": len(self.log)})

    def recover_worker(self, dead_worker: int, W_old: Optional[int] = None,
                       W: Optional[int] = None,
                       backend: Optional[str] = None):
        """Drop worker `dead_worker`'s shards (the live session is killed —
        see `kill_session`), restore on the live session's device,
        evacuate, replay.  `W_old` defaults to the live session's
        executor's worker count on the mesh.  The recovered session
        replaces `self.session` and is returned."""
        if W_old is None and self.session.executor is not None:
            W_old = self.session.executor.wm.W
        device = self.session.g.device
        kill_session(self.session)
        session, _ = recover_worker(
            self.mgr, self.log, dead_worker, W_old=W_old, W=W,
            backend=backend, device=device)
        self.session = session
        return session
