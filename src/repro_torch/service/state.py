"""Device-resident analytics state, published as versioned epoch snapshots.

The serving layer never reads the stream's live tensors: between the
moment a window is applied and the moment its analytics are refreshed,
`session.core`/`session.labels` and the graph describe DIFFERENT epochs,
and the apply path splices the graph's rows in place besides.
`AnalyticsState` is the consistency boundary — after any prefix of
windows it cuts an `EpochSnapshot`: one immutable record of (coreness,
CC labels, PageRank, degrees, adjacency) all describing the same graph,
cloned out of the tensors the next window rewrites.

Snapshot refresh is ONE fused superstep loop, not three recomputes: the
stream already keeps coreness and CC labels exact, and both are
fixpoints of their own monotone updates (min-H of true coreness is the
coreness; min-label of canonical labels is the labels) — so
`fused_analytics(init=(session.core, session.labels))` warm-starts them
AT the fixpoint, where they ride through bit-unchanged, while the
fixed-iteration PageRank sub-program does the actual work off the same
shared adjacency read (`ell_multi` on a CUDA session).  Every field of
the published snapshot is therefore bit-identical to a from-scratch
recompute on that epoch's graph (`coreness`, `connected_components`,
`pagerank(tol=None, max_steps=pr_steps)`) on the session's backend.

Double buffering: snapshots are immutable NamedTuples, so "front" and
"back" collapse to an attribute swap — queries in flight keep whatever
snapshot record they started with; `refresh()` builds the next epoch's
record off to the side and publishes it by a single assignment.

Hub-split sessions (`runtime.stream.MirrorStream`, or any session whose
`.mirror` is a `core.hub_split.MirrorPlan`) refresh through the same
fused loop under the vertex-cut dataflow: coreness and CC equal the
unsplit graph's at primaries, PageRank is allclose, and the snapshot
gains the `primary`/`nbr_max` fields the query layer resolves through
(see `EpochSnapshot`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.algorithms import fused_analytics


class EpochSnapshot(NamedTuple):
    """One epoch's consistent, immutable analytics + topology record.

    All tensors are device-resident CLONES on the session's device (the
    stream's apply path rewrites the live graph's rows in place, so a
    shared reference would change under a published snapshot).  Node
    addressing is the session's padded id space at this epoch; `orig_id`
    maps back to pre-partition input ids (stable across §4.2
    migrations).

    Hub-split sessions publish two extra fields: `primary`, the host
    row -> primary-row map queries resolve through (a replica row's id
    answers with its hub's values), and `nbr_max`, the group-merged
    neighbor-max coreness (a hub's neighbors are spread over its slices,
    so one row's gather would see only one slice).  `deg` then holds
    LOGICAL degrees and `rank` is masked to primaries (replica rows read
    0.0, so top-k never lists a hub twice).  Both stay None otherwise.

    Padded row ids are only comparable between two snapshots whose
    `(Cn, grows)` match: a capacity escalation (`StreamSession.grow`)
    re-keys every padded id monotonically, so a row id cached from an
    older epoch silently points at a different vertex afterwards.
    Cross-epoch joins must go through `orig_id`, the stable key.
    """

    epoch: int                  # snapshot version, 0 at session open
    windows: int                # stream windows ingested when this was cut
    core: torch.Tensor          # (N,) int32 coreness (0 on padding)
    labels: torch.Tensor        # (N,) int32 CC labels (-1 on padding)
    rank: torch.Tensor          # (N,) float32 PageRank (0.0 on padding)
    deg: torch.Tensor           # (N,) int32 degrees (logical under mirror)
    nbr: torch.Tensor           # (N, Cd) int32 sorted-ELL adjacency
    node_mask: torch.Tensor     # (N,) bool real-node mask
    orig_id: torch.Tensor       # (N,) int32 original input ids
    primary: Optional[np.ndarray] = None     # (N,) host row->primary map
    nbr_max: Optional[torch.Tensor] = None   # (N,) group-merged nbr max core
    Cn: int = 0                 # per-block node capacity at this epoch
    Cd: int = 0                 # degree capacity at this epoch
    grows: int = 0              # capacity escalations before this epoch


class AnalyticsState:
    """Maintained analytics over a `StreamSession`, read via snapshots.

    Requires the session to be tracking CC labels (open it with
    `cc_labels=connected_components(g)`): label maintenance is what lets
    the refresh warm-start at the fixpoint instead of budgeting its own
    convergence supersteps.  The refresh runs on the session's graph's
    device with the session's backend; over a session on the worker mesh
    it runs through the session's executor (``backend="ell_spmd"``).
    """

    def __init__(self, session, alpha: float = 0.85, pr_steps: int = 30):
        if session.labels is None:
            raise ValueError(
                "AnalyticsState needs a label-tracking session: open "
                "StreamSession with cc_labels=connected_components(g) "
                "(or MirrorStream with cc_labels=True) so the refresh "
                "can warm-start CC at its maintained fixpoint.")
        self._session = session
        self.alpha = float(alpha)
        self.pr_steps = int(pr_steps)
        self.refreshes = 0
        self._front: Optional[EpochSnapshot] = None
        self.refresh()  # epoch 0: serve from the open-time graph

    @property
    def snapshot(self) -> EpochSnapshot:
        """The published (front) snapshot — what queries read."""
        return self._front

    @property
    def epoch(self) -> int:
        return self._front.epoch

    def staleness(self) -> int:
        """Stream windows applied since the published snapshot was cut."""
        return self._session.windows_applied - self._front.windows

    def refresh(self) -> EpochSnapshot:
        """Cut + publish the next epoch's snapshot from the session head.

        One fused-analytics pass (see module docstring) plus one clone of
        the topology tensors; the publish itself is a reference swap, so
        a reader can never observe a half-built snapshot.
        """
        sess = self._session
        g = sess.g
        mirror = sess.mirror
        core, labels, rank = fused_analytics(
            g, alpha=self.alpha, steps=self.pr_steps, backend=sess.backend,
            executor=sess.executor, init=(sess.core, sess.labels),
            mirror=mirror)
        if mirror is None:
            deg, primary, nbr_max = g.deg, None, None
        else:
            # logical degrees, the primary map, replica ranks masked out
            # of top-k, and neighbor-max coreness merged over the slices:
            # one (N, Cd) gather, a scatter-max into the primary rows and
            # a gather back
            prow = mirror.primary_row.long()
            deg = mirror.ldeg
            rank = torch.where(mirror.primary_mask, rank, 0.0)
            row_max = torch.where(g.nbr >= 0, core[g.nbr.clamp(min=0).long()],
                                  -1).amax(dim=1).to(torch.int32)
            grp_max = torch.full_like(row_max, -1).scatter_reduce(
                0, prow, row_max, "amax")
            nbr_max = grp_max[prow]
            primary = mirror.primary_row.cpu().numpy().astype(np.int32)
        back = EpochSnapshot(
            epoch=0 if self._front is None else self._front.epoch + 1,
            windows=sess.windows_applied,
            core=core.clone(),
            labels=labels.clone(),
            rank=rank.clone(),
            deg=deg.clone(),
            nbr=g.nbr.clone(),
            node_mask=g.node_mask.clone(),
            orig_id=g.orig_id.clone(),
            primary=primary,
            nbr_max=None if nbr_max is None else nbr_max.clone(),
            Cn=int(g.Cn),
            Cd=int(g.Cd),
            grows=int(sess._grows),
        )
        self._front = back  # publish
        self.refreshes += 1
        return back
