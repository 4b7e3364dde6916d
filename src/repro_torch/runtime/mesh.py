"""Worker mesh on `torch.distributed`: one process per worker, blocks
folded onto workers.

The paper assigns one block per worker.  Here a *worker* is one process
of a `torch.distributed` process group, and the group is the one mesh
axis, `AXIS`.  When the graph has more blocks than workers, `B = P // W`
consecutive blocks fold onto each worker (block-contiguous relabeling
makes the fold a plain slice of the node axis: worker w owns padded node
rows ``[w*B*Cn, (w+1)*B*Cn)``).

Process model: every rank holds the whole host graph and builds the same
halo plan from it (`runtime.halo`, deterministic host numpy); each rank
stages only its own shard on its own device: the device of the graph it
was given, ``cuda:rank`` on GPUs (NCCL), the CPU under gloo.

With no process group initialised only W = 1 runs, and its exchange is
the identity copy a one-rank all-to-all is.  With a group, W defaults to
`best_worker_count(P, world size)`, and W must be the group's size: a
rank outside the mesh would have to join every collective and own no
rows, so a caller who wants fewer workers than ranks makes a subgroup of
W ranks (`torch.distributed.new_group`) and passes it as `group`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

#: the one mesh axis of the block runtime (the process group's ranks)
AXIS = "workers"


def best_worker_count(P: int, n_devices: int) -> int:
    """Largest W <= n_devices with W | P (every worker gets B = P/W blocks).

    Divisibility keeps the fold exact: a non-divisor W would strand partial
    blocks on shard boundaries and break `block_of(u) = u // Cn` locality.
    """
    if P < 1:
        raise ValueError(f"need at least one block, got P={P}")
    for w in range(min(P, max(1, n_devices)), 0, -1):
        if P % w == 0:
            return w
    return 1


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """A process group plus the static block-fold geometry.

    Attributes
    ----------
    group:  the `torch.distributed` process group of the W workers, or
            None (no group: W = 1, the exchange is a local copy).
    W:      worker count (the group's size).
    P:      number of graph blocks.
    B:      blocks per worker (the fold), B * W == P.
    Cn:     node capacity per block (from the graph).
    rank:   this process's worker index in [0, W).
    device: this worker's device (where its shard is staged).
    """

    group: Optional[Any]
    W: int
    P: int
    B: int
    Cn: int
    rank: int = 0
    device: torch.device = torch.device("cpu")

    @property
    def S(self) -> int:
        """Padded nodes per worker shard (B blocks of Cn rows)."""
        return self.B * self.Cn

    @property
    def N(self) -> int:
        return self.P * self.Cn

    def worker_of(self, u) -> int:
        """Owning worker of a global padded node id."""
        return u // self.S


def make_worker_mesh(g, W: Optional[int] = None,
                     group: Optional[Any] = None) -> WorkerMesh:
    """Build the worker mesh of a block-partitioned graph (duck-typed:
    `.P`, `.Cn`, `.device`) for this process.

    `group` defaults to the default process group when one is
    initialised; with none, only W = 1 is allowed.  W defaults to
    `best_worker_count(P, group size)`; a W that does not divide P, or
    that is not the group's size, raises ValueError (see the module
    docstring for why fewer workers than ranks need a subgroup).
    """
    if group is None and not (dist.is_available() and dist.is_initialized()):
        W = 1 if W is None else int(W)
        if W != 1:
            raise ValueError(
                f"W={W} needs a torch.distributed process group of W ranks; "
                "with none initialised only W = 1 runs")
        return WorkerMesh(group=None, W=1, P=g.P, B=g.P, Cn=g.Cn, rank=0,
                          device=g.device)
    if group is None:
        group = dist.group.WORLD
    size = dist.get_world_size(group)
    if W is None:
        W = best_worker_count(g.P, size)
    W = int(W)
    if W < 1 or W > size:
        raise ValueError(f"W={W} outside [1, {size} ranks]")
    if g.P % W:
        raise ValueError(f"W={W} must divide P={g.P} (blocks-per-worker fold)")
    if W != size:
        raise ValueError(
            f"W={W} must equal the process group's size {size}: make a "
            f"subgroup of {W} ranks (torch.distributed.new_group) and pass "
            "it as group=")
    return WorkerMesh(group=group, W=W, P=g.P, B=g.P // W, Cn=g.Cn,
                      rank=dist.get_rank(group), device=g.device)
