"""Runtime of the port: BLADYG's architecture on a `torch.distributed`
worker mesh, one process per worker.

  mesh.py     — `WorkerMesh`: the process group with a blocks-per-worker
                fold when P > W.
  halo.py     — `HaloPlan`: which neighbor slots cross shard boundaries
                and the all-to-all indices that serve them, built on the
                host from `GraphBlocks.nbr`.
  spmd.py     — `SpmdExecutor` (halo-exchange primitives running the ELL
                kernels on each shard) and `SpmdEngine.run_spmd`, the
                superstep executor of `SpmdProgram`s (`SpmdBlockProgram`
                runs any `BlockProgram`): W2W is an executed halo
                exchange, W2M an all-gather of per-worker summaries, M2W
                the replicated master directive (`kernels.ops`'
                "ell_spmd").
  stream.py   — streaming update ingestion on one device or on the mesh
                (one long-lived executor with incremental halo-plan
                maintenance), §4.2 live rebalancing, capacity growth.
  recovery.py — the window log, worker loss and replay, onto one device
                or another mesh shape.
"""
from .mesh import AXIS, WorkerMesh, best_worker_count, make_worker_mesh
from .halo import HaloPlan, build_halo_plan
from .spmd import (
    SpmdBlockProgram, SpmdCorenessProgram, SpmdEngine, SpmdExecutor,
    SpmdProgram, coreness_spmd, frontier_spmd, hindex_spmd,
)
from .stream import (
    MirrorStream, StreamResult, StreamSession, StreamStats, owner_block,
    route_updates, run_stream,
)
from .recovery import (
    ElasticCoordinator, WindowLog, blocks_of_worker, evacuate_blocks,
    kill_session, plan_evacuation, recover_worker)

__all__ = [
    "AXIS", "WorkerMesh", "best_worker_count", "make_worker_mesh",
    "HaloPlan", "build_halo_plan",
    "SpmdExecutor", "SpmdEngine", "SpmdProgram", "SpmdCorenessProgram",
    "SpmdBlockProgram",
    "coreness_spmd", "hindex_spmd", "frontier_spmd",
    "MirrorStream", "StreamResult", "StreamSession", "StreamStats",
    "owner_block", "route_updates", "run_stream",
    "ElasticCoordinator", "WindowLog", "blocks_of_worker",
    "evacuate_blocks", "kill_session", "plan_evacuation", "recover_worker",
]
