"""Runtime of the port: the stream (`stream`), crash recovery on one
device (`recovery`), and the first half of the mesh runtime on
`torch.distributed` — the worker mesh (`mesh`), the halo plan (`halo`)
and the halo-exchange executor (`spmd`), which runs h-index, frontier
hops and coreness on a worker mesh (`kernels.ops`' "ell_spmd").

Not ported yet (ROADMAP.md, Queue 1 item 6): the mesh programs
(`SpmdEngine` and its programs, step 3) and the stream, maintenance and
restore on the mesh (step 4).
"""
from .mesh import AXIS, WorkerMesh, best_worker_count, make_worker_mesh
from .halo import HaloPlan, build_halo_plan
from .spmd import SpmdExecutor, coreness_spmd, frontier_spmd, hindex_spmd
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
    "SpmdExecutor", "coreness_spmd", "hindex_spmd", "frontier_spmd",
    "MirrorStream", "StreamResult", "StreamSession", "StreamStats",
    "owner_block", "route_updates", "run_stream",
    "ElasticCoordinator", "WindowLog", "blocks_of_worker",
    "evacuate_blocks", "kill_session", "plan_evacuation", "recover_worker",
]
