"""BLADYG core on PyTorch: the block graph, static and dynamic coreness,
the superstep engine and the BlockProgram workloads, hub mirroring, the
degree example and maximal-clique maintenance."""
from .graph import (
    PAD, CapacityError, GraphBlocks, add_vertices_host, build_blocks,
    build_ell_random, delete_edge, grow_blocks, halo_pair_counts,
    halo_slot_counts, has_edge, insert_edge, migrate_vertices,
    relocate_rows, sort_nbr_rows, to_networkx_edges,
)
from .engine import (
    BladygEngine, BladygProgram, BlockCtx, BlockProgram, MessageStats, Mode,
    MultiProgram,
)
from .algorithms import (
    ConnectedComponentsProgram, CorenessBlockProgram, PageRankProgram,
    TriangleCountProgram, connected_components, fused_analytics,
    merge_labels, pagerank, triangle_counts, triangle_total,
)
from .kcore import (
    CorenessProgram, coreness, coreness_step, coreness_via_engine,
    coreness_via_spmd, coreness_with_stats, hindex_rows, max_coreness,
)
from .kcore_dynamic import (
    BatchMaintenanceStats, MaintenanceStats, delete_edge_maintain,
    insert_edge_maintain, k_reachable, k_reachable_batch, maintain_batch,
    maintain_batch_host,
)
from .degree import (
    compute_degrees, maintain_degrees_delete, maintain_degrees_insert,
)
from .cliques import MaximalCliques, bron_kerbosch
from .hub_split import (
    MirrorPlan, apply_mirrored_edits, groups_of, grow_plan, mirror_report,
    run_common_mirror, split_hubs,
)
from . import partition, partition_dynamic, updates

__all__ = [
    "PAD", "CapacityError", "GraphBlocks", "add_vertices_host",
    "build_blocks", "build_ell_random", "delete_edge", "grow_blocks",
    "has_edge", "insert_edge", "migrate_vertices", "relocate_rows",
    "sort_nbr_rows", "to_networkx_edges", "halo_slot_counts",
    "halo_pair_counts",
    "BladygEngine", "BladygProgram", "BlockCtx", "BlockProgram",
    "MessageStats", "Mode", "MultiProgram",
    "ConnectedComponentsProgram", "CorenessBlockProgram", "PageRankProgram",
    "TriangleCountProgram", "connected_components", "fused_analytics",
    "merge_labels", "pagerank", "triangle_counts", "triangle_total",
    "CorenessProgram", "coreness", "coreness_step", "coreness_via_engine",
    "coreness_via_spmd", "coreness_with_stats", "hindex_rows", "max_coreness",
    "BatchMaintenanceStats", "MaintenanceStats", "delete_edge_maintain",
    "insert_edge_maintain", "k_reachable", "k_reachable_batch",
    "maintain_batch", "maintain_batch_host", "compute_degrees",
    "maintain_degrees_insert", "maintain_degrees_delete",
    "MaximalCliques", "bron_kerbosch",
    "MirrorPlan", "apply_mirrored_edits", "groups_of", "grow_plan",
    "mirror_report", "run_common_mirror", "split_hubs",
    "partition", "partition_dynamic", "updates",
]
