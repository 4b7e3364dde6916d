"""BLADYG core on PyTorch: the block graph, static and dynamic coreness."""
from .graph import (
    PAD, CapacityError, GraphBlocks, build_blocks, build_ell_random,
    delete_edge, insert_edge, sort_nbr_rows,
)
from .kcore import coreness, coreness_step, coreness_with_stats, max_coreness
from .kcore_dynamic import (
    BatchMaintenanceStats, MaintenanceStats, delete_edge_maintain,
    insert_edge_maintain, k_reachable, k_reachable_batch, maintain_batch,
    maintain_batch_host,
)
from . import partition, updates

__all__ = [
    "PAD", "CapacityError", "GraphBlocks", "build_blocks",
    "build_ell_random", "delete_edge", "insert_edge", "sort_nbr_rows",
    "coreness", "coreness_step", "coreness_with_stats", "max_coreness",
    "BatchMaintenanceStats", "MaintenanceStats", "delete_edge_maintain",
    "insert_edge_maintain", "k_reachable", "k_reachable_batch",
    "maintain_batch", "maintain_batch_host", "partition", "updates",
]
