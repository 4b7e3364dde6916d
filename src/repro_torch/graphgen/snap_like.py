"""SNAP-shaped stand-in graphs (offline substitutes for Table 1 datasets).

Each entry reproduces the *shape* of the paper's dataset (node count, edge
count, clustering regime) with a deterministic generator; `scale` shrinks
node counts proportionally for CI (the paper-scale graph is `scale=1.0`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .nn_model import nearest_neighbor_graph
from .simple import barabasi_albert, grid_like

# name -> (n, m, generator kind) from paper Table 1
DATASETS: Dict[str, Tuple[int, int, str]] = {
    "DS1": (50_000, 365_883, "nn"),
    "DS2": (100_000, 734_416, "nn"),
    "ego-Facebook": (4_039, 88_234, "ba-dense"),
    "roadNet-CA": (1_965_206, 2_766_607, "grid"),
    "com-LiveJournal": (3_997_962, 34_681_189, "nn-dense"),
}


def snap_like(name: str, scale: float = 1.0, seed: int = 0) -> np.ndarray:
    """Generate a stand-in for the named paper dataset at `scale`."""
    n_full, m_full, kind = DATASETS[name]
    n = max(64, int(n_full * scale))
    target_ratio = m_full / n_full  # edges per node
    if kind == "nn":
        u = 1.0 - 1.0 / target_ratio
        return nearest_neighbor_graph(n, u=u, seed=seed)
    if kind == "nn-dense":
        u = 1.0 - 1.0 / target_ratio
        return nearest_neighbor_graph(n, u=min(0.93, u), seed=seed)
    if kind == "ba-dense":
        k = max(2, int(round(target_ratio)))
        return barabasi_albert(n, k, seed=seed)
    if kind == "grid":
        return grid_like(n, seed=seed)
    raise ValueError(kind)
