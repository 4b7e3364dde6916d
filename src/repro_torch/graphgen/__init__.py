"""Synthetic graph generators (the paper's data sources, offline).

Numpy copies of the JAX package's generators, so both packages build the
same edges from the same seed: the Nearest-Neighbor model [Sala et al.,
WWW'10] behind the paper's DS1/DS2, and size-matched stand-ins for its
SNAP graphs (`snap_like`).
"""
from .nn_model import nearest_neighbor_graph
from .simple import erdos_renyi, barabasi_albert, grid_like
from .snap_like import snap_like, DATASETS

__all__ = [
    "nearest_neighbor_graph", "erdos_renyi", "barabasi_albert",
    "grid_like", "snap_like", "DATASETS",
]
