"""Nearest-Neighbor synthetic graph model [Sala et al., WWW'10].

Growth process with connection probability u:
  * with prob (1-u): add a new node and connect it to a uniformly random
    existing node;
  * with prob u: pick a random node and connect a random pair of its
    neighbors' *2-hop* endpoints (i.e. connect two random nodes at distance
    2), creating a triangle.

This yields the high clustering / heavy-tail degree shape the paper's DS1 and
DS2 exhibit; u controls density: edges-per-node ≈ 1 / (1 - u).
"""
from __future__ import annotations

import numpy as np


def nearest_neighbor_graph(
    n: int, u: float = 0.86, seed: int = 0
) -> np.ndarray:
    """Grow until `n` nodes; returns (m, 2) unique undirected edge list."""
    rng = np.random.default_rng(seed)
    adj = [set() for _ in range(n)]
    edges = []

    def add_edge(a: int, b: int):
        if a != b and b not in adj[a]:
            adj[a].add(b)
            adj[b].add(a)
            edges.append((a, b))

    # seed triangle
    add_edge(0, 1)
    add_edge(1, 2)
    add_edge(0, 2)
    alive = 3
    while alive < n:
        if rng.random() < u and alive > 3:
            # close a random 2-hop pair
            a = int(rng.integers(alive))
            if adj[a]:
                nb = list(adj[a])
                if len(nb) >= 2:
                    i, j = rng.choice(len(nb), size=2, replace=False)
                    add_edge(nb[i], nb[j])
                    continue
            # fall through when no pair available
        b = int(rng.integers(alive))
        add_edge(alive, b)
        alive += 1
    return np.asarray(edges, dtype=np.int64)
