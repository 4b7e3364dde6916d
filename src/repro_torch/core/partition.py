"""Node partitioners — the BLADYG `partitioner worker` (host numpy).

Copies of the JAX package's node partitioners, so both packages assign
the same blocks from the same seed:

    - ``node_hash_partition``   — hash(node) % P
    - ``node_random_partition`` — balanced random
    - ``node_bfs_partition``    — balanced multi-source BFS growth (edge-cut
      flavored: connected, near-equal blocks, few crossing edges)

Partitioning runs once, on ingest, so it stays on the host.  The edge and
vertex-cut partitioners are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "node_hash_partition",
    "node_random_partition",
    "node_bfs_partition",
]


def node_hash_partition(n: int, P: int, seed: int = 0) -> np.ndarray:
    """Deterministic multiplicative hash of node id -> block."""
    ids = np.arange(n, dtype=np.uint64)
    key = np.uint64(0x9E3779B97F4A7C15 + 2 * seed + 1)
    h = (ids * key) >> np.uint64(17)
    return np.asarray(h % np.uint64(P), dtype=np.int64)


def node_random_partition(n: int, P: int, seed: int = 0) -> np.ndarray:
    """Balanced random: a shuffled round-robin."""
    rng = np.random.default_rng(seed)
    assign = np.arange(n, dtype=np.int64) % P
    rng.shuffle(assign)
    return assign


def node_bfs_partition(
    edges: np.ndarray, n: int, P: int, seed: int = 0
) -> np.ndarray:
    """Balanced multi-source BFS growth (edge-cut style).

    P random seeds grow in rounds; each block stops claiming at capacity
    ceil(n/P).  Unreached nodes (other components) go to the smallest blocks.
    """
    rng = np.random.default_rng(seed)
    cap = -(-n // P)
    adj_head, adj_next, adj_dst = _csr_ish(edges, n)
    assign = np.full(n, -1, dtype=np.int64)
    size = np.zeros(P, dtype=np.int64)
    seeds = rng.choice(n, size=min(P, n), replace=False)
    frontiers = []
    for p, s in enumerate(seeds):
        if assign[s] == -1:
            assign[s] = p
            size[p] += 1
            frontiers.append([s])
        else:
            frontiers.append([])
    active = True
    while active:
        active = False
        for p in range(P):
            if size[p] >= cap or not frontiers[p]:
                continue
            nxt = []
            for u in frontiers[p]:
                e = adj_head[u]
                while e != -1:
                    v = adj_dst[e]
                    e = adj_next[e]
                    if assign[v] == -1 and size[p] < cap:
                        assign[v] = p
                        size[p] += 1
                        nxt.append(v)
            frontiers[p] = nxt
            if nxt:
                active = True
    left = np.flatnonzero(assign == -1)
    for u in left:
        p = int(np.argmin(size))
        assign[u] = p
        size[p] += 1
    return assign


def _csr_ish(edges: np.ndarray, n: int):
    """Linked-list adjacency (head/next arrays) — O(m) build, no sorting."""
    m2 = 2 * len(edges)
    adj_head = np.full(n, -1, dtype=np.int64)
    adj_next = np.full(m2, -1, dtype=np.int64)
    adj_dst = np.empty(m2, dtype=np.int64)
    k = 0
    for a, b in edges:
        adj_dst[k] = b
        adj_next[k] = adj_head[a]
        adj_head[a] = k
        k += 1
        adj_dst[k] = a
        adj_next[k] = adj_head[b]
        adj_head[b] = k
        k += 1
    return adj_head, adj_next, adj_dst
