"""Partitioners — the BLADYG `partitioner worker` (host numpy).

Copies of the JAX package's partitioners, with the same hash constants
and `default_rng` draws, so both packages assign the same owners from the
same seed.

*Node partitioners* (k-core / degree tasks, where a block is a set of
nodes and their adjacency):
    - ``node_hash_partition``   — hash(node) % P
    - ``node_random_partition`` — balanced random
    - ``node_bfs_partition``    — balanced multi-source BFS growth (edge-cut
      flavored: connected, near-equal blocks, few crossing edges)

*Edge partitioners* (the dynamic-partitioning experiments of the paper's
§5.2.2, where the unit being assigned is an edge):
    - ``edge_hash_partition``, ``edge_random_partition``
    - ``vertex_cut_greedy``     — the PowerGraph greedy heuristic (paper §2)
    - ``vertex_cut_update``     — greedy continuation over new edges only
    - ``dfep``                  — funding-based Distributed Edge Partitioning
      [Guerrieri & Montresor, Europar'15], vectorized rounds
    - ``ub_update``             — DynamicDFEP's Unit-Based incremental
      assignment of new edges [Sakouhi et al., IDEAS'16]

Partitioning runs once, on ingest, so it stays on the host.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "node_hash_partition",
    "node_random_partition",
    "node_bfs_partition",
    "edge_hash_partition",
    "edge_random_partition",
    "vertex_cut_greedy",
    "vertex_cut_update",
    "dfep",
    "ub_update",
    "edge_balance",
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


# ---------------------------------------------------------------------------
# Edge partitioners
# ---------------------------------------------------------------------------

def edge_hash_partition(edges: np.ndarray, P: int, seed: int = 0) -> np.ndarray:
    lo = np.minimum(edges[:, 0], edges[:, 1]).astype(np.uint64)
    hi = np.maximum(edges[:, 0], edges[:, 1]).astype(np.uint64)
    key = np.uint64(0x9E3779B97F4A7C15 + 2 * seed + 1)
    h = (lo * key ^ (hi + np.uint64(0x517CC1B727220A95))) * key
    return np.asarray((h >> np.uint64(19)) % np.uint64(P), dtype=np.int64)


def edge_random_partition(edges: np.ndarray, P: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    assign = np.arange(len(edges), dtype=np.int64) % P
    rng.shuffle(assign)
    return assign


def _vertex_cut_assign(
    edges: np.ndarray,
    parts_of: list,
    size: np.ndarray,
    remaining: np.ndarray,
    start: int,
    P: int,
    balance_slack: float,
) -> np.ndarray:
    """The greedy vertex-cut inner loop over `edges`, continuing from the
    given per-node partition sets / sizes, with the running capacity
    indexed from global edge position `start` (so a continuation is
    bit-identical to the static greedy over the concatenated stream)."""
    out = np.empty(len(edges), dtype=np.int64)
    for j, (u, v) in enumerate(edges):
        cap = balance_slack * ((start + j) / P) + 1.0
        pu, pv = parts_of[u], parts_of[v]

        def pick(cands):
            ok = [q for q in cands if size[q] < cap]
            if ok:
                return min(ok, key=lambda q: size[q])
            return int(np.argmin(size))

        common = pu & pv
        if common:
            p = pick(common)
        elif pu and pv:
            picker = u if remaining[u] >= remaining[v] else v
            p = pick(parts_of[picker])
        elif pu or pv:
            p = pick(pu or pv)
        else:
            p = int(np.argmin(size))
        out[j] = p
        size[p] += 1
        pu.add(p)
        pv.add(p)
        remaining[u] -= 1
        remaining[v] -= 1
    return out


def vertex_cut_greedy(
    edges: np.ndarray, n: int, P: int, balance_slack: float = 1.1
) -> np.ndarray:
    """PowerGraph greedy vertex-cut (paper §2 description, processed in order).

    Rules for edge (u, v):
      1. common partition of u and v -> that partition (least loaded of them)
      2. only one endpoint placed   -> one of its partitions (least loaded)
      3. both placed, disjoint      -> endpoint with more remaining edges
                                       picks its least-loaded partition
      4. neither placed             -> globally least-loaded partition

    A capacity bound (`balance_slack` x running mean) guards against the
    known degeneracy of the pure greedy on ordered edge streams (growth
    models feed every new edge an already-placed endpoint, cascading all
    edges into partition 0); over-full candidates fall back to rule 4 — the
    standard greedy-with-capacity variant.
    """
    edges = np.asarray(edges, dtype=np.int64)
    remaining = np.zeros(n, dtype=np.int64)
    np.add.at(remaining, edges[:, 0], 1)
    np.add.at(remaining, edges[:, 1], 1)
    parts_of = [set() for _ in range(n)]
    size = np.zeros(P, dtype=np.int64)
    return _vertex_cut_assign(
        edges, parts_of, size, remaining, 0, P, balance_slack)


def vertex_cut_update(
    edges: np.ndarray,
    owner: np.ndarray,
    new_edges: np.ndarray,
    n: int,
    P: int,
    balance_slack: float = 1.1,
) -> np.ndarray:
    """Greedy vertex-cut *continuation*: assign only `new_edges`, resuming
    from the state the static greedy would hold after `edges`/`owner`.

    Reconstructs the per-node partition sets and sizes from the existing
    assignment and restarts the greedy with the running-capacity index
    offset by `len(edges)`.  `remaining` at that point counts only the
    not-yet-processed (new) edges — exactly the static greedy's state at
    index `len(edges)` of the concatenated stream.  Parity contract:
    `vertex_cut_greedy(concat(edges, new))` equals
    `concat(owner, vertex_cut_update(...))` bit-for-bit whenever `owner`
    is that static run's own prefix assignment.  (A greedy run over the
    prefix *alone* is a different state — its `remaining` tie-break never
    saw the future edges — so chaining `initial_partition` +
    `incremental_part` matches the heuristic, not necessarily the
    one-shot static output.)  Never touches the existing assignment
    either way, which is the IncrementalPart contract.
    """
    edges = np.asarray(edges, dtype=np.int64)
    new_edges = np.asarray(new_edges, dtype=np.int64)
    owner = np.asarray(owner, dtype=np.int64)
    parts_of = [set() for _ in range(n)]
    for (u, v), p in zip(edges, owner):
        parts_of[u].add(int(p))
        parts_of[v].add(int(p))
    size = np.bincount(owner, minlength=P).astype(np.int64)
    remaining = np.zeros(n, dtype=np.int64)
    if len(new_edges):
        np.add.at(remaining, new_edges[:, 0], 1)
        np.add.at(remaining, new_edges[:, 1], 1)
    return _vertex_cut_assign(
        new_edges, parts_of, size, remaining, len(edges), P, balance_slack)


def dfep(
    edges: np.ndarray,
    n: int,
    P: int,
    seed: int = 0,
    init_funding: float = 10.0,
    round_funding: float = 10.0,
    max_rounds: int = 10_000,
) -> np.ndarray:
    """DFEP — funding-based distributed edge partitioning (vectorized rounds).

    Faithful to the paper's 4-step description (§5.2.2): random seed node per
    partition with initial funding; partitions buy adjacent unowned edges
    with funding; the coordinator tops partitions up inversely proportional
    to their size; repeat until all edges are bought.  Conflicts in a round
    resolve in favor of the currently-smallest partition.  Edges unreachable
    from any seed (other components) are swept to the smallest partitions at
    the end, as in the reference implementation.
    """
    edges = np.asarray(edges, dtype=np.int64)
    m = len(edges)
    rng = np.random.default_rng(seed)
    owner = np.full(m, -1, dtype=np.int64)
    funding = np.full(P, float(init_funding))
    size = np.zeros(P, dtype=np.int64)

    in_part = np.zeros((P, n), dtype=bool)  # vertex touched by partition p
    seeds = rng.choice(n, size=min(P, n), replace=False)
    for p, s in enumerate(seeds):
        in_part[p, s] = True

    u_end, v_end = edges[:, 0], edges[:, 1]
    for _ in range(max_rounds):
        if (owner >= 0).all():
            break
        progress = False
        unowned = owner == -1
        for p in np.argsort(size, kind="stable"):  # smallest spends first
            budget = int(funding[p])
            if budget <= 0:
                continue
            # adjacent unowned edges: either endpoint touched by p (O(m) vec)
            cand = np.flatnonzero(
                unowned & (in_part[p][u_end] | in_part[p][v_end]))
            if not len(cand):
                continue
            buy = cand[:budget] if len(cand) > budget else cand
            owner[buy] = p
            unowned[buy] = False
            funding[p] -= len(buy)
            size[p] += len(buy)
            ends = edges[buy].reshape(-1)
            in_part[p, ends] = True
            progress = True
        # coordinator: top-up inversely proportional to size
        mean_size = max(1.0, float(size.mean()))
        funding += round_funding * mean_size / np.maximum(size, 1)
        if not progress:
            # everything reachable is bought; sweep stragglers
            left = np.flatnonzero(owner == -1)
            for e in left:
                p = int(np.argmin(size))
                owner[e] = p
                size[p] += 1
                in_part[p, edges[e]] = True
            break
    left = np.flatnonzero(owner == -1)
    for e in left:
        p = int(np.argmin(size))
        owner[e] = p
        size[p] += 1
    return owner


def ub_update(
    edges: np.ndarray,
    owner: np.ndarray,
    new_edges: np.ndarray,
    n: int,
    P: int,
) -> np.ndarray:
    """Unit-Based incremental assignment (DynamicDFEP UB-UPDATE flavor).

    Each new edge goes to the partition that already owns the most edges
    incident to its endpoints (ties -> smaller partition); if no endpoint is
    known, to the globally smallest partition.  O(new · deg) — never touches
    the existing assignment, which is the whole point (IncrementalPart).
    """
    owner = np.asarray(owner)
    size = np.bincount(owner, minlength=P).astype(np.int64)
    # per-node partition histograms (sparse dict-of-rows to stay O(m))
    node_part = [dict() for _ in range(n)]
    for (u, v), p in zip(np.asarray(edges, dtype=np.int64), owner):
        node_part[u][p] = node_part[u].get(p, 0) + 1
        node_part[v][p] = node_part[v].get(p, 0) + 1
    out = np.empty(len(new_edges), dtype=np.int64)
    for i, (u, v) in enumerate(np.asarray(new_edges, dtype=np.int64)):
        score: dict = {}
        for d in (node_part[u], node_part[v]):
            for p, c in d.items():
                score[p] = score.get(p, 0) + c
        if score:
            best = min(score.items(), key=lambda kv: (-kv[1], size[kv[0]]))[0]
        else:
            best = int(np.argmin(size))
        out[i] = best
        size[best] += 1
        node_part[u][best] = node_part[u].get(best, 0) + 1
        node_part[v][best] = node_part[v].get(best, 0) + 1
    return out


def edge_balance(owner: np.ndarray, P: int) -> float:
    """Imbalance metric: max partition size / mean size (1.0 = perfect)."""
    size = np.bincount(np.asarray(owner), minlength=P)
    return float(size.max() / max(1.0, size.mean()))
