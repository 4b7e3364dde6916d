"""Dynamic edge-partitioning maintenance — BLADYG application #2 (paper §4.2).

Two update strategies, exactly the paper's §5.2.2 experiment:

  * IncrementalPart — apply the partitioning technique only to the
    incremental changes (hash/random: stateless per-edge assignment;
    DFEP: the UB-UPDATE neighbor-funding rule; vertex-cut: the greedy
    continuation).
  * NaivePart — destroy the old partitioning and restart from scratch.

Deletions trigger the repartition-threshold protocol of §4.2: every worker
computes a local balance summary (workerCompute, W2M), the coordinator
decides whether a full repartition is needed (masterCompute).

The same protocol also runs *live* against the block graph:
`block_loads`/`block_balance` are the workerCompute summaries over a
`GraphBlocks` and `choose_node_moves` is the masterCompute move selection
that `runtime.stream` feeds into `graph.migrate_vertices` when the
streaming balance trips its threshold.

Host numpy, as in the JAX package: the same inputs give the same owners,
moves and decisions.  The functions that take a `GraphBlocks` read its
tensors to the host once per call (`choose_node_moves` only the rows of
the blocks it moves nodes out of).  The seconds the partitioning
functions return are measured on the host clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import partition as P_


@dataclass
class PartitionState:
    edges: np.ndarray   # (m, 2) original ids
    owner: np.ndarray   # (m,) block of each edge
    n: int
    P: int
    method: str         # 'hash' | 'random' | 'dfep' | 'vertex_cut'
    seed: int = 0


_STATIC = {
    "hash": lambda e, n, P, seed: P_.edge_hash_partition(e, P, seed),
    "random": lambda e, n, P, seed: P_.edge_random_partition(e, P, seed),
    "dfep": lambda e, n, P, seed: P_.dfep(e, n, P, seed),
    "vertex_cut": lambda e, n, P, seed: P_.vertex_cut_greedy(e, n, P),
}


def initial_partition(
    edges: np.ndarray, n: int, P: int, method: str, seed: int = 0
) -> Tuple[PartitionState, float]:
    """Run the static partitioner; returns (state, partitioning-time seconds)."""
    t0 = time.perf_counter()
    owner = _STATIC[method](np.asarray(edges), n, P, seed)
    pt = time.perf_counter() - t0
    return PartitionState(np.asarray(edges), owner, n, P, method, seed), pt


def incremental_part(
    st: PartitionState, new_edges: np.ndarray
) -> Tuple[PartitionState, float]:
    """IncrementalPart: assign only the new edges, keep everything else."""
    new_edges = np.asarray(new_edges)
    t0 = time.perf_counter()
    if st.method in ("hash", "random"):
        new_owner = _STATIC[st.method](new_edges, st.n, st.P, st.seed)
    elif st.method == "dfep":
        new_owner = P_.ub_update(st.edges, st.owner, new_edges, st.n, st.P)
    elif st.method == "vertex_cut":
        # the greedy continuation from the current per-node partition sets
        new_owner = P_.vertex_cut_update(
            st.edges, st.owner, new_edges, st.n, st.P)
    else:
        raise ValueError(st.method)
    ut = time.perf_counter() - t0
    st2 = PartitionState(
        np.concatenate([st.edges, new_edges]),
        np.concatenate([st.owner, new_owner]),
        st.n, st.P, st.method, st.seed,
    )
    return st2, ut


def naive_part(
    st: PartitionState, new_edges: np.ndarray
) -> Tuple[PartitionState, float]:
    """NaivePart: throw the assignment away and repartition everything."""
    all_edges = np.concatenate([st.edges, np.asarray(new_edges)])
    t0 = time.perf_counter()
    owner = _STATIC[st.method](all_edges, st.n, st.P, st.seed)
    ut = time.perf_counter() - t0
    return PartitionState(all_edges, owner, st.n, st.P, st.method, st.seed), ut


def _loads(deg: np.ndarray, P: int, Cn: int) -> np.ndarray:
    return deg.astype(np.int64).reshape(P, Cn).sum(axis=1)


def block_loads(g) -> np.ndarray:
    """workerCompute load summary (W2M): valid neighbor slots per block,
    (P,) int64 on the host.

    Degree-sum is the superstep cost model of the block graph — every
    valid slot is one gathered value per superstep — so it is the balance
    the §4.2 threshold protocol acts on (node counts would miss hub
    skew)."""
    return _loads(g.deg.cpu().numpy(), g.P, g.Cn)


def block_balance(g) -> float:
    """Imbalance summary the §4.2 masterCompute thresholds: max/mean load."""
    load = block_loads(g)
    return float(load.max() / max(1.0, load.mean()))


def choose_node_moves(
    g,
    max_moves: int = 8,
    balance_slack: float = 1.05,
    pair_counts: Optional[np.ndarray] = None,
    objective: str = "halo",
) -> list:
    """masterCompute move selection for live rebalancing (§4.2).

    Greedy, deterministic: while some block's load exceeds
    `balance_slack x mean`, move one of its real nodes to an underloaded
    block with free node capacity.  Two candidate objectives:

      * ``"halo"`` (default) — halo-volume minimization: the primary
        score is the volume reduction aff[u][b2] - aff[u][b] (neighbors
        of u in the destination minus those in its own block); ties
        break toward the smallest residual halo degree deg[u] -
        aff[u][b2], then the heaviest node, the lowest id, and the
        destination first in `pair_counts` traffic order.
      * ``"load"`` — edge-cut gain, then heaviest node, lowest id,
        traffic-ordered destination.

    `pair_counts` (`graph.halo_pair_counts`) orders destination
    candidates by existing W2W traffic from the overloaded block.  A
    destination never goes past the slack line (a hub would ping-pong).

    Only *pre-existing* padding slots count as capacity (slots vacated by
    the chosen moves do not), matching `migrate_vertices`' contract.
    Returns a list of (node_id, dest_block) — possibly empty when no
    admissible move helps — equal to the JAX package's for the same graph.
    Each move scores every (node, destination) pair of the block at once:
    the keys are unique per pair (they end in the node id and the
    destination's rank), so the lexicographic maximum is the pair the
    JAX package's scan over nodes and destinations keeps.  A block's
    rows are read to the host, and its affinities counted, once a call.
    """
    if objective not in ("halo", "load"):
        raise ValueError(f"objective must be 'halo' or 'load', "
                         f"got {objective!r}")
    mask = g.node_mask.cpu().numpy()
    deg = g.deg.cpu().numpy().astype(np.int64)
    P, Cn = g.P, g.Cn
    load = _loads(deg, P, Cn)
    mean = max(1.0, float(load.mean()))
    free = (~mask).reshape(P, Cn).sum(axis=1)
    moves: list = []
    moved = np.zeros(g.N, bool)
    blocks: dict = {}  # b -> (real rows, affinities); the graph is fixed
    while len(moves) < max_moves:
        b = int(np.argmax(load))
        if load[b] <= balance_slack * mean:
            break
        dests = [b2 for b2 in range(P)
                 if b2 != b and free[b2] > 0 and load[b2] < mean]
        if not dests:
            break
        if pair_counts is not None:
            dests.sort(key=lambda b2: (-int(pair_counts[b, b2]), b2))
        if b not in blocks:
            blocks[b] = _affinities(g, b, mask)
        real, aff = blocks[b]
        d = np.asarray(dests)
        du = deg[real]
        # (node, destination) pairs the scan would score
        ok = ((~moved[real]) & (du > 0))[:, None] \
            & ~(load[d][None, :] + du[:, None] > balance_slack * mean)
        i, j = np.nonzero(ok)
        if not len(i):
            break
        gain = aff[i, d[j]] - aff[i, b]
        if objective == "halo":
            residual = du[i] - aff[i, d[j]]
            keys = (gain, -residual, du[i], -real[i], -j)
        else:
            keys = (gain, du[i], -real[i], -j)
        best = _lexmax(keys)
        u, b2 = int(real[i[best]]), int(d[j[best]])
        moves.append((u, b2))
        moved[u] = True
        load[b] -= deg[u]
        load[b2] += deg[u]
        free[b2] -= 1
    return moves


def _affinities(g, b: int, mask: np.ndarray):
    """(real rows of block b, aff) with aff[i, p] = neighbors of real[i]
    living in block p: one read of the block's rows, one bincount."""
    Cn = g.Cn
    rows = np.arange(b * Cn, (b + 1) * Cn)
    real = rows[mask[rows]]
    nb = g.nbr[b * Cn:(b + 1) * Cn].cpu().numpy()[mask[rows]]
    ri, si = np.nonzero(nb >= 0)
    aff = np.zeros((len(real), g.P), np.int64)
    np.add.at(aff, (ri, nb[ri, si] // Cn), 1)
    return real, aff


def _lexmax(keys) -> int:
    """Index of the lexicographic maximum of parallel key arrays, the
    first key most significant (ties on every key: the first index)."""
    idx = np.arange(len(keys[0]))
    for k in keys:
        k = k[idx]
        idx = idx[k == k.max()]
        if len(idx) == 1:
            break
    return int(idx[0])


def delete_edges(
    st: PartitionState,
    idx: np.ndarray,
    threshold: float = 1.5,
) -> Tuple[PartitionState, bool, float]:
    """Deletion protocol (§4.2): drop edges, workers report balance, the
    coordinator repartitions iff imbalance exceeds `threshold`.

    Returns (state', repartitioned?, update-time seconds).
    """
    t0 = time.perf_counter()
    keep = np.ones(len(st.edges), bool)
    keep[np.asarray(idx)] = False
    edges = st.edges[keep]
    owner = st.owner[keep]
    # workerCompute: per-block sizes (W2M); masterCompute: threshold test
    bal = P_.edge_balance(owner, st.P)
    repart = bal > threshold
    if repart:
        owner = _STATIC[st.method](edges, st.n, st.P, st.seed)
    ut = time.perf_counter() - t0
    return (
        PartitionState(edges, owner, st.n, st.P, st.method, st.seed),
        bool(repart),
        ut,
    )
