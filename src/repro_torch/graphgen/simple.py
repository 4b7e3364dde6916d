"""Simple reference generators: ER, BA, and grid-like (roadNet-shaped)."""
from __future__ import annotations

import numpy as np


def erdos_renyi(n: int, m: int, seed: int = 0) -> np.ndarray:
    """G(n, m): m distinct uniform edges (no loops).

    Vectorized rejection sampling: draw endpoint batches sized to the
    remaining deficit, key each undirected pair as lo*n+hi, np.unique
    the accumulated keys, and top up until m distinct edges exist; a
    final permutation picks the m returned.  A numpy copy of the JAX
    package's generator: the same seed gives the same edges.
    """
    if n < 2:
        raise ValueError(f"erdos_renyi needs n >= 2, got {n}")
    if m > n * (n - 1) // 2:
        raise ValueError(f"m={m} exceeds the {n * (n - 1) // 2} distinct "
                         f"pairs on n={n} nodes")
    rng = np.random.default_rng(seed)
    keys = np.empty(0, np.int64)
    while keys.size < m:
        batch = max(2 * (m - keys.size) + 16, 256)
        a = rng.integers(0, n, size=batch)
        b = rng.integers(0, n, size=batch)
        ok = a != b
        lo = np.minimum(a, b)[ok].astype(np.int64)
        hi = np.maximum(a, b)[ok].astype(np.int64)
        keys = np.unique(np.concatenate([keys, lo * n + hi]))
    keys = rng.permutation(keys)[:m]
    return np.stack([keys // n, keys % n], 1)


def barabasi_albert(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Preferential attachment, k edges per new node.

    Vectorized Batagelj-Brandes: the sequential algorithm appends both
    endpoints of every accepted edge to a "repeated nodes" array and
    picks each new target uniformly from it (a node's slot count IS its
    degree — that is preferential attachment).  Here the array is never
    materialized sequentially: lay out the endpoint sequence as
    k seed slots + (source, target) pairs, draw every target's slot
    index r_t uniformly over the prefix [0, k + 2t) up front, then
    resolve targets with iterated gathers — a slot that lands on an
    earlier *target* slot chases that slot's own draw (indices strictly
    decrease, so expected O(log nk) full-vector rounds), while seed and
    source slots resolve to known node ids immediately.  Self-loops and
    duplicate pairs are dropped afterwards, matching the old
    generator's simple-graph contract: hubs at early node ids, max
    degree ~k*sqrt(n), mean just under 2k.  A numpy copy of the JAX
    package's generator: the same seed gives the same edges.
    """
    if not 0 < k < n:
        raise ValueError(f"barabasi_albert needs 0 < k < n, got {k=} {n=}")
    rng = np.random.default_rng(seed)
    M = (n - k) * k  # k attachments per node after the k seed nodes
    t = np.arange(M, dtype=np.int64)
    src = k + t // k
    r = rng.integers(0, k + 2 * t)  # target slot: uniform over the prefix
    p = r.copy()
    while True:
        odd = (p >= k) & ((p - k) % 2 == 1)  # landed on a target slot
        if not odd.any():
            break
        p[odd] = r[(p[odd] - k - 1) // 2]
    tgt = np.where(p < k, p, src[np.maximum(p - k, 0) // 2])
    lo = np.minimum(src, tgt)
    hi = np.maximum(src, tgt)
    e = np.stack([lo, hi], 1)[lo != hi]
    return np.unique(e, axis=0)


def grid_like(n: int, seed: int = 0, diag_frac: float = 0.05) -> np.ndarray:
    """Planar-ish lattice with sparse diagonals — roadNet shape: huge
    diameter, tiny clustering, max degree ~4."""
    side = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    idx = (xs * side + ys).reshape(-1)
    keep = idx < n
    edges = []
    right = (xs * side + (ys + 1)).reshape(-1)
    ok = (ys + 1 < side).reshape(-1) & keep & (right < n)
    edges.append(np.stack([idx[ok], right[ok]], 1))
    down = ((xs + 1) * side + ys).reshape(-1)
    ok = (xs + 1 < side).reshape(-1) & keep & (down < n)
    edges.append(np.stack([idx[ok], down[ok]], 1))
    e = np.concatenate(edges)
    # sparse random diagonals
    extra = int(diag_frac * len(e))
    if extra:
        a = rng.integers(0, n, size=extra)
        b = np.clip(a + side + 1, 0, n - 1)
        ok = a != b
        e = np.concatenate([e, np.stack([a[ok], b[ok]], 1)])
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    return np.unique(np.stack([lo, hi], 1), axis=0)
