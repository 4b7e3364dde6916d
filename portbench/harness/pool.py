"""The update pool of a stream cell, drawn on the device from the seed.

The paper's §5.2.1 protocol as one mixed stream: inserts of non-adjacent
pairs and deletes of existing edges, each either inside one block
("intra") or across two ("inter"), in the shares the traffic file gives,
shuffled together.  No pair occurs twice in the pool, so every order of
it is valid: an insert's pair is absent until it is applied, a delete's
edge present until it is.
"""
from __future__ import annotations

from typing import Dict

import torch

from .graphs import Layout

#: the mix's four classes: (op, same block?)
CLASSES = {"insert_intra": (1, True), "insert_inter": (1, False),
           "delete_intra": (-1, True), "delete_inter": (-1, False)}


def class_counts(size: int, mix: Dict[str, float]) -> Dict[str, int]:
    """Updates of each class in a pool of `size` (rounded down, the rest
    to the first classes in `CLASSES` order)."""
    if set(mix) - set(CLASSES):
        raise ValueError(f"unknown classes {sorted(set(mix) - set(CLASSES))}")
    counts = {c: int(size * float(mix.get(c, 0.0))) for c in CLASSES}
    for c in CLASSES:
        if sum(counts.values()) >= size:
            break
        if mix.get(c, 0.0) > 0:
            counts[c] += 1
    return counts


def _deletes(lay: Layout, k: int, intra: bool, gen) -> torch.Tensor:
    lo, hi = lay.keys // lay.N, lay.keys % lay.N
    idx = torch.nonzero(((lo // lay.Cn) == (hi // lay.Cn)) == intra)[:, 0]
    if idx.numel() < k:
        raise ValueError(f"only {idx.numel()} edges to delete, need {k}")
    pick = torch.randperm(idx.numel(), generator=gen,
                          device=idx.device)[:k]
    return lay.keys[idx[pick]]


def _random_node(block: torch.Tensor, lay: Layout, gen) -> torch.Tensor:
    """A uniform real node of each block in `block`."""
    u = torch.rand(block.shape, generator=gen, device=block.device,
                   dtype=torch.float64)
    return block * lay.Cn + (u * lay.pop[block]).long()


def _inserts(lay: Layout, k: int, intra: bool, gen,
             taken: torch.Tensor) -> torch.Tensor:
    """`k` distinct keys of absent pairs, none in `taken`."""
    dev = lay.keys.device
    P = lay.P
    draw = 2 * k + 64
    while True:
        b1 = torch.randint(0, P, (draw,), generator=gen, device=dev)
        shift = torch.randint(1, max(P, 2), (draw,), generator=gen,
                              device=dev)
        b2 = b1 if intra else (b1 + shift) % P
        a, b = _random_node(b1, lay, gen), _random_node(b2, lay, gen)
        key = torch.minimum(a, b) * lay.N + torch.maximum(a, b)
        ok = (a != b) & ~torch.isin(key, lay.keys) & ~torch.isin(key, taken)
        key = key[ok]
        # first occurrence of each key, in draw order
        uniq, inv = torch.unique(key, return_inverse=True)
        first = torch.full((uniq.numel(),), key.numel(), device=dev,
                           dtype=torch.int64)
        first.scatter_reduce_(0, inv, torch.arange(key.numel(), device=dev),
                              "amin")
        key = key[torch.sort(first).values]
        if key.numel() >= k:
            return key[:k]
        draw *= 2


def sample_pool(lay: Layout, size: int, mix: Dict[str, float],
                gen: torch.Generator) -> torch.Tensor:
    """(size, 3) int64 updates ``(u, v, op)`` over padded ids, shuffled."""
    parts = []
    taken = torch.empty(0, dtype=torch.int64, device=lay.keys.device)
    for c, k in class_counts(size, mix).items():
        op, intra = CLASSES[c]
        if k == 0:
            continue
        if op > 0:
            keys = _inserts(lay, k, intra, gen, taken)
            taken = torch.cat([taken, keys])
        else:
            keys = _deletes(lay, k, intra, gen)
        parts.append(torch.stack([keys // lay.N, keys % lay.N,
                                  torch.full_like(keys, op)], 1))
    pool = torch.cat(parts)
    return pool[torch.randperm(pool.shape[0], generator=gen,
                               device=pool.device)]


def insert_load(pool: torch.Tensor, N: int) -> torch.Tensor:
    """(N,) count of pool inserts touching each node: a row's degree can
    rise by at most this much over the stream."""
    ins = pool[pool[:, 2] > 0]
    return torch.bincount(ins[:, :2].reshape(-1), minlength=N)
