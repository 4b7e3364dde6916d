"""rgg: the random geometric graph of the 10th DIMACS Implementation
Challenge (``rgg_n_2_<scale>_s0``; the generator of Holtgrewe, Sanders and
Schulz, IPDPS 2010): 2^`scale` points uniform in the unit square, and an
edge between every two points whose Euclidean distance is below
r = `radius_factor` * sqrt(ln n / n).

The points are drawn in float64 on the generator's device and binned on a
grid whose cells have a side of at least r, so a point's neighbours lie in
its own cell and the eight around it.  Each cell is tested against itself
and its half-neighbourhood (east, north-west, north, north-east), so every
pair of cells is tested once; a pass takes the k-th point of every
neighbouring cell, so no pass holds more than one candidate a point.

The points are numbered in the order of the configuration's partition
(`bisection_order`): recursive coordinate bisection over log2(`blocks`)
levels, x, y, x, ..., each part split at its median.  Ids
``[b * n / blocks, (b + 1) * n / blocks)`` are then the points of block b,
a rectangle of the square, so a driver lays blocks out by id alone.
"""
import math

import torch

#: the half-neighbourhood of a cell, itself first: (dx, dy)
HALF = ((0, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def radius(n: int, factor: float) -> float:
    """The connection radius of `n` points: factor * sqrt(ln n / n)."""
    return factor * math.sqrt(math.log(n) / n)


def points(n: int, gen: torch.Generator) -> torch.Tensor:
    """(n, 2) float64 points uniform in the unit square, on `gen`'s
    device."""
    return torch.rand(n, 2, generator=gen, device=gen.device,
                      dtype=torch.float64)


def bisection_order(xy: torch.Tensor, levels: int) -> torch.Tensor:
    """The point at each id: recursive coordinate bisection of `xy` over
    `levels` levels, level l splitting every part of the level before at
    its median along axis l % 2.  Leaf b of the 2^levels is ids
    ``[b * n >> levels, (b + 1) * n >> levels)``, each leaf in the order of
    its last axis."""
    n = xy.shape[0]
    if n % (1 << levels):
        raise ValueError(f"{n} points do not split into {1 << levels} "
                         "equal blocks")
    order = torch.arange(n, device=xy.device)
    for level in range(levels):
        # each part of this level is sorted along its axis, so the next
        # level's halves of it are its two sides of the median
        parts = order.view(1 << level, -1)
        by = torch.argsort(xy[parts, level % 2], dim=1, stable=True)
        order = parts.gather(1, by).reshape(-1)
    return order


def levels_of(blocks: int) -> int:
    """log2(`blocks`); ValueError unless `blocks` is a power of two."""
    levels = blocks.bit_length() - 1
    if blocks < 1 or 1 << levels != blocks:
        raise ValueError(f"blocks {blocks} is not a power of two")
    return levels


def edges(config: dict, gen: torch.Generator) -> torch.Tensor:
    """The graph's undirected pairs over `vertices` = 2^`scale` points
    numbered in partition order, as sorted keys ``lo * n + hi``."""
    scale, n = int(config["scale"]), int(config["vertices"])
    if n != 1 << scale:
        raise ValueError(f"vertices {n} is not 2^scale = {1 << scale}")
    r = radius(n, float(config["radius_factor"]))
    xy = points(n, gen)
    xy = xy[bisection_order(xy, levels_of(int(config["blocks"])))]
    side = max(1, int(1.0 / r))            # cells a side, each >= r wide
    c = (xy * side).long().clamp_(max=side - 1)
    cx, cy = c[:, 0], c[:, 1]
    cell = cy * side + cx
    by_cell = torch.argsort(cell, stable=True)
    count = torch.bincount(cell, minlength=side * side)
    start = torch.cumsum(count, 0) - count
    most = int(count.max())
    found = []
    for dx, dy in HALF:
        nx, ny = cx + dx, cy + dy
        a = torch.nonzero((nx >= 0) & (nx < side) & (ny < side))[:, 0]
        other = ny[a] * side + nx[a]
        for k in range(most):
            has = count[other] > k
            a, other = a[has], other[has]
            b = by_cell[start[other] + k]
            keep = (xy[a] - xy[b]).square().sum(1) < r * r
            if (dx, dy) == (0, 0):
                keep &= b > a              # each pair of a cell once
            lo, hi = torch.minimum(a, b)[keep], torch.maximum(a, b)[keep]
            found.append(lo * n + hi)
    return torch.sort(torch.cat(found)).values
