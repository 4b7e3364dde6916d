"""The graph of a configuration and the block layout, on the device, from
a seed: what every driver shares.

A configuration file names its generator (`"generator"`, found as
``portbench/generators/<generator>.py`` by `spec.load_generator`), its
sizes and its `graph_seed`; `make_layout` draws the graph's undirected
edge list on the device from that constant, as GAP draws each of its
graphs from one fixed seed, so that every run measures the same graph.
The run's own seed relabels the nodes by a random permutation and deals
them into blocks.

The layout is the paper's random node partitioning over `blocks` blocks:
a random permutation deals the nodes round-robin into the blocks, which
are laid out block-contiguously (block `b` owns padded ids
``[b*Cn, (b+1)*Cn)``, the first ``pop[b]`` of them real, in the order of
their original ids).  Edges are
returned as sorted undirected keys ``lo * N + hi`` over padded ids.
How a driver hands the graph to the program is the driver's: `ell_rows`
gives the unsplit ELL rows.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from . import spec


@dataclasses.dataclass
class Layout:
    """A graph in padded ids, as the benchmark made it."""

    n: int                 # real nodes
    N: int                 # padded nodes (P * Cn)
    P: int
    Cn: int
    Cd: int
    pop: torch.Tensor      # (P,) int64 real nodes of each block
    keys: torch.Tensor     # (m,) int64 sorted undirected keys lo*N + hi
    node_mask: torch.Tensor  # (N,) bool
    orig_id: torch.Tensor  # (N,) int64, -1 on padding rows


def make_edges(config: dict, gen: torch.Generator,
               root: Path = spec.ROOT) -> torch.Tensor:
    """Sorted undirected keys over original ids for `config`, from the
    generator its `"generator"` names under `root`."""
    return spec.load_generator(config["generator"], root).edges(config, gen)


def lay_out(keys: torch.Tensor, n: int, P: int, Cd: int,
            gen: torch.Generator) -> Layout:
    """Random node partitioning into `P` balanced blocks, relabelled
    block-contiguously; `keys` (original ids) become padded-id keys."""
    dev = keys.device
    Cn = -(-n // P)              # ceil(n / P) real rows at most ...
    Cn = -(-Cn // 8) * 8         # ... padded to a multiple of 8
    N = P * Cn
    ids = torch.arange(n, device=dev)
    block = torch.empty(n, dtype=torch.int64, device=dev)
    block[torch.randperm(n, generator=gen, device=dev)] = ids % P
    # inside a block, nodes keep their original order (as the program's
    # own `build_blocks` lays them out)
    order = torch.argsort(block * n + ids)
    pop = torch.bincount(block, minlength=P)
    begin = torch.cumsum(pop, 0) - pop
    new_of_old = torch.empty(n, dtype=torch.int64, device=dev)
    new_of_old[order] = block[order] * Cn + ids - begin[block[order]]
    a, b = new_of_old[keys // n], new_of_old[keys % n]
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    node_mask = torch.zeros(N, dtype=torch.bool, device=dev)
    node_mask[new_of_old] = True
    orig_id = torch.full((N,), -1, dtype=torch.int64, device=dev)
    orig_id[new_of_old] = torch.arange(n, device=dev)
    return Layout(n=n, N=N, P=P, Cn=Cn, Cd=Cd, pop=pop,
                  keys=torch.sort(lo * N + hi).values,
                  node_mask=node_mask, orig_id=orig_id)


def relabel(keys: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """The same graph with its `n` node ids permuted at random: sorted
    undirected keys ``lo * n + hi``."""
    perm = torch.randperm(n, generator=gen, device=keys.device)
    a, b = perm[keys // n], perm[keys % n]
    return torch.sort(torch.minimum(a, b) * n + torch.maximum(a, b)).values


def make_layout(config: dict, gen: torch.Generator,
                root: Path = spec.ROOT) -> Layout:
    """The configuration's graph, drawn from its `graph_seed` by its
    generator under `root`, relabelled and partitioned by `gen`, the run's
    seed."""
    n = int(config["vertices"])
    graph_gen = torch.Generator(device=gen.device).manual_seed(
        int(config["graph_seed"]))
    keys = relabel(make_edges(config, graph_gen, root), n, gen)
    return lay_out(keys, n, int(config["blocks"]),
                   int(config["degree_capacity"]), gen)


def ell_rows(keys: torch.Tensor, N: int, Cd: int):
    """Sorted ELL rows of the undirected `keys` over `N` padded nodes:
    (nbr (N, Cd) int32, -1 padded on the right, deg (N,) int32).  Raises
    if a row needs more than `Cd` slots."""
    dev = keys.device
    lo, hi = keys // N, keys % N
    directed = torch.sort(torch.cat([lo * N + hi, hi * N + lo])).values
    src, dst = directed // N, directed % N
    deg = torch.bincount(src, minlength=N)
    if int(deg.max()) > Cd:
        raise ValueError(f"max degree {int(deg.max())} exceeds Cd={Cd}")
    start = torch.cumsum(deg, 0) - deg
    pos = torch.arange(src.numel(), device=dev) - start[src]
    nbr = torch.full((N, Cd), -1, dtype=torch.int32, device=dev)
    nbr[src, pos] = dst.to(torch.int32)
    return nbr, deg.to(torch.int32)
