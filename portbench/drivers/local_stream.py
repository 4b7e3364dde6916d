"""The local_stream driver: spatially local updates through
`StreamSession` on a graph whose blocks are cut by position.

The configuration's generator numbers its points so that ids
``[b * Cn, (b + 1) * Cn)`` lie in block b (`generators/rgg.py`: recursive
coordinate bisection), so the layout takes the blocks by id, with no
coordinates, and the run's seed permutes the rows inside each block at
random (`lay_out_by_id`), as the other configurations relabel.

The pool (`sample_local_pool`) is a spatial network's churn: deletes of
present edges drawn uniformly, and inserts of absent pairs two hops apart
(a uniform edge (u, w), then a uniform neighbour v of w with v != u and v
not adjacent to u: triadic closure), in the shares of the traffic's
``mix``, no pair twice, shuffled.  Whether an update joins two blocks is
not drawn: it falls out of the geometry.

Closed loop as the stream driver runs it: windows of R updates back to
back, each timed from the call of `apply_window` to a device sync after
it.  The judgement, the reference and the control are the stream
driver's.  Besides its counters the run records the session's
`local_candidates` (the candidates of its joint block-local recomputes)
where the program keeps that count.

Configuration keys: ``generator``, ``vertices``, ``blocks``,
``degree_capacity``, ``graph_seed`` and the generator's own.  Traffic
keys: ``window`` (R), ``pool``, ``mix`` (shares of ``delete`` and
``insert_two_hop``), ``warmup_windows``, ``limits``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

from portbench.harness import compare, graphs, outcome, pool as pool_mod
from portbench.harness import spec
from portbench.harness.outcome import Outcome
from portbench.harness.record import RunRecord
from portbench.harness.trace import Tracer

#: the stream driver, whose counters, reference, judgement and control
#: this one uses
_stream = spec.load_driver("stream", Path(__file__).resolve().parents[2])

#: the pool's two classes
MIX = ("delete", "insert_two_hop")


def lay_out_by_id(keys: torch.Tensor, n: int, P: int, Cd: int,
                  gen: torch.Generator) -> graphs.Layout:
    """Blocks of ``n / P`` consecutive original ids, the rows inside each
    permuted at random by `gen`; `keys` (original ids) become keys over
    the new ids.  No padding rows."""
    if n % P:
        raise ValueError(f"{n} nodes do not fill {P} equal blocks")
    dev, Cn = keys.device, n // P
    ids = torch.arange(n, device=dev)
    # the original id at each new id: blocks kept, order inside drawn
    orig = torch.argsort((ids // Cn) * n
                         + torch.randperm(n, generator=gen, device=dev))
    new_of_old = torch.empty_like(orig)
    new_of_old[orig] = ids
    a, b = new_of_old[keys // n], new_of_old[keys % n]
    keys = torch.sort(torch.minimum(a, b) * n + torch.maximum(a, b)).values
    return graphs.Layout(n=n, N=n, P=P, Cn=Cn, Cd=Cd,
                         pop=torch.full((P,), Cn, device=dev),
                         keys=keys,
                         node_mask=torch.ones(n, dtype=torch.bool,
                                              device=dev),
                         orig_id=orig)


def _two_hop_inserts(keys: torch.Tensor, nbr: torch.Tensor,
                     deg: torch.Tensor, N: int, k: int,
                     gen: torch.Generator) -> torch.Tensor:
    """`k` distinct keys of absent pairs (u, v) with a common neighbour w:
    a uniform edge, a uniform orientation (u, w) of it, a uniform
    neighbour v of w."""
    dev, m = keys.device, keys.numel()
    draw = 4 * k + 64
    while True:
        e = keys[torch.randint(0, m, (draw,), generator=gen, device=dev)]
        flip = torch.randint(0, 2, (draw,), generator=gen,
                             device=dev).bool()
        u = torch.where(flip, e % N, e // N)
        w = torch.where(flip, e // N, e % N)
        j = (torch.rand(draw, generator=gen, device=dev, dtype=torch.float64)
             * deg[w]).long()
        v = nbr[w, j].long()
        key = torch.minimum(u, v) * N + torch.maximum(u, v)
        key = key[(u != v) & ~torch.isin(key, keys)]
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


def sample_local_pool(lay: graphs.Layout, nbr: torch.Tensor,
                      deg: torch.Tensor, size: int, mix: Dict[str, float],
                      gen: torch.Generator) -> torch.Tensor:
    """(size, 3) int64 updates ``(u, v, op)`` over the layout's ids:
    uniform deletes of present edges and two-hop inserts of absent pairs
    in the shares of `mix`, no pair twice, shuffled.  Every order of the
    pool is valid."""
    if set(mix) != set(MIX):
        raise ValueError(f"mix {sorted(mix)} is not of {sorted(MIX)}")
    k_del = int(size * float(mix["delete"]))
    k_ins = size - k_del
    dev, N = lay.keys.device, lay.N
    if lay.keys.numel() < k_del:
        raise ValueError(f"only {lay.keys.numel()} edges to delete, need "
                         f"{k_del}")
    dels = lay.keys[torch.randperm(lay.keys.numel(), generator=gen,
                                   device=dev)[:k_del]]
    ins = _two_hop_inserts(lay.keys, nbr, deg, N, k_ins, gen)
    parts = [torch.stack([k // N, k % N, torch.full_like(k, op)], 1)
             for k, op in ((dels, -1), (ins, 1))]
    pool = torch.cat(parts)
    return pool[torch.randperm(pool.shape[0], generator=gen, device=dev)]


def _counters(sess) -> Dict[str, float]:
    c = _stream._counters(sess.stats())
    # a program without the count has no such attribute
    local = getattr(sess, "local_candidates", None)
    if local is not None:
        c["local_candidates"] = local
    return c


def run(cell, seed: int, seconds: float, tracer: Tracer, device,
        started: float) -> Outcome:
    from repro_torch.core import kcore
    from repro_torch.core.graph import GraphBlocks
    from repro_torch.runtime import stream as stream_mod

    conf, traffic, R = cell.config, cell.traffic, int(cell.traffic["window"])
    marks = {"imports": time.perf_counter() - started}
    gen = torch.Generator(device=device).manual_seed(seed)
    graph_gen = torch.Generator(device=device).manual_seed(
        int(conf["graph_seed"]))
    n = int(conf["vertices"])
    lay = lay_out_by_id(graphs.make_edges(conf, graph_gen, cell.root), n,
                        int(conf["blocks"]), int(conf["degree_capacity"]),
                        gen)
    nbr, deg = graphs.ell_rows(lay.keys, lay.N, lay.Cd)
    pool = sample_local_pool(lay, nbr, deg, int(traffic["pool"]),
                             traffic["mix"], gen)
    need = int((deg.long() + pool_mod.insert_load(pool, lay.N)).max())
    sizes = dict(n=lay.n, N=lay.N, m=lay.keys.numel(), Cd=lay.Cd, P=lay.P,
                 max_deg=int(deg.max()), need=need)
    print(f"portbench: {cell.config_name} graph: {sizes}", file=sys.stderr)
    if need > lay.Cd:
        raise ValueError(f"the pool's inserts need Cd >= {need}, the "
                         f"configuration gives {lay.Cd}")
    g = GraphBlocks(nbr=nbr, deg=deg, node_mask=lay.node_mask.clone(),
                    orig_id=lay.orig_id.to(torch.int32), P=lay.P, Cn=lay.Cn,
                    Cd=lay.Cd)
    inputs = dict(keys=lay.keys.cpu(), pool=pool.cpu(), N=lay.N,
                  node_mask=lay.node_mask.cpu())
    del lay, nbr, deg
    windows = [[tuple(u) for u in pool[i:i + R].tolist()]
               for i in range(0, pool.shape[0] - R + 1, R)]
    del pool

    marks["graph and pool"] = time.perf_counter() - started
    sess = stream_mod.StreamSession(g, kcore.coreness(g), R=R)
    del g
    outcome.sync(device)
    marks["coreness and session"] = time.perf_counter() - started
    nxt = 0

    def next_window():
        nonlocal nxt
        sess.apply_window(windows[nxt])
        outcome.sync(device)
        nxt += 1

    for _ in range(int(traffic["warmup_windows"])):
        next_window()
    marks["warm-up windows"] = time.perf_counter() - started
    outcome.reset_peak(device)

    unit_ms: List[float] = []
    with tracer.window(warm=next_window):
        before = _counters(sess)
        t_start = time.perf_counter()
        setup_s = t_start - started
        while nxt < len(windows):
            t0 = time.perf_counter()
            with tracer.span("apply_window"):
                next_window()
            t1 = time.perf_counter()
            unit_ms.append((t1 - t0) * 1e3)
            if t1 - t_start >= seconds:
                break
    window_s = t1 - t_start
    peak = outcome.peak_bytes(device)
    after = _counters(sess)
    counters = {k: v - before[k] for k, v in after.items()}
    record = RunRecord(cell=cell.name, device_kind=outcome.device_kind(device),
                       setup_s=setup_s, window_s=window_s,
                       units=int(counters["updates"]), unit_ms=unit_ms,
                       counters=counters, sizes=sizes, trace=tracer.trace,
                       setup_marks=marks)
    keys, nslots = compare.slots(sess.g.nbr)
    outputs = dict(slots=keys, nslots=nslots, deg=sess.g.deg.clone(),
                   core=sess.core.clone())
    inputs["applied"] = nxt * R
    return Outcome(record=record, attempted=len(unit_ms) * R,
                   memory_peak_bytes=peak, outputs=outputs, inputs=inputs)


#: the stream driver's numbers (`edge_diff`, `degree_diff`, `core_diff`)
#: and its control (the reference with one window acknowledged and not
#: applied)
judge = _stream.judge
control = _stream.control
