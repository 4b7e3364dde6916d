"""The stream_cc driver: the local_stream driver's spatially local churn
through `StreamSession`, with connected-component labels kept exact after
every window.

The pool and the closed loop are the local_stream driver's
(`sample_local_pool`; windows of R updates back to back, each timed from
the call of `apply_window` to a device sync after it), and so is the
layout (`lay_out_by_id`: blocks by id, rows permuted inside each block by
the run's seed) but for one row: the generator's first point keeps id 0
(`least_id_kept`; the point of least x in block 0, by the generator's
numbering).  Min-label propagation runs as many supersteps as the
least id's eccentricity in its component, so where the seed put that
point moved a recompute's depth with it, by a fifth between two seeds at
2^23 (1,733 and 2,086 supersteps); with the point fixed every seed
measures the same depth of the same graph.

The session opens with ``cc_labels`` the labels `connected_components`
gives the graph at open (counted in set-up, a mark of its own), so every
window ends with the labels equal to a recompute on the post-window
graph: a window with a delete recomputes them, an insert-only window
merges them.  Besides the local_stream driver's counters the run records
the session's `cc_recomputes` and `cc_merges` (`StreamStats`) and its
`cc_steps` (the recomputes' supersteps) where the program keeps that
count.

Nearly no update of the timed traffic changes a component (an insert
joins two nodes that share a neighbour, and a delete among 63.5M edges
almost never cuts a bridge), so the labels at the window's end equal
those at open, stale or not.  After the measured window the run
therefore applies two more windows through the same session, untimed
and judged (`probe_windows`): one that deletes every edge of a node of
least degree that the applied traffic never touched (its component
splits: the recompute), then one that inserts an edge from that node to
the least id more than two hops from it (two components join: the
merge).  The labels after each of them are outputs.

The judgement is the stream driver's three numbers on the final graph
and coreness, and `label_diff`: over the labels after each probe window,
nodes whose label differs from the plain reference's components (hooking
and pointer jumping) of the edge list replayed to that window's end,
each labelled with its component's least id.  The control is the
reference with each probe window acknowledged and not applied: its
graph and coreness lack the last one, its labels after each probe window
are those from before it.

Configuration keys: the local_stream driver's.  Traffic keys: the
local_stream driver's, and ``label_diff`` among the ``limits``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from portbench import reference
from portbench.harness import compare, graphs, outcome, pool as pool_mod
from portbench.harness import spec
from portbench.harness.outcome import Outcome
from portbench.harness.record import RunRecord
from portbench.harness.trace import Tracer

#: the local_stream driver, whose layout, pool and counters this one
#: uses, and through it the stream driver, whose judgement and reference
#: it extends
_local = spec.load_driver("local_stream", Path(__file__).resolve().parents[2])
_stream = _local._stream


def least_id_kept(lay: graphs.Layout) -> graphs.Layout:
    """`lay` with the rows of id 0 and of the generator's first point
    (original id 0, in block 0 like id 0) swapped, so that point keeps
    id 0."""
    N = lay.N
    j = int(torch.nonzero(lay.orig_id == 0)[0, 0])
    swap = torch.arange(N, device=lay.keys.device)
    swap[0], swap[j] = j, 0
    a, b = swap[lay.keys // N], swap[lay.keys % N]
    keys = torch.sort(torch.minimum(a, b) * N + torch.maximum(a, b)).values
    return graphs.Layout(n=lay.n, N=N, P=lay.P, Cn=lay.Cn, Cd=lay.Cd,
                         pop=lay.pop, keys=keys, node_mask=lay.node_mask,
                         orig_id=lay.orig_id[swap])


def probe_windows(g, untouched: torch.Tensor, R: int
                  ) -> List[List[Tuple[int, int, int]]]:
    """The judged windows after the measured one, on the session's graph
    `g`: the deletes of every edge of `x`, the node of least nonzero
    degree among the real rows in `untouched` (R deletes a window), then
    one window that inserts (x, y), `y` the least real id with room in
    its row that is neither `x` nor within two hops of it.  A node the
    traffic never touched keeps every pair of the probe out of the
    replayed updates, which replay once each."""
    deg = g.deg.long()
    live = g.node_mask & untouched & (deg > 0)
    x = int(torch.argmin(torch.where(live, deg, deg.max() + 1)))
    if not bool(live[x]):
        raise ValueError("every node with an edge was touched by the "
                         "traffic: no node to isolate")
    near = g.nbr[x, :int(deg[x])].long()
    two = g.nbr[near].long()
    two = two[torch.arange(g.Cd, device=two.device) < deg[near, None]]
    free = g.node_mask & (deg < g.Cd)
    free[torch.cat([near, two, near.new_tensor([x])])] = False
    y = int(torch.nonzero(free)[0, 0])
    ids = near.tolist()
    return ([[(x, v, -1) for v in ids[i:i + R]]
             for i in range(0, len(ids), R)] + [[(x, y, 1)]])


def _counters(sess) -> Dict[str, float]:
    c = _local._counters(sess)
    st = sess.stats()
    c.update(cc_recomputes=st.cc_recomputes, cc_merges=st.cc_merges)
    # a program without the count has no such attribute
    steps = getattr(sess, "cc_steps", None)
    if steps is not None:
        c["cc_steps"] = steps
    return c


def run(cell, seed: int, seconds: float, tracer: Tracer, device,
        started: float) -> Outcome:
    from repro_torch.core import algorithms, kcore
    from repro_torch.core.graph import GraphBlocks
    from repro_torch.runtime import stream as stream_mod

    conf, traffic, R = cell.config, cell.traffic, int(cell.traffic["window"])
    marks = {"imports": time.perf_counter() - started}
    gen = torch.Generator(device=device).manual_seed(seed)
    graph_gen = torch.Generator(device=device).manual_seed(
        int(conf["graph_seed"]))
    n = int(conf["vertices"])
    lay = least_id_kept(_local.lay_out_by_id(
        graphs.make_edges(conf, graph_gen, cell.root), n,
        int(conf["blocks"]), int(conf["degree_capacity"]), gen))
    nbr, deg = graphs.ell_rows(lay.keys, lay.N, lay.Cd)
    pool = _local.sample_local_pool(lay, nbr, deg, int(traffic["pool"]),
                                    traffic["mix"], gen)
    need = int((deg.long() + pool_mod.insert_load(pool, lay.N)).max())
    sizes = dict(n=lay.n, N=lay.N, m=lay.keys.numel(), Cd=lay.Cd, P=lay.P,
                 max_deg=int(deg.max()), sum_deg=int(deg.sum()), need=need)
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
    core = kcore.coreness(g)
    outcome.sync(device)
    marks["coreness"] = time.perf_counter() - started
    labels = algorithms.connected_components(g)
    outcome.sync(device)
    marks["labels"] = time.perf_counter() - started
    sess = stream_mod.StreamSession(g, core, R=R, cc_labels=labels)
    del g, core, labels
    outcome.sync(device)
    marks["session"] = time.perf_counter() - started
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
    applied = inputs["pool"][:nxt * R]
    untouched = torch.ones(inputs["N"], dtype=torch.bool, device=device)
    untouched[applied[:, :2].reshape(-1).to(device)] = False
    probe = probe_windows(sess.g, untouched, R)
    labels_at, bounds = [], [applied.shape[0]]
    for w in probe:
        sess.apply_window(w)
        outcome.sync(device)
        labels_at.append(sess.labels.clone())
        bounds.append(bounds[-1] + len(w))
    keys, nslots = compare.slots(sess.g.nbr)
    outputs = dict(slots=keys, nslots=nslots, deg=sess.g.deg.clone(),
                   core=sess.core.clone(), labels=labels_at.pop())
    outputs["labels_at"] = labels_at
    inputs["pool"] = torch.cat([applied, torch.tensor(
        [u for w in probe for u in w], dtype=applied.dtype)])
    inputs["applied"], inputs["probe_bounds"] = bounds[-1], bounds
    return Outcome(record=record, attempted=len(unit_ms) * R,
                   memory_peak_bytes=peak, outputs=outputs, inputs=inputs)


def _labels(inputs: dict, upto: int, device) -> torch.Tensor:
    """The reference's components of the edge list replayed to update
    `upto`, each node labelled with its component's least id."""
    N = inputs["N"]
    keys = reference.replay(inputs["keys"].to(device),
                            inputs["pool"][:upto].to(device), N)
    return reference.component_labels(keys, N,
                                      inputs["node_mask"].to(device))


def reference_outputs(inputs: dict, device, drop_last: bool = False) -> dict:
    """The stream driver's reference outputs on the final graph, the
    components at its end (`labels`) and at the end of each earlier
    probe window (`labels_at`).  `drop_last` leaves every probe window
    out of the labels after it, and the last one out of the graph."""
    bounds = inputs["probe_bounds"]
    starts, ends = bounds[:-1], bounds[1:]
    at = starts if drop_last else ends
    ref = _stream.reference_outputs(inputs, device, 1 if drop_last else 0,
                                    ends[-1] - starts[-1])
    ref["labels"] = _labels(inputs, at[-1], device)
    ref["labels_at"] = [_labels(inputs, u, device) for u in at[:-1]]
    return ref


def judge(outputs: dict, inputs: dict, traffic: dict, device,
          ref: dict = None) -> Dict[str, float]:
    """The stream driver's numbers (`edge_diff`, `degree_diff`,
    `core_diff`) and the nodes whose component label differs after each
    probe window, summed (`label_diff`)."""
    if ref is None:
        ref = reference_outputs(inputs, device)
    numbers = _stream.judge(
        {k: v for k, v in outputs.items() if k != "labels_at"}, inputs,
        traffic, device, ref=ref)
    pairs = ([(outputs["labels"], ref["labels"])]
             + list(zip(outputs["labels_at"], ref["labels_at"])))
    numbers["label_diff"] = sum(compare.count_diff(o.to(device), r)
                                for o, r in pairs)
    return numbers


def control(inputs: dict, traffic: dict, device) -> dict:
    """The control in the program's place: the reference with each probe
    window acknowledged and not applied (its labels after a probe window
    those from before it; its graph without the last)."""
    return reference_outputs(inputs, device, drop_last=True)
