"""The stream driver: windows of updates through `StreamSession`.

Closed loop: windows of R updates from a pool drawn in set-up go back to
back, each timed from the call of `apply_window` to a device sync after
it, so every window ends with coreness exact and nothing queued.  The
program sees the graph and the updates only; the pool, the edge list and
the reference's inputs stay with the benchmark.

Traffic keys: ``window`` (R), ``pool`` (updates drawn), ``mix`` (shares
of the four classes of `pool.CLASSES`), ``warmup_windows``, ``limits``.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench import reference
from portbench.harness import compare, graphs, outcome, pool as pool_mod
from portbench.harness.outcome import Outcome
from portbench.harness.record import RunRecord
from portbench.harness.trace import Tracer


def _counters(stats) -> Dict[str, float]:
    return dict(updates=stats.updates, windows=stats.batches,
                escalated=stats.escalated, block_local=stats.block_local,
                bfs_steps=stats.bfs_steps,
                recompute_steps=stats.recompute_steps)


def run(cell, seed: int, seconds: float, tracer: Tracer, device,
        started: float) -> Outcome:
    from repro_torch.core import kcore
    from repro_torch.core.graph import GraphBlocks
    from repro_torch.runtime import stream as stream_mod

    traffic, R = cell.traffic, int(cell.traffic["window"])
    marks = {"imports": time.perf_counter() - started}
    gen = torch.Generator(device=device).manual_seed(seed)
    lay = graphs.make_layout(cell.config, gen, cell.root)
    pool = pool_mod.sample_pool(lay, int(traffic["pool"]), traffic["mix"],
                                gen)
    nbr, deg = graphs.ell_rows(lay.keys, lay.N, lay.Cd)
    need = int((deg.long() + pool_mod.insert_load(pool, lay.N)).max())
    if need > lay.Cd:
        raise ValueError(f"the pool's inserts need Cd >= {need}, the "
                         f"configuration gives {lay.Cd}")
    g = GraphBlocks(nbr=nbr, deg=deg, node_mask=lay.node_mask.clone(),
                    orig_id=lay.orig_id.to(torch.int32), P=lay.P, Cn=lay.Cn,
                    Cd=lay.Cd)
    inputs = dict(keys=lay.keys.cpu(), pool=pool.cpu(), N=lay.N,
                  node_mask=lay.node_mask.cpu())
    sizes = dict(n=lay.n, N=lay.N, m=lay.keys.numel(), Cd=lay.Cd, P=lay.P)
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
        before = sess.stats()
        t_start = time.perf_counter()
        setup_s = t_start - started
        # the window closes at `seconds`, or early where the pool runs out
        # (the rate stays all the work over all the time)
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
    after = sess.stats()
    counters = {k: v - _counters(before)[k]
                for k, v in _counters(after).items()}
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


def reference_outputs(inputs: dict, device, drop_windows: int = 0,
                      R: int = 0) -> dict:
    """What the plain reference says the timed path should produce: the
    stream's updates replayed onto the edge list and its coreness by
    peeling.  `drop_windows` leaves the last windows of `R`
    updates out: the control of a stream that acknowledges a window and
    leaves it unapplied."""
    N = inputs["N"]
    upto = inputs["applied"] - drop_windows * R
    keys = reference.replay(inputs["keys"].to(device),
                            inputs["pool"][:upto].to(device), N)
    src, dst = reference.directed(keys, N)
    deg = reference.degrees(keys, N)
    return dict(slots=src * N + dst, nslots=deg, deg=deg,
                core=reference.coreness(keys, N))


def judge(outputs: dict, inputs: dict, traffic: dict, device,
          ref: dict = None) -> Dict[str, float]:
    """The numbers compared: directed slots on one side only
    (`edge_diff`), rows whose degree or slot count differs
    (`degree_diff`) and nodes whose coreness differs (`core_diff`)."""
    if ref is None:
        ref = reference_outputs(inputs, device)
    o = {k: v.to(device) for k, v in outputs.items()}
    rows = (o["deg"].long() != ref["deg"]) | (o["nslots"].long() != ref["deg"])
    return dict(edge_diff=compare.edge_diff(o["slots"], ref["slots"]),
                degree_diff=int(rows.sum()),
                core_diff=compare.count_diff(o["core"], ref["core"]))


def control(inputs: dict, traffic: dict, device) -> dict:
    """The control in the program's place: the reference, with the
    stream's guarantee broken by one window acknowledged and not
    applied."""
    return reference_outputs(inputs, device, drop_windows=1,
                             R=int(traffic["window"]))
