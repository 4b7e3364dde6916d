"""The analytics driver: full analytics passes back to back.

A pass is the four entry points a stream starts from, on the whole
graph: `coreness`, `connected_components`, `pagerank` and
`triangle_counts`, each timed to a device sync at the pass's end.  Each
call's superstep count comes from the entry point itself
(``with_steps``).  The outputs of `JUDGED` passes, drawn from the seed,
are kept for the judgement.

Traffic keys: ``pagerank`` (``alpha``, ``tol``, ``max_steps``),
``warmup_passes``, ``limits``; a ``tol`` of null runs exactly
``max_steps`` PageRank supersteps.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from portbench import reference
from portbench.harness import compare, graphs, outcome
from portbench.harness.outcome import Outcome
from portbench.harness.record import RunRecord
from portbench.harness.trace import Tracer

ENTRY_POINTS = ("coreness", "connected_components", "pagerank",
                "triangle_counts")

#: passes of a window whose outputs are judged
JUDGED = 4


def _tol(pr: dict):
    return None if pr["tol"] is None else float(pr["tol"])


def _pass(g, traffic: dict, tracer: Tracer):
    """One pass: ({entry point: output}, {entry point: supersteps})."""
    from repro_torch.core import algorithms, kcore

    pr = traffic["pagerank"]
    out, steps = {}, {}
    with tracer.span("coreness"):
        out["coreness"], steps["coreness"] = kcore.coreness_with_stats(g)
    with tracer.span("connected_components"):
        out["connected_components"], steps["connected_components"] = \
            algorithms.connected_components(g, with_steps=True)
    with tracer.span("pagerank"):
        out["pagerank"], steps["pagerank"] = algorithms.pagerank(
            g, alpha=float(pr["alpha"]), tol=_tol(pr),
            max_steps=int(pr["max_steps"]), with_steps=True)
    with tracer.span("triangle_counts"):
        out["triangle_counts"], steps["triangle_counts"] = \
            algorithms.triangle_counts(g, with_steps=True)
    return out, steps


def run(cell, seed: int, seconds: float, tracer: Tracer, device,
        started: float) -> Outcome:
    from repro_torch.core.graph import GraphBlocks

    traffic = cell.traffic
    marks = {"imports": time.perf_counter() - started}
    gen = torch.Generator(device=device).manual_seed(seed)
    lay = graphs.make_layout(cell.config, gen, cell.root)
    nbr, deg = graphs.ell_rows(lay.keys, lay.N, lay.Cd)
    g = GraphBlocks(nbr=nbr, deg=deg, node_mask=lay.node_mask.clone(),
                    orig_id=lay.orig_id.to(torch.int32), P=lay.P, Cn=lay.Cn,
                    Cd=lay.Cd)
    inputs = dict(keys=lay.keys.cpu(), N=lay.N,
                  node_mask=lay.node_mask.cpu())
    sizes = dict(n=lay.n, N=lay.N, m=lay.keys.numel(), Cd=lay.Cd, P=lay.P,
                 sum_deg=2 * lay.keys.numel())
    del lay, nbr, deg
    outcome.sync(device)
    marks["graph"] = time.perf_counter() - started
    for _ in range(int(traffic["warmup_passes"])):
        _pass(g, traffic, tracer)
    outcome.sync(device)
    marks["warm-up passes"] = time.perf_counter() - started
    outcome.reset_peak(device)

    # the passes judged: a sample of `JUDGED` drawn from the seed
    # (reservoir sampling), so that what the benchmark keeps does not grow
    # with the window
    judged: List[dict] = []
    pick = random.Random(seed)
    n_passes = 0
    counters: Dict[str, float] = {f"steps.{e}": 0 for e in ENTRY_POINTS}
    unit_ms: List[float] = []
    with tracer.window(warm=lambda: _pass(g, traffic, tracer)):
        t_start = time.perf_counter()
        setup_s = t_start - started
        while True:
            t0 = time.perf_counter()
            out, steps = _pass(g, traffic, tracer)
            outcome.sync(device)
            t1 = time.perf_counter()
            unit_ms.append((t1 - t0) * 1e3)
            if n_passes < JUDGED:
                judged.append(out)
            elif (j := pick.randrange(n_passes + 1)) < JUDGED:
                judged[j] = out
            n_passes += 1
            del out
            for e, s in steps.items():
                counters[f"steps.{e}"] += s
            if t1 - t_start >= seconds:
                break
    window_s = t1 - t_start
    peak = outcome.peak_bytes(device)
    counters["passes"] = n_passes
    record = RunRecord(cell=cell.name, device_kind=outcome.device_kind(device),
                       setup_s=setup_s, window_s=window_s, units=n_passes,
                       unit_ms=unit_ms, counters=counters, sizes=sizes,
                       trace=tracer.trace, setup_marks=marks)
    return Outcome(record=record, attempted=n_passes,
                   memory_peak_bytes=peak, outputs=dict(passes=judged),
                   inputs=inputs)


def reference_outputs(inputs: dict, traffic: dict, device,
                      pagerank_dtype=torch.float64) -> dict:
    """The plain reference's four outputs on the benchmark's edge list."""
    keys, N = inputs["keys"].to(device), inputs["N"]
    mask = inputs["node_mask"].to(device)
    pr = traffic["pagerank"]
    rank, _ = reference.pagerank(keys, N, mask, float(pr["alpha"]),
                                 _tol(pr), int(pr["max_steps"]),
                                 dtype=pagerank_dtype)
    return dict(coreness=reference.coreness(keys, N),
                connected_components=reference.component_labels(keys, N,
                                                                 mask),
                pagerank=rank, triangle_counts=reference.triangles(keys, N))


def judge(outputs: dict, inputs: dict, traffic: dict, device,
          ref: dict = None) -> Dict[str, float]:
    """The numbers compared, each the worst over the judged passes of the
    window: nodes whose coreness, component label or triangle count
    differs (`core_diff`, `label_diff`, `triangle_diff`), and the largest
    relative error of a real node's PageRank (`pagerank_rel_err`)."""
    if ref is None:
        ref = reference_outputs(inputs, traffic, device)
    mask = inputs["node_mask"].to(device)
    worst = dict(core_diff=0, label_diff=0, triangle_diff=0,
                 pagerank_rel_err=0.0)
    for out in outputs["passes"]:
        o = {k: v.to(device) for k, v in out.items()}
        now = dict(
            core_diff=compare.count_diff(o["coreness"], ref["coreness"]),
            label_diff=compare.count_diff(o["connected_components"],
                                          ref["connected_components"]),
            triangle_diff=compare.count_diff(o["triangle_counts"],
                                             ref["triangle_counts"]),
            pagerank_rel_err=compare.rel_err(o["pagerank"], ref["pagerank"],
                                             mask))
        worst = {k: max(worst[k], now[k]) for k in worst}
    return worst


def control(inputs: dict, traffic: dict, device) -> dict:
    """The control in the program's place: the reference, its PageRank
    in bfloat16, the precision below the float32 the program states (its
    integer outputs have no precision to lower)."""
    return dict(passes=[reference_outputs(inputs, traffic, device,
                                          pagerank_dtype=torch.bfloat16)])
