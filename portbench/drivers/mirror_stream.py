"""The mirror_stream driver: windows of updates through `MirrorStream`,
the port's stream over a hub-split graph.

The configuration's graph is built straight into its split form
(`hub_split.build_split_blocks`): every vertex of degree above
`hub_threshold` keeps its row for the first slice of its neighbours and
gets a replica row for each further slice, so no row is wider than the
threshold (`degree_capacity`, the split graph's Cd).  Replicas take
padding rows, so the blocks get `node_capacity` rows each.  The layout and
the pool are the stream driver's (`graphs.make_layout`,
`pool.sample_pool`), with the ids moved onto the wider blocks; each node
keeps its place in its block.

Closed loop, as the stream driver runs it: windows of R updates back to
back, each timed from the call of `apply_window` to a device sync after
it, so every window ends with coreness exact and nothing queued.  The
judgement maps the final split graph back onto the logical graph (every
slot's row and neighbour to their primaries, degrees and coreness at the
primaries, 0 elsewhere) and holds it to the stream driver's reference and
limits; the control is the stream driver's.

Configuration keys beyond the layout's: ``hub_threshold``,
``node_capacity``.  Traffic keys: those of the stream driver.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List

import torch

from portbench.harness import graphs, outcome, pool as pool_mod
from portbench.harness import spec
from portbench.harness.outcome import Outcome
from portbench.harness.record import RunRecord
from portbench.harness.trace import Tracer

#: the stream driver, whose reference, judgement and control this one uses
_stream = spec.load_driver("stream", Path(__file__).resolve().parents[2])


def _counters(sess) -> Dict[str, float]:
    st = sess.result().stats
    return dict(updates=st.updates, windows=st.batches,
                refresh_steps=sess.refresh_steps)


def widen(ids: torch.Tensor, Cn: int, Cn2: int) -> torch.Tensor:
    """Padded ids of blocks of `Cn` rows as ids of blocks of `Cn2` rows,
    each node at the same place in its block."""
    return ids // Cn * Cn2 + ids % Cn


def group_sizes(g, plan) -> Dict[str, int]:
    """The split graph's sizes that the refresh's least bytes are counted
    from: its valid slots, and its replica groups (one a split hub)."""
    heads = (plan.row_gid.long() < plan.Gmax) & plan.primary_mask
    return dict(sum_deg=int(g.deg.long().sum()), groups=int(heads.sum()))


def logical_outputs(g, plan, core) -> dict:
    """The split graph as the logical graph over its padded ids: each
    valid slot as (row's primary, neighbour's primary), each primary's
    slot count and logical degree, and coreness at the primaries."""
    prow = plan.primary_row.long()
    valid = g.nbr >= 0
    rows = torch.arange(g.N, device=g.nbr.device)[:, None].expand_as(g.nbr)
    src, dst = prow[rows[valid]], prow[g.nbr[valid].long()]
    keys = torch.sort(src * g.N + dst).values
    pm = plan.primary_mask
    return dict(slots=keys, nslots=torch.bincount(src, minlength=g.N),
                deg=torch.where(pm, plan.ldeg, 0).clone(),
                core=torch.where(pm, core, 0).clone())


def run(cell, seed: int, seconds: float, tracer: Tracer, device,
        started: float) -> Outcome:
    from repro_torch.core.hub_split import build_split_blocks
    from repro_torch.runtime.stream import MirrorStream

    conf, traffic, R = cell.config, cell.traffic, int(cell.traffic["window"])
    marks = {"imports": time.perf_counter() - started}
    gen = torch.Generator(device=device).manual_seed(seed)
    lay = graphs.make_layout(conf, gen, cell.root)
    pool = pool_mod.sample_pool(lay, int(traffic["pool"]), traffic["mix"],
                                gen)
    P, Cn, Cn2 = lay.P, lay.Cn, int(conf["node_capacity"])
    t = int(conf["hub_threshold"])
    if Cn2 < Cn or t != lay.Cd:
        raise ValueError(f"node_capacity {Cn2} must hold a block's {Cn} "
                         f"nodes and degree_capacity {lay.Cd} must be the "
                         f"hub threshold {t}")
    N2 = P * Cn2
    # the graph in the relabelled original ids, and each id's block
    real = torch.nonzero(lay.node_mask)[:, 0]
    assign = torch.empty(lay.n, dtype=torch.int64, device=lay.keys.device)
    assign[lay.orig_id[real]] = real // Cn
    ends = lay.orig_id[torch.stack([lay.keys // lay.N, lay.keys % lay.N], 1)]
    g2, plan = build_split_blocks(ends, lay.n, assign, P, t, Cn=Cn2,
                                  device=device)
    del ends, assign
    # the program's rows for the layout's nodes: the same ids, widened
    if not torch.equal(g2.orig_id[widen(real, Cn, Cn2)].long(),
                       lay.orig_id[real]):
        raise AssertionError("the split graph's layout is not the widened "
                             "layout of the benchmark")
    keys2 = widen(lay.keys // lay.N, Cn, Cn2) * N2 \
        + widen(lay.keys % lay.N, Cn, Cn2)
    pool = torch.cat([widen(pool[:, :2], Cn, Cn2), pool[:, 2:]], 1)
    node_mask = torch.zeros(N2, dtype=torch.bool, device=lay.keys.device)
    node_mask[widen(real, Cn, Cn2)] = True
    # room for every replica the pool's inserts could ask for
    free = int((~g2.node_mask).sum())
    need = 2 * int((pool[:, 2] > 0).sum())
    if free < need:
        raise ValueError(f"{free} free rows after the split; the pool's "
                         f"inserts may ask for {need} replicas")
    inputs = dict(keys=keys2.cpu(), pool=pool.cpu(), N=N2,
                  node_mask=node_mask.cpu())
    sizes = dict(n=lay.n, N=N2, m=lay.keys.numel(), Cd=t, P=P)
    del lay, keys2, real, node_mask
    windows = [[tuple(u) for u in pool[i:i + R].tolist()]
               for i in range(0, pool.shape[0] - R + 1, R)]
    del pool

    outcome.sync(device)
    marks["graph, split and pool"] = time.perf_counter() - started
    sess = MirrorStream(g2, plan, backend="auto")
    del g2, plan
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
    sizes.update(group_sizes(sess.g, sess.mirror))
    record = RunRecord(cell=cell.name, device_kind=outcome.device_kind(device),
                       setup_s=setup_s, window_s=window_s,
                       units=int(counters["updates"]), unit_ms=unit_ms,
                       counters=counters, sizes=sizes, trace=tracer.trace,
                       setup_marks=marks)
    outputs = logical_outputs(sess.g, sess.mirror, sess.core)
    del sess
    inputs["applied"] = nxt * R
    return Outcome(record=record, attempted=len(unit_ms) * R,
                   memory_peak_bytes=peak, outputs=outputs, inputs=inputs)


def judge(outputs: dict, inputs: dict, traffic: dict, device,
          ref: dict = None) -> Dict[str, float]:
    """The stream driver's numbers on the logical graph: `edge_diff`,
    `degree_diff` and `core_diff`."""
    return _stream.judge(outputs, inputs, traffic, device, ref)


def control(inputs: dict, traffic: dict, device) -> dict:
    """The stream driver's control: the reference with one window
    acknowledged and not applied."""
    return _stream.control(inputs, traffic, device)
