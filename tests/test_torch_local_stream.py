"""The stream session's block-local batch on a spatial graph.

A tiny random geometric graph (points uniform in the unit square, an edge
within 0.55 * sqrt(ln n / n)) is built here with its blocks cut by
position, and windows of local updates (deletes of present edges, inserts
of absent pairs two hops apart) go through `StreamSession.apply_window`.
The maintained coreness and graph equal the plain reference (the updates
replayed, then coreness by peeling); the block-local branch is taken; the
session's `local_candidates` equals the sum over windows of the accepted
columns' candidate sets, recomputed here; the `bladyg.local` span opens
once in each window that accepts an update and never otherwise; and the
`bladyg.sync` spans still equal the host reads.

The same churn with connected-component labels kept (`cc_labels=`): after
every window the labels equal a recompute and networkx's components
(each node labelled with its component's least padded id); `cc_steps`
adds 1 a recompute (the union-find's one pass over the slots) and nothing
for an insert-only window, which merges; the `bladyg.cc` span opens once in each window of a session
with labels and never in one without; and `MirrorStream` counts and spans
its label recomputes alike.  This file does not import JAX.
"""
from __future__ import annotations

import collections
import math

import networkx as nx
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.analysis import entrypoints as E
from repro_torch.core import algorithms, kcore
from repro_torch.core import kcore_dynamic as kd
from repro_torch.core.graph import build_blocks
from repro_torch.core.hub_split import build_split_blocks
from repro_torch.runtime.stream import MirrorStream, StreamSession

N_POINTS, P, R, WINDOWS = 2048, 4, 8, 6
SEEDS = (2**31 + 3, 2**31 + 17, 2**31 + 29)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_rgg(rng):
    """(edges (m, 2) of original ids, block of each point): all pairs
    within the radius, blocks by position (split at the median in x, then
    each half at its median in y)."""
    n = N_POINTS
    xy = rng.random((n, 2))
    r = 0.55 * math.sqrt(math.log(n) / n)
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    i, j = np.nonzero(np.triu(d2 < r * r, 1))
    block = np.zeros(n, np.int64)
    by_x = np.argsort(xy[:, 0], kind="stable")
    for half in (0, 1):
        ids = by_x[half * n // 2:(half + 1) * n // 2]
        upper = ids[np.argsort(xy[ids, 1], kind="stable")[n // 4:]]
        block[ids] = 2 * half
        block[upper] += 1
    return np.stack([i, j], 1), block


def local_updates(edges, rng, count):
    """`count` updates over original ids, no pair twice: half deletes of
    present edges, half inserts of absent pairs with a common neighbour,
    shuffled."""
    adj = collections.defaultdict(set)
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    present = {(min(a, b), max(a, b)) for a, b in edges}
    dels = [tuple(edges[k]) + (-1,) for k in
            rng.choice(len(edges), count // 2, replace=False)]
    ins, seen = [], set()
    while len(ins) < count - count // 2:
        u, w = edges[rng.integers(len(edges))][::rng.choice([1, -1])]
        v = sorted(adj[w])[rng.integers(len(adj[w]))]
        pair = (min(u, v), max(u, v))
        if u != v and pair not in present and pair not in seen:
            seen.add(pair)
            ins.append((u, v, 1))
    ups = dels + ins
    return [ups[k] for k in rng.permutation(len(ups))]


def accepted_columns(cand, us, vs, n, Cn):
    """The routing rule, column by column: both endpoints in one block,
    every candidate in it, and no candidate shared with an earlier
    column."""
    out = []
    for r in range(n):
        owner = us[r] // Cn
        rows = np.flatnonzero(cand[:, r])
        earlier = cand[:, :r].any(axis=1)
        if (owner == vs[r] // Cn and (rows // Cn == owner).all()
                and not earlier[rows].any()):
            out.append(r)
    return out


def _events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("bladyg.")]


@pytest.fixture(scope="module", params=SEEDS)
def stream(request):
    """One stream of local windows through two equal sessions, one
    profiled window by window and one under the host-read counter, with
    what each window showed."""
    rng = np.random.default_rng(request.param)
    edges, block = tiny_rgg(rng)
    g, g2 = (build_blocks(edges, N_POINTS, block, P, device="cpu")
             for _ in range(2))
    pid = np.full(N_POINTS, -1, np.int64)
    real = np.flatnonzero(g.node_mask.numpy())
    pid[g.orig_id.numpy()[real]] = real
    ups = local_updates(edges, rng, R * WINDOWS)
    # a last window of one insert across blocks, which escalates
    a, b = (int(np.flatnonzero(block == k)[0]) for k in (0, P - 1))
    ups.append((a, b, 1))
    core = kcore.coreness(g)
    traced = StreamSession(g2, core.clone(), R=R)
    counted = StreamSession(g, core, R=R)
    seen = []
    for w in range(WINDOWS + 1):
        window = [(int(pid[u]), int(pid[v]), op)
                  for u, v, op in ups[w * R:(w + 1) * R]]
        n = len(window)
        us, vs = (np.zeros(R, np.int64) for _ in range(2))
        us[:n] = [u for u, _, _ in window]
        vs[:n] = [v for _, v, _ in window]
        cand, _ = kd._batch_candidates(
            counted.g, counted.core, torch.as_tensor(us),
            torch.as_tensor(vs), torch.arange(R) < n)
        cand = cand.numpy()
        acc = accepted_columns(cand, us, vs, n, g.Cn)
        local0, cand0 = counted.stats().block_local, counted.local_candidates
        with E.count_host_reads("cpu") as box:
            counted.apply_window(window)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced.apply_window(window)
        seen.append(dict(
            accepted=counted.stats().block_local - local0,
            want_accepted=len(acc),
            candidates=counted.local_candidates - cand0,
            want_candidates=int(cand[:, acc].any(axis=1).sum()),
            events=_events(prof), reads=box.count))
    return dict(edges=edges, ups=ups, pid=pid, traced=traced,
                counted=counted, windows=seen)


def test_local_windows_equal_the_reference(stream):
    """Both sessions equal the updates replayed onto the edge list and
    its coreness by peeling."""
    ref = nx.Graph()
    ref.add_nodes_from(range(N_POINTS))
    ref.add_edges_from(map(tuple, stream["edges"]))
    for u, v, op in stream["ups"]:
        (ref.add_edge if op > 0 else ref.remove_edge)(u, v)
    want = nx.core_number(ref)
    pid = stream["pid"]
    edges = {(min(u, v), max(u, v)) for u, v in ref.edges}
    for sess in (stream["traced"], stream["counted"]):
        core = sess.core.numpy()
        assert [int(core[pid[v]]) for v in range(N_POINTS)] == \
            [want[v] for v in range(N_POINTS)]
        nbr, orig = sess.g.nbr.numpy(), sess.g.orig_id.numpy()
        rows, slots = np.nonzero(nbr >= 0)
        a, b = orig[rows], orig[nbr[rows, slots]]
        have = set(zip(np.minimum(a, b).tolist(), np.maximum(a, b).tolist()))
        assert len(rows) == 2 * len(edges) and have == edges


def test_block_local_branch_is_taken(stream):
    st = stream["counted"].stats()
    assert st.block_local > 0
    assert st.block_local == sum(w["accepted"] for w in stream["windows"])
    assert stream["traced"].stats() == st


def test_local_candidates_equal_the_accepted_columns(stream):
    """Each window's growth of the count is the size of the union of the
    candidate sets of the columns the routing rule accepts."""
    for w in stream["windows"]:
        assert w["accepted"] == w["want_accepted"]
        assert w["candidates"] == w["want_candidates"]
    total = sum(w["want_candidates"] for w in stream["windows"])
    assert stream["counted"].local_candidates == total > 0
    assert stream["traced"].local_candidates == total


def test_local_span_opens_once_in_each_window_that_accepts(stream):
    """One `bladyg.local` in a window with an accepted update, holding
    the joint recompute, inside the window's span; none in any other."""
    for w in stream["windows"]:
        local = [e for e in w["events"] if e[0] == tracing.LOCAL]
        assert len(local) == int(w["accepted"] > 0)
        (_, w0, w1), = [e for e in w["events"] if e[0] == tracing.WINDOW]
        for _, s, e in local:
            assert w0 <= s <= e <= w1
            inner = [x for x in w["events"] if x[0] == tracing.RECOMPUTE
                     and s <= x[1] <= x[2] <= e]
            assert len(inner) == 1
    accepted = [w["accepted"] > 0 for w in stream["windows"]]
    assert any(accepted) and not all(accepted)
    assert tracing.LOCAL not in [n for n, _ in tracing.SPANS]


def test_sync_spans_still_count_host_reads(stream):
    for w in stream["windows"]:
        syncs = sum(e[0] == tracing.SYNC for e in w["events"])
        assert syncs == w["reads"] > 0


# ---- connected-component labels kept through the same churn ------------


def labels_of(ref, pid, N):
    """Each row's component label from networkx's components over
    original ids: the least padded id of its component; -1 on padding."""
    want = np.full(N, -1, np.int64)
    for comp in nx.connected_components(ref):
        rows = pid[list(comp)]
        want[rows] = rows.min()
    return want


@pytest.fixture(scope="module", params=SEEDS)
def cc_stream(request):
    """The local churn through two equal sessions that keep CC labels, one
    profiled window by window and one under the host-read counter: a first
    window deletes every edge of a node of least degree (it splits a
    component), then the local windows, then an insert-only window that
    joins the node back (a merge of two components); with what each
    window showed."""
    rng = np.random.default_rng(request.param)
    edges, block = tiny_rgg(rng)
    g, g2 = (build_blocks(edges, N_POINTS, block, P, device="cpu")
             for _ in range(2))
    pid = np.full(N_POINTS, -1, np.int64)
    real = np.flatnonzero(g.node_mask.numpy())
    pid[g.orig_id.numpy()[real]] = real
    deg = np.bincount(edges.ravel(), minlength=N_POINTS)
    x = int(np.argmin(np.where(deg > 0, deg, N_POINTS)))
    near = [int(b if a == x else a) for a, b in edges if x in (a, b)]
    assert 0 < len(near) <= R
    ups = [u for u in local_updates(edges, rng, R * WINDOWS)
           if x not in u[:2]]
    windows = ([[(x, y, -1) for y in near]]
               + [ups[i:i + R] for i in range(0, len(ups), R)]
               + [[(x, near[0], 1)]])
    core = kcore.coreness(g)
    labels0 = algorithms.connected_components(g)
    traced = StreamSession(g2, core.clone(), R=R, cc_labels=labels0.clone())
    counted = StreamSession(g, core, R=R, cc_labels=labels0.clone())
    ref = nx.Graph()
    ref.add_nodes_from(range(N_POINTS))
    ref.add_edges_from(map(tuple, edges))
    seen = []
    for window in windows:
        w = [(int(pid[u]), int(pid[v]), op) for u, v, op in window]
        st0, steps0 = counted.stats(), counted.cc_steps
        with E.count_host_reads("cpu") as box:
            counted.apply_window(w)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced.apply_window(w)
        for u, v, op in window:
            (ref.add_edge if op > 0 else ref.remove_edge)(u, v)
        st = counted.stats()
        redo, redo_steps = algorithms.connected_components(counted.g,
                                                           with_steps=True)
        seen.append(dict(
            deletes=any(op < 0 for _, _, op in w),
            inserts=sum(op > 0 for _, _, op in w),
            recomputes=st.cc_recomputes - st0.cc_recomputes,
            merges=st.cc_merges - st0.cc_merges,
            steps=counted.cc_steps - steps0, redo=redo,
            redo_steps=redo_steps, want=labels_of(ref, pid, g.N),
            labels=counted.labels.clone(), traced=traced.labels.clone(),
            events=_events(prof), reads=box.count))
    return dict(labels0=labels0, traced=traced, counted=counted,
                windows=seen)


def test_cc_labels_equal_a_recompute_and_networkx(cc_stream):
    for w in cc_stream["windows"]:
        assert torch.equal(w["labels"], w["redo"])
        assert torch.equal(w["traced"], w["redo"])
        np.testing.assert_array_equal(w["labels"].numpy(), w["want"])
    # the first window split a component and the last joined two
    first, *_, before, last = cc_stream["windows"]
    assert not torch.equal(first["labels"], cc_stream["labels0"])
    assert not torch.equal(last["labels"], before["labels"])


def test_cc_steps_add_each_recompute(cc_stream):
    """A window with a delete recomputes once and adds exactly 1, the
    union-find's one pass over the slots, where min-label propagation on
    the same graph takes many supersteps."""
    total = 0
    for w in cc_stream["windows"]:
        if w["deletes"]:
            assert (w["recomputes"], w["merges"]) == (1, 0)
            assert w["steps"] == 1 < w["redo_steps"]
            total += 1
    assert cc_stream["counted"].cc_steps == total > 0
    assert cc_stream["traced"].cc_steps == total
    assert cc_stream["traced"].stats() == cc_stream["counted"].stats()


def test_insert_only_window_merges_and_adds_no_step(cc_stream):
    only = [w for w in cc_stream["windows"] if not w["deletes"]]
    assert only and only[-1] is cc_stream["windows"][-1]
    for w in only:
        assert (w["recomputes"], w["merges"], w["steps"]) == \
            (0, w["inserts"], 0)


def test_cc_span_opens_once_in_each_window_with_labels(cc_stream):
    """One `bladyg.cc` in every window, inside the window's span; the
    host reads of a recompute's loop inside it, none in a merge."""
    for w in cc_stream["windows"]:
        (_, w0, w1), = [e for e in w["events"] if e[0] == tracing.WINDOW]
        (_, s, e), = [x for x in w["events"] if x[0] == tracing.CC]
        assert w0 <= s <= e <= w1
        syncs = [x for x in w["events"] if x[0] == tracing.SYNC
                 and s <= x[1] <= x[2] <= e]
        assert bool(syncs) == w["deletes"]
    assert tracing.CC not in [n for n, _ in tracing.SPANS]


def test_cc_span_never_opens_without_labels(stream):
    assert stream["traced"].labels is None
    for w in stream["windows"]:
        assert not [e for e in w["events"] if e[0] == tracing.CC]
    assert stream["counted"].cc_steps == 0


def test_sync_spans_count_host_reads_with_labels(cc_stream):
    for w in cc_stream["windows"]:
        syncs = sum(e[0] == tracing.SYNC for e in w["events"])
        assert syncs == w["reads"] > 0


def test_cc_steps_survive_a_snapshot(cc_stream):
    sess = cc_stream["counted"]
    arrays, meta = sess.state_dict()
    back = StreamSession.from_state(arrays, meta, device="cpu")
    assert back.cc_steps == sess.cc_steps > 0
    assert torch.equal(back.labels, sess.labels)
    # a snapshot without the count (the JAX package writes none) gives 0
    del meta["counters"]["cc_steps"]
    assert StreamSession.from_state(arrays, meta, device="cpu").cc_steps == 0


@pytest.mark.parametrize("keep", [True, False])
def test_mirror_stream_counts_and_spans_its_label_recomputes(keep):
    """On the tiny graph split at 12 slots a row, each refresh of a
    session with labels adds the supersteps of a recompute on its graph
    inside one `bladyg.cc` nested in the refresh's span; a session
    without labels counts nothing and opens no such span."""
    rng = np.random.default_rng(SEEDS[0])
    edges, block = tiny_rgg(rng)
    g2, plan = build_split_blocks(edges, N_POINTS, block, P, 12,
                                  node_slack=64, device="cpu")
    pm, oid = plan.primary_mask.numpy(), g2.orig_id.numpy()
    assert int(g2.node_mask.sum()) > int(pm.sum())   # replica rows
    prow = {int(o): r for r, o in enumerate(oid) if pm[r]}
    sess = MirrorStream(g2, plan, cc_labels=keep)

    def recompute():
        return algorithms.connected_components(sess.g, mirror=sess.mirror,
                                               with_steps=True)

    assert sess.cc_steps == (recompute()[1] if keep else 0)
    ups = local_updates(edges, rng, R * 3)
    for i in range(0, len(ups), R):
        steps0 = sess.cc_steps
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sess.apply_window([(prow[u], prow[v], op)
                               for u, v, op in ups[i:i + R]])
        events = _events(prof)
        cc = [e for e in events if e[0] == tracing.CC]
        if not keep:
            assert not cc and sess.cc_steps == 0 and sess.labels is None
            continue
        labels, steps = recompute()
        assert torch.equal(sess.labels, labels)
        assert sess.cc_steps - steps0 == steps > 0
        (_, s, e), = cc
        (_, r0, r1), = [x for x in events if x[0] == tracing.MIRROR_REFRESH]
        assert r0 <= s <= e <= r1
