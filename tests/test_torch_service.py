"""PyTorch port vs the JAX package: the query service.

At the reference test's size (BA(140, 3, seed 7), P = 4, `deg_slack=48`,
`PR_STEPS = 10`, 16 mixed updates, R = 4):

* every batched answer over every epoch snapshot is bit-identical to the
  port's from-scratch recompute on that epoch's graph (`coreness`,
  `connected_components`, `pagerank(tol=None, max_steps=PR_STEPS)`), and
  top-k ids are `jax.lax.top_k`'s on the recomputed ranks;
* the same graph, updates and seeded query feed through the JAX
  `QueryServer` (backend "jnp") and the port's ("torch") give EQUAL
  integer and boolean answers, top-k ids and `ServiceMetrics` counts,
  staleness and `summary()` keys; ranks `allclose(atol=2e-6)`, the JAX
  tests' own bar;
* a published snapshot stays unchanged while later windows splice the
  graph in place; each answered batch makes one host->device copy of its
  ids and one device->host copy of its answers; admission, submit
  errors, staleness, field lists and config errors are the reference's;
* over a hub-split session (`MirrorStream`, split threshold 8), every
  snapshot equals the reference's (`primary`, `nbr_max`, logical `deg`,
  ranks masked to primaries) and a mirrored recompute on its epoch, and
  every answer, at replica rows too, equals the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (fixtures)
    CPU, needs_cuda, one_torch_thread, reference, reference_service,
    require_cuda, to_port)

import repro.core as jcore
from repro.core.partition import node_random_partition
from repro.core.updates import sample_deletions, sample_insertions
from repro.graphgen import barabasi_albert

import repro_torch.core as tcore
import repro_torch.service as tsvc
from repro_torch.core import hub_split as ths
from repro_torch.runtime.stream import (
    MirrorStream, StreamSession, _iter_windows)
from repro_torch.service import queries as tq

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P = 4
PR_STEPS = 10
ALPHA = 0.85
R = 4
RANK_ATOL = 2e-6


def _jgraph(n=140, seed=7):
    edges = barabasi_albert(n, 3, seed=seed)
    nn = int(edges.max()) + 1
    assign = node_random_partition(nn, P, seed=2)
    return jcore.build_blocks(edges, nn, assign, P=P, deg_slack=48)


def _mixed_updates(jg, count=16, seed=11):
    per = max(1, count // 4)
    return (sample_insertions(jg, per, "inter", seed=seed)
            + sample_insertions(jg, per, "intra", seed=seed + 1)
            + sample_deletions(jg, per, "inter", seed=seed + 2)
            + sample_deletions(jg, per, "intra", seed=seed + 3))


def _open(g, backend="torch", **kw):
    """A port session with CC labels (`g` is updated in place)."""
    return StreamSession(
        g, tcore.coreness(g, backend=backend), R=R, backend=backend,
        cc_labels=tcore.connected_components(g, backend=backend), **kw)


def _jopen(jg, **kw):
    return reference().StreamSession(
        jg, jcore.coreness(jg, backend="jnp"), R=R, backend="jnp",
        cc_labels=jcore.connected_components(jg, backend="jnp"), **kw)


def _epoch_oracle(g0, snap, backend):
    """From-scratch recompute of every queryable field on snap's graph."""
    eg = dataclasses.replace(g0, nbr=snap.nbr, deg=snap.deg,
                             node_mask=snap.node_mask, orig_id=snap.orig_id)
    return {
        "core": tcore.coreness(eg, backend=backend).numpy(),
        "labels": tcore.connected_components(eg, backend=backend).numpy(),
        "rank": tcore.pagerank(eg, alpha=ALPHA, tol=None, max_steps=PR_STEPS,
                               backend=backend).numpy(),
        "deg": eg.deg.numpy(),
        "nbr": eg.nbr.numpy(),
        "N": eg.N,
    }


@functools.lru_cache(maxsize=None)
def _serving_trace(backend):
    """One serving run per backend: [(EpochSnapshot, oracle), ...]; epoch 0
    is the pre-stream graph, each later one follows one more window."""
    jg = _jgraph()
    g0 = to_port(jg)
    sess = _open(to_port(jg), backend)
    state = tsvc.AnalyticsState(sess, alpha=ALPHA, pr_steps=PR_STEPS)
    trace = [(state.snapshot, _epoch_oracle(g0, state.snapshot, backend))]
    for window in _iter_windows(_mixed_updates(jg), R):
        sess.apply_window(window)
        snap = state.refresh()
        trace.append((snap, _epoch_oracle(g0, snap, backend)))
    return trace


def _jax_topk(rank, k):
    vals, ids = jax.device_get(jax.lax.top_k(jnp.asarray(rank), k))
    return ids.tolist(), vals.tolist()


@pytest.mark.parametrize("backend", ["torch", "ell"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_queries_bit_identical_to_epoch_recompute(backend, seed):
    """(a) Random mixed batches against every epoch answer bit-identically
    to the recompute; "ell" on CPU tensors runs the wrappers' plain
    versions."""
    rng = np.random.default_rng(seed)
    trace = _serving_trace(backend)
    assert [s.epoch for s, _ in trace] == list(range(len(trace)))
    for snap, ora in trace:
        real = np.flatnonzero(snap.node_mask.numpy())
        n_q = int(rng.integers(1, 24))
        us = rng.choice(real, n_q)
        vs = rng.choice(real, n_q)

        got = tq.run_batch(snap, "core", [tsvc.core_of(u) for u in us])
        assert got == [int(x) for x in ora["core"][us]]
        got = tq.run_batch(snap, "degree", [tsvc.degree_of(u) for u in us])
        assert got == [int(x) for x in ora["deg"][us]]
        got = tq.run_batch(snap, "nbr_max_core",
                           [tsvc.nbr_max_core_of(u) for u in us])
        for u, ans in zip(us, got):
            row = ora["nbr"][u]
            nbrs = row[row >= 0]
            assert ans == (int(ora["core"][nbrs].max()) if nbrs.size else -1)
        got = tq.run_batch(snap, "same_component",
                           [tsvc.same_component(u, v) for u, v in zip(us, vs)])
        assert got == [bool(ora["labels"][u] == ora["labels"][v])
                       for u, v in zip(us, vs)]

        k = int(rng.integers(1, 12))
        kk = tq.topk_bucket(k, ora["N"])
        [(ids, ranks)] = tq.run_batch(snap, "topk_pagerank",
                                      [tsvc.topk_pagerank(k)], k=kk)
        ref_ids, ref_vals = _jax_topk(ora["rank"], kk)
        assert ids == ref_ids[:k]
        assert ranks == ref_vals[:k]  # float bit-equality


def _feed(svc, N, seed, per_window=12):
    """A seeded query feed of all five kinds, built with `svc`'s
    constructors; k runs past the bucket floor."""
    rng = np.random.default_rng(seed)

    def feed(i):
        out = []
        for _ in range(per_window):
            r = int(rng.integers(5))
            u, v = int(rng.integers(N)), int(rng.integers(N))
            k = int(rng.integers(1, 40))
            out.append([svc.core_of(u), svc.degree_of(u),
                        svc.nbr_max_core_of(u), svc.same_component(u, v),
                        svc.topk_pagerank(k)][r])
        return out
    return feed


def _recording(srv):
    """Record every `submit` result (None for a shed) on `srv.requests`."""
    submit = srv.submit
    srv.requests = []

    def recorded(query):
        req = submit(query)
        srv.requests.append(req)
        return req
    srv.submit = recorded
    return srv


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def _serve_both(cfg, seed=3):
    jsvc = reference_service()
    jg = _jgraph()
    ups = _mixed_updates(jg)
    tg = to_port(jg)
    js = _recording(jsvc.QueryServer(
        _jopen(jg), config=jsvc.ServiceConfig(**cfg)))
    ts = _recording(tsvc.QueryServer(
        _open(tg), config=tsvc.ServiceConfig(**cfg)))
    jres = js.serve(list(ups), _feed(jsvc, jg.N, seed))
    tres = ts.serve(list(ups), _feed(tsvc, tg.N, seed))
    return js, ts, jres, tres


def _assert_same_answers(jreqs, treqs):
    assert len(jreqs) == len(treqs)
    for a, b in zip(jreqs, treqs):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert tuple(a.query) == tuple(b.query)
        assert (a.done, a.epoch) == (b.done, b.epoch)
        if a.query.kind == "topk_pagerank":
            (ia, ra), (ib, rb) = a.answer, b.answer
            assert ia == ib
            np.testing.assert_allclose(rb, ra, atol=RANK_ATOL)
        else:
            assert b.answer == a.answer
            assert type(b.answer) is type(a.answer)


@pytest.mark.parametrize("cfg", [
    dict(refresh_every=1, pr_steps=PR_STEPS, alpha=ALPHA, max_batch=8,
         max_queue=1024),
    dict(refresh_every=2, pr_steps=PR_STEPS, alpha=ALPHA, max_batch=64,
         max_queue=10),
])
def test_serving_equals_reference(cfg):
    """(b) The JAX `QueryServer` on "jnp" and the port's on "torch": the
    same answers, epochs, metrics counts, staleness and summary keys."""
    js, ts, jres, tres = _serve_both(cfg)
    assert sum(r is not None for r in ts.requests) >= 40
    assert ts.metrics.total_shed == (8 if cfg["max_queue"] == 10 else 0)
    _assert_same_answers(js.requests, ts.requests)
    jm, tm = js.metrics, ts.metrics
    assert (tm.answered, tm.shed, tm.batches) == (jm.answered, jm.shed,
                                                   jm.batches)
    assert tm._staleness == jm._staleness
    js_sum, ts_sum = jm.summary(), tm.summary()
    assert _keys(ts_sum) == _keys(js_sum)
    for k in ("answered", "shed", "batches", "staleness_max",
              "staleness_mean"):
        assert ts_sum[k] == js_sum[k], k
    assert ts.state.refreshes == js.state.refreshes
    assert tres.stats == jres.stats
    np.testing.assert_array_equal(tres.core.numpy(), np.asarray(jres.core))
    np.testing.assert_array_equal(tres.labels.numpy(),
                                  np.asarray(jres.labels))


def test_snapshot_survives_in_place_updates():
    """(c) Later windows splice the graph's rows in place; a published
    snapshot shares no storage with the session and stays as it was, and
    a refresh never writes the session's coreness or labels."""
    jg = _jgraph()
    sess = _open(to_port(jg))
    state = tsvc.AnalyticsState(sess, alpha=ALPHA, pr_steps=PR_STEPS)
    snap0 = state.snapshot
    tensors = {f: getattr(snap0, f) for f in snap0._fields
               if isinstance(getattr(snap0, f), torch.Tensor)}
    assert set(tensors) == {"core", "labels", "rank", "deg", "nbr",
                            "node_mask", "orig_id"}
    live = [sess.core, sess.labels, sess.g.nbr, sess.g.deg,
            sess.g.node_mask, sess.g.orig_id]
    for t in tensors.values():
        assert all(t.data_ptr() != x.data_ptr() for x in live)
    before = {f: t.clone() for f, t in tensors.items()}
    for window in _iter_windows(_mixed_updates(jg), R):
        sess.apply_window(window)
        core, labels = sess.core, sess.labels
        core_b, labels_b = core.clone(), labels.clone()
        state.refresh()
        assert sess.core is core and sess.labels is labels
        assert torch.equal(core, core_b) and torch.equal(labels, labels_b)
    assert not torch.equal(sess.g.nbr, before["nbr"])  # the graph moved
    for f, t in tensors.items():
        assert torch.equal(t, before[f]), f
    real = np.flatnonzero(snap0.node_mask.numpy())
    got = tq.run_batch(snap0, "core", [tsvc.core_of(int(real[0]))])
    assert got == [int(before["core"][real[0]])]


def test_one_transfer_each_way_per_answered_batch(monkeypatch):
    """(d) Each answered batch makes ONE host->device copy of its padded
    ids and ONE device->host copy of its answers."""
    calls = {"to_host": 0, "ids": 0}
    to_host, pad_ids = tq._to_host, tq._pad_ids

    def counting_to_host(x):
        calls["to_host"] += 1
        return to_host(x)

    def counting_pad_ids(*a, **kw):
        calls["ids"] += 1
        return pad_ids(*a, **kw)

    monkeypatch.setattr(tq, "_to_host", counting_to_host)
    monkeypatch.setattr(tq, "_pad_ids", counting_pad_ids)
    srv = tsvc.QueryServer(_open(to_port(_jgraph())), config=tsvc.ServiceConfig(
        refresh_every=1, pr_steps=PR_STEPS, alpha=ALPHA, max_batch=32))
    real = np.flatnonzero(srv.state.snapshot.node_mask.numpy())
    for u in real[:16]:
        srv.submit(tsvc.core_of(u))        # 16 queries -> 1 batch
        srv.submit(tsvc.degree_of(u))      # 16 queries -> 1 batch
        srv.submit(tsvc.nbr_max_core_of(u))  # 16 queries -> 1 batch
    for u in real[:4]:
        srv.submit(tsvc.same_component(u, real[1]))  # 4 queries -> 1 batch
    for k in (1, 5, 8):
        srv.submit(tsvc.topk_pagerank(k))  # one k bucket -> 1 batch, no ids
    assert srv.pump() == 55
    assert calls == {"to_host": 5, "ids": 4}
    assert srv.metrics.batches == 5


def test_admission_sheds_like_reference():
    """(e) Admission control sheds at the bound, with the reference's
    per-kind shed counts."""
    jsvc = reference_service()
    jg = _jgraph()
    js = jsvc.QueryServer(_jopen(jg), config=jsvc.ServiceConfig(
        max_queue=8, pr_steps=PR_STEPS))
    ts = tsvc.QueryServer(_open(to_port(jg)), config=tsvc.ServiceConfig(
        max_queue=8, pr_steps=PR_STEPS))
    real = np.flatnonzero(np.asarray(jg.node_mask))
    kinds = [lambda m, i: m.core_of(real[i]),
             lambda m, i: m.same_component(real[i], real[i + 1]),
             lambda m, i: m.topk_pagerank(i + 1),
             lambda m, i: m.degree_of(real[i])]
    got = {}
    for name, m, srv in (("jax", jsvc, js), ("torch", tsvc, ts)):
        adm = [srv.submit(kinds[i % 4](m, i)) is not None for i in range(14)]
        got[name] = (adm, dict(srv.metrics.shed), srv.queued, srv.pump(),
                     srv.metrics.total_answered)
    assert got["torch"] == got["jax"]
    adm, shed, queued, pumped, answered = got["torch"]
    assert sum(adm) == 8 and sum(shed.values()) == 6 and queued == 8
    assert pumped == answered == 8
    s = ts.metrics.summary()
    assert np.isfinite(s["p50_ms"]) and np.isfinite(s["p99_ms"])


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (the type is what is compared)
        return type(e), str(e)
    return None


@pytest.mark.parametrize("bad", [
    lambda m, N: m.Query("bogus"),
    lambda m, N: m.core_of(N + 5),
    lambda m, N: m.degree_of(-1),
    lambda m, N: m.same_component(0, N),
    lambda m, N: m.topk_pagerank(N + 1),
])
def test_submit_errors_equal_reference(bad):
    """(f) `submit` rejects bad ids, kinds and k with the reference's
    exception type and message."""
    jsvc = reference_service()
    jg = _jgraph()
    js = jsvc.QueryServer(_jopen(jg),
                          config=jsvc.ServiceConfig(pr_steps=PR_STEPS))
    ts = tsvc.QueryServer(_open(to_port(jg)),
                          config=tsvc.ServiceConfig(pr_steps=PR_STEPS))
    want = _raised(lambda: js.submit(bad(jsvc, jg.N)))
    assert want is not None and want[0] is ValueError
    assert _raised(lambda: ts.submit(bad(tsvc, jg.N))) == want
    assert ts.queued == 0
    assert (_raised(lambda: tsvc.topk_pagerank(0))
            == _raised(lambda: jsvc.topk_pagerank(0)))


def test_serve_staleness_equals_reference():
    """(g) `serve` with refresh_every=3 drains everything, refreshes once
    more at the end, and reports the reference's staleness."""
    jsvc = reference_service()
    jg = _jgraph()
    ups = _mixed_updates(jg)
    real = np.flatnonzero(np.asarray(jg.node_mask))
    out = {}
    for name, m, sess in (("jax", jsvc, _jopen(jg)),
                          ("torch", tsvc, _open(to_port(jg)))):
        srv = m.QueryServer(sess, config=m.ServiceConfig(
            refresh_every=3, pr_steps=PR_STEPS))

        def feed(i, m=m):
            return [m.core_of(int(real[i % len(real)])), m.topk_pagerank(3)]

        res = srv.serve(list(ups), feed)
        out[name] = (srv.queued, srv.metrics.total_answered,
                     srv.metrics.staleness_max(),
                     srv.metrics.staleness_mean(), srv.state.refreshes,
                     srv.state.epoch, res.stats.batches)
    assert out["torch"] == out["jax"]
    assert out["torch"][:3] == (0, 8, 2)


def _cycle(n=30, P_=4):
    edges = np.array([(i, (i + 1) % n) for i in range(n)], np.int64)
    assign = np.arange(n) % P_
    return tcore.build_blocks(edges, n, assign, P=P_, deg_slack=4,
                              node_slack=3, device=CPU)


def test_topk_ties_in_reference_order():
    """(h) A cycle: every real node carries the same rank and every
    padding row 0.0.  With k past the real nodes the ids are
    `jax.lax.top_k`'s: equal ranks lowest id first."""
    g = _cycle()
    assert g.n_real < g.N
    srv = tsvc.QueryServer(_open(g), config=tsvc.ServiceConfig(
        pr_steps=PR_STEPS))
    rank = srv.state.snapshot.rank.numpy()
    assert len(set(rank[g.node_mask.numpy()].tolist())) == 1  # real ties
    for k in (1, 5, g.n_real, g.n_real + 3, g.N):
        req = srv.submit(tsvc.topk_pagerank(k))
        srv.pump()
        kk = tq.topk_bucket(k, g.N)
        ids, vals = _jax_topk(rank, kk)
        assert req.answer == (ids[:k], vals[:k])


@pytest.mark.parametrize("case", ["zeros", "few_values", "random_ties"])
def test_batch_topk_order_equals_jax(case):
    """(h) The top-k primitive alone, on vectors full of ties."""
    rng = np.random.default_rng(5)
    n = 300
    rank = {"zeros": np.zeros(n, np.float32),
            "few_values": rng.choice(np.float32([0.5, 0.25, 0.0]), n),
            "random_ties": np.round(rng.random(n), 2).astype(np.float32),
            }[case]
    for k in (1, 7, 64, n):
        vals, ids = tq._batch_topk(torch.from_numpy(rank), k)
        want_ids, want_vals = _jax_topk(rank, k)
        assert ids.tolist() == want_ids
        assert vals.tolist() == want_vals


def test_field_lists_equal_reference():
    """(i) `EpochSnapshot`, `Query`, `Request` and `ServiceConfig` have the
    reference's fields, order and defaults; the kinds, batch floor and
    buckets are the reference's."""
    jsvc = reference_service()
    import repro.service.queries as jq
    import repro.service.server as jserver

    assert tsvc.EpochSnapshot._fields == jsvc.EpochSnapshot._fields
    assert len(tsvc.EpochSnapshot._fields) == 14
    assert (tsvc.EpochSnapshot._field_defaults
            == jsvc.EpochSnapshot._field_defaults)
    assert tsvc.Query._fields == jsvc.Query._fields
    assert tsvc.Query._field_defaults == jsvc.Query._field_defaults

    def fields(cls):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]

    def same(a, b):  # NaN defaults compare by identity of their repr
        return repr(fields(a)) == repr(fields(b))

    assert same(tsvc.Request, jserver.Request)
    assert same(tsvc.ServiceConfig, jsvc.ServiceConfig)
    assert tsvc.ServiceConfig() == tsvc.ServiceConfig()
    assert hash(tsvc.ServiceConfig()) == hash(tsvc.ServiceConfig())
    assert tsvc.KINDS == jsvc.KINDS
    assert tq.BATCH_FLOOR == jq.BATCH_FLOOR
    for n in range(1, 300, 7):
        assert tq.batch_bucket(n) == jq.batch_bucket(n)
        for N in (5, 64, 1000):
            assert tq.topk_bucket(n, N) == jq.topk_bucket(n, N)
    assert set(tsvc.__all__) == set(jsvc.__all__) - {"query_trace_count"}


@pytest.mark.parametrize("kw", [
    dict(max_queue=0), dict(max_batch=0), dict(refresh_every=0),
    dict(pr_steps=0), dict(max_queue=-3, max_batch=0),
])
def test_service_config_errors_equal_reference(kw):
    """(i) `ServiceConfig`'s validation errors are the reference's."""
    jsvc = reference_service()
    want = _raised(lambda: jsvc.ServiceConfig(**kw))
    assert want is not None
    assert _raised(lambda: tsvc.ServiceConfig(**kw)) == want
    with pytest.raises(dataclasses.FrozenInstanceError):
        tsvc.ServiceConfig().max_queue = 3


@pytest.mark.parametrize("events", [
    [],
    [("obs", "core", [0.01, 0.02], 0, 0.005), ("shed", "degree")],
    [("obs", "core", [0.5], 1, 0.1), ("obs", "topk_pagerank", [0.2, 0.4], 2,
                                      0.05), ("shed", "core"),
     ("shed", "nbr_max_core"), ("obs", "core", [0.05, 0.3, 0.7], 0, 0.02)],
])
def test_metrics_equal_reference(events):
    """`ServiceMetrics` gives the reference's summary for the same
    observations."""
    jsvc = reference_service()
    jm, tm = jsvc.ServiceMetrics(), tsvc.ServiceMetrics()
    for m in (jm, tm):
        for ev in events:
            if ev[0] == "obs":
                m.observe_batch(ev[1], ev[2], staleness=ev[3], busy_s=ev[4])
            else:
                m.observe_shed(ev[1])
    assert repr(tm.summary()) == repr(jm.summary())  # NaN-aware equality
    assert (tm.total_answered, tm.total_shed) == (jm.total_answered,
                                                  jm.total_shed)


def test_state_needs_labels_and_refuses_mirror():
    """(j) A session without labels, plain or hub-split, raises the
    reference's ValueError; a hub-split session with labels is served
    (its snapshot carries `primary` and `nbr_max`, a plain one neither)."""
    jg = _jgraph()
    g = to_port(jg)
    plain = StreamSession(g, tcore.coreness(g), R=R)
    jplain = reference().StreamSession(jg, jcore.coreness(jg), R=R)
    want = _raised(lambda: reference_service().AnalyticsState(jplain))
    assert want is not None and want[0] is ValueError
    assert _raised(lambda: tsvc.AnalyticsState(plain)) == want
    assert plain.mirror is None

    jg2, jplan, g2, plan = _split_pair()
    jmir = reference().MirrorStream(jg2, jplan, backend="jnp")
    mir = MirrorStream(g2, plan, backend="torch")
    want = _raised(lambda: reference_service().AnalyticsState(jmir))
    assert want is not None and want[0] is ValueError
    assert _raised(lambda: tsvc.AnalyticsState(mir)) == want

    snap = tsvc.AnalyticsState(_open(to_port(jg)), pr_steps=PR_STEPS).snapshot
    assert snap.primary is None and snap.nbr_max is None
    mir = MirrorStream(g2, plan, backend="torch", cc_labels=True)
    snap = tsvc.QueryServer(mir).state.snapshot
    assert snap.primary is not None and snap.nbr_max is not None


# ---------------------------------------------------------------------------
# hub-split sessions
# ---------------------------------------------------------------------------


def _split_pair(threshold=8, n=100, seed=3):
    """tests/test_hub_split.py's split-worthy graph (BA skew + two
    planted hubs, P = 8), split by both packages."""
    from repro.core import hub_split as jhs

    edges = {(0, v) for v in range(1, 1 + threshold * 4)}
    edges |= {(1, v) for v in range(2 + threshold * 4, 2 + threshold * 5)}
    for u, v in barabasi_albert(n, 3, seed=seed):
        if u != v:
            edges.add((min(u, v), max(u, v)))
    assign = np.random.default_rng(seed).integers(0, 8, n)
    jg = jcore.build_blocks(np.array(sorted(edges)), n, assign, P=8,
                            node_slack=64)
    jg2, jplan = jhs.split_hubs(jg, threshold)
    g2, plan = ths.split_hubs(to_port(jg), threshold)
    return jg2, jplan, g2, plan


def _mirror_windows(jplan, edges_of, k=3, width=4, seed=6):
    """k windows of inserts/deletes between primary rows (hubs among
    them, so on-line splits and mirrored deletes happen)."""
    prim = np.flatnonzero(np.asarray(jplan.primary_mask))
    cur = set(edges_of)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        w, tried = [], set()
        while len(w) < width:
            u, v = (int(x) for x in rng.choice(prim, 2))
            if u == v or (min(u, v), max(u, v)) in tried:
                continue
            e = (min(u, v), max(u, v))
            tried.add(e)
            op = -1 if e in cur else +1
            (cur.discard if op < 0 else cur.add)(e)
            w.append((e[0], e[1], op))
        out.append(w)
    return out


def _logical_edges(jg2, jplan):
    """The split graph's edge set between primary rows."""
    nbr, prow = np.asarray(jg2.nbr), np.asarray(jplan.primary_row)
    rows, cols = np.nonzero(nbr >= 0)
    a, b = prow[rows], prow[nbr[rows, cols]]
    return {(int(x), int(y)) for x, y in zip(a, b) if x < y}


def _mirror_oracle(snap, sess):
    """A mirrored recompute on the snapshot's epoch: core, labels and the
    neighbor max coreness over each row's LOGICAL neighborhood."""
    g, plan = sess.g, sess.mirror
    core = tcore.coreness(g, backend="torch", mirror=plan)
    labels = tcore.connected_components(g, backend="torch", mirror=plan)
    prow = plan.primary_row.numpy()
    nbr, c = g.nbr.numpy(), core.numpy()
    best = {}
    for r in range(g.N):
        vals = [int(c[x]) for x in nbr[r] if x >= 0]
        best[prow[r]] = max([best.get(prow[r], -1)] + vals)
    return core, labels, np.array([best[prow[r]] for r in range(g.N)])


def test_mirror_snapshots_equal_reference_and_recompute():
    """Per epoch: the port's snapshot of a MirrorStream equals the
    reference's (ranks within RANK_ATOL) and a mirrored recompute."""
    jsvc = reference_service()
    jg2, jplan, g2, plan = _split_pair()
    jsess = reference().MirrorStream(jg2, jplan, backend="jnp",
                                     cc_labels=True)
    sess = MirrorStream(g2, plan, backend="torch", cc_labels=True)
    jst = jsvc.AnalyticsState(jsess, alpha=ALPHA, pr_steps=PR_STEPS)
    st = tsvc.AnalyticsState(sess, alpha=ALPHA, pr_steps=PR_STEPS)
    windows = _mirror_windows(jplan, _logical_edges(jg2, jplan))
    for i in range(len(windows) + 1):
        if i:
            jsess.apply_window(windows[i - 1])
            sess.apply_window(windows[i - 1])
            jst.refresh()
            st.refresh()
        js, ts = jst.snapshot, st.snapshot
        assert ts.epoch == js.epoch == i and ts.windows == js.windows
        for f in ("core", "labels", "deg", "nbr", "node_mask", "orig_id",
                  "nbr_max"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(ts.primary, js.primary)
        assert ts.primary.dtype == np.int32
        np.testing.assert_allclose(ts.rank.numpy(), np.asarray(js.rank),
                                   atol=RANK_ATOL)
        assert torch.equal(ts.deg, sess.mirror.ldeg)
        assert not ts.rank[~sess.mirror.primary_mask].any()
        core, labels, nbr_max = _mirror_oracle(ts, sess)
        assert torch.equal(ts.core, core) and torch.equal(ts.labels, labels)
        np.testing.assert_array_equal(ts.nbr_max.numpy(), nbr_max)
    assert sess.mirror.n_groups > 1


def test_mirror_answers_at_replica_rows_equal_reference():
    """Every kind, asked at every row (replicas included), answers as the
    reference does; a replica row answers with its hub's values."""
    jsvc = reference_service()
    jg2, jplan, g2, plan = _split_pair()
    jsess = reference().MirrorStream(jg2, jplan, backend="jnp",
                                     cc_labels=True)
    sess = MirrorStream(g2, plan, backend="torch", cc_labels=True)
    js = jsvc.AnalyticsState(jsess, pr_steps=PR_STEPS).snapshot
    ts = tsvc.AnalyticsState(sess, pr_steps=PR_STEPS).snapshot
    N = g2.N
    rng = np.random.default_rng(0)
    for kind, make in (("core", "core_of"), ("degree", "degree_of"),
                       ("nbr_max_core", "nbr_max_core_of")):
        for lo in range(0, N, 64):
            ids = range(lo, min(N, lo + 64))
            jq = [getattr(jsvc, make)(u) for u in ids]
            tq_ = [getattr(tsvc, make)(u) for u in ids]
            assert tq.run_batch(ts, kind, tq_) == \
                jsvc.queries.run_batch(js, kind, jq)
    pairs = rng.integers(0, N, (64, 2)).tolist()
    assert tq.run_batch(ts, "same_component",
                        [tsvc.same_component(u, v) for u, v in pairs]) == \
        jsvc.queries.run_batch(js, "same_component",
                               [jsvc.same_component(u, v) for u, v in pairs])
    got = tq.run_batch(ts, "topk_pagerank", [tsvc.topk_pagerank(8)], k=8)
    want = jsvc.queries.run_batch(js, "topk_pagerank",
                                  [jsvc.topk_pagerank(8)], k=8)
    assert got[0][0] == want[0][0]
    np.testing.assert_allclose(got[0][1], want[0][1], atol=RANK_ATOL)
    hub, rows = next((h, r) for h, r in ths.groups_of(plan).items()
                     if len(r) >= 2)
    for kind, make in (("core", tsvc.core_of), ("degree", tsvc.degree_of),
                       ("nbr_max_core", tsvc.nbr_max_core_of)):
        answers = tq.run_batch(ts, kind, [make(r) for r in rows])
        assert len(set(answers)) == 1, kind
    assert tq.run_batch(ts, "degree", [tsvc.degree_of(rows[1])]) == [
        int(plan.ldeg[hub])]
    assert not set(got[0][0]) & set(rows[1:])


def test_mirror_serving_steps_equal_reference():
    """`QueryServer.step` over a MirrorStream: the reference's answers,
    epochs and metrics counts for a seeded feed with replica-row ids."""
    jsvc = reference_service()
    jg2, jplan, g2, plan = _split_pair()
    cfg = dict(refresh_every=1, pr_steps=PR_STEPS, alpha=ALPHA, max_batch=8)
    js = _recording(jsvc.QueryServer(
        reference().MirrorStream(jg2, jplan, backend="jnp", cc_labels=True),
        config=jsvc.ServiceConfig(**cfg)))
    ts = _recording(tsvc.QueryServer(
        MirrorStream(g2, plan, backend="torch", cc_labels=True),
        config=tsvc.ServiceConfig(**cfg)))
    windows = _mirror_windows(jplan, _logical_edges(jg2, jplan))
    jfeed, tfeed = _feed(jsvc, g2.N, 5), _feed(tsvc, g2.N, 5)
    for i, w in enumerate(windows):
        for srv, feed in ((js, jfeed), (ts, tfeed)):
            for q in feed(i):
                srv.submit(q)
            srv.step(w)
    _assert_same_answers(js.requests, ts.requests)
    replicas = set(np.flatnonzero(np.asarray(jg2.node_mask)
                                  & ~np.asarray(jplan.primary_mask)).tolist())
    asked = {r.query.u for r in ts.requests if r.query.kind != "topk_pagerank"}
    assert asked & replicas, "the feed must ask at replica rows"
    assert (ts.metrics.answered, ts.metrics.batches) == (
        js.metrics.answered, js.metrics.batches)
    assert tuple(ts.session.result().stats) == tuple(
        js.session.result().stats)


@needs_cuda
def test_cuda_serving_equals_torch():
    """(k) On the card: a small `ell` serving loop (the ELL kernels) gives
    the plain run's answers, ranks allclose."""
    jg = _jgraph()
    ups = _mixed_updates(jg)
    dev = torch.device("cuda")
    servers = {}
    for backend, device in (("ell", dev), ("torch", CPU)):
        srv = _recording(tsvc.QueryServer(
            _open(to_port(jg, device), backend),
            config=tsvc.ServiceConfig(pr_steps=PR_STEPS, max_batch=8)))
        srv.serve(list(ups), _feed(tsvc, jg.N, seed=4))
        assert srv.state.snapshot.core.device.type == device.type
        servers[backend] = srv
    _assert_same_answers(servers["torch"].requests, servers["ell"].requests)
    assert servers["ell"].metrics.answered == servers["torch"].metrics.answered
