"""PyTorch port vs the JAX package: the mesh runtime's programs and the
mesh paths of maintenance, the stream, restore, the service and recovery,
at W = 1 in one process (no process group: the exchange is the identity
copy a one-rank all-to-all is).  W = 2, 4, 8 run in spawned gloo ranks
in tests/test_torch_mesh_programs.py.

  * `SpmdEngine` / `coreness_via_spmd`: coreness, superstep traces and
    `message_totals` equal the JAX package's `coreness_via_spmd` and
    `coreness_via_engine` (executed W2W == metered; W2M = P per-block
    flags a superstep), under `overlap` True and False (whose
    `serialized_collectives` are 0 and 1); the host loop (`fuse=False`)
    meters the gathered summaries, as the JAX package's does;
  * the workloads on "ell_spmd" through ONE threaded executor (CC,
    PageRank, triangles, `fused_analytics`), equal to the JAX package's,
    with a spy that no executor or plan is built again;
  * mirrored coreness, CC, PageRank, triangles and `fused_analytics` on
    "ell_spmd", equal to the JAX package's mirrored "jnp" results, with
    the kernels given the split graph's `deg` and the update the logical
    `ldeg`;
  * `maintain_batch` and a multi-window `StreamSession` on the mesh with
    `migrate`, `grow` and `add_vertices`, its plan counters, a
    `state_dict` -> `restore_session(W=1, backend="ell_spmd")`, the query
    service over the mesh session, and the e2e elasticity drill on
    "ell_spmd" (`recover_worker` with `W_old` from the executor), each
    equal to the JAX package's same run.

Integers equal bit for bit; PageRank to ``atol=2e-6``.
Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_spmd_engine.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (fixtures)
    CPU, FLOAT_ATOL, assert_same_state, np_of, one_torch_thread, reference,
    reference_service, tensor_of, to_port)

import repro.core as jcore
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen
from repro.core import hub_split as jhs
from repro.kernels import ops as jops

import repro_torch.core as tcore
import repro_torch.core.kcore_dynamic as tkd
import repro_torch.service as tsvc
from repro_torch.checkpoint import (
    CheckpointManager, restore_session, save_session)
from repro_torch.core import algorithms as talg
from repro_torch.core import hub_split as thub
from repro_torch.kernels import ops
from repro_torch.runtime import recovery as trec
from repro_torch.runtime import spmd as tspmd
from repro_torch.runtime import stream as tstream

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JSTREAM = reference()
import repro.checkpoint as jckpt  # noqa: E402
import repro.runtime.recovery as jrec  # noqa: E402
import repro.runtime.spmd as jspmd  # noqa: E402

SP = "ell_spmd"
PR_STEPS = 10


def _jgraph(P=4, n=150, seed=11, node_slack=0, deg_slack=24):
    edges = jgen.barabasi_albert(n, 4, seed=seed)
    n = int(edges.max()) + 1
    assign = jpart.node_random_partition(n, P, seed=2)
    return jcore.build_blocks(edges, n, assign, P=P, deg_slack=deg_slack,
                              node_slack=node_slack)


def _jclone(jg):
    """A copy the JAX package may donate."""
    return jax.tree.map(lambda x: jnp.copy(x) if hasattr(x, "dtype") else x,
                        jg)


def _mixed(jg, k=3, seed=2):
    return (jupd.sample_insertions(jg, k, "inter", seed=seed)
            + jupd.sample_insertions(jg, k, "intra", seed=seed + 1)
            + jupd.sample_deletions(jg, k, "inter", seed=seed + 2)
            + jupd.sample_deletions(jg, k, "intra", seed=seed + 3))


# ---------------------------------------------------------------------------
# SpmdEngine: traces and message totals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
def test_coreness_via_spmd_traces_equal_reference(P):
    jg = _jgraph(P)
    tg = to_port(jg)
    core, eng = tcore.coreness_via_spmd(tg)
    jcore_, jeng = jcore.coreness_via_spmd(jg)
    core_m, eng_m = tcore.coreness_via_engine(tg)
    np.testing.assert_array_equal(core.numpy(), np.asarray(jcore_))
    assert torch.equal(core, core_m)
    assert len(eng.traces) == len(jeng.traces) == len(eng_m.traces) > 1
    tot, jtot, mtot = (e.message_totals() for e in (eng, jeng, eng_m))
    assert tuple(tot) == tuple(jtot)
    # executed W2W == metered, both splits, every superstep
    assert (tot.w2w_intra, tot.w2w_inter) == (mtot.w2w_intra,
                                              mtot.w2w_inter)
    for a, b, m in zip(eng.traces, jeng.traces, eng_m.traces):
        assert (a.step, a.mode.value, tuple(a.stats)) == \
            (b.step, b.mode.value, tuple(b.stats))
        assert (a.stats.w2w_intra, a.stats.w2w_inter) == \
            (m.stats.w2w_intra, m.stats.w2w_inter)
        assert a.serialized_collectives == b.serialized_collectives == 0
    # the W2M summary carries per-BLOCK flags: P a superstep
    assert tot.w2m == P * len(eng.traces)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("fuse", [True, False])
def test_run_spmd_loops_and_metering_equal_reference(overlap, fuse):
    """Both loops of `run_spmd` on the coreness program and on a block
    program: the same states, trace counts and per-superstep stats as the
    JAX package's, `serialized_collectives` = 0 with overlap, 1 without;
    the fused loop meters a block program's declared (1,) flag, the host
    loop the gathered per-worker flags."""
    jg = _jgraph(4)
    tg = to_port(jg)
    ex = tspmd.SpmdExecutor(tg, overlap=overlap)
    jex = jspmd.SpmdExecutor(jg, W=1, overlap=overlap)
    est0 = torch.where(tg.node_mask, tg.deg, 0).to(torch.int32)
    jest0 = jnp.where(jg.node_mask, jg.deg, 0).astype(jnp.int32)
    cc, jcc = talg.ConnectedComponentsProgram(), \
        jcore.ConnectedComponentsProgram()
    runs = [
        (tspmd.SpmdCorenessProgram(), jspmd.SpmdCorenessProgram(), est0,
         jest0),
        (tspmd.SpmdBlockProgram(cc, tg.n_real),
         jspmd.SpmdBlockProgram(jcc, int(jg.n_real)), cc.init(tg),
         jcc.init(jg)),
    ]
    for prog, jprog, s0, js0 in runs:
        eng = tspmd.SpmdEngine(tg, executor=ex)
        jeng = jspmd.SpmdEngine(jg, executor=jex)
        out, m = eng.run_spmd(prog, s0, None, fuse=fuse)
        jout, jm = jeng.run_spmd(jprog, js0, None, fuse=fuse)
        assert m is None and jm is None
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert len(eng.traces) == len(jeng.traces) > 1
        for a, b in zip(eng.traces, jeng.traces):
            assert (a.step, tuple(a.stats)) == (b.step, tuple(b.stats))
            assert a.serialized_collectives == b.serialized_collectives \
                == (0 if overlap else 1)
        assert tuple(eng.message_totals()) == tuple(jeng.message_totals())
    assert runs[1][0].summary_shape().shape == (1,)
    assert runs[1][0] == tspmd.SpmdBlockProgram(cc, tg.n_real)
    assert hash(runs[0][0]) == hash(tspmd.SpmdCorenessProgram())


def test_run_spmd_respects_max_supersteps():
    jg = _jgraph(4)
    tg = to_port(jg)
    eng = tspmd.SpmdEngine(tg)
    est0 = torch.where(tg.node_mask, tg.deg, 0).to(torch.int32)
    full, _ = eng.run_spmd(tspmd.SpmdCorenessProgram(), est0, None)
    n = len(eng.traces)
    for cap in (0, 3, n):
        e = tspmd.SpmdEngine(tg, executor=eng.ex)
        jcap = jspmd.SpmdEngine(jg, W=1)
        got, _ = e.run_spmd(tspmd.SpmdCorenessProgram(), est0, None,
                            max_supersteps=cap)
        want, _ = jcap.run_spmd(
            jspmd.SpmdCorenessProgram(),
            jnp.where(jg.node_mask, jg.deg, 0).astype(jnp.int32), None,
            max_supersteps=cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert len(e.traces) == len(jcap.traces) == min(cap, n)
    assert torch.equal(got, full)


# ---------------------------------------------------------------------------
# the workloads on one threaded executor
# ---------------------------------------------------------------------------


def test_workloads_thread_one_executor(monkeypatch):
    """CC, PageRank, triangles and `fused_analytics` on "ell_spmd" through
    one executor equal the JAX package's, and no executor or halo plan is
    built after it (after tests/test_workloads.py:241)."""
    jg = _jgraph(4, seed=5)
    tg = to_port(jg)
    ex = tspmd.SpmdExecutor(tg)
    built = []
    for name in ("SpmdExecutor", "build_halo_plan"):
        real = getattr(tspmd, name)

        def spy(*a, _real=real, _name=name, **kw):
            built.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(tspmd, name, spy)
    got = {
        "cc": tcore.connected_components(tg, backend=SP, executor=ex,
                                         with_steps=True),
        "pr": tcore.pagerank(tg, backend=SP, executor=ex, with_steps=True),
        "pr30": tcore.pagerank(tg, tol=None, max_steps=30, backend=SP,
                               executor=ex, with_steps=True),
        "tri": tcore.triangle_counts(tg, backend=SP, executor=ex,
                                     with_steps=True),
        "fused": tcore.fused_analytics(tg, steps=PR_STEPS, backend=SP,
                                       executor=ex, with_steps=True),
        "core": tcore.coreness(tg, backend=SP, executor=ex),
    }
    assert built == [] and ex.plan_updates == ex.full_rebuilds == 0
    want = {
        "cc": jcore.connected_components(jg, backend="jnp", with_steps=True),
        "pr": jcore.pagerank(jg, backend="jnp", with_steps=True),
        "pr30": jcore.pagerank(jg, tol=None, max_steps=30, backend="jnp",
                               with_steps=True),
        "tri": jcore.triangle_counts(jg, backend="jnp", with_steps=True),
        "fused": jcore.fused_analytics(jg, steps=PR_STEPS, backend="jnp",
                                       with_steps=True),
        "core": jcore.coreness(jg, backend="jnp"),
    }
    for k in got:
        assert_same_state(got[k], want[k], k)
    # and warm-started from maintained values, as the service refreshes
    labels = got["cc"][0]
    assert_same_state(
        tcore.fused_analytics(tg, steps=PR_STEPS, backend=SP, executor=ex,
                              init=(got["core"], labels)),
        jcore.fused_analytics(jg, steps=PR_STEPS, backend="jnp",
                              init=(want["core"], want["cc"][0])))


def test_neighbor_combine_refuses_the_mesh_as_reference():
    jg = _jgraph(2)
    tg = to_port(jg)
    for combine in ("min", "hindex"):
        with pytest.raises(ValueError, match="run_block_program"):
            jops.neighbor_combine_blocks(jg, jg.deg, combine, backend=SP)
        with pytest.raises(ValueError, match="run_block_program"):
            ops.neighbor_combine_blocks(tg, tg.deg, combine, backend=SP)


# ---------------------------------------------------------------------------
# mirrored runs on the mesh
# ---------------------------------------------------------------------------


def _split(threshold):
    jg = _jgraph(4, n=140, seed=13, node_slack=24)
    jg2, jplan = jhs.split_hubs(jg, threshold=threshold)
    g2, plan = thub.split_hubs(to_port(jg), threshold)
    assert plan.n_groups > 0
    return (g2, plan), (jg2, jplan)


@pytest.mark.parametrize("threshold", [10, 16])
def test_mirrored_runs_equal_reference(threshold, monkeypatch):
    """Mirrored coreness, CC, PageRank, triangles and `fused_analytics` on
    "ell_spmd" equal the JAX package's mirrored "jnp" results; every
    kernel is given the split graph's row lengths, every update the
    logical degrees (the hub-mirroring rule, on the mesh)."""
    (g2, plan), (jg2, jplan) = _split(threshold)
    seen, ctx_deg = [], []

    def spy(name, real):
        def call(nbr, field, *a, **kw):
            seen.append((name, kw.get("deg")))
            return real(nbr, field, *a, **kw)
        return call

    for name in ("neighbor_min_ell", "neighbor_sum_ell", "hindex_ell",
                 "neighbor_common_ell", "neighbor_multi_ell"):
        monkeypatch.setattr(ops, name, spy(name, getattr(ops, name)))
    real_update = talg.PageRankProgram.update

    def update(self, ctx, state, red):
        ctx_deg.append(ctx.deg)
        return real_update(self, ctx, state, red)
    monkeypatch.setattr(talg.PageRankProgram, "update", update)

    ex = tspmd.SpmdExecutor(g2)
    got = (tcore.coreness(g2, backend=SP, executor=ex, mirror=plan),
           tcore.connected_components(g2, backend=SP, executor=ex,
                                      mirror=plan),
           tcore.pagerank(g2, tol=None, max_steps=PR_STEPS, backend=SP,
                          executor=ex, mirror=plan),
           tcore.triangle_counts(g2, backend=SP, mirror=plan),
           tcore.fused_analytics(g2, steps=PR_STEPS, backend=SP,
                                 executor=ex, mirror=plan))
    want = (jcore.coreness(jg2, backend="jnp", mirror=jplan),
            jcore.connected_components(jg2, backend="jnp", mirror=jplan),
            jcore.pagerank(jg2, tol=None, max_steps=PR_STEPS, backend="jnp",
                           mirror=jplan),
            jcore.triangle_counts(jg2, backend="jnp", mirror=jplan),
            jcore.fused_analytics(jg2, steps=PR_STEPS, backend="jnp",
                                  mirror=jplan))
    assert_same_state(got, want)
    names = {n for n, _ in seen}
    assert names == {"neighbor_min_ell", "neighbor_sum_ell", "hindex_ell",
                     "neighbor_common_ell", "neighbor_multi_ell"}
    for name, deg in seen:
        assert deg is not None and torch.equal(deg, g2.deg), name
    assert ctx_deg and all(torch.equal(d, plan.ldeg) for d in ctx_deg)
    assert not torch.equal(plan.ldeg, g2.deg)


def test_mirror_stream_on_the_mesh_equals_reference():
    (g2, plan), (jg2, jplan) = _split(12)
    pm = np.flatnonzero(np.asarray(jplan.primary_mask)
                        & np.asarray(jg2.node_mask))
    rng = np.random.default_rng(4)
    nbr = np.asarray(jg2.nbr)
    prow = np.asarray(jplan.primary_row)
    have = {(min(int(prow[u]), int(prow[v])), max(int(prow[u]), int(prow[v])))
            for u in pm for v in nbr[u] if v >= 0}
    ins = []
    while len(ins) < 6:
        u, v = (int(x) for x in rng.choice(pm, 2, replace=False))
        key = (min(u, v), max(u, v))
        if key not in have:
            have.add(key)
            ins.append((u, v, +1))
    t = tstream.MirrorStream(g2, plan, backend=SP, cc_labels=True)
    j = JSTREAM.MirrorStream(jg2, jplan, backend="jnp", cc_labels=True)
    assert t.executor is None
    for w in (ins[:3], ins[3:], [(u, v, -1) for u, v, _ in ins[:2]]):
        t.apply_window(w)
        j.apply_window(w)
        assert_same_state(t.result(), j.result())


# ---------------------------------------------------------------------------
# maintenance and the stream on the mesh
# ---------------------------------------------------------------------------


def test_maintain_batch_on_the_mesh_equals_reference():
    jg = _jgraph(4, seed=7)
    ups = _mixed(jg, 3)
    jc = jcore.coreness(jg, backend="jnp")
    tg = to_port(jg)
    for R in (1, 4):
        got = tkd.maintain_batch(tg.clone(), tensor_of(jc), ups, R=R,
                                 backend=SP, W=1)
        want = jcore.maintain_batch(_jclone(jg), jc, ups, R=R, backend="jnp")
        assert_same_state(got, want, f"R={R}")
    with pytest.raises(ValueError, match="maintain_batch"):
        tkd.maintain_batch_host(tg.clone(), tensor_of(jc), ups, backend=SP)
    for fn in (tkd.insert_edge_maintain, tkd.delete_edge_maintain):
        with pytest.raises(ValueError, match=SP):
            fn(tg.clone(), tensor_of(jc), 0, 1, backend=SP)


def _sessions(jg, **kw):
    """The same mesh session in both packages (CC labels kept)."""
    tg = to_port(jg)
    t = tstream.StreamSession(tg, tcore.coreness(tg), R=4, backend=SP,
                              cc_labels=tcore.connected_components(tg), **kw)
    jgc = _jclone(jg)
    j = JSTREAM.StreamSession(
        jgc, jcore.coreness(jgc, backend="jnp"), R=4, backend=SP,
        cc_labels=jcore.connected_components(jgc, backend="jnp"), **kw)
    return t, j


def test_stream_session_elastic_on_the_mesh_equals_reference():
    """Four windows, a migration, a Cn grow and a vertex arrival with its
    window, on "ell_spmd" in both packages: the same graph, coreness,
    labels and `StreamStats` after every step (plan counters included:
    one incremental update a window and sequential update, one rebuild a
    migration), and one executor throughout."""
    jg = _jgraph(4, seed=9, node_slack=8)
    ups = _mixed(jg, 4, seed=5)
    t, j = _sessions(jg)
    ex = t.executor
    assert ex is not None and ex.wm.W == 1
    for i in range(0, len(ups), 4):
        t.apply_window(ups[i:i + 4])
        j.apply_window(ups[i:i + 4])
        assert_same_state(t, j, f"window {i // 4}")
    assert t.stats().plan_updates > 0 == t.stats().plan_rebuilds
    b0 = np.flatnonzero(np.asarray(jg.node_mask)[:jg.Cn])[:2]
    moves = [(int(u), 2) for u in b0]
    np.testing.assert_array_equal(t.migrate(moves), j.migrate(moves))
    assert_same_state(t, j, "migrate")
    assert t.stats().plan_rebuilds == 1
    np.testing.assert_array_equal(t.grow(Cn=2 * jg.Cn),
                                  j.grow(Cn=2 * jg.Cn))
    assert ex.grows == 1 and ex.wm.Cn == 2 * jg.Cn
    assert_same_state(t, j, "grow")
    h = t.add_vertices(1, 2)
    assert h == j.add_vertices(1, 2)
    w = [(h[0], int(b0[0]), +1), (h[1], h[0], +1)]
    t.apply_window(w)
    j.apply_window(w)
    assert_same_state(t, j, "add_vertices")
    assert t.executor is ex


def test_state_dict_restores_onto_the_mesh(tmp_path):
    """`state_dict` -> `restore_session(W=1, backend="ell_spmd")` resumes
    where the session was, with the plan counters carried on, and then
    matches an uninterrupted session window for window."""
    jg = _jgraph(4, seed=3)
    ups = _mixed(jg, 4, seed=11)
    t, _ = _sessions(jg)
    ws = [ups[i:i + 4] for i in range(0, len(ups), 4)]
    for w in ws[:2]:
        t.apply_window(w)
    mgr = CheckpointManager(str(tmp_path))
    save_session(mgr, t)
    _, back, meta = restore_session(mgr, W=1, backend=SP, device=CPU)
    assert back.executor is not None and back.executor is not t.executor
    assert meta["counters"]["plan_updates"] == t.stats().plan_updates > 0
    assert_same_state(back, t)
    for w in ws[2:]:
        back.apply_window(w)
        t.apply_window(w)
        assert_same_state(back, t)
    # a snapshot of a single-device session restores onto the mesh too
    tg = to_port(jg)
    plain = tstream.StreamSession(tg, tcore.coreness(tg), R=4,
                                  cc_labels=tcore.connected_components(tg))
    for w in ws[:2]:
        plain.apply_window(w)
    arrays, meta = plain.state_dict()
    mesh = tstream.StreamSession.from_state(arrays, meta, backend=SP,
                                            device=CPU)
    for w in ws[2:]:
        mesh.apply_window(w)
        plain.apply_window(w)
    assert mesh.stats().plan_updates > 0
    assert_same_state((mesh.g, mesh.core, mesh.labels,
                       mesh.stats()._replace(plan_updates=0)),
                      (plain.g, plain.core, plain.labels, plain.stats()))


def test_service_over_a_mesh_session():
    """`AnalyticsState` over a mesh session equals the JAX package's over
    its mesh session, epoch after epoch, and a `QueryServer` answers the
    same queries as over a single-device session."""
    jsvc = reference_service()
    jg = _jgraph(4, seed=6)
    ups = _mixed(jg, 2, seed=8)
    t, j = _sessions(jg)
    ts = tsvc.AnalyticsState(t, pr_steps=PR_STEPS)
    js = jsvc.AnalyticsState(j, pr_steps=PR_STEPS)
    assert_same_state(ts.snapshot, js.snapshot, "epoch 0")
    for i in range(0, len(ups), 4):
        t.apply_window(ups[i:i + 4])
        j.apply_window(ups[i:i + 4])
        assert_same_state(ts.refresh(), js.refresh(), f"epoch {i // 4}")
    tg = to_port(jg)
    answers = []
    for backend in (SP, "torch"):
        sess = tstream.StreamSession(
            tg.clone(), tcore.coreness(tg), R=4, backend=backend,
            cc_labels=tcore.connected_components(tg))
        srv = tsvc.QueryServer(sess, config=tsvc.ServiceConfig(
            max_batch=8, refresh_every=1, pr_steps=PR_STEPS))
        reqs = []

        def feed(i):
            qs = [tsvc.core_of(3 + i), tsvc.degree_of(5 + i),
                  tsvc.nbr_max_core_of(7 + i), tsvc.same_component(1, 9 + i),
                  tsvc.topk_pagerank(4)]
            reqs.append(qs)
            return qs

        reqs = [srv.submit(q) for q in feed(0)]
        srv.serve(ups, lambda i: [])
        srv.serve([], None)
        answers.append([r.answer for r in reqs])
    assert_same_state(answers[0], answers[1])


def test_e2e_recovery_drill_on_the_mesh(tmp_path):
    """The e2e elasticity drill on "ell_spmd" (after tests/test_faults.py:
    297-327): tight capacities grown by auto-grow, a checkpoint, a worker
    lost and recovered onto the mesh (the coordinator reads W_old from
    the executor when not given; the paper's block-worker here, W_old =
    P), the stream going on; equal to the JAX package's same drill, and
    exact against a recompute."""
    jg = _jgraph(4, n=90, seed=4, node_slack=4, deg_slack=1)
    rng = np.random.default_rng(1)
    real = np.flatnonzero(np.asarray(jg.node_mask))
    have = {(min(int(u), int(v)), max(int(u), int(v)))
            for u in real for v in np.asarray(jg.nbr)[u] if v >= 0}
    hub = int(np.argmax(np.asarray(jg.deg)))  # fills its row: a Cd grow
    ws = []
    for i in range(6):
        w = []
        while len(w) < 4:
            u, v = (int(x) for x in rng.choice(real, 2, replace=False))
            if i == 0:
                u = hub
            if u == v:
                continue
            key = (min(u, v), max(u, v))
            if key not in have:
                have.add(key)
                w.append((u, v, +1))
        ws.append(w)
    t, j = _sessions(jg, auto_grow=True)
    coord = trec.ElasticCoordinator(t, CheckpointManager(str(tmp_path / "t")))
    jcoord = jrec.ElasticCoordinator(
        j, jckpt.CheckpointManager(str(tmp_path / "j")))
    P = jg.P
    for i, w in enumerate(ws):
        if i == 3:
            coord.checkpoint()
            jcoord.checkpoint()
        if i == 5:
            coord.recover_worker(1, W_old=P, backend=SP)
            jcoord.recover_worker(1, W_old=P, backend=SP)
            assert coord.session.executor is not None
        coord.apply_window(w)
        jcoord.apply_window(w)
        assert_same_state(coord.session, jcoord.session, f"window {i}")
    s = coord.session
    assert s._grows >= 1 and s.stats().migrations == 1
    mask = s.g.node_mask.view(P, -1)
    assert not mask[1].any()
    assert torch.equal(s.core, tcore.coreness(s.g, backend="torch"))
    assert torch.equal(s.labels,
                       tcore.connected_components(s.g, backend="torch"))
    snap = tsvc.AnalyticsState(s, pr_steps=PR_STEPS).snapshot
    np.testing.assert_allclose(
        snap.rank.numpy(),
        tcore.pagerank(s.g, tol=None, max_steps=PR_STEPS).numpy(),
        rtol=0, atol=FLOAT_ATOL)
    # W_old from the executor: one worker of W = 1 held every block
    assert s.executor.wm.W == 1
