"""PyTorch port vs the JAX package: the mesh runtime's executor.

`repro_torch.runtime.spmd.SpmdExecutor` (one process per worker on
`torch.distributed`) against the JAX package's `SpmdExecutor`:

  * W = 1 in process: coreness, h-index, frontier hop, k-reachability and
    the clamped recompute equal the JAX package's W = 1 executor —
    values and superstep counts — under `overlap=True` and `False`, and
    `ops.hindex_blocks` / `frontier_blocks` / `coreness_blocks` with
    ``backend="ell_spmd"`` equal the JAX package's;
  * W in {2, 4, 8} by gloo: W spawned ranks on the CPU, each holding the
    graph, each returning global results that must equal the JAX
    package's single-device "jnp" results (values and counts), which the
    JAX package asserts every W gives (`runtime/spmd.py:36-39`); P = 8,
    so W = 2 folds four blocks onto each worker.  The jobs have time
    limits (`_torch_mesh_worker.JOB_TIMEOUT`, a 60 s collective timeout);
  * each local superstep runs the port's kernel wrappers (`hindex_ell`,
    `frontier_step_ell`) on the shard's rows and a field longer than
    them;
  * every other entry point that takes a backend does with "ell_spmd"
    what the JAX package does at W = 1: the same values and counts, or
    the same exception type where it refuses.  (The programs, workloads,
    maintenance, stream, restore and service on the mesh are held further
    in tests/test_torch_spmd_engine.py, W = 1, and
    tests/test_torch_mesh_programs.py, W = 2, 4, 8.)

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_mesh.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (fixtures)
    CPU, assert_same_state, np_of, one_torch_thread, reference,
    reference_service, tensor_of, to_port)
import _torch_mesh_worker as mesh_worker

import repro.core as jcore
import repro.core.kcore_dynamic as jkd
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen
from repro.core import hub_split as jhs
from repro.kernels import ops as jops

import repro_torch.core as tcore
import repro_torch.core.algorithms as talg
import repro_torch.core.hub_split as thub
import repro_torch.core.kcore_dynamic as tkd
from repro_torch.checkpoint import CheckpointManager, restore_session
from repro_torch.kernels import ops
from repro_torch.runtime import mesh as tmesh
from repro_torch.runtime import spmd as tspmd
from repro_torch.runtime import stream as tstream
import repro_torch.service as tsvc

pytestmark = pytest.mark.usefixtures("one_torch_thread")

reference()  # the JAX runtime package, imported with its warning ignored
import repro.runtime.mesh as jmesh  # noqa: E402
import repro.runtime.spmd as jspmd  # noqa: E402

R = 3


def _jgraph(kind="ba", P=8, seed=2):
    if kind == "ba":
        edges = jgen.barabasi_albert(180, 4, seed=11)
        n = int(edges.max()) + 1
    else:
        edges = jgen.erdos_renyi(150, 450, seed=5)
        n = 150
    assign = jpart.node_random_partition(n, P, seed=seed)
    return jcore.build_blocks(edges, n, assign, P=P, deg_slack=48)


def _inputs(jg, seed=0):
    """Host inputs of every primitive, made from a seed with numpy:
    est, frontier masks, roots/k levels of searches that expand, and a
    clamped-recompute start; plus a mixed update window."""
    rng = np.random.default_rng(seed)
    core = np.asarray(jops.coreness_blocks(jg, backend="jnp"))
    real = np.flatnonzero(np.asarray(jg.node_mask))
    us = rng.choice(real, R, replace=False)
    roots = np.zeros((jg.N, R), bool)
    roots[us, np.arange(R)] = True
    cand = rng.random(jg.N) < 0.3
    deg = np.asarray(jg.deg)
    window = (jupd.sample_insertions(jg, 3, "inter", seed=seed + 4)
              + jupd.sample_deletions(jg, 3, "inter", seed=seed + 5))
    return dict(
        est=rng.integers(0, 12, jg.N).astype(np.int32),
        f=rng.random((jg.N, R)) < 0.1, elig=rng.random((jg.N, R)) < 0.8,
        vis=rng.random((jg.N, R)) < 0.1, core=core.astype(np.int32),
        roots=roots, ks=core[us].astype(np.int32),
        est0=np.minimum(core + cand, deg).astype(np.int32), cand=cand,
        window=np.asarray(window, np.int64))


def _want(jg, x):
    """The JAX package's single-device "jnp" results on the inputs."""
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "window"}
    core, steps = jops.coreness_blocks(jg, backend="jnp", with_steps=True)
    reach, reach_steps = jkd.k_reachable_batch(
        jg, j["core"], j["roots"], j["ks"], backend="jnp")
    rec, rec_steps = jkd._restricted_recompute(
        jg, j["est0"], j["cand"], backend="jnp")
    window = [tuple(int(v) for v in e) for e in x["window"]]
    jg2 = jupd.apply_updates_host(jg, window)
    core2, steps2 = jops.coreness_blocks(jg2, backend="jnp", with_steps=True)
    return dict(
        core=np_of(core), core_steps=int(steps),
        hindex=np_of(jops.hindex_blocks(jg, j["est"], backend="jnp")),
        frontier=np_of(jops.frontier_blocks(
            jg, j["f"], j["elig"], j["vis"], backend="jnp")),
        frontier_shared=np_of(jops.frontier_blocks(
            jg, j["f"], j["elig"][:, 0], j["vis"], backend="jnp")),
        reach=np_of(reach), reach_steps=int(reach_steps),
        rec=np_of(rec), rec_steps=int(rec_steps),
        updated_core=np_of(core2), updated_steps=int(steps2))


@pytest.fixture(scope="module")
def case():
    """P = 8 graph, its inputs (the ranks' `case`) and the reference."""
    jg = _jgraph()
    x = _inputs(jg)
    tg = to_port(jg)
    want = _want(jg, x)
    c = dict(tg.to_numpy(), P=np.asarray(tg.P), Cn=np.asarray(tg.Cn),
             Cd=np.asarray(tg.Cd), **x)
    return c, want


def _check_rank(res, want, W):
    for ov in (1, 0):
        p = f"ov{ov}_"
        assert int(res[p + "W"]) == W
        for k in ("core", "hindex", "frontier", "frontier_shared", "reach",
                  "rec"):
            np.testing.assert_array_equal(res[p + k], want[k],
                                          err_msg=f"W={W} overlap={ov} {k}")
        for k in ("core_steps", "reach_steps", "rec_steps"):
            assert int(res[p + k]) == want[k], (W, ov, k)
    np.testing.assert_array_equal(res["updated_core"], want["updated_core"])
    np.testing.assert_array_equal(res["spmd_core"], want["updated_core"])
    assert int(res["updated_steps"]) == want["updated_steps"]
    assert int(res["plan_updates"]) == 1


# ---------------------------------------------------------------------------
# mesh geometry
# ---------------------------------------------------------------------------


def test_best_worker_count_divisor_rule():
    for P, nd, w in ((8, 8, 8), (8, 5, 4), (6, 4, 3), (4, 1, 1), (1, 16, 1)):
        assert tmesh.best_worker_count(P, nd) == w == \
            jmesh.best_worker_count(P, nd)
    with pytest.raises(ValueError):
        tmesh.best_worker_count(0, 4)
    assert tmesh.AXIS == jmesh.AXIS


def test_worker_mesh_fold_geometry_and_errors():
    tg = to_port(_jgraph(P=4))
    wm = tmesh.make_worker_mesh(tg, W=1)
    assert (wm.W, wm.B, wm.S) == (1, 4, 4 * tg.Cn)
    assert wm.N == tg.N and wm.worker_of(tg.N - 1) == 0
    assert wm.group is None and wm.device == tg.device
    with pytest.raises(ValueError):
        tmesh.make_worker_mesh(tg, W=3)  # no group: only W = 1
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_worker_mesh(tg, W=2)
    fold = tmesh.WorkerMesh(group=None, W=2, P=4, B=2, Cn=tg.Cn)
    assert (fold.S, fold.worker_of(fold.S), fold.worker_of(fold.S - 1)) == \
        (2 * tg.Cn, 1, 0)


# ---------------------------------------------------------------------------
# W = 1 in process, against the JAX package's W = 1 executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,P", [("ba", 2), ("ba", 8), ("er", 4)])
def test_w1_executor_equals_reference_executor(kind, P):
    jg = _jgraph(kind, P)
    x = _inputs(jg, seed=P)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    jex = jspmd.SpmdExecutor(jg, W=1)
    jcore_, jsteps = jex.coreness()
    jreach, jreach_steps = jex.k_reachable_batch(
        jnp.asarray(x["core"]), jnp.asarray(x["roots"]), jnp.asarray(x["ks"]))
    jrec, jrec_steps = jex.restricted_recompute(
        jnp.asarray(x["est0"]), jnp.asarray(x["cand"]))
    jh = np_of(jex.hindex(jnp.asarray(x["est"])))
    jf = np_of(jex.frontier(jnp.asarray(x["f"]), jnp.asarray(x["elig"]),
                            jnp.asarray(x["vis"])))
    tg = to_port(jg)
    for overlap in (True, False):
        ex = tspmd.SpmdExecutor(tg, overlap=overlap)
        assert ex.wm.W == 1 and ex.plan.H == jex.plan.H
        core, steps = ex.coreness()
        np.testing.assert_array_equal(core.numpy(), np_of(jcore_))
        assert steps == int(jsteps)
        np.testing.assert_array_equal(ex.hindex(t["est"]).numpy(), jh)
        np.testing.assert_array_equal(
            ex.frontier(t["f"], t["elig"], t["vis"]).numpy(), jf)
        reach, reach_steps = ex.k_reachable_batch(t["core"], t["roots"],
                                                  t["ks"])
        np.testing.assert_array_equal(reach.numpy(), np_of(jreach))
        assert reach_steps == int(jreach_steps) > 0
        rec, rec_steps = ex.restricted_recompute(t["est0"], t["cand"])
        np.testing.assert_array_equal(rec.numpy(), np_of(jrec))
        assert rec_steps == int(jrec_steps)


def test_w1_run_case_equals_reference(case):
    """The gloo ranks' whole case, run alone in this process (W = 1, the
    identity exchange)."""
    c, want = case
    _check_rank(mesh_worker.run_case(c), want, 1)


def test_ops_dispatch_ell_spmd_equals_reference():
    jg = _jgraph("ba", 4)
    tg = to_port(jg)
    x = _inputs(jg, seed=1)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ex = tspmd.SpmdExecutor(tg)
    for kw in ({}, {"executor": ex}):
        np.testing.assert_array_equal(
            ops.hindex_blocks(tg, t["est"], backend="ell_spmd", **kw).numpy(),
            np_of(jops.hindex_blocks(jg, jnp.asarray(x["est"]),
                                     backend="ell_spmd")))
        for elig in (x["elig"], x["elig"][:, 0]):
            np.testing.assert_array_equal(
                ops.frontier_blocks(tg, t["f"], torch.from_numpy(elig),
                                    t["vis"], backend="ell_spmd",
                                    **kw).numpy(),
                np_of(jops.frontier_blocks(
                    jg, jnp.asarray(x["f"]), jnp.asarray(elig),
                    jnp.asarray(x["vis"]),
                    backend="ell_spmd")))
        core, steps = ops.coreness_blocks(tg, backend="ell_spmd",
                                          with_steps=True, **kw)
        jc, js = jops.coreness_blocks(jg, backend="ell_spmd", with_steps=True)
        np.testing.assert_array_equal(core.numpy(), np_of(jc))
        assert steps == int(js)
    assert torch.equal(tcore.coreness(tg, backend="ell_spmd"),
                       tcore.coreness(tg, backend="torch"))
    assert torch.equal(tspmd.coreness_spmd(tg), core)
    assert torch.equal(tspmd.hindex_spmd(tg, t["est"]),
                       ops.hindex_blocks(tg, t["est"], backend="torch"))


def test_executor_plan_maintenance_counters_and_parity():
    """`apply_updates` keeps mesh results equal to a recompute and counts
    incremental maintenance against full rebuilds; `grow` refits the
    mesh to a grown graph (the port of the JAX package's
    `test_executor_apply_updates_counters_and_parity`)."""
    jg = _jgraph("ba", 4, seed=9)
    tg = to_port(jg)
    ex = tspmd.SpmdExecutor(tg)
    assert (ex.full_rebuilds, ex.plan_updates, ex.grows) == (0, 0, 0)
    for i in range(3):
        window = (jupd.sample_insertions(jg, 2, "inter", seed=20 + i)
                  + jupd.sample_deletions(jg, 2, "intra", seed=30 + i))
        jg = jupd.apply_updates_host(jg, window)
        tg = to_port(jg)
        ex.apply_updates(tg, window)
        np.testing.assert_array_equal(
            ex.coreness()[0].numpy(),
            np_of(jops.coreness_blocks(jg, backend="jnp")))
    assert (ex.plan_updates, ex.full_rebuilds) == (3, 0)
    ex.rebuild(tg)
    assert ex.full_rebuilds == 1
    assert torch.equal(ex.coreness()[0], tcore.coreness(tg))
    tg2, _ = tg.grow(Cn=2 * tg.Cn)
    ex.grow(tg2)
    assert ex.grows == 1 and ex.wm.Cn == tg2.Cn and ex.wm.S == tg2.N
    assert torch.equal(ex.coreness()[0], tcore.coreness(tg2))
    ex.refresh_fields(tg2)
    assert torch.equal(ex.hindex(tg2.deg),
                       ops.hindex_blocks(tg2, tg2.deg, backend="torch"))


def test_local_superstep_runs_the_kernel_wrappers(monkeypatch):
    """Each superstep calls `hindex_ell` / `frontier_step_ell` on the
    shard's rows (the local-frame adjacency with PAD = -1), with the
    shard's `deg` and column bound, on a field of S + H + 2 rows."""
    tg = to_port(_jgraph("er", 4))
    ex = tspmd.SpmdExecutor(tg)
    seen = []

    def spy(real):
        def call(nbr, field, *args, **kw):
            seen.append((real.__name__, nbr, field.shape[0], kw))
            return real(nbr, field, *args, **kw)
        return call

    monkeypatch.setattr(tspmd, "hindex_ell", spy(tspmd.hindex_ell))
    monkeypatch.setattr(tspmd, "frontier_step_ell",
                        spy(tspmd.frontier_step_ell))
    ex.coreness()
    f = torch.zeros((tg.N, 2), dtype=torch.bool)
    f[:3] = True
    ex.frontier(f, torch.ones_like(f), torch.zeros_like(f))
    names = {s[0] for s in seen}
    assert names == {"hindex_ell", "frontier_step_ell"}
    S, H = ex.wm.S, ex.plan.H
    for _, nbr, rows, kw in seen:
        assert rows == S + H + 2 > nbr.shape[0] == S
        assert torch.equal(nbr, tg.nbr)  # W = 1: the local frame is global
        assert torch.equal(kw["deg"], tg.deg)
        assert kw["K"] == ops.degree_bound(tg)


# ---------------------------------------------------------------------------
# W > 1: spawned gloo ranks on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", (2, 4, 8))
def test_gloo_mesh_equals_single_device_reference(W, case, tmp_path):
    c, want = case
    results = mesh_worker.spawn_mesh(W, c, tmp_path)
    assert len(results) == W
    for res in results:
        _check_rank(res, want, W)


# ---------------------------------------------------------------------------
# "ell_spmd" on every other entry point that takes a backend
# ---------------------------------------------------------------------------


#: every entry point that refused "ell_spmd" before the mesh runtime's
#: programs and mesh maintenance were ported; each case now holds the
#: port against the JAX package at W = 1 (`test_ell_spmd_refused_elsewhere`)
REFUSED = ("run_block_program", "neighbor_combine_blocks",
           "connected_components", "pagerank", "triangle_counts",
           "coreness(mirror=)", "MirrorStream", "k_reachable_batch",
           "_restricted_recompute", "insert_edge_maintain", "maintain_batch",
           "maintain_batch_host", "StreamSession", "run_stream",
           "StreamSession.from_state", "restore_session",
           "the query service")

#: (port, JAX package) exception types of the cases that refuse the mesh:
#: the JAX package's own refusals, and its host loop, which takes no
#: backend (TypeError) where the port names `maintain_batch` (ValueError);
#: every other case runs in both
EXPECTED_RAISE = {"neighbor_combine_blocks": (ValueError, ValueError),
                  "insert_edge_maintain": (ValueError, ValueError),
                  "maintain_batch_host": (ValueError, TypeError)}


def _jclone(jg):
    return jax.tree.map(lambda x: jnp.copy(x) if hasattr(x, "dtype") else x,
                        jg)


def _jsplit():
    """A BA graph with padding rows, split at 12 by both packages."""
    edges = jgen.barabasi_albert(120, 4, seed=13)
    n = int(edges.max()) + 1
    jg = jcore.build_blocks(edges, n, jpart.node_random_partition(
        n, 4, seed=3), P=4, node_slack=24)
    jg2, jplan = jhs.split_hubs(jg, threshold=12)
    g2, plan = thub.split_hubs(to_port(jg), 12)
    assert plan.n_groups > 0
    return (g2, plan), (jg2, jplan)


def _mesh_cases():
    """{name: (port call, reference call)}, each call taking tmp_path;
    every call makes its own copies of the inputs."""
    jstream = reference()
    jsvc = reference_service()
    from repro.checkpoint import CheckpointManager as JManager
    from repro.checkpoint import restore_session as jrestore
    from repro.checkpoint import save_session as jsave
    from repro_torch.checkpoint import save_session

    jg = _jgraph("ba", 4)
    g = to_port(jg)
    jc = jops.coreness_blocks(jg, backend="jnp")
    core = tensor_of(jc)
    sp = "ell_spmd"
    x = _inputs(jg, seed=4)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ups = [tuple(int(v) for v in e) for e in x["window"]]
    (g2, plan), (jg2, jplan) = _jsplit()
    jlab = jcore.connected_components(jg, backend="jnp")

    def tsess(backend=sp):
        return tstream.StreamSession(
            g.clone(), core.clone(), R=3, backend=backend,
            cc_labels=tcore.connected_components(g))

    def jsess(backend=sp):
        return jstream.StreamSession(_jclone(jg), jnp.copy(jc), R=3,
                                     backend=backend, cc_labels=jlab)

    def windows(s, undo=False):
        """The window's updates in windows of 3 (undo: reversed, each op
        negated, which takes them back out)."""
        seq = [(u, v, -op) for u, v, op in ups[::-1]] if undo else ups
        for i in range(0, len(seq), 3):
            s.apply_window(seq[i:i + 3])
        return s

    def t_from_state(tmp):
        arrays, meta = tsess("torch").state_dict()
        return windows(tstream.StreamSession.from_state(
            arrays, meta, backend=sp, device=CPU))

    def j_from_state(tmp):
        arrays, meta = jsess("jnp").state_dict()
        return windows(jstream.StreamSession.from_state(arrays, meta,
                                                        backend=sp))

    def t_restore(tmp):
        mgr = CheckpointManager(str(tmp / "port"))
        save_session(mgr, windows(tsess()))
        _, s, _ = restore_session(mgr, backend=sp, device=CPU)
        return windows(s, undo=True)

    def j_restore(tmp):
        mgr = JManager(str(tmp / "ref"))
        jsave(mgr, windows(jsess()))
        _, s, _ = jrestore(mgr, backend=sp)
        return windows(s, undo=True)

    def snapshot(svc, s):
        state = svc.AnalyticsState(s, pr_steps=8)
        windows(s)
        return state.refresh()

    jroots, jks = jnp.asarray(x["roots"]), jnp.asarray(x["ks"])
    return {
        "run_block_program": (
            lambda tmp: ops.run_block_program(
                g, talg.ConnectedComponentsProgram(), backend=sp,
                with_steps=True),
            lambda tmp: jops.run_block_program(
                jg, jcore.ConnectedComponentsProgram(), backend=sp,
                with_steps=True)),
        "neighbor_combine_blocks": (
            lambda tmp: ops.neighbor_combine_blocks(g, core, "min",
                                                    backend=sp),
            lambda tmp: jops.neighbor_combine_blocks(jg, jc, "min",
                                                     backend=sp)),
        "connected_components": (
            lambda tmp: tcore.connected_components(g, backend=sp,
                                                   with_steps=True),
            lambda tmp: jcore.connected_components(jg, backend=sp,
                                                   with_steps=True)),
        "pagerank": (
            lambda tmp: tcore.pagerank(g, backend=sp, with_steps=True),
            lambda tmp: jcore.pagerank(jg, backend=sp, with_steps=True)),
        "triangle_counts": (
            lambda tmp: tcore.triangle_counts(g, backend=sp,
                                              with_steps=True),
            lambda tmp: jcore.triangle_counts(jg, backend=sp,
                                              with_steps=True)),
        "coreness(mirror=)": (
            lambda tmp: tcore.coreness(g2, backend=sp, mirror=plan),
            lambda tmp: jcore.coreness(jg2, backend=sp, mirror=jplan)),
        "MirrorStream": (
            lambda tmp: tstream.MirrorStream(g2.clone(), plan, backend=sp,
                                             cc_labels=True).result(),
            lambda tmp: jstream.MirrorStream(_jclone(jg2), jplan,
                                             backend=sp,
                                             cc_labels=True).result()),
        "k_reachable_batch": (
            lambda tmp: tkd.k_reachable_batch(g, t["core"], t["roots"],
                                              t["ks"], backend=sp),
            lambda tmp: jkd.k_reachable_batch(
                jg, jnp.asarray(x["core"]), jroots, jks, backend=sp)),
        "_restricted_recompute": (
            lambda tmp: tkd._restricted_recompute(g, t["est0"], t["cand"],
                                                  backend=sp),
            lambda tmp: jkd._restricted_recompute(
                jg, jnp.asarray(x["est0"]), jnp.asarray(x["cand"]),
                backend=sp)),
        "insert_edge_maintain": (
            lambda tmp: tkd.insert_edge_maintain(g.clone(), core,
                                                 *ups[0][:2], backend=sp),
            lambda tmp: jkd.insert_edge_maintain(
                _jclone(jg), jc, jnp.int32(ups[0][0]), jnp.int32(ups[0][1]),
                backend=sp)),
        "maintain_batch": (
            lambda tmp: tkd.maintain_batch(g.clone(), core, ups, R=3,
                                           backend=sp),
            lambda tmp: jkd.maintain_batch(_jclone(jg), jc, ups, R=3,
                                           backend=sp)),
        "maintain_batch_host": (
            lambda tmp: tkd.maintain_batch_host(g.clone(), core, ups,
                                                backend=sp),
            lambda tmp: jkd.maintain_batch_host(_jclone(jg), jc, ups,
                                                backend=sp)),
        "StreamSession": (lambda tmp: windows(tsess()),
                          lambda tmp: windows(jsess())),
        "run_stream": (
            lambda tmp: tstream.run_stream(g.clone(), core, ups, R=3,
                                           backend=sp),
            lambda tmp: jstream.run_stream(_jclone(jg), jc, ups, R=3,
                                           backend=sp)),
        "StreamSession.from_state": (t_from_state, j_from_state),
        "restore_session": (t_restore, j_restore),
        "the query service": (
            lambda tmp: snapshot(tsvc, tsess()),
            lambda tmp: snapshot(jsvc, jsess())),
    }


def _outcome(call, tmp):
    try:
        return call(tmp), None
    except Exception as e:  # the refusal, compared by type
        return None, type(e)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_ell_spmd_refused_elsewhere(name, tmp_path):
    """Each entry point that used to refuse "ell_spmd" in the port now
    does what the JAX package does at W = 1: the same values and counts
    (sessions: graph, coreness, labels and every `StreamStats` field, the
    plan counters included), or the same exception type where the JAX
    package refuses (`EXPECTED_RAISE` where the two differ by design)."""
    port, ref = _mesh_cases()[name]
    got, got_exc = _outcome(port, tmp_path)
    want, want_exc = _outcome(ref, tmp_path)
    assert (got_exc, want_exc) == EXPECTED_RAISE.get(name, (None, None))
    if want_exc is None:
        assert_same_state(got, want, name)
