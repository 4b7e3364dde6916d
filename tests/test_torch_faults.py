"""PyTorch port vs the JAX package: crash recovery on one device.

The drills of the JAX package's `tests/test_faults.py` on the port's
`runtime.recovery` (`WindowLog`, `plan_evacuation`, `evacuate_blocks`,
`kill_session`, `recover_worker`, `ElasticCoordinator`), held against the
JAX package's recovery on the same inputs:

  * a torn save (``step_XXXX.tmp``, or a step directory without its
    COMMIT marker) is never listed or loaded;
  * a read of a session after `kill_session` raises RuntimeError (the
    port's sentinels; the process does not crash);
  * `plan_evacuation` gives the JAX package's moves on random graphs and
    dead sets, balanced, and raises `CapacityError` when the survivors
    are full; `evacuate_blocks` grows Cn as the JAX package's does;
  * the chaos drill: a random edit stream, a checkpoint at a random
    window, a worker killed at a random later window with torn-save
    debris beside the snapshot: the recovered session equals the JAX
    package's recovered session (graph arrays, core, labels, the whole
    `StreamStats`) and a never-crashed oracle's logical state, and its
    analytics equal a recompute;
  * the single-device form of the e2e elasticity drill on
    ``backend="torch"``: triple the edges by auto-grow, checkpoint, lose
    block 0 (W_old = P), recover, stream on; core, labels and PageRank
    equal a recompute.  Its `ell_spmd` form is
    tests/test_torch_spmd_engine.py::test_e2e_recovery_drill_on_the_mesh;
    here the mesh arguments of `recover_worker` and the coordinator
    (`W`, ``backend="ell_spmd"``, `W_old` from the session's executor)
    are held against the JAX package's on the same snapshot.
"""
import shutil
import tempfile

import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from _torch_port import (  # noqa: F401 (fixtures)
    CPU, assert_same_graph, np_of, one_torch_thread, reference, to_port)

import jax
import jax.numpy as jnp

import repro.core as jcore
import repro.core.algorithms as jalg
import repro.core.partition as jpart
import repro.graphgen as jgen

import repro_torch.core as tcore
from repro_torch.checkpoint import (
    CheckpointManager, restore_session, save_session)
from repro_torch.core.graph import CapacityError
from repro_torch.runtime import recovery as trec
from repro_torch.runtime.stream import StreamSession
from repro_torch.service import AnalyticsState

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JSTREAM = reference()
import repro.checkpoint as jckpt  # noqa: E402
import repro.runtime.recovery as jrec  # noqa: E402

P = 8
N_NODES = 96
PR_STEPS = 10


def _jgraph(seed=2, deg_slack=1, node_slack=2):
    edges = jgen.erdos_renyi(N_NODES, 200, seed=seed)
    assign = jpart.node_random_partition(N_NODES, P, seed=seed + 1)
    return jcore.build_blocks(edges, N_NODES, assign, P=P,
                              deg_slack=deg_slack, node_slack=node_slack)


def _session(jg, backend="torch"):
    g = to_port(jg)
    return StreamSession(g, tcore.coreness(g), R=8, backend=backend,
                         cc_labels=tcore.connected_components(g),
                         auto_grow=True)


def _jsession(jg):
    g = jax.tree.map(jnp.copy, jg)
    return JSTREAM.StreamSession(
        g, jcore.coreness(g, backend="jnp"), R=8, backend="jnp",
        cc_labels=jalg.connected_components(g), auto_grow=True)


def _windows(jg, n_w, seed, insert_bias=0.7):
    """Random edit windows in the OPEN-TIME padded id space (the JAX
    package's generator)."""
    rng = np.random.default_rng(seed)
    real = np.flatnonzero(np.asarray(jg.node_mask))
    nbr = np.asarray(jg.nbr)
    cur = {(min(int(i), int(j)), max(int(i), int(j)))
           for i in real for j in nbr[i] if j >= 0}
    out = []
    for _ in range(n_w):
        w = []
        while len(w) < 6:
            u = int(real[rng.integers(0, len(real))])
            v = int(real[rng.integers(0, len(real))])
            key = (min(u, v), max(u, v))
            if u == v:
                continue
            if key in cur and rng.random() > insert_bias:
                cur.discard(key)
                w.append((u, v, -1))
            elif key not in cur:
                cur.add(key)
                w.append((u, v, +1))
        out.append(w)
    return out


def _logical_state(sess):
    """Per-orig-id coreness, component structure and edge set: the
    permutation-free view two differently-migrated sessions compare in."""
    g = sess.g
    mask = np_of(g.node_mask).astype(bool)
    oid = np_of(g.orig_id)
    core = dict(zip(oid[mask].tolist(), np_of(sess.core)[mask].tolist()))
    labels = np_of(sess.labels)
    comps = {}
    for i in np.flatnonzero(mask):
        comps.setdefault(int(labels[i]), set()).add(int(oid[i]))
    parts = sorted(tuple(sorted(s)) for s in comps.values())
    nbr = np_of(g.nbr)
    edges = {(min(int(oid[i]), int(oid[j])), max(int(oid[i]), int(oid[j])))
             for i in np.flatnonzero(mask) for j in nbr[i] if j >= 0}
    return core, parts, edges


def _assert_exact_vs_recompute(sess):
    assert torch.equal(sess.core, tcore.coreness(sess.g, backend="torch"))
    assert torch.equal(sess.labels,
                       tcore.connected_components(sess.g, backend="torch"))


def _assert_same_session(t, j):
    """The port's session equals the JAX package's, array for array."""
    assert_same_graph(t.g, j.g)
    np.testing.assert_array_equal(np_of(t.core), np.asarray(j.core))
    np.testing.assert_array_equal(np_of(t.labels), np.asarray(j.labels))
    assert tuple(t.stats()) == tuple(j.stats())


# ---------------------------------------------------------------------------
# torn checkpoints, the killed session
# ---------------------------------------------------------------------------


def test_torn_checkpoint_never_loaded(tmp_path):
    """Crash injections at every stage of a save — a tmp dir with partial
    leaves, a step dir missing COMMIT — are invisible to recovery."""
    sess = _session(_jgraph())
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    save_session(mgr, sess, step=1)
    torn_tmp = tmp_path / "step_00000007.tmp"
    torn_tmp.mkdir()
    (torn_tmp / "leaf_00000.npy").write_bytes(b"partial garbage")
    torn_dir = tmp_path / "step_00000008"
    torn_dir.mkdir()
    (torn_dir / "leaf_00000.npy").write_bytes(b"also garbage")
    (torn_dir / "manifest.json").write_text("{}")

    assert mgr.all_steps() == [1]
    step, restored, _ = restore_session(mgr, device=CPU)
    assert step == 1
    assert torch.equal(restored.g.nbr, sess.g.nbr)
    with pytest.raises(FileNotFoundError):
        restore_session(mgr, step=8, device=CPU)


def test_kill_session_reads_raise(tmp_path):
    """After the loss drill every read of the dead session raises
    RuntimeError instead of serving stale pre-crash state (the JAX
    package's `test_kill_session_buffers_unusable`), and nothing
    crashes the process."""
    jg = _jgraph()
    sess = _session(jg)
    w = _windows(jg, 1, seed=3)[0]
    trec.kill_session(sess)
    reads = [
        lambda: sess.core.cpu(),
        lambda: sess.g.nbr.sum(),
        lambda: sess.apply_window(w),
        lambda: np.asarray(sess.core) + 0,
        lambda: torch.equal(sess.core, sess.core),
        lambda: sess.labels + 1,
        lambda: sess.core[0],
        lambda: int(sess.g.N),
        lambda: sess.state_dict(),
        lambda: tcore.coreness(sess.g),
    ]
    for read in reads:
        with pytest.raises(RuntimeError, match="kill_session"):
            read()
    assert "killed" in repr(sess.core)


# ---------------------------------------------------------------------------
# evacuation planning
# ---------------------------------------------------------------------------


def test_blocks_of_worker_equals_reference():
    for P_, W in ((8, 8), (8, 4), (8, 2), (8, 1), (6, 3)):
        for w in range(W):
            assert trec.blocks_of_worker(w, P_, W) == \
                jrec.blocks_of_worker(w, P_, W)
    for bad in ((0, 8, 3), (8, 8, 8), (-1, 8, 4)):
        with pytest.raises(ValueError):
            trec.blocks_of_worker(*bad)


@pytest.mark.parametrize("seed", range(4))
def test_plan_evacuation_equals_reference(seed):
    """Random graphs and dead sets: the same moves, balanced (most-free
    first keeps the survivors' slack within one)."""
    rng = np.random.default_rng(seed)
    jg = _jgraph(seed=seed, node_slack=24)
    tg = to_port(jg)
    for W in (8, 4, 2):
        dead = trec.blocks_of_worker(int(rng.integers(0, W)), P, W)
        moves = trec.plan_evacuation(tg, dead)
        assert moves == jrec.plan_evacuation(jg, dead)
        mask = np_of(tg.node_mask)
        assert len(moves) == sum(int(mask[b * tg.Cn:(b + 1) * tg.Cn].sum())
                                 for b in dead)
        if W == 8:
            loads = {}
            for _, d in moves:
                loads[d] = loads.get(d, 0) + 1
            free = {b: int(tg.Cn - mask[b * tg.Cn:(b + 1) * tg.Cn].sum())
                    for b in range(P) if b not in dead}
            slack = [free[b] - loads.get(b, 0) for b in free]
            assert max(slack) - min(slack) <= 1
    assert trec.plan_evacuation(tg, []) == []
    with pytest.raises(ValueError):
        trec.plan_evacuation(tg, list(range(P)))


def test_plan_evacuation_raises_when_survivors_full():
    """Every block exactly full: both packages refuse and tell the caller
    to grow Cn; `evacuate_blocks` then grows Cn as the JAX package's
    does and lands on the same graph."""
    edges = jgen.erdos_renyi(N_NODES, 200, seed=2)
    assign = np.arange(N_NODES) % P
    jg = jcore.build_blocks(edges, N_NODES, assign, P=P, Cn=N_NODES // P,
                            deg_slack=4)
    with pytest.raises(CapacityError, match="grow Cn"):
        trec.plan_evacuation(to_port(jg), [0])
    with pytest.raises(Exception, match="grow Cn"):
        jrec.plan_evacuation(jg, [0])
    tsess, jsess = _session(jg), _jsession(jg)
    assert trec.evacuate_blocks(tsess, [0]) == \
        jrec.evacuate_blocks(jsess, [0]) == N_NODES // P
    _assert_same_session(tsess, jsess)
    assert tsess.g.Cn == trec._pow2_ceil(N_NODES // P + 1) == 16
    assert not np_of(tsess.g.node_mask)[:tsess.g.Cn].any()


def test_window_log_replay_and_cursor():
    jg = _jgraph()
    ws = _windows(jg, 3, seed=4)
    log = trec.WindowLog()
    for w in ws:
        log.append_window(w)
    log.append_vertices(1, 2)
    assert len(log) == 4 and log.entries[-1] == ("vertices", 1, 2)
    a, b = _session(jg), _session(jg)
    assert log.replay(a) == 4
    for w in ws:
        b.apply_window(w)
    b.add_vertices(1, 2)
    assert torch.equal(a.core, b.core) and torch.equal(a.g.nbr, b.g.nbr)
    assert log.replay(_session(jg), cursor=3) == 1
    log.entries.append(("bogus",))
    with pytest.raises(ValueError):
        log.replay(a, cursor=4)


# ---------------------------------------------------------------------------
# chaos: kill a worker at a random window, recover, compare
# ---------------------------------------------------------------------------


@settings(max_examples=3, deadline=None)
@given(st.integers(0, 10_000))
def test_chaos_worker_loss_recovery(seed):
    """Property drill: random edit stream, checkpoint at a random window,
    worker killed at a random later window, torn-save debris injected —
    recovery in both packages; the port's equals the JAX package's and
    the never-crashed oracle's logical state, and equals a recompute."""
    rng = np.random.default_rng(seed)
    jg = _jgraph(seed=int(rng.integers(0, 100)), node_slack=4)
    ws = _windows(jg, 8, seed=seed + 1)
    ckpt_at = int(rng.integers(1, 7))
    kill_at = int(rng.integers(ckpt_at, 9))
    dead_w = int(rng.integers(0, P))

    tmp, jtmp = tempfile.mkdtemp(), tempfile.mkdtemp()
    try:
        mgr = CheckpointManager(tmp, keep_n=2)
        coord = trec.ElasticCoordinator(_session(jg), mgr)
        jcoord = jrec.ElasticCoordinator(
            _jsession(jg), jckpt.CheckpointManager(jtmp, keep_n=2))
        oracle = _session(jg)
        for i, w in enumerate(ws):
            if i == ckpt_at:
                coord.checkpoint()
                jcoord.checkpoint()
            if i == kill_at:
                torn = mgr.dir / f"step_{90 + i:08d}.tmp"
                torn.mkdir()
                (torn / "leaf_00000.npy").write_bytes(b"x")
                coord.recover_worker(dead_w)
                jcoord.recover_worker(dead_w)
            coord.apply_window(w)
            jcoord.apply_window(w)
            oracle.apply_window(w)
        if kill_at >= len(ws):  # kill after the stream drained
            coord.recover_worker(dead_w)
            jcoord.recover_worker(dead_w)
        _assert_same_session(coord.session, jcoord.session)
        got, want = _logical_state(coord.session), _logical_state(oracle)
        assert got[0] == want[0], "coreness diverged"
        assert got[1] == want[1], "components diverged"
        assert got[2] == want[2], "topology diverged"
        _assert_exact_vs_recompute(coord.session)
        assert all(s < 90 for s in mgr.all_steps())
        assert coord.session.executor is None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(jtmp, ignore_errors=True)


def test_recover_refuses_the_mesh(tmp_path):
    """Recovery's mesh arguments act as the JAX package's do, on the same
    snapshot and log: W=2 off the mesh is not read; "ell_spmd" restores
    onto the W = 1 mesh, evacuates and replays there; and the coordinator
    takes W_old from its live session's executor (here one of W = 2: the
    dead worker 0 then owns blocks 0..3).  Every recovered session equals
    the JAX package's."""
    jg = _jgraph(node_slack=4)
    ws = _windows(jg, 4, seed=3)
    mgr = CheckpointManager(str(tmp_path / "t"))
    jmgr = jckpt.CheckpointManager(str(tmp_path / "j"))
    coord = trec.ElasticCoordinator(_session(jg), mgr)
    jcoord = jrec.ElasticCoordinator(_jsession(jg), jmgr)
    for i, w in enumerate(ws):
        if i == 2:
            coord.checkpoint()
            jcoord.checkpoint()
        coord.apply_window(w)
        jcoord.apply_window(w)
    for kw in (dict(W=2), dict(backend="ell_spmd")):
        sess, n = trec.recover_worker(mgr, coord.log, 0, device=CPU, **kw)
        jsess, jn = jrec.recover_worker(jmgr, jcoord.log, 0, **kw)
        assert n == jn == 2
        _assert_same_session(sess, jsess)
        assert (sess.executor is None) == ("backend" not in kw)
    fake = type("Ex", (), {"wm": type("Wm", (), {"W": 2})})()
    coord.session.executor = fake
    jcoord.session.executor = fake
    coord.recover_worker(0)
    jcoord.recover_worker(0)
    _assert_same_session(coord.session, jcoord.session)
    mask = coord.session.g.node_mask.view(P, -1)
    assert not mask[:P // 2].any()  # W_old = 2: worker 0 held 4 blocks


# ---------------------------------------------------------------------------
# the e2e elasticity drill, on one device
# ---------------------------------------------------------------------------


class _EditStream:
    """Stateful window generator in the session's OPEN-TIME id space."""

    def __init__(self, jg, seed):
        self.real = np.flatnonzero(np.asarray(jg.node_mask))
        nbr = np.asarray(jg.nbr)
        self.cur = {(min(int(i), int(j)), max(int(i), int(j)))
                    for i in self.real for j in nbr[i] if j >= 0}
        self.rng = np.random.default_rng(seed)

    def window(self, size=6, insert_bias=0.7):
        w = []
        while len(w) < size:
            u = int(self.real[self.rng.integers(0, len(self.real))])
            v = int(self.real[self.rng.integers(0, len(self.real))])
            key = (min(u, v), max(u, v))
            if u == v:
                continue
            if key in self.cur and self.rng.random() > insert_bias:
                self.cur.discard(key)
                w.append((u, v, -1))
            elif key not in self.cur:
                self.cur.add(key)
                w.append((u, v, +1))
        return w


def test_e2e_elastic_acceptance(tmp_path):
    """Start at tight capacities; TRIPLE the edge count via automatic
    escalation; checkpoint; lose block 0 (one block per worker, W_old =
    P); recover; keep streaming.  Final core, labels and PageRank equal a
    recompute bit for bit."""
    jg = _jgraph(deg_slack=1, node_slack=2)
    m0 = jg.m_real
    coord = trec.ElasticCoordinator(_session(jg),
                                    CheckpointManager(str(tmp_path), keep_n=3))
    stream = _EditStream(jg, seed=0)
    while coord.session.g.m_real < 3 * m0:
        coord.apply_window(stream.window(insert_bias=1.0))
    grows_p1 = coord.session._grows
    assert grows_p1 >= 1, "tripling never hit a capacity wall"
    _assert_exact_vs_recompute(coord.session)

    coord.checkpoint()
    for _ in range(2):
        coord.apply_window(stream.window())
    dead = coord.session
    coord.recover_worker(0, W_old=P)
    with pytest.raises(RuntimeError):
        dead.core.cpu()
    g2 = coord.session.g
    mask = np_of(g2.node_mask)
    for b in trec.blocks_of_worker(0, P, P):
        assert mask[b * g2.Cn:(b + 1) * g2.Cn].sum() == 0
    for _ in range(4):
        coord.apply_window(stream.window())

    final = coord.session
    _assert_exact_vs_recompute(final)
    snap = AnalyticsState(final, pr_steps=PR_STEPS).snapshot
    assert torch.equal(snap.rank, tcore.pagerank(final.g, tol=None,
                                                 max_steps=PR_STEPS))
    assert snap.grows == final._grows >= grows_p1
