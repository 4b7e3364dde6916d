"""PyTorch port vs the JAX package: checkpoints and resumed streams.

`repro_torch.checkpoint` keeps the JAX package's on-disk layout (one
`step_XXXXXXXX/` per step: `manifest.json`, `leaf_XXXXX.npy` in pytree
order, a `COMMIT` marker, written through a `.tmp` rename), so a flat-dict
checkpoint written by either package restores in the other, and a nested
one restores into a template of the other package's structure.  The
scenarios replay tests/test_checkpoint.py: round trip, uncommitted and
torn `.tmp` ignored, keep-N, async, structure mismatch, dtype cast,
flat-dict meta, session snapshot round trip, and a snapshot that
survives later windows (the port writes graphs in place, so a snapshot
must hold copies).  A reference session saved by the reference's
`save_session` and restored here continues to the reference's result.
`MirrorStream` snapshots (kind ``mirror_stream``: the split graph and its
`MirrorPlan` under ``g.*``/``plan.*``) round-trip in the port and restore
in either package whichever wrote them.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (fixtures)
    CPU, assert_same_graph, one_torch_thread, reference, to_port)

import repro.checkpoint.manager as jmanager
import repro.core as jcore
import repro.core.algorithms as jalg
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen
from repro.core import hub_split as jhs

import repro_torch.core as tcore
from repro_torch.checkpoint import (CheckpointManager, remesh_restore,
                                    restore_session, save_session)
from repro_torch.core import hub_split as ths
from repro_torch.runtime.stream import MirrorStream, StreamSession

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jg0():
    edges = jgen.barabasi_albert(120, 3, seed=3)
    n = int(edges.max()) + 1
    assign = jpart.node_random_partition(n, 4, seed=1)
    return jcore.build_blocks(edges, n, assign, P=4, deg_slack=24)


@pytest.fixture(scope="module")
def jg0():
    return _jg0()


@pytest.fixture(scope="module")
def skewed():
    """Half the nodes (the BA hubs among them) on block 0, free rows
    everywhere (tests/test_stream.py's graph): the §4.2 rebalance fires."""
    edges = jgen.barabasi_albert(160, 4, seed=7)
    n = int(edges.max()) + 1
    assign = np.where(np.arange(n) < n // 2, 0, 1 + np.arange(n) % 3)
    return jcore.build_blocks(edges, n, assign, P=4, Cn=96, deg_slack=48)


@pytest.fixture
def g0(jg0):
    return to_port(jg0)


@pytest.fixture
def tree(g0):
    # a GraphBlocks plus nested analytics, as the JAX package's test has it
    return {"g": g0, "analytics": {"core": tcore.coreness(g0)}}


def _leaves(t):
    from repro_torch.checkpoint.manager import _flatten
    return _flatten(t)


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    mgr.save(3, tree)
    like = {"g": tree["g"].clone(),
            "analytics": {"core": torch.zeros_like(tree["analytics"]["core"])}}
    out = mgr.restore(3, like, device=CPU)
    _assert_tree_equal(tree, out)
    g, want = out["g"], tree["g"]
    assert isinstance(g, tcore.GraphBlocks)
    assert (g.P, g.Cn, g.Cd) == (want.P, want.Cn, want.Cd)


def test_leaf_order_is_jax_flatten_order(tmp_path, jg0, tree):
    """The same nested tree written by each package: the same manifest
    leaves, the same bytes per leaf, and each restores into the other's
    template."""
    jtree = {"g": jg0, "analytics": {"core": jcore.coreness(jg0)}}
    jmanager.CheckpointManager(str(tmp_path / "j")).save(1, jtree)
    CheckpointManager(str(tmp_path / "t")).save(1, tree)
    for name in ("j", "t"):
        d = tmp_path / name / "step_00000001"
        assert (d / "COMMIT").exists()
    import json
    mj = json.loads((tmp_path / "j/step_00000001/manifest.json").read_text())
    mt = json.loads((tmp_path / "t/step_00000001/manifest.json").read_text())
    assert mj["leaves"] == mt["leaves"]
    for i in range(len(mt["leaves"])):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"j/step_00000001/leaf_{i:05d}.npy"),
            np.load(tmp_path / f"t/step_00000001/leaf_{i:05d}.npy"))
    out = CheckpointManager(str(tmp_path / "j")).restore(1, tree, device=CPU)
    _assert_tree_equal(tree, out)
    back = jmanager.CheckpointManager(str(tmp_path / "t")).restore(1, jtree)
    for x, y in zip(jax.tree_util.tree_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_uncommitted_checkpoint_ignored(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    bad = tmp_path / "step_00000002"
    shutil.copytree(tmp_path / "step_00000001", bad)
    (bad / "COMMIT").unlink()
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        mgr.load_meta(2)


def test_torn_tmp_dir_ignored(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    torn = tmp_path / "step_00000002.tmp"
    torn.mkdir()
    (torn / "leaf_00000.npy").write_bytes(b"\x93NUMPY garbage")
    assert mgr.all_steps() == [1]
    with pytest.raises(FileNotFoundError):
        mgr.restore_dict(2, device=CPU)
    mgr.save(2, tree)  # overwrites the torn tmp on its way through
    assert mgr.all_steps() == [1, 2]
    assert not torn.exists()


def test_keep_n_garbage_collection(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_async_save_copies_before_returning(tmp_path, tree):
    """A non-blocking save has its leaves on the host when it returns:
    writing the live tensors in place afterwards changes nothing saved."""
    mgr = CheckpointManager(str(tmp_path))
    want = {"g": tree["g"].clone(),
            "analytics": {"core": tree["analytics"]["core"].clone()}}
    mgr.save(7, tree, blocking=False)
    tree["g"].nbr.fill_(-1)
    tree["analytics"]["core"].add_(5)
    mgr.wait()
    assert mgr.latest_step() == 7
    _assert_tree_equal(want, mgr.restore(7, want, device=CPU))


def test_structure_mismatch_raises(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"g": tree["g"]}, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"g": tree["g"], "analytics": {
            "core": torch.zeros(3, dtype=torch.int32)}}, device=CPU)


def test_dtype_cast_on_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4, dtype=torch.float32)})
    out = mgr.restore(1, {"w": torch.zeros(4, dtype=torch.bfloat16)},
                      device=CPU)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], torch.ones(4, dtype=torch.bfloat16))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_flat_dict_self_describing_both_ways(tmp_path, jg0, writer):
    """A flat-dict checkpoint restores with NO template, in either package,
    whichever wrote it: the manifest carries key order and meta."""
    core = jcore.coreness(jg0)
    np_arrays = {"g.nbr": np.asarray(jg0.nbr), "g.deg": np.asarray(jg0.deg),
                 "g.node_mask": np.asarray(jg0.node_mask),
                 "core": np.asarray(core)}
    meta = {"kind": "unit", "Cn": jg0.Cn, "Cd": jg0.Cd}
    if writer == "port":
        CheckpointManager(str(tmp_path)).save(
            5, {k: torch.from_numpy(v.copy()) for k, v in np_arrays.items()},
            meta=meta)
    else:
        jmanager.CheckpointManager(str(tmp_path)).save(
            5, {k: jnp.asarray(v) for k, v in np_arrays.items()}, meta=meta)
    t = CheckpointManager(str(tmp_path))
    j = jmanager.CheckpointManager(str(tmp_path))
    assert t.load_meta(5) == j.load_meta(5) == meta
    t_out, j_out = t.restore_dict(5, device=CPU), j.restore_dict(5)
    assert set(t_out) == set(j_out) == set(np_arrays)
    for k, v in np_arrays.items():
        np.testing.assert_array_equal(t_out[k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(j_out[k]), v)
        assert t_out[k].numpy().dtype == v.dtype


def test_restore_dict_needs_flat_dict(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)  # nested — not key-addressable
    with pytest.raises(ValueError, match="flat dict"):
        mgr.restore_dict(1, device=CPU)


def test_restore_needs_a_device_or_cuda(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.arange(3)})
    if torch.cuda.is_available():
        assert mgr.restore_dict(1)["x"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mgr.restore_dict(1)


# ---------------------------------------------------------------------------
# Stream sessions
# ---------------------------------------------------------------------------


def _open(jg0, **kw):
    g = to_port(jg0)
    return StreamSession(g, tcore.coreness(g), R=4,
                         cc_labels=tcore.connected_components(g), **kw)


def _windows(g, k=6, seed=9):
    ups = (jupd.sample_insertions(g, 2 * k, "inter", seed=seed)
           + jupd.sample_deletions(g, 2 * k, "intra", seed=seed + 1))
    return [ups[i::k] for i in range(k)]


def _same(a, b):
    assert_same_graph(a.g, b.g)
    assert torch.equal(a.core, b.core)
    assert torch.equal(a.labels, b.labels)
    assert tuple(a.stats()) == tuple(b.stats())


@pytest.mark.parametrize("blocking", [True, False])
def test_session_snapshot_roundtrip(tmp_path, skewed, blocking):
    """save_session/restore_session: the restored session continues the
    stream bit-identically to one that was never interrupted (every
    stats field), also across a migration, with the remap restored."""
    ws = _windows(skewed)
    a = _open(skewed, rebalance_threshold=1.2, rebalance_max_moves=4)
    b = _open(skewed, rebalance_threshold=1.2, rebalance_max_moves=4)
    for w in ws[:3]:
        a.apply_window(w)
        b.apply_window(w)
    assert a.stats().migrations > 0
    mgr = CheckpointManager(str(tmp_path))
    step = save_session(mgr, a, blocking=blocking, extra_meta={"note": 1})
    mgr.wait()
    assert step == 3
    step2, c, meta = restore_session(mgr, device=CPU)
    assert step2 == 3 and meta["extra"] == {"note": 1}
    assert c.windows_applied == a.windows_applied
    _same(b, c)
    for w in ws[3:]:
        b.apply_window(w)
        c.apply_window(w)
    _same(b, c)


def test_restore_session_requires_meta(tmp_path, g0):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": g0.deg})
    with pytest.raises(ValueError, match="session meta"):
        restore_session(mgr, step=1, device=CPU)


def test_restore_session_empty_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_session(CheckpointManager(str(tmp_path)), device=CPU)


@pytest.mark.parametrize("kw,kind", [
    (dict(W=2), "stream_session"),
    (dict(backend="ell_spmd"), "stream_session"),
    (dict(executor=object()), "stream_session"),
    (dict(W=2), "mirror_stream"),
])
def test_restore_session_refuses_what_is_not_ported(tmp_path, jg0, kw,
                                                     kind):
    """The mesh arguments of `restore_session` act as the JAX package's
    do on the same snapshot: `executor=` off the mesh raises ValueError in
    both; W off the mesh, and any mesh argument of a mirrored session, is
    not read; "ell_spmd" restores onto the W = 1 mesh.  A restored pair
    holds the same state, and keeps it over two more windows (the plan
    counters included)."""
    from repro.checkpoint import restore_session as j_restore_session
    from repro.checkpoint import save_session as j_save_session

    if kind == "stream_session":
        ws = _windows(to_port(jg0))
        t = _open(jg0)
        jg = jax.tree.map(  # the JAX session donates its graph's buffers
            lambda x: jnp.copy(x) if hasattr(x, "dtype") else x, jg0)
        j = reference().StreamSession(
            jg, jcore.coreness(jg, backend="jnp"), R=4, backend="jnp",
            cc_labels=jalg.connected_components(jg, backend="jnp"))
        for w in ws[:2]:
            t.apply_window(w)
            j.apply_window(w)
        rest, same = ws[2:4], _same_as_reference
    else:
        j, t, rest = _mirror_pair(*_split_graph())
        same = _same_mirror
    save_session(CheckpointManager(str(tmp_path / "t")), t)
    j_save_session(jmanager.CheckpointManager(str(tmp_path / "j")), j)
    try:
        _, jr, _ = j_restore_session(
            jmanager.CheckpointManager(str(tmp_path / "j")), **kw)
    except ValueError:
        with pytest.raises(ValueError, match="executor"):
            restore_session(CheckpointManager(str(tmp_path / "t")),
                            device=CPU, **kw)
        assert "executor" in kw
        return
    _, tr, _ = restore_session(CheckpointManager(str(tmp_path / "t")),
                               device=CPU, **kw)
    assert (tr.executor is None) == (kw.get("backend") != "ell_spmd")
    same(tr, jr)
    for w in rest:
        tr.apply_window(w)
        jr.apply_window(w)
        same(tr, jr)
    assert remesh_restore is restore_session


def _same_as_reference(t, j):
    """A port StreamSession and a JAX one hold the same state."""
    assert_same_graph(t.g, j.g)
    np.testing.assert_array_equal(t.core.numpy(), np.asarray(j.core))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert tuple(t.stats()) == tuple(j.stats())


def test_snapshot_survives_later_windows(tmp_path, jg0):
    """The port writes the live graph in place: a snapshot taken BEFORE
    further windows holds copies, and restores the state it saw."""
    ws = _windows(jg0)
    sess = _open(jg0)
    sess.apply_window(ws[0])
    arrays, meta = sess.state_dict()
    want = {k: v.clone() for k, v in arrays.items()}
    for w in ws[1:]:
        sess.apply_window(w)  # in-place row splices on the live graph
    assert not torch.equal(sess.g.nbr, want["g.nbr"])
    for k in want:
        assert torch.equal(arrays[k], want[k]), k
    back = StreamSession.from_state(arrays, meta, device=CPU)
    assert torch.equal(back.g.nbr, want["g.nbr"])
    back.apply_window(ws[1])  # a restored session owns its own storage
    assert torch.equal(arrays["g.nbr"], want["g.nbr"])


def test_reference_session_resumes_in_the_port(tmp_path, skewed):
    """A reference session saved by the reference's `save_session` and
    restored by the port's `restore_session(backend="torch")` continues,
    across a migration and a grow, to the reference's own result; the
    port's snapshot of that state restores back in the reference
    (through `restore_dict` and its `from_state`)."""
    ref = reference()
    from repro.checkpoint import save_session as j_save_session

    ws = _windows(skewed)
    core = jcore.coreness(skewed, backend="jnp")
    labels = jalg.connected_components(skewed, backend="jnp")
    j = ref.StreamSession(jax.tree.map(jnp.copy, skewed), core, R=4,
                          backend="jnp", cc_labels=labels,
                          rebalance_threshold=1.2, rebalance_max_moves=4,
                          auto_grow=True)
    for w in ws[:3]:
        j.apply_window(w)
    j.grow(Cn=128)
    assert j.stats().migrations > 0 and j.stats().grows == 1
    j_save_session(jmanager.CheckpointManager(str(tmp_path)), j)
    _, t, meta = restore_session(CheckpointManager(str(tmp_path)),
                                 backend="torch", device=CPU)
    assert meta["backend"] == "jnp" and t.backend == "torch"
    assert tuple(t.stats()) == tuple(j.stats())
    for w in ws[3:]:
        j.apply_window(w)
        t.apply_window(w)
    assert_same_graph(t.g, j.g)
    np.testing.assert_array_equal(t.core.numpy(), np.asarray(j.core))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert tuple(t.stats()) == tuple(j.stats())
    # and back: the port's snapshot restores in the reference
    save_session(CheckpointManager(str(tmp_path / "t")), t, step=9)
    jm = jmanager.CheckpointManager(str(tmp_path / "t"))
    meta = dict(jm.load_meta(9), backend="jnp")
    back = ref.StreamSession.from_state(jm.restore_dict(9), meta)
    assert_same_graph(t.g, back.g)
    assert tuple(back.stats()) == tuple(t.stats())
    np.testing.assert_array_equal(np.asarray(back._remap), t._remap)


# ---------------------------------------------------------------------------
# MirrorStream snapshots
# ---------------------------------------------------------------------------


def _split_graph(threshold=8, n=90, seed=2):
    """A split-worthy graph (tests/test_hub_split.py's): BA skew + two
    planted hubs, P = 8, room for replicas and on-line splits."""
    edges = {(0, v) for v in range(1, 1 + threshold * 4)}
    edges |= {(1, v) for v in range(2 + threshold * 4, 2 + threshold * 5)}
    for u, v in jgen.barabasi_albert(n, 3, seed=seed):
        if u != v:
            edges.add((min(u, v), max(u, v)))
    edges = np.array(sorted(edges))
    assign = np.random.default_rng(seed).integers(0, 8, n)
    return jcore.build_blocks(edges, n, assign, P=8, node_slack=64), edges


def _mirror_windows(jg2, jplan, edges, k=4, width=6, seed=5):
    """k windows of random inserts/deletes in primary-row ids."""
    pm = np.asarray(jplan.primary_mask)
    row_of = {int(o): i for i, o in enumerate(np.asarray(jg2.orig_id))
              if pm[i]}
    n = len(row_of)
    cur = set(map(tuple, edges.tolist()))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        w, tried = [], set()
        while len(w) < width:
            u, v = (int(x) for x in rng.integers(0, n, 2))
            e = (min(u, v), max(u, v))
            if u == v or e in tried:
                continue
            tried.add(e)
            op = -1 if e in cur else +1
            (cur.discard if op < 0 else cur.add)(e)
            w.append((row_of[e[0]], row_of[e[1]], op))
        out.append(w)
    return out


def _same_mirror(t, o):
    """A port MirrorStream `t` and another session `o` (either package's)
    hold the same state: graph, plan (all but uid), core, labels, stats
    and open-time id map."""
    assert_same_graph(t.g, o.g)
    for f in ths.MirrorPlan.ARRAYS:
        np.testing.assert_array_equal(getattr(t.mirror, f).numpy(),
                                      np.asarray(getattr(o.mirror, f)))
    for f in ("Gmax", "Km", "threshold", "n_logical"):
        assert getattr(t.mirror, f) == getattr(o.mirror, f)
    np.testing.assert_array_equal(t.core.numpy(), np.asarray(o.core))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(o.labels))
    assert tuple(t.result().stats) == tuple(o.result().stats)
    np.testing.assert_array_equal(t._remap, np.asarray(o._remap))


def _mirror_pair(jg, edges):
    """The same split graph opened as a reference and a port
    MirrorStream, both after a window, a Cn grow and another window."""
    jg2, jplan = jhs.split_hubs(jg, 8)
    g2, plan = ths.split_hubs(to_port(jg), 8)
    ws = _mirror_windows(jg2, jplan, edges)
    j = reference().MirrorStream(jg2, jplan, backend="jnp", cc_labels=True,
                                 auto_grow=True)
    t = MirrorStream(g2, plan, backend="torch", cc_labels=True,
                     auto_grow=True)
    for sess in (j, t):
        sess.apply_window(ws[0])
        sess.grow(Cn=2 * sess.g.Cn)
        sess.apply_window(ws[1])
    return j, t, ws[2:]


@pytest.mark.parametrize("blocking", [True, False])
def test_mirror_session_snapshot_roundtrip(tmp_path, blocking):
    """A MirrorStream saved after windows and a grow restores as a
    MirrorStream that continues to the reference session's state; the
    snapshot holds clones."""
    j, t, rest = _mirror_pair(*_split_graph())
    mgr = CheckpointManager(str(tmp_path))
    assert save_session(mgr, t, blocking=blocking) == 2
    mgr.wait()
    arrays, _ = t.state_dict()
    assert arrays["g.nbr"].data_ptr() != t.g.nbr.data_ptr()
    assert arrays["remap"].dtype == torch.int32
    step, back, meta = restore_session(mgr, device=CPU)
    assert step == 2 and meta["kind"] == "mirror_stream"
    assert isinstance(back, MirrorStream) and back.backend == "torch"
    assert back.mirror.uid != t.mirror.uid
    _same_mirror(back, j)
    for w in rest:
        back.apply_window(w)
        j.apply_window(w)
    _same_mirror(back, j)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_mirror_snapshot_restores_in_the_other_package(tmp_path, writer):
    """A mirror_stream snapshot written by either package's
    `save_session` restores in the other's `restore_session` and
    continues to the writer's own result."""
    from repro.checkpoint import restore_session as j_restore_session
    from repro.checkpoint import save_session as j_save_session

    j, t, rest = _mirror_pair(*_split_graph())
    _same_mirror(t, j)
    if writer == "port":
        save_session(CheckpointManager(str(tmp_path)), t)
        _, j, meta = j_restore_session(
            jmanager.CheckpointManager(str(tmp_path)), backend="jnp")
        assert meta["backend"] == "torch" and j.backend == "jnp"
    else:
        j_save_session(jmanager.CheckpointManager(str(tmp_path)), j)
        _, t, meta = restore_session(CheckpointManager(str(tmp_path)),
                                     backend="torch", device=CPU)
        assert meta["backend"] == "jnp" and t.backend == "torch"
    assert type(j).__name__ == type(t).__name__ == "MirrorStream"
    _same_mirror(t, j)
    for w in rest:
        t.apply_window(w)
        j.apply_window(w)
    _same_mirror(t, j)
