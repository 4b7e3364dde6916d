"""PyTorch port vs the JAX package: capacity growth and vertex arrival.

`graph.grow_blocks` (a pad-and-rekey), `relocate_rows`,
`add_vertices_host`, `to_networkx_edges`, `has_edge` and the elastic
`StreamSession` surface (`auto_grow`, `grow`, `add_vertices`, windows in
open-time ids across migrations and grows) must give graph arrays, rekey
maps, handles, coreness, labels and whole stats tuples EQUAL to the JAX
package's on the same inputs.  The scenarios replay tests/test_growth.py:
grow equals rebuild, grow-then-shrink round trip, shrink raises,
`add_vertices` deterministic and capped, Cd auto-escalation, migrate after
grow keeps orig_id.  Nothing returned aliases a live graph's storage.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (fixtures)
    assert_same_graph, needs_cuda, one_torch_thread, reference,
    require_cuda, tensor_of, to_port)

import repro.core as jcore
import repro.core.algorithms as jalg
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen

import repro_torch.core as tcore
import repro_torch.core.updates as tupd
from repro_torch.runtime import stream as tstream

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("nbr", "deg", "node_mask", "orig_id")


def _graph(n=96, m=240, P=4, seed=2, deg_slack=2, node_slack=0):
    edges = jgen.erdos_renyi(n, m, seed=seed)
    assign = jpart.node_random_partition(n, P, seed=seed + 1)
    jg = jcore.build_blocks(edges, n, assign, P=P, deg_slack=deg_slack,
                            node_slack=node_slack)
    return jg, edges, assign


def _fresh(a, b):
    """No tensor of graph `a` shares storage with one of graph `b`."""
    ptrs = {getattr(b, f).untyped_storage().data_ptr() for f in FIELDS}
    return all(getattr(a, f).untyped_storage().data_ptr() not in ptrs
               for f in FIELDS)


@pytest.mark.parametrize("scale", [(2, 1), (1, 2), (2, 4)])
def test_grow_equals_rebuild_and_reference(scale):
    """Growing relocates to EXACTLY the graph a build at the larger
    capacities gives, and to the JAX package's grown graph."""
    jg, edges, assign = _graph()
    tg = to_port(jg)
    Cn2, Cd2 = jg.Cn * scale[0], jg.Cd * scale[1]
    t2, rekey = tcore.grow_blocks(tg, Cn=Cn2, Cd=Cd2)
    j2, jrekey = jcore.grow_blocks(jg, Cn=Cn2, Cd=Cd2)
    np.testing.assert_array_equal(rekey, jrekey)
    assert rekey.dtype == np.int64
    assert_same_graph(t2, j2)
    want = tcore.build_blocks(edges, len(assign), assign, P=jg.P, Cn=Cn2,
                              Cd=Cd2, device="cpu")
    assert_same_graph(t2, jcore.build_blocks(edges, len(assign), assign,
                                             P=jg.P, Cn=Cn2, Cd=Cd2))
    for f in FIELDS:
        assert torch.equal(getattr(t2, f), getattr(want, f))
    real = rekey[rekey >= 0]
    assert np.all(np.diff(real) > 0)  # monotone: rows stay sorted
    assert _fresh(t2, tg)


def test_grow_then_shrink_roundtrip():
    jg, _, _ = _graph()
    tg = to_port(jg)
    t2, _ = tcore.grow_blocks(tg, Cn=jg.Cn * 4, Cd=jg.Cd * 2)
    t3, rekey = tcore.grow_blocks(t2, Cn=jg.Cn, Cd=jg.Cd)
    for f in FIELDS:
        assert torch.equal(getattr(t3, f), getattr(tg, f))
    j2, _ = jcore.grow_blocks(jg, Cn=jg.Cn * 4, Cd=jg.Cd * 2)
    _, jrekey = jcore.grow_blocks(j2, Cn=jg.Cn, Cd=jg.Cd)
    np.testing.assert_array_equal(rekey, jrekey)
    assert (rekey == -1).any()  # the shrink dropped padding rows


def test_shrink_below_contents_raises():
    jg, _, _ = _graph()
    tg = to_port(jg)
    with pytest.raises(tcore.CapacityError):
        tcore.grow_blocks(tg, Cd=1)  # max real degree exceeds 1
    full_rows = int(tg.node_mask[:tg.Cn].sum())
    with pytest.raises(tcore.CapacityError):
        tcore.grow_blocks(tg, Cn=max(1, full_rows - 1))
    with pytest.raises(ValueError, match="capacities"):
        tcore.grow_blocks(tg, Cn=0)


def test_relocate_rows_equal():
    jg, _, _ = _graph()
    _, rekey = jcore.grow_blocks(jg, Cn=jg.Cn * 2)
    arr = np.arange(jg.N * 3, dtype=np.int32).reshape(jg.N, 3)
    for fill in (0, -1):
        np.testing.assert_array_equal(
            tcore.relocate_rows(arr, rekey, 2 * jg.N, fill),
            jcore.relocate_rows(arr, rekey, 2 * jg.N, fill))


def test_add_vertices_deterministic_and_capped():
    jg, _, _ = _graph(node_slack=3)
    tg = to_port(jg)
    t2, rows = tcore.add_vertices_host(tg, 1, 2)
    _, rows_again = tcore.add_vertices_host(tg, 1, 2)
    j2, jrows = jcore.add_vertices_host(jg, 1, 2)
    assert list(rows) == list(rows_again) == list(map(int, jrows))
    assert all(tg.Cn <= r < 2 * tg.Cn for r in rows)
    assert_same_graph(t2, j2)
    assert _fresh(t2, tg)
    assert not tg.node_mask[rows].any()  # the input is left as it was
    with pytest.raises(tcore.CapacityError):
        tcore.add_vertices_host(t2, 1, tg.Cn)  # block 1 cannot take Cn more
    t3, r3 = tcore.add_vertices_host(t2, 0, 1, orig_ids=[500])
    j3, _ = jcore.add_vertices_host(j2, 0, 1, orig_ids=[500])
    assert_same_graph(t3, j3)
    assert int(t3.orig_id[int(r3[0])]) == 500
    for bad in (dict(block=9, count=1), dict(block=0, count=0)):
        with pytest.raises(ValueError):
            tcore.add_vertices_host(tg, **bad)


def test_edge_list_and_has_edge_equal():
    jg, _, _ = _graph()
    tg = to_port(jg)
    np.testing.assert_array_equal(tcore.to_networkx_edges(tg),
                                  jcore.to_networkx_edges(jg))
    nbr = jg.nbr
    u = int(np.flatnonzero(np.asarray(jg.deg) > 0)[0])
    v = int(np.asarray(nbr)[u, 0])
    from repro.core.graph import has_edge as j_has_edge
    for w in (v, (v + 1) % jg.N):
        got = tcore.has_edge(tg, u, w)
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == bool(j_has_edge(jg, u, w))


def test_migrate_after_grow_keeps_orig_ids():
    """A §4.2 migration on a grown graph still tracks vertices by orig_id,
    and equals the JAX package's."""
    jg, _, _ = _graph()
    j2, _ = jcore.grow_blocks(jg, Cn=jg.Cn * 2)
    t2, _ = tcore.grow_blocks(to_port(jg), Cn=jg.Cn * 2)
    core2 = tcore.coreness(t2, backend="torch")
    mask = t2.node_mask.numpy()
    movers = np.flatnonzero(mask[:t2.Cn])[:3]  # 3 nodes out of block 0
    moves = [(int(u), 1 + int(u) % (t2.P - 1)) for u in movers]
    t3, perm, core3 = tcore.migrate_vertices(t2, moves, core2)
    j3, jperm, _ = jcore.migrate_vertices(j2, moves,
                                          np.asarray(core2.numpy()))
    np.testing.assert_array_equal(perm, jperm)
    assert_same_graph(t3, j3)
    want = dict(zip(t2.orig_id[t2.node_mask].tolist(),
                    core2[t2.node_mask].tolist()))
    got = dict(zip(t3.orig_id[t3.node_mask].tolist(),
                   core3[t3.node_mask].tolist()))
    assert got == want


# ---------------------------------------------------------------------------
# The elastic session: escalation and vertex arrival against the reference
# ---------------------------------------------------------------------------


def _overflow_windows(g, k=4, seed=5):
    """Insert-heavy windows guaranteed to overflow a tight Cd (the JAX
    package's test builds them the same way)."""
    rng = np.random.default_rng(seed)
    real = np.flatnonzero(np.asarray(g.node_mask))
    nbr = np.asarray(g.nbr)
    cur = {(min(int(i), int(j)), max(int(i), int(j)))
           for i in real for j in nbr[i] if j >= 0}
    hub = int(real[np.argmax(np.asarray(g.deg)[real])])
    out = []
    for _ in range(k):
        w = []
        while len(w) < 6:
            u = hub if rng.random() < 0.5 else int(
                real[rng.integers(0, len(real))])
            v = int(real[rng.integers(0, len(real))])
            key = (min(u, v), max(u, v))
            if u == v or key in cur:
                continue
            cur.add(key)
            w.append((u, v, +1))
        out.append(w)
    return out


def _sessions(jg, **kw):
    """The same session opened in both packages (the reference's on copies:
    its apply path donates the graph's buffers)."""
    core = jcore.coreness(jg, backend="jnp")
    labels = jalg.connected_components(jg, backend="jnp")
    t = tstream.StreamSession(to_port(jg), tensor_of(core),
                              cc_labels=tensor_of(labels), **kw)
    j = reference().StreamSession(jax.tree.map(jnp.copy, jg), core,
                                  backend="jnp", cc_labels=labels, **kw)
    return t, j


def _same_session(t, j):
    assert_same_graph(t.g, j.g)
    np.testing.assert_array_equal(t.core.numpy(), np.asarray(j.core))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert tuple(t.stats()) == tuple(j.stats())


def test_cd_escalation_equals_reference_host_and_recompute():
    """auto_grow ingests windows that overflow Cd: the port's session equals
    the reference's, the final graph equals the host oracle on an
    already-grown graph, and core and labels equal a recompute."""
    jg, _, _ = _graph(deg_slack=1)
    ws = _overflow_windows(jg)
    t, j = _sessions(jg, R=8, auto_grow=True)
    for w in ws:
        t.apply_window(w)
        j.apply_window(w)
    assert t.stats().grows >= 1
    _same_session(t, j)
    tg = to_port(jg)
    big, rekey = tcore.grow_blocks(tg, Cn=t.g.Cn, Cd=t.g.Cd)
    flat = [u for w in ws for u in w]
    host = tupd.apply_updates_host(
        big, [(int(rekey[u]), int(rekey[v]), op) for u, v, op in flat])
    for f in FIELDS:
        assert torch.equal(getattr(t.g, f), getattr(host, f)), f
    assert torch.equal(t.core, tcore.coreness(t.g, backend="torch"))
    assert torch.equal(t.labels, tcore.connected_components(t.g))


def test_cd_overflow_raises_without_auto_grow():
    jg, _, _ = _graph(deg_slack=1)
    t, _ = _sessions(jg, R=8)
    with pytest.raises(tcore.CapacityError):
        for w in _overflow_windows(jg):
            t.apply_window(w)


def test_add_vertices_and_grow_in_a_rebalancing_stream():
    """The elastic path end to end at a small size: a skewed stream that
    migrates, `add_vertices` past a block's free rows (a Cn grow), a
    window on the new handles, an explicit Cd grow, and windows in
    open-time ids — equal to the reference's session after every step."""
    edges = jgen.barabasi_albert(160, 4, seed=7)
    n = int(edges.max()) + 1
    assign = np.where(np.arange(n) < n // 2, 0, 1 + np.arange(n) % 3)
    jg = jcore.build_blocks(edges, n, assign, P=4, node_slack=2,
                            deg_slack=24)
    ups = (jupd.sample_insertions(jg, 6, "inter", seed=2)
           + jupd.sample_deletions(jg, 6, "intra", seed=3))
    t, j = _sessions(jg, R=4, rebalance_threshold=1.2,
                     rebalance_max_moves=4, auto_grow=True)
    for s in (t, j):
        for i in range(0, 8, 4):
            s.apply_window(ups[i:i + 4])
    _same_session(t, j)
    assert t.stats().migrations > 0
    free = (~t.g.node_mask).reshape(t.g.P, t.g.Cn).sum(1).numpy()
    b = int(np.argmin(free))
    Cn0 = t.g.Cn
    hs = t.add_vertices(b, int(free[b]) + 2)
    assert hs == j.add_vertices(b, int(free[b]) + 2)
    assert t.g.Cn == tstream._pow2_ceil(Cn0 + 1)
    _same_session(t, j)
    assert all(int(t.labels[t._cur(h)]) == t._cur(h) for h in hs)
    join = [(hs[0], 0, +1), (hs[1], 5, +1), (hs[0], hs[1], +1)]
    for s in (t, j):
        s.apply_window(join)
    _same_session(t, j)
    np.testing.assert_array_equal(t.grow(Cd=64), j.grow(Cd=64))
    _same_session(t, j)
    for s in (t, j):
        for i in range(8, len(ups), 4):
            s.apply_window(ups[i:i + 4])
    _same_session(t, j)
    st = t.stats()
    assert st.grows == 2 and st.migrations > 0
    assert torch.equal(t.core, tcore.coreness(t.g, backend="torch"))
    assert torch.equal(t.labels, tcore.connected_components(t.g))
    with pytest.raises(ValueError, match="handle"):
        t.apply_window([(hs[-1] + 1, 0, +1)])


def test_add_vertices_without_auto_grow_raises():
    jg, _, _ = _graph()
    t, _ = _sessions(jg, R=4)
    with pytest.raises(tcore.CapacityError):
        t.add_vertices(0, t.g.Cn + 1)


@needs_cuda
def test_elastic_session_on_gpu_equals_cpu(tmp_path):
    """The elastic steps on the card (kernels, device-side remap and row
    sort, a checkpoint restored onto the card) equal the plain run on the
    CPU: arrays, coreness, labels and stats."""
    from repro_torch.checkpoint import (
        CheckpointManager, restore_session, save_session)

    edges = jgen.barabasi_albert(160, 4, seed=7)
    n = int(edges.max()) + 1
    assign = np.where(np.arange(n) < n // 2, 0, 1 + np.arange(n) % 3)
    jg = jcore.build_blocks(edges, n, assign, P=4, node_slack=2,
                            deg_slack=24)
    ups = (jupd.sample_insertions(jg, 6, "inter", seed=2)
           + jupd.sample_deletions(jg, 6, "intra", seed=3))
    out = []
    for dev, backend in (("cpu", "torch"), ("cuda", "ell")):
        g = to_port(jg, device=dev)
        s = tstream.StreamSession(
            g, tcore.coreness(g), R=4, backend=backend,
            cc_labels=tcore.connected_components(g),
            rebalance_threshold=1.2, rebalance_max_moves=4, auto_grow=True)
        for i in range(0, 8, 4):
            s.apply_window(ups[i:i + 4])
        free = int((~s.g.node_mask[:s.g.Cn]).sum())
        hs = s.add_vertices(0, free + 2)  # one Cn grow
        s.apply_window([(hs[0], 0, +1), (hs[1], 5, +1)])
        s.grow(Cd=64)
        mgr = CheckpointManager(str(tmp_path / dev))
        save_session(mgr, s, blocking=False)
        mgr.wait()
        _, s, _ = restore_session(mgr, device=dev)
        for i in range(8, len(ups), 4):
            s.apply_window(ups[i:i + 4])
        out.append(s)
    cpu, gpu = out
    for f in FIELDS:
        assert torch.equal(getattr(cpu.g, f), getattr(gpu.g, f).cpu()), f
    assert torch.equal(cpu.core, gpu.core.cpu())
    assert torch.equal(cpu.labels, gpu.labels.cpu())
    assert cpu.stats() == gpu.stats() and gpu.stats().grows == 2
