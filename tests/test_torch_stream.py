"""PyTorch port vs the JAX package: the whole main-path slice.

Build an NN graph (~400 nodes, P=4), compute static coreness, and stream
64 mixed updates (inter/intra inserts and deletes) through `run_stream`
with R=8, in both packages — the JAX one with ``backend="ell"`` (Pallas
in interpret mode).  The final `nbr`, `deg` and coreness, and every
`StreamStats` field the port keeps, are integers and must be EQUAL.

With `cc_labels=` both packages also keep connected-component labels
over the stream; the labels and the `cc_merges` / `cc_recomputes` counts
must be EQUAL.  `StreamResult` and `StreamStats` are the reference's
NamedTuples: the same fields in the same order, length, indexing and
legacy unpacking, and whole stats tuples compare equal.  With
`rebalance_threshold=` (§4.2 live rebalancing) both packages migrate the
same vertices and end on the same arrays; the mesh arguments (`W`,
`executor`, ``backend="ell_spmd"``) act as the JAX package's do.  Also: with no backend
given, the entry points take the plain versions on a CPU graph and the
CUDA kernels on a CUDA graph; they raise without CUDA unless the caller
asks for the CPU; and no module of the port (nor chip_smoke.py) imports
jax or the JAX package.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (fixtures)
    CPU, assert_same_graph, needs_cuda, np_of, one_torch_thread, reference,
    require_cuda, tensor_of, to_port)

import repro.core as jcore
import repro.core.algorithms as jalg
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen

import repro_torch.core as tcore
import repro_torch.core.partition_dynamic as tpd
import repro_torch.core.updates as tupd
from repro_torch.runtime import stream as tstream

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent


def _slice(n=400, P=4, q=16, seed=7):
    edges = jgen.nearest_neighbor_graph(n, u=0.86, seed=seed)
    nn = int(edges.max()) + 1
    assign = jpart.node_bfs_partition(edges, nn, P, seed=1)
    jg = jcore.build_blocks(edges, nn, assign, P=P, deg_slack=16)
    ups = (jupd.sample_insertions(jg, q, "inter", seed=2)
           + jupd.sample_insertions(jg, q, "intra", seed=3)
           + jupd.sample_deletions(jg, q, "inter", seed=4)
           + jupd.sample_deletions(jg, q, "intra", seed=5))
    return edges, nn, assign, jg, ups


def test_run_stream_equals_reference():
    edges, nn, assign, jg, ups = _slice()
    assert len(ups) == 64
    # the port builds, partitions and samples on its own, from the same seeds
    tg = tcore.build_blocks(edges, nn, assign, P=4, deg_slack=16, device=CPU)
    assert_same_graph(tg, jg)
    t_ups = (tupd.sample_insertions(tg, 16, "inter", seed=2)
             + tupd.sample_insertions(tg, 16, "intra", seed=3)
             + tupd.sample_deletions(tg, 16, "inter", seed=4)
             + tupd.sample_deletions(tg, 16, "intra", seed=5))
    assert t_ups == ups

    t_core, t_steps = tcore.coreness_with_stats(tg, backend="ell")
    j_core, j_steps = jcore.coreness_with_stats(jg, backend="ell")
    np.testing.assert_array_equal(t_core.numpy(), np.asarray(j_core))
    assert t_steps == j_steps

    res = tstream.run_stream(tg, t_core, iter(ups), R=8, backend="ell")
    ref = reference().run_stream(jg, j_core, iter(ups), R=8, backend="ell")
    assert_same_graph(res.g, ref.g)
    np.testing.assert_array_equal(res.core.numpy(), np.asarray(ref.core))
    assert tuple(res.stats) == tuple(ref.stats)
    assert res.stats.escalated == ref.stats.escalated
    # every routing path ran
    st = res.stats
    assert st.block_local and st.escalated_cross_block and st.escalated_spill
    # and the maintained coreness equals a fresh recompute
    np.testing.assert_array_equal(
        res.core.numpy(), tcore.coreness(res.g, backend="torch").numpy())


def test_session_windows_and_torch_backend():
    _, _, _, jg, ups = _slice(n=200, q=4)
    core = jcore.coreness(jg, backend="jnp")
    want = tstream.run_stream(to_port(jg), tensor_of(core), ups, R=4,
                              backend="torch")
    sess = tstream.StreamSession(to_port(jg), tensor_of(core), R=4,
                                 backend="ell")
    for i in range(0, len(ups), 3):  # narrower windows than R
        sess.apply_window(ups[i:i + 3])
    sess.apply_window([])
    got = sess.close()
    assert sess.windows_applied == got.stats.batches == -(-len(ups) // 3)
    np.testing.assert_array_equal(got.core.numpy(), want.core.numpy())
    np.testing.assert_array_equal(got.g.nbr.numpy(), want.g.nbr.numpy())
    with pytest.raises(ValueError, match="exceeds R"):
        sess.apply_window(ups[:5])


def _cc_stream(kind):
    """(jax graph, updates) for the CC-maintenance cases."""
    edges = jgen.barabasi_albert(120, 3, seed=31)
    n = int(edges.max()) + 1
    rng = np.random.default_rng(32)
    jg = jcore.build_blocks(edges, n, rng.integers(0, 4, n), P=4,
                            deg_slack=24)
    if kind == "insert_only":
        return jg, jupd.sample_insertions(jg, 8, "inter", seed=43)
    return jg, (jupd.sample_insertions(jg, 6, "inter", seed=33)
                + jupd.sample_deletions(jg, 3, "intra", seed=34)
                + jupd.sample_insertions(jg, 5, "intra", seed=35))


@pytest.mark.parametrize("kind", ["mixed", "insert_only"])
def test_run_stream_cc_labels_equal_reference(kind):
    jg, ups = _cc_stream(kind)
    core = jcore.coreness(jg, backend="jnp")
    labels0 = jalg.connected_components(jg, backend="jnp")
    tg, tg2 = to_port(jg), to_port(jg)  # before the reference donates jg
    res = tstream.run_stream(tg, tensor_of(core), list(ups), R=4,
                             cc_labels=tensor_of(labels0))
    ref = reference().run_stream(jg, core, list(ups), R=4, backend="jnp",
                                 cc_labels=labels0)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(res.core.numpy(), np.asarray(ref.core))
    assert tuple(res.stats) == tuple(ref.stats)
    assert torch.equal(res.labels, tcore.connected_components(res.g))
    st = res.stats
    if kind == "insert_only":
        assert (st.cc_merges, st.cc_recomputes) == (len(ups), 0)
    else:
        assert st.cc_merges > 0 and st.cc_recomputes > 0
    # without cc_labels nothing is kept
    plain = tstream.run_stream(tg2, tensor_of(core), list(ups), R=4)
    assert plain.labels is None and plain.stats.cc_merges == 0


@pytest.mark.parametrize("keep_labels", [False, True])
def test_stream_result_is_the_reference_tuple(keep_labels):
    """The smallest stream on which a dataclass result differs from the
    reference's NamedTuple: `len`, indexing and `_fields` agree, and
    unpacking yields the legacy arity (3, or 4 with CC labels) behind the
    reference's DeprecationWarning, with equal values."""
    edges = np.array([[0, 1], [1, 2], [2, 0], [3, 4]])
    assign = np.arange(8) % 2
    jg = jcore.build_blocks(edges, 8, assign, P=2, deg_slack=4)
    tg = tcore.build_blocks(edges, 8, assign, P=2, deg_slack=4, device=CPU)
    assert_same_graph(tg, jg)
    core = jcore.coreness(jg, backend="jnp")
    labels = jalg.connected_components(jg, backend="jnp") \
        if keep_labels else None
    ups = [(0, 3, +1)]
    res = tstream.run_stream(
        tg, tensor_of(core), ups, R=2,
        cc_labels=None if labels is None else tensor_of(labels))
    ref = reference().run_stream(jg, core, ups, R=2, backend="jnp",
                                 cc_labels=labels)
    assert isinstance(res, tuple)
    assert res._fields == ref._fields == ("g", "core", "stats", "labels")
    assert len(res) == len(ref) == 4
    assert (res[3] is None) == (ref[3] is None) == (not keep_labels)
    with pytest.warns(DeprecationWarning, match="tuple-unpacking"):
        got = tuple(res)
    with pytest.warns(DeprecationWarning, match="tuple-unpacking"):
        want = tuple(ref)
    assert len(got) == len(want) == (4 if keep_labels else 3)
    for item in (got, [res[i] for i in range(len(got))]):
        assert_same_graph(item[0], want[0])
        np.testing.assert_array_equal(item[1].numpy(), np.asarray(want[1]))
        assert tuple(item[2]) == tuple(want[2])
        if keep_labels:
            np.testing.assert_array_equal(item[3].numpy(),
                                          np.asarray(want[3]))


@pytest.mark.parametrize("keep_labels", [False, True])
def test_stream_stats_are_the_reference_tuple(keep_labels):
    """`StreamStats` has the reference's fields, in its order and with its
    defaults, so `len`, every position and the whole tuple agree (Queue 3
    fault 2: the port's had 11 fields, and from position 9 on each held
    another counter than the reference's)."""
    ref = reference()
    assert tstream.StreamStats._fields == ref.StreamStats._fields
    assert tstream.StreamStats._field_defaults == \
        ref.StreamStats._field_defaults
    edges = np.array([[0, 1], [1, 2], [2, 0], [3, 4]])
    assign = np.arange(8) % 2
    jg = jcore.build_blocks(edges, 8, assign, P=2, deg_slack=4)
    tg = to_port(jg)
    core = jcore.coreness(jg, backend="jnp")
    labels = jalg.connected_components(jg, backend="jnp") \
        if keep_labels else None
    ups = [(0, 3, +1)]
    res = tstream.run_stream(
        tg, tensor_of(core), ups, R=2,
        cc_labels=None if labels is None else tensor_of(labels))
    want = ref.run_stream(jg, core, ups, R=2, backend="jnp",
                          cc_labels=labels)
    assert len(res.stats) == len(want.stats)
    assert tuple(res.stats) == tuple(want.stats)
    assert res.stats.cc_merges == (1 if keep_labels else 0)


def test_stream_session_has_no_executor():
    """Queue 3 fault 3: the reference's one-device `StreamSession` sets
    `.executor = None` (the service and recovery read it); the port's had
    no such attribute.  Also on a session rebuilt by `from_state`."""
    edges = np.array([[0, 1], [1, 2], [2, 0], [3, 4]])
    assign = np.arange(8) % 2
    jg = jcore.build_blocks(edges, 8, assign, P=2, deg_slack=4)
    core = jcore.coreness(jg, backend="jnp")
    ref = reference().StreamSession(jg, core, R=2, backend="jnp")
    sess = tstream.StreamSession(to_port(jg), tensor_of(core), R=2)
    assert ref.executor is None and sess.executor is None
    arrays, meta = sess.state_dict()
    back = tstream.StreamSession.from_state(arrays, meta, device=CPU)
    assert back.executor is None
    back.apply_window([(0, 3, +1)])
    assert back.executor is None


def _skewed_graph():
    """tests/test_stream.py's skewed graph: half the nodes (the BA hubs
    among them) on block 0, free node capacity everywhere."""
    edges = jgen.barabasi_albert(160, 4, seed=7)
    n = int(edges.max()) + 1
    assign = np.where(np.arange(n) < n // 2, 0, 1 + np.arange(n) % 3)
    return jcore.build_blocks(edges, n, assign, P=4, Cn=96, deg_slack=48)


def _mixed_updates(g):
    return (jupd.sample_insertions(g, 4, "inter", seed=2)
            + jupd.sample_insertions(g, 4, "intra", seed=3)
            + jupd.sample_deletions(g, 4, "inter", seed=4)
            + jupd.sample_deletions(g, 4, "intra", seed=5))


def _core_by_orig(g, core):
    """Coreness indexed by original node id — the migration-invariant view."""
    orig = np_of(g.orig_id)
    core = np_of(core)
    out = np.full(int(orig.max()) + 1, -1, core.dtype)
    m = orig >= 0
    out[orig[m]] = core[m]
    return out


@pytest.mark.parametrize("keep_labels", [False, True])
def test_stream_rebalance_equals_reference(keep_labels):
    """tests/test_stream.py's acceptance, in both packages: a §4.2
    migration fires, and the port's graph, coreness, labels and whole
    stats tuple equal the reference's; read through orig_id, coreness and
    the edge set equal those of the unmigrated run."""
    jg = _skewed_graph()
    ups = _mixed_updates(jg)
    core = jcore.coreness(jg, backend="jnp")
    labels = jalg.connected_components(jg, backend="jnp") \
        if keep_labels else None
    tg, tg_plain = to_port(jg), to_port(jg)
    kw = dict(R=4, rebalance_threshold=1.2, rebalance_max_moves=6)
    res = tstream.run_stream(
        tg, tensor_of(core), list(ups), backend="torch",
        cc_labels=None if labels is None else tensor_of(labels), **kw)
    want = reference().run_stream(jg, core, list(ups), backend="jnp",
                                  cc_labels=labels, **kw)
    assert_same_graph(res.g, want.g)
    np.testing.assert_array_equal(res.core.numpy(), np.asarray(want.core))
    assert tuple(res.stats) == tuple(want.stats)
    st = res.stats
    assert st.migrations > 0 and st.migrated_vertices > 0
    if keep_labels:
        np.testing.assert_array_equal(res.labels.numpy(),
                                      np.asarray(want.labels))
        assert torch.equal(res.labels, tcore.connected_components(res.g))
        assert st.cc_recomputes >= st.migrations
    plain = tstream.run_stream(tg_plain, tensor_of(core), list(ups), R=4)
    assert plain.stats.migrations == 0
    np.testing.assert_array_equal(_core_by_orig(res.g, res.core),
                                  _core_by_orig(plain.g, plain.core))
    np.testing.assert_array_equal(tcore.to_networkx_edges(res.g),
                                  tcore.to_networkx_edges(plain.g))
    assert tpd.block_balance(res.g) <= tpd.block_balance(plain.g)
    assert torch.equal(res.core, tcore.coreness(res.g, backend="torch"))


def test_stream_rebalance_disabled_never_migrates():
    jg = _skewed_graph()
    core = jcore.coreness(jg, backend="jnp")
    st = tstream.run_stream(to_port(jg), tensor_of(core),
                            _mixed_updates(jg)[:4], R=4).stats
    assert st.migrations == 0 and st.migrated_vertices == 0


def test_session_migrate_equals_reference():
    """An explicit `migrate` between windows, then windows in open-time
    ids: the same arrays, labels and stats as the reference's session."""
    ref = reference()
    jg = _skewed_graph()
    ups = _mixed_updates(jg)
    core = jcore.coreness(jg, backend="jnp")
    labels = jalg.connected_components(jg, backend="jnp")
    t = tstream.StreamSession(to_port(jg), tensor_of(core), R=4,
                              cc_labels=tensor_of(labels))
    j = ref.StreamSession(jg, core, R=4, backend="jnp", cc_labels=labels)
    moves = [(0, 1), (1, 2), (2, 3)]
    for s in (t, j):
        s.apply_window(ups[:4])
    np.testing.assert_array_equal(t.migrate(moves), j.migrate(moves))
    for s in (t, j):
        for i in range(4, len(ups), 4):
            s.apply_window(ups[i:i + 4])
    assert_same_graph(t.g, j.g)
    np.testing.assert_array_equal(t.core.numpy(), np.asarray(j.core))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert tuple(t.stats()) == tuple(j.stats())
    assert t.stats().migrations == 1 and t._cur(0) != 0


@pytest.mark.parametrize("kw", [dict(W=2), dict(executor=object()),
                                dict(backend="ell_spmd")])
def test_mesh_arguments_raise_not_implemented(kw):
    """The stream's mesh arguments do what the JAX package's do (one
    process, W = 1): `executor=` off the mesh raises ValueError in both;
    W=2 off the mesh is not read; "ell_spmd" runs, equal to the JAX
    package's mesh stream (graph, coreness, every `StreamStats` field,
    the plan counters included)."""
    jg = _skewed_graph()
    tg = to_port(jg)
    jc = jcore.coreness(jg, backend="jnp")
    core = tensor_of(jc)
    ups = _mixed_updates(jg)
    ref_kw = dict(kw, backend=kw.get("backend", "jnp"))
    try:
        want = reference().run_stream(jg, jc, ups, R=4, **ref_kw)
    except ValueError:
        with pytest.raises(ValueError, match="executor"):
            tstream.run_stream(tg, core, ups, R=4, **kw)
        return
    got = tstream.run_stream(tg, core, ups, R=4, **kw)
    assert_same_graph(got.g, want.g)
    np.testing.assert_array_equal(got.core.numpy(), np.asarray(want.core))
    assert tuple(got.stats) == tuple(want.stats)
    mesh = kw.get("backend") == "ell_spmd"
    assert (got.stats.plan_updates > 0) == mesh
    assert got.stats.plan_rebuilds == 0


def test_defaults_equal_torch_backend_on_cpu():
    """No backend given: "auto", the plain versions on a CPU graph."""
    _, _, _, jg, ups = _slice(n=200, q=4)
    core, steps = tcore.coreness_with_stats(to_port(jg))
    core_t, steps_t = tcore.coreness_with_stats(to_port(jg), backend="torch")
    assert torch.equal(core, core_t) and steps == steps_t
    got = tstream.run_stream(to_port(jg), core, ups, R=4)
    want = tstream.run_stream(to_port(jg), core_t, ups, R=4, backend="torch")
    assert torch.equal(got.core, want.core) and got.stats == want.stats
    assert torch.equal(got.g.nbr, want.g.nbr)


def test_route_window_equals_reference():
    rng = np.random.default_rng(3)
    N, R, Cn = 48, 8, 12
    cand = rng.random((N, R)) < 0.08
    us = rng.integers(0, N, R).astype(np.int32)
    vs = np.where(rng.random(R) < 0.5, us, rng.integers(0, N, R)).astype(
        np.int32)
    ops_ = rng.choice([-1, 1], R).astype(np.int32)
    valid = np.arange(R) < 6
    import jax.numpy as jnp
    want = reference()._route_window(
        *(jnp.asarray(a) for a in (cand, us, vs, ops_, valid)), Cn=Cn)
    got = tstream._route_window(
        *(torch.as_tensor(a) for a in (cand, us.astype(np.int64),
                                       vs.astype(np.int64), ops_, valid)),
        Cn=Cn)
    for f in tstream.RouteMasks._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_router_helpers_equal_reference():
    _, _, _, jg, ups = _slice(n=120, q=3)
    tg = to_port(jg)
    ref = reference()
    assert tstream.route_updates(tg, ups) == ref.route_updates(jg, ups)
    assert [tstream.owner_block(tg, u) for u, _, _ in ups] == \
        [ref.owner_block(jg, u) for u, _, _ in ups]
    assert list(tstream._iter_windows(range(7), 3)) == \
        list(ref._iter_windows(range(7), 3))


def test_entry_points_raise_without_cuda():
    """Called without device=, entry points run on CUDA — or raise if there
    is no CUDA device."""
    edges = jgen.erdos_renyi(30, 50, seed=1)
    assign = np.zeros(30, np.int64)
    arrays = to_port(jcore.build_ell_random(16, Cd=4)).to_numpy()
    calls = (lambda: tcore.build_blocks(edges, 30, assign, P=1),
             lambda: tcore.build_ell_random(16, Cd=4),
             lambda: tcore.GraphBlocks.from_numpy(arrays, 1, 16, 4))
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def _imports(path: Path):
    """Top-level module names imported anywhere in a file, absolute only."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module or "")
    return names


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10 and files[-1].exists()
    bad = [(f.relative_to(REPO).as_posix(), name)
           for f in files for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


@needs_cuda
def test_run_stream_on_gpu_equals_reference():
    _, _, _, jg, ups = _slice(n=300, q=8)
    core = jcore.coreness(jg, backend="jnp")
    tg = to_port(jg, device="cuda")
    res = tstream.run_stream(tg, tensor_of(core, "cuda"), ups, R=8,
                             backend="ell")
    ref = reference().run_stream(jg, core, ups, R=8, backend="jnp")
    np.testing.assert_array_equal(res.core.cpu().numpy(), np.asarray(ref.core))
    assert tuple(res.stats) == tuple(ref.stats)


@needs_cuda
def test_defaults_launch_the_kernels_on_gpu():
    """No backend given on a CUDA graph: the CUDA kernels run."""
    from repro_torch.kernels.ell_frontier import frontier_step_ell
    from repro_torch.kernels.ell_hindex import hindex_ell

    _, _, _, jg, ups = _slice(n=300, q=8)
    tg = to_port(jg, device="cuda")
    h0 = hindex_ell.launches
    core, steps = tcore.coreness_with_stats(tg)
    assert hindex_ell.launches > h0
    h1, f1 = hindex_ell.launches, frontier_step_ell.launches
    res = tstream.run_stream(tg, core, ups, R=8)
    torch.cuda.synchronize()
    assert hindex_ell.launches > h1 and frontier_step_ell.launches > f1
    want = jcore.coreness_with_stats(jg, backend="jnp")
    np.testing.assert_array_equal(core.cpu().numpy(), np.asarray(want[0]))
    assert steps == want[1]
    ref = reference().run_stream(jg, want[0], ups, R=8, backend="jnp")
    np.testing.assert_array_equal(res.core.cpu().numpy(), np.asarray(ref.core))
