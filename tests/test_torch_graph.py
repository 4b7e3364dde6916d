"""PyTorch port vs the JAX package: graph construction and mutation.

Generators, node partitioners, `build_blocks`, `build_ell_random`,
`sort_nbr_rows`, the device insert/delete splices, `apply_updates_host`
and the update samplers must give arrays EQUAL to the JAX package's for
the same seeds — integers match exactly, no tolerance.  Includes the
sorted-ELL mutation scenarios of tests/test_sorted_ell.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _hyp import given, settings, st
from _torch_port import (  # noqa: F401 (fixtures)
    CPU, assert_same_graph, np_of, one_torch_thread)

import repro.core.graph as jgraph
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen

import repro_torch.core.graph as tgraph
import repro_torch.core.partition as tpart
import repro_torch.core.updates as tupd
import repro_torch.graphgen as tgen

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name,args", [
    ("erdos_renyi", (60, 150)),
    ("barabasi_albert", (80, 3)),
    ("grid_like", (70,)),
    ("nearest_neighbor_graph", (120,)),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_generators_equal(name, args, seed):
    np.testing.assert_array_equal(getattr(tgen, name)(*args, seed=seed),
                                  getattr(jgen, name)(*args, seed=seed))


@pytest.mark.parametrize("name", ["DS1", "ego-Facebook", "roadNet-CA"])
def test_snap_like_equal(name):
    np.testing.assert_array_equal(tgen.snap_like(name, 0.002, seed=3),
                                  jgen.snap_like(name, 0.002, seed=3))


def test_node_partitioners_equal():
    edges = jgen.barabasi_albert(90, 3, seed=4)
    n = int(edges.max()) + 1
    for P in (1, 3, 8):
        np.testing.assert_array_equal(tpart.node_hash_partition(n, P, seed=2),
                                      jpart.node_hash_partition(n, P, seed=2))
        np.testing.assert_array_equal(
            tpart.node_random_partition(n, P, seed=2),
            jpart.node_random_partition(n, P, seed=2))
        np.testing.assert_array_equal(
            tpart.node_bfs_partition(edges, n, P, seed=2),
            jpart.node_bfs_partition(edges, n, P, seed=2))


def _graphs(n, seed, P=4, m=3, deg_slack=16):
    """The same BA graph built by both packages."""
    edges = jgen.barabasi_albert(n, m, seed=seed)
    nn = int(edges.max()) + 1
    assign = jpart.node_random_partition(nn, P, seed=seed)
    jg = jgraph.build_blocks(edges, nn, assign, P=P, deg_slack=deg_slack)
    tg = tgraph.build_blocks(edges, nn, assign, P=P, deg_slack=deg_slack,
                             device=CPU)
    return tg, jg


@settings(max_examples=6, deadline=None)
@given(st.integers(10, 60), st.integers(0, 10_000), st.integers(1, 5))
def test_build_blocks_equal(n, seed, P):
    tg, jg = _graphs(n, seed, P=P)
    assert_same_graph(tg, jg)
    assert tg.n_real == jg.n_real and tg.m_real == jg.m_real
    assert tg.edge_cut() == int(jg.edge_cut())


def test_build_blocks_explicit_capacities_and_slack():
    edges = jgen.erdos_renyi(40, 90, seed=1)
    assign = jpart.node_hash_partition(40, 3, seed=0)
    for kw in (dict(Cn=24, Cd=20), dict(node_slack=5, deg_slack=3)):
        jg = jgraph.build_blocks(edges, 40, assign, P=3, **kw)
        tg = tgraph.build_blocks(edges, 40, assign, P=3, device=CPU, **kw)
        assert_same_graph(tg, jg)


@pytest.mark.parametrize("N,Cd,seed", [(64, 8, 0), (200, 16, 3), (333, 5, 9)])
def test_build_ell_random_equal(N, Cd, seed):
    assert_same_graph(tgraph.build_ell_random(N, Cd=Cd, seed=seed, device=CPU),
                      jgraph.build_ell_random(N, Cd=Cd, seed=seed))


def test_sort_nbr_rows_equal():
    rng = np.random.default_rng(5)
    nbr = rng.integers(-1, 50, size=(30, 12)).astype(np.int32)
    np.testing.assert_array_equal(tgraph.sort_nbr_rows(nbr),
                                  jgraph.sort_nbr_rows(nbr))


def test_round_trip_numpy():
    tg, jg = _graphs(40, 2)
    back = tgraph.GraphBlocks.from_numpy(tg.to_numpy(), tg.P, tg.Cn, tg.Cd,
                                         device=CPU)
    assert_same_graph(back, jg)
    assert back.nbr.dtype == torch.int32 and back.node_mask.dtype == torch.bool


@pytest.mark.parametrize("scenario", ["intra", "inter"])
@pytest.mark.parametrize("seed", [1, 2])
def test_samplers_equal(scenario, seed):
    tg, jg = _graphs(60, seed)
    assert (tupd.sample_insertions(tg, 5, scenario, seed=seed)
            == jupd.sample_insertions(jg, 5, scenario, seed=seed))
    assert (tupd.sample_deletions(tg, 5, scenario, seed=seed)
            == jupd.sample_deletions(jg, 5, scenario, seed=seed))
    u, v, _ = tupd.sample_insertions(tg, 1, scenario, seed=seed)[0]
    assert tupd.classify(tg, u, v) == jupd.classify(jg, u, v) == scenario


@settings(max_examples=8, deadline=None)
@given(st.integers(16, 50), st.integers(0, 10_000),
       st.sampled_from(["intra", "inter"]))
def test_mutations_equal_reference(n, seed, scen):
    """The sorted-ELL mutation scenarios of test_sorted_ell.py: the port's
    device splices and host path equal the JAX package's bit for bit."""
    tg, jg = _graphs(n, seed)

    def sample(upd, g):
        return (upd.sample_insertions(g, 3, scen, seed=seed)
                + upd.sample_deletions(g, 3, scen, seed=seed + 1))

    try:
        ups = sample(jupd, jg)
    except RuntimeError as e:  # too few edges of the scenario: both refuse
        with pytest.raises(RuntimeError, match=str(e).split(",")[0]):
            sample(tupd, tg)
        return
    assert ups == sample(tupd, tg)
    j_host = jupd.apply_updates_host(jg, ups)
    t_host = tupd.apply_updates_host(tg, ups)
    assert_same_graph(t_host, j_host)
    t_dev = tg.clone()
    for u, v, op in ups:
        (tgraph.insert_edge if op > 0 else tgraph.delete_edge)(t_dev, u, v)
    assert_same_graph(t_dev, j_host)
    # apply_updates_host leaves its argument as it was
    assert_same_graph(tg, jg)


def test_device_splice_matches_jitted_splice():
    """Single device splices against the JAX jitted ones, edge by edge."""
    tg, jg = _graphs(30, 11)
    ups = (jupd.sample_insertions(jg, 4, "intra", seed=3)
           + jupd.sample_deletions(jg, 4, "inter", seed=4))
    for u, v, op in ups:
        fn_j = jgraph.insert_edge if op > 0 else jgraph.delete_edge
        fn_t = tgraph.insert_edge if op > 0 else tgraph.delete_edge
        jg = fn_j(jg, jnp.int32(u), jnp.int32(v))
        assert fn_t(tg, u, v) is tg  # in place
        assert_same_graph(tg, jg)


@pytest.mark.parametrize("bad,exc", [
    ((0, 0, 1), ValueError),        # self-loop
    ((-1, 2, 1), ValueError),       # out of range
])
def test_apply_updates_rejects(bad, exc):
    tg, _ = _graphs(20, 1)
    with pytest.raises(exc):
        tupd.apply_updates_host(tg, [bad])


def test_apply_updates_rejects_duplicate_missing_and_capacity():
    tg, jg = _graphs(24, 5, deg_slack=0)
    nbr = np_of(tg.nbr)
    u = 0
    v = int(nbr[u, 0])
    with pytest.raises(ValueError, match="already present"):
        tupd.apply_updates_host(tg, [(u, v, 1)])
    with pytest.raises(ValueError, match="not present"):
        tupd.apply_updates_host(tg, [(u, v, -1), (u, v, -1)])
    full = int(np.argmax(np_of(tg.deg)))  # at capacity: deg_slack=0
    other = next(w for w in range(tg.N)
                 if np_of(tg.node_mask)[w] and w != full
                 and w not in set(nbr[full].tolist()))
    for mod in (tupd, jupd):
        with pytest.raises(mod.CapacityError):
            mod.apply_updates_host(tg if mod is tupd else jg,
                                   [(full, other, 1)])


def _window(kind, tg, seed):
    """A window of the named kind on `tg`, its ids drawn from `seed`, and
    a part of the message it must fail with (None: it passes; ...:
    either)."""
    rng = np.random.default_rng(seed)
    nbr, deg = np_of(tg.nbr), np_of(tg.deg)
    real = np.flatnonzero(np_of(tg.node_mask))
    N, Cd = tg.N, tg.Cd

    def edge():
        u = int(rng.choice(real[(deg[real] > 0) & (deg[real] < Cd)]))
        return u, int(rng.choice(nbr[u, :deg[u]]))

    def absent(u, k=1):
        ok = [w for w in real if w != u and deg[w] < Cd - 1
              and w not in set(nbr[u, :deg[u]].tolist())]
        return [int(w) for w in rng.choice(ok, k, replace=False)]

    u, v = edge()
    a, b, c = absent(u, 3)
    if kind == "random":  # deletes of edges, inserts of absent pairs, noise
        out = []
        for r in rng.random(8):
            if r < 0.45:
                out.append(edge() + (-1,))
            elif r < 0.9:
                x = int(rng.choice(real))
                out.append((x, absent(x)[0], 1))
            else:
                out.append(tuple(int(x) for x in rng.integers(-2, N + 2, 2))
                           + (int(rng.choice([1, -1])),))
        return out, ...
    full = int(np.argmax(deg))  # deg_slack=2: two slots left
    f1, f2, f3 = absent(full, 3)
    return {
        "out_of_range_after_valid": (
            [(u, v, -1), (N + int(rng.integers(0, 5)), u, 1), (u, u, 1)],
            "out of range"),
        "negative_before_bad": (
            [(-1 - int(rng.integers(0, 5)), v, 1), (u, v, 1)],
            "out of range"),
        "bad_before_out_of_range": ([(u, v, 1), (u, N, -1)],
                                    "already present"),
        "self_loop": ([(u, a, 1), (a, a, -1)], "self-loop"),
        "duplicate_insert": ([(u, a, 1), (a, u, 1)], "already present"),
        "missing_delete": ([(u, v, -1), (u, a, -1)], "not present"),
        "insert_then_delete": ([(u, a, 1), (a, u, -1)], None),
        "delete_then_reinsert": ([(u, v, -1), (v, u, 1), (u, v, -1),
                                  (v, u, -1)], "not present"),
        "fill_row_to_Cd": ([(full, f1, 1), (f2, full, 1)], None),
        "past_Cd": ([(full, f1, 1), (f2, full, 1), (f3, full, 1)],
                    "degree capacity"),
        "past_Cd_at_u": ([(full, f1, 1), (f2, full, 1), (full, f3, 1)],
                         "degree capacity"),
        "row_four_times": ([(u, a, 1), (v, u, -1), (u, v, 1), (b, u, 1),
                            (a, u, -1), (u, c, 1)], None),
    }[kind]


def _outcome(fn, g, window):
    try:
        fn(g, window)
    except ValueError as e:  # CapacityError is one
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", [
    "out_of_range_after_valid", "negative_before_bad",
    "bad_before_out_of_range", "self_loop", "duplicate_insert",
    "missing_delete", "insert_then_delete", "delete_then_reinsert",
    "fill_row_to_Cd", "past_Cd", "past_Cd_at_u", "row_four_times",
    "random"])
def test_validate_updates_equals_reference(kind, seed):
    """`validate_updates`, which replays a window on its endpoint rows
    only, raises or passes as the JAX package's whole-array replay does:
    the same first failing update, exception type and message, each row
    seeing the window's earlier edits to it.  The port's own whole-array
    replay (`apply_updates_host`) agrees, and the graph is left as it
    was."""
    from repro.core.kcore_dynamic import _validate_updates_host

    tg, jg = _graphs(40, 100 + seed, deg_slack=2)
    window, want = _window(kind, tg, seed)
    got = _outcome(tupd.validate_updates, tg, window)
    assert got == _outcome(_validate_updates_host, jg, window)
    assert got == _outcome(tupd.apply_updates_host, tg, window)
    if want is not ...:
        assert (got is None) if want is None else want in got[1]
    if kind.startswith("past_Cd"):
        assert got[0] == "CapacityError"
    assert_same_graph(tg, jg)



def _assert_row_lengths(g):
    """The invariant the kernels' row-length stop relies on: deg[u] is
    row u's count of valid slots and they come first,
    ``nbr[u, :deg[u]] >= 0`` and ``nbr[u, deg[u]:] == PAD``; deg is a
    contiguous int32 tensor on the graph's device."""
    assert g.deg.dtype == torch.int32 and g.deg.is_contiguous()
    assert g.deg.device == g.nbr.device
    nbr, deg = np_of(g.nbr), np_of(g.deg)
    np.testing.assert_array_equal(deg, (nbr >= 0).sum(axis=1))
    left = np.arange(nbr.shape[1])[None, :] < deg[:, None]
    assert (nbr[left] >= 0).all() and (nbr[~left] == tgraph.PAD).all()


def _mutations(tg, seed, n=4):
    """n inserts and n deletes of each scenario, sampled from tg."""
    return [up for scen in ("intra", "inter")
            for up in (tupd.sample_insertions(tg, n, scen, seed=seed)
                       + tupd.sample_deletions(tg, n, scen, seed=seed + 1))]


@pytest.mark.parametrize("path", ["build_blocks", "build_ell_random",
                                  "insert_delete_edge", "apply_updates_host",
                                  "run_stream"])
def test_row_lengths_hold_on_every_mutation_path(path):
    """deg equals the valid slots of each row, all on the left, after each
    path that builds or changes a graph (the ELL kernels take g.deg)."""
    from repro_torch.core import coreness
    from repro_torch.runtime import run_stream

    if path == "build_ell_random":
        _assert_row_lengths(tgraph.build_ell_random(300, Cd=12, seed=4,
                                                    device=CPU))
        return
    tg, _ = _graphs(60, 9)
    _assert_row_lengths(tg)
    ups = _mutations(tg, seed=9)
    if path == "insert_delete_edge":
        for u, v, op in ups:
            (tgraph.insert_edge if op > 0 else tgraph.delete_edge)(tg, u, v)
            _assert_row_lengths(tg)
    elif path == "apply_updates_host":
        _assert_row_lengths(tupd.apply_updates_host(tg, ups))
    elif path == "run_stream":
        res = run_stream(tg, coreness(tg), ups, R=4)
        _assert_row_lengths(res.g)
        assert res.stats.updates == len(ups)


def test_graph_methods_equal_reference():
    """Queue 3 fault 4: `GraphBlocks.block_of`, `valid_nbr_mask`,
    `is_boundary` and `grow` with the reference's semantics.  On fault
    3's graph the reference's boundary rows are 0, 1, 2, 8 and 9."""
    edges = np.array([[0, 1], [1, 2], [2, 0], [3, 4]])
    assign = np.arange(8) % 2
    jg = jgraph.build_blocks(edges, 8, assign, P=2, deg_slack=4)
    tg = tgraph.GraphBlocks.from_numpy(jg, jg.P, jg.Cn, jg.Cd, device=CPU)
    assert np.flatnonzero(tg.is_boundary().numpy()).tolist() == \
        np.flatnonzero(np.asarray(jg.is_boundary())).tolist() == \
        [0, 1, 2, 8, 9]
    np.testing.assert_array_equal(tg.valid_nbr_mask().numpy(),
                                  np.asarray(jg.valid_nbr_mask()))
    ids = np.arange(tg.N)
    np.testing.assert_array_equal(tg.block_of(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jg.block_of(jnp.asarray(ids))))
    assert tg.block_of(tg.Cn) == jg.block_of(jg.Cn) == 1
    t2, trekey = tg.grow(Cn=2 * tg.Cn, Cd=8)
    j2, jrekey = jg.grow(Cn=2 * jg.Cn, Cd=8)
    assert_same_graph(t2, j2)
    np.testing.assert_array_equal(np.asarray(trekey), np.asarray(jrekey))


@pytest.mark.parametrize("seed", [0, 1])
def test_is_boundary_equals_reference_on_random_graphs(seed):
    edges = jgen.erdos_renyi(120, 300, seed=seed)
    assign = jpart.node_random_partition(120, 4, seed=seed)
    jg = jgraph.build_blocks(edges, 120, assign, P=4, deg_slack=3)
    tg = tgraph.GraphBlocks.from_numpy(jg, jg.P, jg.Cn, jg.Cd, device=CPU)
    np.testing.assert_array_equal(tg.is_boundary().numpy(),
                                  np.asarray(jg.is_boundary()))
