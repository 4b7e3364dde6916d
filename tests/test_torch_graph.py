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
from _torch_port import CPU, assert_same_graph, np_of

import repro.core.graph as jgraph
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen

import repro_torch.core.graph as tgraph
import repro_torch.core.partition as tpart
import repro_torch.core.updates as tupd
import repro_torch.graphgen as tgen


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

