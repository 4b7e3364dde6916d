"""PyTorch port vs the JAX package: the §4.2 partitioners and rebalancing.

The edge and vertex-cut partitioners (`core/partition.py`), the dynamic
partitioning protocol (`core/partition_dynamic.py`: IncrementalPart,
NaivePart, the deletion threshold) and the live-rebalancing pieces over a
`GraphBlocks` (`block_loads`, `block_balance`, `choose_node_moves`,
`graph.migrate_vertices`) must give owners, decisions, moves,
permutations and graph arrays EQUAL to the JAX package's from the same
inputs and seeds.  The scenarios replay tests/test_partition.py and
tests/test_partition_dynamic.py; the measured seconds are not compared.
"""
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from _torch_port import (  # noqa: F401 (fixtures)
    assert_same_graph, one_torch_thread, tensor_of, to_port)

import repro.core as jcore
import repro.core.partition as jpart
import repro.core.partition_dynamic as jpd
import repro.graphgen as jgen

import repro_torch.core as tcore
import repro_torch.core.partition as tpart
import repro_torch.core.partition_dynamic as tpd

pytestmark = pytest.mark.usefixtures("one_torch_thread")

METHODS = ["hash", "random", "dfep", "vertex_cut"]


@pytest.fixture(scope="module")
def graph():
    e = jgen.barabasi_albert(300, 4, seed=3)
    return e, int(e.max()) + 1


def _state_equal(a, b):
    np.testing.assert_array_equal(a.edges, b.edges)
    np.testing.assert_array_equal(a.owner, b.owner)
    assert (a.n, a.P, a.method, a.seed) == (b.n, b.P, b.method, b.seed)


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", ["edge_hash_partition",
                                  "edge_random_partition"])
def test_stateless_edge_partitioners_equal(graph, name, P, seed):
    edges, _ = graph
    np.testing.assert_array_equal(getattr(tpart, name)(edges, P, seed=seed),
                                  getattr(jpart, name)(edges, P, seed=seed))


@pytest.mark.parametrize("P", [4, 8])
def test_vertex_cut_greedy_and_dfep_equal(graph, P):
    edges, n = graph
    np.testing.assert_array_equal(tpart.vertex_cut_greedy(edges, n, P),
                                  jpart.vertex_cut_greedy(edges, n, P))
    for seed in (0, 3):
        np.testing.assert_array_equal(tpart.dfep(edges, n, P, seed=seed),
                                      jpart.dfep(edges, n, P, seed=seed))


@pytest.mark.parametrize("m0", [0, 1, 50, 594, 1185])
def test_vertex_cut_update_equals_reference_and_static_greedy(graph, m0):
    """The continuation contract at every split point, and the same
    owners as the JAX package's continuation."""
    edges, n = graph
    full = tpart.vertex_cut_greedy(edges, n, 4)
    cont = tpart.vertex_cut_update(edges[:m0], full[:m0], edges[m0:], n, 4)
    np.testing.assert_array_equal(cont, full[m0:])
    np.testing.assert_array_equal(
        cont, jpart.vertex_cut_update(edges[:m0], full[:m0], edges[m0:], n, 4))


def test_ub_update_and_edge_balance_equal(graph):
    edges, n = graph
    owner = jpart.dfep(edges[:900], n, 4, seed=0)
    np.testing.assert_array_equal(
        tpart.ub_update(edges[:900], owner, edges[900:], n, 4),
        jpart.ub_update(edges[:900], owner, edges[900:], n, 4))
    for P in (4, 8):
        assert tpart.edge_balance(owner, P) == jpart.edge_balance(owner, P)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 99999))
def test_property_hash_partition_equal_and_deterministic(seed):
    e = jgen.erdos_renyi(25, 40, seed=seed)
    a = tpart.edge_hash_partition(e, 5, seed=seed)
    np.testing.assert_array_equal(a, jpart.edge_hash_partition(e, 5,
                                                               seed=seed))
    perm = np.random.default_rng(seed).permutation(len(e))
    np.testing.assert_array_equal(
        tpart.edge_hash_partition(e[perm], 5, seed=seed), a[perm])


@pytest.mark.parametrize("method", METHODS)
def test_initial_incremental_naive_equal(graph, method):
    """IncrementalPart keeps the old owners and assigns the new edges as
    the JAX package does; NaivePart repartitions everything the same."""
    edges, n = graph
    cut = int(0.9 * len(edges))
    t0, pt = tpd.initial_partition(edges[:cut], n, 8, method, seed=4)
    j0, _ = jpd.initial_partition(edges[:cut], n, 8, method, seed=4)
    _state_equal(t0, j0)
    assert pt >= 0.0
    tinc, _ = tpd.incremental_part(t0, edges[cut:])
    jinc, _ = jpd.incremental_part(j0, edges[cut:])
    _state_equal(tinc, jinc)
    np.testing.assert_array_equal(tinc.owner[:cut], t0.owner)
    tnv, _ = tpd.naive_part(t0, edges[cut:])
    jnv, _ = jpd.naive_part(j0, edges[cut:])
    _state_equal(tnv, jnv)


def test_incremental_part_rejects_unknown_method(graph):
    edges, n = graph
    st0 = tpd.PartitionState(edges[:10], np.zeros(10, np.int64), n, 4,
                             "metis")
    with pytest.raises(ValueError):
        tpd.incremental_part(st0, edges[10:20])


# ---------------------------------------------------------------------------
# The deletion threshold protocol (tests/test_partition_dynamic.py)
# ---------------------------------------------------------------------------


def _skewed_states():
    """The hand-built state of tests/test_partition_dynamic.py (block 0
    holds half of all edges), in both packages."""
    edges = jgen.barabasi_albert(200, 4, seed=9)
    m = len(edges)
    owner = np.zeros(m, np.int64)
    owner[m // 2:] = 1 + np.arange(m - m // 2) % 3
    n = int(edges.max()) + 1
    return (tpd.PartitionState(edges, owner, n, 4, "hash"),
            jpd.PartitionState(edges, owner, n, 4, "hash"))


def _idx(kind, owner):
    if kind == "few":
        return np.arange(5)
    if kind == "most_but_block0":
        return np.flatnonzero(owner != 0)
    return np.arange(3)


@pytest.mark.parametrize("kind,threshold", [
    ("few", 3.0),              # below: owners untouched
    ("most_but_block0", 1.5),  # above: a full repartition
    ("three", None),           # at the balance itself: strict, no repart
    ("three", -1.0),           # just below it
])
def test_delete_edges_equal(kind, threshold):
    ts, js = _skewed_states()
    idx = _idx(kind, ts.owner)
    if threshold is None:
        threshold = tpart.edge_balance(np.delete(ts.owner, idx), 4)
    elif threshold < 0:
        threshold = tpart.edge_balance(np.delete(ts.owner, idx), 4) - 1e-6
    t2, trep, ut = tpd.delete_edges(ts, idx, threshold=threshold)
    j2, jrep, _ = jpd.delete_edges(js, idx, threshold=threshold)
    assert trep == jrep
    assert ut >= 0.0
    _state_equal(t2, j2)
    if kind == "few":
        assert not trep
        np.testing.assert_array_equal(t2.owner, np.delete(ts.owner, idx))
    if kind == "most_but_block0":
        assert trep and len(np.unique(t2.owner)) > 1


def test_deletion_round_trip_equal(graph):
    """tests/test_partition.py's protocol: random owners, a few deletes
    keep them, deleting most of all but block 0 forces a repartition."""
    edges, n = graph
    t0, _ = tpd.initial_partition(edges, n, 8, "random", seed=2)
    j0, _ = jpd.initial_partition(edges, n, 8, "random", seed=2)
    t1, r1, _ = tpd.delete_edges(t0, np.arange(10), threshold=1.5)
    j1, s1, _ = jpd.delete_edges(j0, np.arange(10), threshold=1.5)
    assert r1 == s1 is False
    idx = np.flatnonzero(t1.owner != 0)
    t2, r2, _ = tpd.delete_edges(t1, idx[:len(idx) - 5], threshold=1.5)
    j2, s2, _ = jpd.delete_edges(j1, idx[:len(idx) - 5], threshold=1.5)
    assert r2 == s2 is True
    _state_equal(t2, j2)


# ---------------------------------------------------------------------------
# Live rebalancing over the block graph
# ---------------------------------------------------------------------------


def _skewed_graph(seed=7):
    """tests/test_stream.py's skewed graph: half the nodes (the BA hubs
    among them) on block 0, free node capacity everywhere."""
    edges = jgen.barabasi_albert(160, 4, seed=seed)
    n = int(edges.max()) + 1
    assign = np.where(np.arange(n) < n // 2, 0, 1 + np.arange(n) % 3)
    return jcore.build_blocks(edges, n, assign, P=4, Cn=96, deg_slack=48)


def test_block_loads_and_balance_equal():
    jg = _skewed_graph()
    tg = to_port(jg)
    np.testing.assert_array_equal(tpd.block_loads(tg), jpd.block_loads(jg))
    assert tpd.block_balance(tg) == jpd.block_balance(jg) > 1.2


@pytest.mark.parametrize("objective", ["halo", "load"])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("seed,max_moves", [(7, 8), (7, 40), (11, 20)])
def test_choose_node_moves_equal(objective, pairs, seed, max_moves):
    jg = _skewed_graph(seed)
    tg = to_port(jg)
    pc = tcore.halo_pair_counts(tg) if pairs else None
    if pairs:
        np.testing.assert_array_equal(pc, jcore.halo_pair_counts(jg))
    got = tpd.choose_node_moves(tg, max_moves=max_moves, pair_counts=pc,
                                objective=objective)
    want = jpd.choose_node_moves(jg, max_moves=max_moves, pair_counts=pc,
                                 objective=objective)
    assert got == want and len(got) > 0
    with pytest.raises(ValueError, match="objective"):
        tpd.choose_node_moves(tg, objective="cut")


def test_choose_node_moves_on_a_balanced_graph_is_empty():
    jg = jcore.build_blocks(np.array([[0, 1], [2, 3]]), 4,
                            np.array([0, 0, 1, 1]), P=2, node_slack=2)
    assert tpd.choose_node_moves(to_port(jg)) == [] \
        == jpd.choose_node_moves(jg)


def test_migrate_vertices_equals_reference():
    """The chosen moves executed: the same permutation, graph arrays and
    permuted coreness; the inputs are left as they were and share no
    storage with the result."""
    jg = _skewed_graph()
    tg = to_port(jg)
    before = tg.clone()
    core = jcore.coreness(jg, backend="jnp")
    moves = jpd.choose_node_moves(jg, max_moves=8,
                                  pair_counts=jcore.halo_pair_counts(jg))
    t2, tperm, tcore2 = tcore.migrate_vertices(tg, moves, tensor_of(core))
    j2, jperm, jcore2 = jcore.migrate_vertices(jg, moves, core)
    np.testing.assert_array_equal(tperm, jperm)
    assert tperm.dtype == np.int64
    assert_same_graph(t2, j2)
    np.testing.assert_array_equal(tcore2.numpy(), np.asarray(jcore2))
    np.testing.assert_array_equal(tcore2.numpy()[tperm], np.asarray(core))
    for f in ("nbr", "deg", "node_mask", "orig_id"):
        assert torch.equal(getattr(tg, f), getattr(before, f))
        assert getattr(t2, f).data_ptr() != getattr(tg, f).data_ptr()
    # and the migrated graph's coreness is the permuted one
    assert torch.equal(tcore.coreness(t2, backend="torch"), tcore2)


@pytest.mark.parametrize("bad,exc", [
    ([(95, 1)], ValueError),            # a padding row of block 0
    ([(0, 4)], ValueError),             # no such block
    ([(0, 0)], ValueError),             # no-op move
    ([(0, 1), (0, 2)], ValueError),     # duplicate
])
def test_migrate_vertices_rejects(bad, exc):
    tg = to_port(_skewed_graph())
    with pytest.raises(exc):
        tcore.migrate_vertices(tg, bad)


def test_migrate_vertices_capacity_is_pre_migration():
    jg = jcore.build_blocks(np.array([[0, 1], [1, 2], [2, 3]]), 4,
                            np.array([0, 0, 1, 1]), P=2, Cn=3)
    tg = to_port(jg)
    with pytest.raises(tcore.CapacityError):  # block 1 has ONE free row
        tcore.migrate_vertices(tg, [(0, 1), (1, 1)])
    with pytest.raises(jcore.CapacityError):
        jcore.migrate_vertices(jg, [(0, 1), (1, 1)])
