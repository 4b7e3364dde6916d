"""PyTorch port vs the JAX package: the degree example, neighbor estimates
and maximal-clique maintenance.

* `compute_degrees`, `maintain_degrees_insert`/`_delete` and
  `DegreeProgram` through `BladygEngine` give the JAX package's integers,
  traces and message totals on a seeded BA graph; the maintenance
  functions return new tensors and leave their input as it was.
* `kcore.neighbor_estimates` equals the JAX one on seeded estimates.
* `MaximalCliques` under seeded random insert/delete dynamics holds the
  same clique sets and root index as the JAX `MaximalCliques` and as
  `networkx.find_cliques`, as tests/test_cliques.py checks the reference.
"""
import networkx as nx
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (fixtures)
    one_torch_thread, tensor_of, to_port)

import repro.core as jcore
from repro.core.degree import DegreeProgram as JDegreeProgram
from repro.core.kcore import neighbor_estimates as j_neighbor_estimates
from repro.core.partition import node_random_partition
from repro.core.updates import sample_deletions, sample_insertions
from repro.graphgen import barabasi_albert, erdos_renyi

import repro_torch.core as tcore
from repro_torch.core.degree import DegreeProgram
from repro_torch.core.kcore import neighbor_estimates

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jgraph(seed):
    edges = barabasi_albert(200, 4, seed=seed)
    n = int(edges.max()) + 1
    assign = node_random_partition(n, 4, seed=2)
    return jcore.build_blocks(edges, n, assign, P=4, deg_slack=48)


@pytest.mark.parametrize("seed", [11, 12])
def test_compute_degrees_equals_reference(seed):
    jg = _jgraph(seed)
    tg = to_port(jg)
    got = tcore.compute_degrees(tg)
    want = np.asarray(jcore.compute_degrees(jg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tg.deg.numpy())
    assert (got.numpy()[~tg.node_mask.numpy()] == 0).all()


@pytest.mark.parametrize("scenario", ["inter", "intra"])
def test_maintain_degrees_equal_reference(scenario):
    """Paper §3.2: insert (u, v) -> only deg[u], deg[v] bumped via M2W;
    the input tensor is never written."""
    jg = _jgraph(11)
    tg = to_port(jg)
    deg = tcore.compute_degrees(tg)
    deg0 = deg.clone()
    jdeg = jcore.compute_degrees(jg)
    for (u, v, _) in sample_insertions(jg, 3, scenario, seed=0):
        tg = tcore.insert_edge(tg, u, v)
        deg2 = tcore.maintain_degrees_insert(deg, u, v)
        assert torch.equal(deg, deg0)  # input unmodified
        jdeg = jcore.maintain_degrees_insert(jdeg, u, v)
        np.testing.assert_array_equal(deg2.numpy(), np.asarray(jdeg))
        np.testing.assert_array_equal(deg2.numpy(),
                                      tcore.compute_degrees(tg).numpy())
        deg3 = tcore.maintain_degrees_delete(deg2, u, v)
        assert deg3 is not deg2
        np.testing.assert_array_equal(
            deg3.numpy(), np.asarray(jcore.maintain_degrees_delete(jdeg, u,
                                                                   v)))
        np.testing.assert_array_equal(deg3.numpy(), deg0.numpy())
        deg, deg0 = deg2, deg2.clone()
    for (u, v, _) in sample_deletions(jg, 3, scenario, seed=1):
        got = tcore.maintain_degrees_delete(deg, u, v)
        jdeg = jcore.maintain_degrees_delete(jdeg, u, v)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jdeg))
        assert torch.equal(deg, deg0)
        deg, deg0 = got, got.clone()


def test_degree_program_through_engine_equals_reference():
    """One superstep (LOCAL | W2M), the same degrees, traces and message
    totals as the JAX engine."""
    jg = _jgraph(11)
    tg = to_port(jg)
    assert DegreeProgram.modes.name == JDegreeProgram.modes.name
    eng = tcore.BladygEngine(tg)
    deg, _ = eng.run(DegreeProgram(), None, None, max_supersteps=10)
    jeng = jcore.BladygEngine(jg)
    jdeg, _ = jeng.run(JDegreeProgram(), None, None, max_supersteps=10)
    assert len(eng.traces) == len(jeng.traces) == 1
    np.testing.assert_array_equal(
        torch.where(tg.node_mask, deg, 0).numpy(),
        np.asarray(jcore.compute_degrees(jg)))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    assert tuple(eng.message_totals()) == tuple(jeng.message_totals())
    assert eng.message_totals().w2m == tg.P


@pytest.mark.parametrize("seed", [0, 1])
def test_neighbor_estimates_equal_reference(seed):
    jg = _jgraph(11 + seed)
    tg = to_port(jg)
    rng = np.random.default_rng(seed)
    for est in (rng.integers(0, 9, tg.N).astype(np.int32),
                np.asarray(jcore.coreness(jg, backend="jnp"))):
        got = neighbor_estimates(tg, tensor_of(est))
        want = np.asarray(j_neighbor_estimates(jg, est))
        assert got.shape == (tg.N, tg.Cd)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy()[tg.nbr.numpy() < 0] == -1).all()


def _nx_cliques(G):
    return set(frozenset(c) for c in nx.find_cliques(G))


def _nx(edges, n):
    G = nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(map(tuple, np.asarray(edges)))
    return G


@pytest.mark.parametrize("n,m,seed", [(40, 160, 2), (25, 70, 5)])
def test_static_cliques_equal_reference(n, m, seed):
    edges = erdos_renyi(n, m, seed=seed)
    mc = tcore.MaximalCliques(n, map(tuple, edges))
    jmc = jcore.MaximalCliques(n, map(tuple, edges))
    assert mc.cliques == jmc.cliques == _nx_cliques(_nx(edges, n))
    assert mc.by_root == jmc.by_root
    assert (sorted(map(sorted, tcore.bron_kerbosch(mc.adj)))
            == sorted(map(sorted, jcore.bron_kerbosch(jmc.adj))))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_clique_dynamics_equal_reference(seed):
    """Seeded random inserts and deletes: every step returns the
    reference's (added, removed) and keeps the same cliques and index."""
    rng = np.random.default_rng(seed)
    n = 18
    edges = erdos_renyi(n, 30, seed=seed)
    G = _nx(edges, n)
    mc = tcore.MaximalCliques(n, map(tuple, edges))
    jmc = jcore.MaximalCliques(n, map(tuple, edges))
    for _ in range(30):
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if a == b:
            continue
        if G.has_edge(a, b):
            assert mc.delete_edge(a, b) == jmc.delete_edge(a, b)
            G.remove_edge(a, b)
        else:
            assert mc.insert_edge(a, b) == jmc.insert_edge(a, b)
            G.add_edge(a, b)
        assert mc.cliques == jmc.cliques
    assert mc.cliques == _nx_cliques(G)
    assert mc.by_root == jmc.by_root
    assert mc.check()
