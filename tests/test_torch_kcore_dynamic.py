"""PyTorch port vs the JAX package: Theorem-1 coreness maintenance.

`k_reachable_batch`, `insert_edge_maintain` / `delete_edge_maintain`,
`maintain_batch_host` and `maintain_batch` against the JAX package's
functions with ``backend="ell"`` (Pallas in interpret mode), on the same
graph and the same updates.  Graph arrays (`nbr`, `deg`), coreness,
candidate sets and every stats field are integers and must be EQUAL.
Each package gets its own copy of the graph: the JAX functions donate
theirs, the port's update theirs in place.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_port import (  # noqa: F401 (fixtures)
    assert_same_graph, needs_cuda, np_of, one_torch_thread, require_cuda,
    tensor_of, to_port)

import repro.core as jcore
import repro.core.kcore_dynamic as jkd
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen

import repro_torch.core as tcore
import repro_torch.core.kcore_dynamic as tkd

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _setup(seed=4, n=120, P=4):
    edges = jgen.nearest_neighbor_graph(n, u=0.8, seed=seed)
    nn = int(edges.max()) + 1
    assign = jpart.node_bfs_partition(edges, nn, P, seed=1)
    jg = jcore.build_blocks(edges, nn, assign, P=P, deg_slack=12)
    core = jcore.coreness(jg, backend="jnp")
    return jg, core


def _mixed_updates(jg, q, seed=2):
    return (jupd.sample_insertions(jg, q, "inter", seed=seed)
            + jupd.sample_insertions(jg, q, "intra", seed=seed + 1)
            + jupd.sample_deletions(jg, q, "inter", seed=seed + 2)
            + jupd.sample_deletions(jg, q, "intra", seed=seed + 3))


def test_k_reachable_batch_equals_reference():
    jg, core = _setup()
    tg = to_port(jg)
    rng = np.random.default_rng(0)
    R = 8
    roots = np.zeros((jg.N, R), bool)
    real = np.flatnonzero(np.asarray(jg.node_mask))
    for r in range(R):
        roots[rng.choice(real, size=2, replace=False), r] = True
    ks = np.asarray(core)[rng.choice(real, size=R)].astype(np.int32)
    ks[-1] = -1  # an empty search column
    want, want_steps = jkd.k_reachable_batch(
        jg, core, jnp.asarray(roots), jnp.asarray(ks), backend="ell")
    for backend in ("torch", "ell"):
        got, steps = tkd.k_reachable_batch(
            tg, tensor_of(core), torch.as_tensor(roots),
            torch.as_tensor(ks), backend=backend)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert steps == int(want_steps)


def test_k_reachable_max_steps_cut():
    jg, core = _setup(seed=6)
    u = int(np.flatnonzero(np.asarray(jg.node_mask))[0])
    roots = np.zeros(jg.N, bool)
    roots[u] = True
    k = jnp.int32(int(np.asarray(core)[u]))
    for max_steps in (1, 2, 9):
        want, want_steps = jkd.k_reachable(jg, core, jnp.asarray(roots), k,
                                           max_steps=max_steps, backend="ell")
        got, steps = tkd.k_reachable(
            to_port(jg), tensor_of(core),
            torch.as_tensor(roots), torch.tensor(int(k)),
            max_steps=max_steps, backend="ell")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert steps == int(want_steps)


@pytest.mark.parametrize("op", [+1, -1])
def test_single_edge_maintain_equals_reference(op):
    jg, core = _setup(seed=8)
    tg = to_port(jg)
    tcore_ = tensor_of(core)
    sample = jupd.sample_insertions if op > 0 else jupd.sample_deletions
    ups = sample(jg, 3, "inter", seed=1) + sample(jg, 3, "intra", seed=2)
    jfn = jkd.insert_edge_maintain if op > 0 else jkd.delete_edge_maintain
    tfn = tkd.insert_edge_maintain if op > 0 else tkd.delete_edge_maintain
    for u, v, _ in ups:
        jg, core, jst = jfn(jg, core, jnp.int32(u), jnp.int32(v),
                            backend="ell")
        tg2, tcore_, tst = tfn(tg, tcore_, u, v, backend="ell")
        assert tg2 is tg  # updated in place
        assert_same_graph(tg, jg)
        np.testing.assert_array_equal(tcore_.numpy(), np.asarray(core))
        assert tst == tkd.MaintenanceStats(
            *(type(t)(np.asarray(j)) for t, j in zip(tst, jst)))


def test_maintain_batch_host_equals_reference():
    jg, core = _setup(seed=9)
    ups = _mixed_updates(jg, 2)
    tg2, tcore2, tstats = tkd.maintain_batch_host(
        to_port(jg), tensor_of(core), ups, backend="ell")
    jg2, jcore2, jstats = jkd.maintain_batch_host(jg, core, ups)
    assert_same_graph(tg2, jg2)
    np.testing.assert_array_equal(tcore2.numpy(), np.asarray(jcore2))
    assert [tuple(s) for s in tstats] == [
        tuple(type(t)(np.asarray(j)) for t, j in zip(ts, js))
        for ts, js in zip(tstats, jstats)]


@pytest.mark.parametrize("R", [1, 4, 8])
def test_maintain_batch_equals_reference(R):
    jg, core = _setup(seed=4)
    ups = _mixed_updates(jg, 4)
    tg2, tcore2, tstats = tkd.maintain_batch(
        to_port(jg), tensor_of(core), ups, R=R, backend="ell")
    jg2, jcore2, jstats = jkd.maintain_batch(jg, core, ups, R=R,
                                             backend="ell")
    assert_same_graph(tg2, jg2)
    np.testing.assert_array_equal(tcore2.numpy(), np.asarray(jcore2))
    assert tstats._asdict() == jstats._asdict()
    # and the maintained coreness equals a fresh recompute
    np.testing.assert_array_equal(
        tcore2.numpy(), tcore.coreness(tg2, backend="torch").numpy())


def test_independent_prefix_and_rejects():
    cand = np.array([[1, 0, 1], [0, 1, 0], [0, 0, 1]], bool)
    assert tkd._independent_prefix(cand, 3) == jkd._independent_prefix(cand, 3)
    jg, core = _setup()
    with pytest.raises(ValueError):
        tkd.maintain_batch(to_port(jg), tensor_of(core),
                           [(0, 0, 1)])
    with pytest.raises(ValueError):
        tkd.maintain_batch(to_port(jg), tensor_of(core),
                           [], R=0)


@needs_cuda
def test_maintain_batch_on_gpu_equals_cpu():
    jg, core = _setup(seed=4)
    ups = _mixed_updates(jg, 4)
    c0 = tensor_of(core)
    g_cpu, core_cpu, st_cpu = tkd.maintain_batch(to_port(jg), c0, ups,
                                                 backend="torch")
    g_gpu, core_gpu, st_gpu = tkd.maintain_batch(
        to_port(jg, device="cuda"), c0.cuda(), ups, backend="ell")
    assert st_gpu == st_cpu
    np.testing.assert_array_equal(np_of(core_gpu), np_of(core_cpu))
    np.testing.assert_array_equal(np_of(g_gpu.nbr), np_of(g_cpu.nbr))
