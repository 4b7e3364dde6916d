"""PyTorch port vs the JAX package: static coreness (the min-H fixpoint).

`repro_torch.core.coreness_with_stats` against
`repro.core.coreness_with_stats(backend="ell")` (Pallas in interpret
mode): the coreness vector AND the superstep count must be EQUAL — they
are integers.  Covers BA, ER and ragged graphs (padding rows, Cd not a
power of two, isolated nodes), and ``max_steps=3``, which stops inside the
first chunk of the port's every-8-supersteps convergence check.
"""
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from _torch_port import needs_cuda, require_cuda, to_port  # noqa: F401

import repro.core as jcore
import repro.core.partition as jpart
import repro.graphgen as jgen

import repro_torch.core as tcore
from repro_torch.kernels import ops


def _ref_graph(kind, seed, P=4):
    if kind == "ba":
        edges = jgen.barabasi_albert(150, 4, seed=seed)
    elif kind == "er":
        edges = jgen.erdos_renyi(120, 360, seed=seed)
    else:  # ragged: NN growth, isolated tail nodes, padding rows, odd Cd
        edges = jgen.nearest_neighbor_graph(90, u=0.8, seed=seed)
    n = int(edges.max()) + 1 + (5 if kind == "ragged" else 0)
    assign = jpart.node_random_partition(n, P, seed=seed)
    return jcore.build_blocks(edges, n, assign, P=P, deg_slack=7,
                              node_slack=3 if kind == "ragged" else 0)


@pytest.mark.parametrize("kind", ["ba", "er", "ragged"])
@pytest.mark.parametrize("backend", ["torch", "ell"])
def test_coreness_equals_reference(kind, backend):
    jg = _ref_graph(kind, seed=3)
    want, want_steps = jcore.coreness_with_stats(jg, backend="ell")
    got, steps = tcore.coreness_with_stats(to_port(jg), backend=backend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps


@pytest.mark.parametrize("max_steps", [0, 1, 3, 8, 9])
def test_max_steps_cut_equals_reference(max_steps):
    """A cut fixpoint returns the reference's partial estimates and count."""
    jg = _ref_graph("ba", seed=5)
    want, want_steps = jcore.coreness_with_stats(jg, max_steps=max_steps,
                                                 backend="ell")
    got, steps = tcore.coreness_with_stats(to_port(jg), max_steps=max_steps,
                                           backend="ell")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps == min(max_steps, steps)


def _cascade_graph():
    """A long path with a dense head: coreness settles over many
    supersteps, well past one 8-superstep chunk."""
    path = np.stack([np.arange(40), np.arange(1, 41)], 1)
    head = np.array([(i, j) for i in range(6) for j in range(i + 1, 6)])
    edges = np.concatenate([path, head + 41])
    return edges, 47


def test_many_chunks_equal_reference():
    edges, n = _cascade_graph()
    assign = jpart.node_hash_partition(n, 3)
    jg = jcore.build_blocks(edges, n, assign, P=3)
    want, want_steps = jcore.coreness_with_stats(jg, backend="ell")
    got, steps = tcore.coreness_with_stats(to_port(jg), backend="ell")
    assert want_steps > 2 * ops.SYNC_EVERY
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps


@settings(max_examples=5, deadline=None)
@given(st.integers(12, 80), st.integers(0, 10_000), st.integers(1, 4))
def test_coreness_property(n, seed, P):
    edges = jgen.barabasi_albert(n, 3, seed=seed)
    nn = int(edges.max()) + 1
    jg = jcore.build_blocks(edges, nn,
                            jpart.node_random_partition(nn, P, seed=seed),
                            P=P, deg_slack=5)
    want, want_steps = jcore.coreness_with_stats(jg, backend="jnp")
    got, steps = tcore.coreness_with_stats(to_port(jg), backend="torch")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps


def test_coreness_auto_step_and_max():
    jg = _ref_graph("er", seed=2)
    tg = to_port(jg)
    core = tcore.coreness(tg)  # auto -> torch on a CPU graph
    np.testing.assert_array_equal(core.numpy(),
                                  np.asarray(jcore.coreness(jg, backend="jnp")))
    assert tcore.max_coreness(tg) == int(np.asarray(core).max())
    est0 = torch.where(tg.node_mask, tg.deg, 0)
    new, changed = tcore.coreness_step(tg, est0, tg.node_mask)
    assert bool(changed) == bool((new != est0).any())
    assert ops.degree_bound(tg) == min(tg.Cd, ops._pow2_bucket(
        int(tg.deg.max())))


@needs_cuda
@pytest.mark.parametrize("kind", ["ba", "ragged"])
def test_coreness_kernel_path_on_gpu(kind):
    jg = _ref_graph(kind, seed=1)
    want, want_steps = jcore.coreness_with_stats(jg, backend="jnp")
    got, steps = tcore.coreness_with_stats(to_port(jg, device="cuda"),
                                           backend="ell")
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))
    assert steps == want_steps
