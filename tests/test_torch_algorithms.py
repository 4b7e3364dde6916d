"""PyTorch port vs the JAX package: the BlockProgram workloads.

`connected_components`, `triangle_counts` and `CorenessBlockProgram` are
integers: states and superstep counts must be EQUAL to the JAX package's
(`backend="jnp"`, which its own tests hold equal to its Pallas kernels).
`pagerank` is float32: ranks `allclose(atol=2e-6)`, the JAX tests' own bar
across backends, with equal superstep counts.  `fused_analytics` must
equal the standalone runs, and the port's runner (`ops.run_block_program`,
one host read per `SYNC_EVERY` supersteps behind a device `live` flag)
must stop where the JAX `while_loop` stops, also inside a chunk.

Graphs: random edges with random block assignments (ragged Cd, padding
rows, isolated nodes, P = 1 included), built by the JAX package and
carried across with `GraphBlocks.from_numpy`.  Port programs run on
the "torch" and "ell" backends (on the CPU "ell" runs the kernels' plain
versions); the `cuda` tests run "ell" on the card.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_port import (  # noqa: F401 (require_cuda is a fixture)
    needs_cuda, require_cuda, to_port)

import repro.core as jcore
import repro.core.updates as jupd
from repro.core import algorithms as jalg
from repro.kernels import ops as jops

import repro_torch.core as tcore
from repro_torch.core import algorithms as talg
from repro_torch.kernels import ops

BACKENDS = ["torch", "ell"]


def _graph(n, m, P, seed, slack=5):
    rng = np.random.default_rng(seed)
    uv = rng.integers(0, n, (m, 2))
    assign = rng.integers(0, P, n)
    return jcore.build_blocks(uv, n, assign, P=P, deg_slack=slack)


GRAPHS = [
    # (n, m, P, seed): sparse (many components), dense, one block
    (90, 60, 3, 1),
    (120, 300, 4, 2),
    (70, 140, 1, 3),
]


def _path_graph(n, P):
    """A path: CC needs ~n supersteps, many chunks of SYNC_EVERY."""
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    return jcore.build_blocks(edges, n, np.arange(n) % P, P=P)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,m,P,seed", GRAPHS)
def test_connected_components_equals_reference(n, m, P, seed, backend):
    jg = _graph(n, m, P, seed)
    want, want_steps = jalg.connected_components(jg, backend="jnp",
                                                 with_steps=True)
    got, steps = tcore.connected_components(to_port(jg), backend=backend,
                                            with_steps=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)


@pytest.mark.parametrize("max_steps", [None, 0, 3, 8, 13])
def test_cc_chunks_and_cuts_equal_reference(max_steps):
    jg = _path_graph(40, P=3)
    want, want_steps = jalg.connected_components(
        jg, backend="jnp", max_steps=max_steps, with_steps=True)
    got, steps = tcore.connected_components(to_port(jg), max_steps=max_steps,
                                            with_steps=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)
    if max_steps is None:
        assert steps > 2 * ops.SYNC_EVERY


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,m,P,seed", GRAPHS)
def test_triangle_counts_equal_reference(n, m, P, seed, backend):
    jg = _graph(n, m, P, seed)
    want, want_steps = jalg.triangle_counts(jg, backend="jnp",
                                            with_steps=True)
    got, steps = tcore.triangle_counts(to_port(jg), backend=backend,
                                       with_steps=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps) == 1
    assert int(tcore.triangle_total(got)) == int(jalg.triangle_total(want))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,m,P,seed", GRAPHS)
def test_coreness_block_program_equals_reference(n, m, P, seed, backend):
    jg = _graph(n, m, P, seed)
    want, want_steps = jops.run_block_program(
        jg, jalg.CorenessBlockProgram(), backend="jnp", with_steps=True)
    tg = to_port(jg)
    got, steps = ops.run_block_program(tg, talg.CorenessBlockProgram(),
                                       backend=backend, with_steps=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)
    # and the dedicated fixpoint agrees
    np.testing.assert_array_equal(
        torch.where(tg.node_mask, got, 0).numpy(),
        tcore.coreness(tg, backend=backend).numpy())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tol,max_steps", [(None, 30), (1e-6, 100),
                                           (None, 5)])
@pytest.mark.parametrize("n,m,P,seed", GRAPHS)
def test_pagerank_equals_reference(n, m, P, seed, tol, max_steps, backend):
    jg = _graph(n, m, P, seed)
    want, want_steps = jalg.pagerank(jg, tol=tol, max_steps=max_steps,
                                     backend="jnp", with_steps=True)
    got, steps = tcore.pagerank(to_port(jg), tol=tol, max_steps=max_steps,
                                backend=backend, with_steps=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    assert steps == int(want_steps)
    if tol is None:
        assert steps == max_steps


def test_pagerank_halt_mid_chunk_equals_reference():
    """The live flag: PageRank is not idempotent at its halt, so supersteps
    past the quiet one must not touch the ranks or the count."""
    jg = _graph(120, 300, 4, 2)
    tg = to_port(jg)
    seen = set()
    for tol in (1e-3, 3e-4, 1e-4, 3e-5, 1e-5):
        want, want_steps = jalg.pagerank(jg, tol=tol, backend="jnp",
                                         with_steps=True)
        got, steps = tcore.pagerank(tg, tol=tol, with_steps=True)
        assert steps == int(want_steps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
        # the halt's ranks, not those of a later superstep of the chunk
        one_more = tcore.pagerank(tg, tol=None, max_steps=steps + 1)
        assert not torch.equal(got, one_more)
        assert torch.equal(got, tcore.pagerank(tg, tol=None, max_steps=steps))
        seen.add(steps % ops.SYNC_EVERY)
    assert seen - {0}  # at least one halt fell inside a chunk


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_analytics_equals_standalone_and_reference(backend):
    jg = jcore.build_ell_random(192, Cd=16, seed=5)
    tg = to_port(jg)
    (core, lab, rank), n = tcore.fused_analytics(tg, steps=30,
                                                 backend=backend,
                                                 with_steps=True)
    assert n == 30
    core_alone = ops.run_block_program(tg, talg.CorenessBlockProgram(),
                                       backend=backend)
    assert torch.equal(core, core_alone)
    assert torch.equal(lab, tcore.connected_components(tg, backend=backend))
    assert torch.equal(rank, tcore.pagerank(tg, tol=None, max_steps=30,
                                            backend=backend))
    jcore_, jlab, jrank = jalg.fused_analytics(jg, steps=30, backend="jnp")
    np.testing.assert_array_equal(core.numpy(), np.asarray(jcore_))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_allclose(rank.numpy(), np.asarray(jrank), atol=2e-6)


def test_fused_analytics_warm_start_equals_reference():
    """init=(core, labels), the serving path's refresh, carried across as
    numpy: the maintained fields ride through unchanged."""
    jg = _graph(120, 300, 4, 2)
    tg = to_port(jg)
    core = np.array(jcore.coreness(jg, backend="jnp"))
    labels = np.array(jalg.connected_components(jg, backend="jnp"))
    want = jalg.fused_analytics(jg, steps=12, backend="jnp",
                                init=(jnp.asarray(core), jnp.asarray(labels)))
    got = tcore.fused_analytics(tg, steps=12,
                                init=(torch.as_tensor(core),
                                      torch.as_tensor(labels)))
    np.testing.assert_array_equal(got[0].numpy(), core)
    np.testing.assert_array_equal(got[1].numpy(), labels)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=2e-6)


@pytest.mark.parametrize("seed", [21, 22])
def test_merge_labels_equals_reference_and_recompute(seed):
    jg = _graph(70, 60, 2, seed)
    labels = np.array(jalg.connected_components(jg, backend="jnp"))
    ups = jupd.sample_insertions(jg, 8, "inter", seed=seed + 1)
    us = np.array([u for u, _, _ in ups], np.int32)
    vs = np.array([v for _, v, _ in ups], np.int32)
    valid = np.arange(len(ups)) != 3  # one no-op column
    want = jalg.merge_labels(jnp.asarray(labels), jnp.asarray(us),
                             jnp.asarray(vs), jnp.asarray(valid))
    got = tcore.merge_labels(torch.as_tensor(labels), torch.as_tensor(us),
                             torch.as_tensor(vs), torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    applied = [u for u, ok in zip(ups, valid) if ok]
    g2 = to_port(jupd.apply_updates_host(jg, applied))
    assert torch.equal(got, tcore.connected_components(g2))


def test_runner_rejects_what_is_not_ported():
    tg = to_port(_graph(30, 40, 2, 4))
    prog = talg.ConnectedComponentsProgram()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.run_block_program(tg, prog, mirror=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.run_block_program(tg, prog, executor=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.run_block_program(tg, prog, backend="ell_spmd")
    # "dense" is ported: it runs, equal to the plain backend
    assert torch.equal(ops.run_block_program(tg, prog, backend="dense"),
                       ops.run_block_program(tg, prog, backend="torch"))

    class Bad(talg.CorenessBlockProgram):
        combine = "nonsense"

    with pytest.raises(ValueError, match="unknown combine"):
        ops.run_block_program(tg, Bad())


@needs_cuda
@pytest.mark.parametrize("n,m,P,seed", GRAPHS)
def test_workloads_on_gpu_equal_reference(n, m, P, seed):
    jg = _graph(n, m, P, seed)
    tg = to_port(jg, device="cuda")
    lab, s = tcore.connected_components(tg, with_steps=True)  # auto -> ell
    jlab, js = jalg.connected_components(jg, backend="jnp", with_steps=True)
    np.testing.assert_array_equal(lab.cpu().numpy(), np.asarray(jlab))
    assert s == int(js)
    np.testing.assert_array_equal(
        tcore.triangle_counts(tg).cpu().numpy(),
        np.asarray(jalg.triangle_counts(jg, backend="jnp")))
    rank, s = tcore.pagerank(tg, tol=None, max_steps=30, with_steps=True)
    np.testing.assert_allclose(
        rank.cpu().numpy(),
        np.asarray(jalg.pagerank(jg, tol=None, max_steps=30, backend="jnp")),
        atol=2e-6)
    core, lab2, rank2 = tcore.fused_analytics(tg, steps=30)
    assert torch.equal(lab2, lab) and torch.equal(rank2, rank)
    np.testing.assert_array_equal(
        core.cpu().numpy(), np.asarray(jcore.coreness(jg, backend="jnp")))
