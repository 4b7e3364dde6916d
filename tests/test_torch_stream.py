"""PyTorch port vs the JAX package: the whole main-path slice.

Build an NN graph (~400 nodes, P=4), compute static coreness, and stream
64 mixed updates (inter/intra inserts and deletes) through `run_stream`
with R=8, in both packages — the JAX one with ``backend="ell"`` (Pallas
in interpret mode).  The final `nbr`, `deg` and coreness, and every
`StreamStats` field the port keeps, are integers and must be EQUAL.

Also: the port's entry points raise without CUDA unless the caller asks
for the CPU, and no module of the port (nor chip_smoke.py) imports jax or
the JAX package.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (require_cuda is a fixture)
    CPU, assert_same_graph, needs_cuda, reference, require_cuda, tensor_of,
    to_port)

import repro.core as jcore
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen

import repro_torch.core as tcore
import repro_torch.core.updates as tupd
from repro_torch.runtime import stream as tstream

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
    want = {f: getattr(ref.stats, f) for f in tstream.StreamStats._fields}
    assert res.stats._asdict() == want
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
    assert res.stats._asdict() == {f: getattr(ref.stats, f)
                                   for f in tstream.StreamStats._fields}
