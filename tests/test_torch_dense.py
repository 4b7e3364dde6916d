"""PyTorch port vs the JAX package: the "dense" backend.

The dense backend keeps an (N, N) bfloat16 0/1 adjacency and runs the
h-index and the frontier hop through `kernels/kcore_hindex.py` and
`kernels/frontier.py`.  On the CPU these run their plain PyTorch
versions, held here against the JAX package's dense Pallas kernels in
interpret mode (`repro.kernels.ops.hindex` / `frontier_step` /
`coreness_dense`) and its oracles (`ref.hindex_counts_ref`, ...), and the
dense main path and framework path against the JAX package's
``backend="dense"``: coreness with equal superstep counts, `maintain_batch`
and `run_stream` (with CC labels), and the workloads.  Integers and
booleans must be EQUAL; PageRank `allclose(atol=2e-6)`, the JAX tests'
own bar across backends.  The h-index is compared where
K >= max(est) + 1, where both packages are exact: the JAX package caps h
at K padded to a multiple of 128, the port at K.  Graphs stay at
N <= 512.  The `cuda` tests hold the two CUDA kernels against their plain
versions and check that the dense backend launches them.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_port import (  # noqa: F401 (fixtures)
    assert_same_graph, needs_cuda, np_of, one_torch_thread, reference,
    require_cuda, tensor_of, to_port)

import repro.core as jcore
import repro.core.algorithms as jalg
import repro.core.kcore_dynamic as jkd
import repro.core.partition as jpart
import repro.core.updates as jupd
import repro.graphgen as jgen
from repro.kernels import ops as jops
from repro.kernels import ref as jref

import repro_torch.core as tcore
import repro_torch.core.kcore_dynamic as tkd
from repro_torch.core import algorithms as talg
from repro_torch.kernels import kcore_hindex, ops, ref
from repro_torch.kernels.frontier import frontier_step, frontier_step_plain
from repro_torch.kernels.kcore_hindex import (
    hindex_counts, hindex_counts_plain)
from repro_torch.runtime import stream as tstream

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _adj(N, p, seed):
    """A symmetric 0/1 float32 adjacency with empty and near-full rows."""
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((N, N)) < p, 1)
    a[: N // 10] = False  # some isolated nodes
    a[N - 3:, :] = rng.random((3, N)) < 0.9  # a few dense rows
    a = np.triu(a, 1)
    return (a | a.T).astype(np.float32)


# (N, density, est kind): N off and on multiples of 8 and of the 256 tile
DENSE_CASES = [(40, 0.2, "degrees"), (97, 0.1, "random"),
               (256, 0.05, "random"), (300, 0.3, "degrees")]


def _est_of(adj, kind, seed):
    if kind == "degrees":
        return adj.sum(axis=1).astype(np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(-2, 60, size=adj.shape[0]).astype(np.int32)


@pytest.mark.parametrize("N,p,kind", DENSE_CASES)
def test_hindex_counts_plain_equals_reference(N, p, kind):
    adj = _adj(N, p, N)
    est = _est_of(adj, kind, N)
    K = int(est.max()) + 1
    t_adj = torch.as_tensor(adj).to(torch.bfloat16)
    got = hindex_counts(t_adj, torch.as_tensor(est), K)
    assert got.dtype == torch.int32 and got.shape == (N,)
    want = np.asarray(jops.hindex(jnp.asarray(adj), jnp.asarray(est), K=K,
                                  interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.hindex_counts_ref(jnp.asarray(adj), jnp.asarray(est), K)))
    # the raw wrapper (any dtype, K defaulting to N) and a larger K agree
    np.testing.assert_array_equal(
        ops.hindex(torch.as_tensor(adj), torch.as_tensor(est)).numpy(), want)
    assert torch.equal(hindex_counts_plain(t_adj, torch.as_tensor(est),
                                           K + 37), got)


def test_hindex_counts_caps_at_K():
    """Below max(est) + 1 the port caps h at K itself."""
    adj = _adj(120, 0.4, 5)
    est = _est_of(adj, "degrees", 5)
    t_adj, t_est = torch.as_tensor(adj).to(torch.bfloat16), torch.as_tensor(est)
    full = ops.hindex(t_adj, t_est)
    for K in (1, 7, 20):
        assert torch.equal(hindex_counts(t_adj, t_est, K),
                           full.clamp(max=K))


def _masks(N, R, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((N, R)) < 0.2, rng.random(N) < 0.7,
            rng.random((N, R)) < 0.2)


@pytest.mark.parametrize("R", [1, 8, 13])
@pytest.mark.parametrize("N,p,kind", DENSE_CASES[:3])
def test_frontier_step_plain_equals_reference(N, p, kind, R):
    adj = _adj(N, p, N + R)
    f, elig, vis = _masks(N, R, R)
    got = ops.frontier_step(*(torch.as_tensor(a)
                              for a in (adj, f, elig, vis)))
    assert got.dtype == torch.bool and got.shape == (N, R)
    want = np.asarray(jops.frontier_step(
        jnp.asarray(adj), jnp.asarray(f), jnp.asarray(elig),
        jnp.asarray(vis), interpret=True)) > 0
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.frontier_step_ref(jnp.asarray(adj), jnp.asarray(f),
                               jnp.asarray(elig), jnp.asarray(vis))))


def _setup(seed=4, n=120, P=4):
    edges = jgen.nearest_neighbor_graph(n, u=0.8, seed=seed)
    nn = int(edges.max()) + 1
    assign = jpart.node_bfs_partition(edges, nn, P, seed=1)
    jg = jcore.build_blocks(edges, nn, assign, P=P, deg_slack=12)
    return jg, jcore.coreness(jg, backend="jnp")


@pytest.mark.parametrize("shared", [True, False])
def test_frontier_blocks_dense_equals_reference(shared):
    """Per-column eligibility is folded into `visited`; a shared (N,) one
    goes in as it is, on every backend."""
    jg, _ = _setup(seed=5)
    tg = to_port(jg)
    R = 8
    f, elig, vis = _masks(jg.N, R, 11)
    if not shared:
        elig = np.random.default_rng(12).random((jg.N, R)) < 0.7
    want = np.asarray(jops.frontier_blocks(
        jg, jnp.asarray(f), jnp.asarray(elig), jnp.asarray(vis),
        backend="dense", interpret=True))
    args = [torch.as_tensor(a) for a in (f, elig, vis)]
    adj = ops.dense_adj(tg, "dense")
    for backend, kw in (("dense", {}), ("dense", {"adj": adj}),
                        ("torch", {}), ("ell", {})):
        got = ops.frontier_blocks(tg, *args, backend=backend, **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)


def test_ell_to_dense_equals_reference():
    jg, _ = _setup(seed=6)
    nbr = np.asarray(jg.nbr).copy()
    nbr[3, 1] = nbr[3, 0]  # a duplicate id still gives 1
    got = ref.ell_to_dense(torch.as_tensor(nbr), jg.N)
    assert got.dtype == torch.bfloat16 and got.shape == (jg.N, jg.N)
    np.testing.assert_array_equal(
        got.to(torch.float32).numpy(),
        np.asarray(jref.ell_to_dense(jnp.asarray(nbr), jg.N)))
    assert ref.ell_to_dense(torch.as_tensor(nbr), dtype=torch.float32).dtype \
        == torch.float32
    tg = to_port(jg)
    assert ops.dense_adj(tg, "torch") is None and \
        ops.dense_adj(tg, "ell") is None
    assert torch.equal(ops.dense_adj(tg, "dense"),
                       ref.ell_to_dense(tg.nbr, tg.N))
    assert ops.dense_bytes(50_048) == 50_048 ** 2 * 2  # 5.01 GB at DS1


@pytest.mark.parametrize("N,p,kind", DENSE_CASES)
def test_coreness_dense_equals_reference(N, p, kind):
    adj = _adj(N, p, N + 1)
    got, steps = ops.coreness_dense(torch.as_tensor(adj), with_steps=True)
    want, want_steps = jops.coreness_dense(jnp.asarray(adj), interpret=True,
                                           with_steps=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)
    np.testing.assert_array_equal(
        ref.coreness_dense_ref(torch.as_tensor(adj)).numpy(),
        np.asarray(jref.coreness_dense_ref(jnp.asarray(adj))))


def _graph(n, m, P, seed, slack=5):
    rng = np.random.default_rng(seed)
    uv = rng.integers(0, n, (m, 2))
    return jcore.build_blocks(uv, n, rng.integers(0, P, n), P=P,
                              deg_slack=slack)


GRAPHS = [(90, 60, 3, 1), (120, 300, 4, 2), (70, 140, 1, 3)]


@pytest.mark.parametrize("n,m,P,seed", GRAPHS)
def test_coreness_blocks_dense_equals_reference(n, m, P, seed):
    jg = _graph(n, m, P, seed)
    tg = to_port(jg)
    got, steps = ops.coreness_blocks(tg, backend="dense", with_steps=True)
    want, want_steps = jops.coreness_blocks(jg, backend="dense",
                                            interpret=True, with_steps=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)
    c, s = tcore.coreness_with_stats(tg, backend="dense")
    assert torch.equal(c, got) and s == steps
    # the "count" variant reaches the same fixpoint in the same supersteps
    for variant in ("sort", "count"):
        c, s = ops.coreness_blocks(tg, backend="ell", with_steps=True,
                                   variant=variant)
        assert torch.equal(c, got) and s == steps
    with pytest.raises(ValueError, match="unknown variant"):
        ops.coreness_blocks(tg, variant="nonsense")


def _mixed_updates(jg, q, seed=2):
    return (jupd.sample_insertions(jg, q, "inter", seed=seed)
            + jupd.sample_insertions(jg, q, "intra", seed=seed + 1)
            + jupd.sample_deletions(jg, q, "inter", seed=seed + 2)
            + jupd.sample_deletions(jg, q, "intra", seed=seed + 3))


@pytest.mark.parametrize("R", [1, 8])
def test_maintain_batch_dense_equals_reference(R):
    jg, core = _setup(seed=4)
    ups = _mixed_updates(jg, 3)
    tg2, tcore2, tstats = tkd.maintain_batch(
        to_port(jg), tensor_of(core), ups, R=R, backend="dense")
    jg2, jcore2, jstats = jkd.maintain_batch(jg, core, ups, R=R,
                                             backend="dense")
    assert_same_graph(tg2, jg2)
    np.testing.assert_array_equal(tcore2.numpy(), np.asarray(jcore2))
    assert tstats._asdict() == jstats._asdict()
    np.testing.assert_array_equal(
        tcore2.numpy(), tcore.coreness(tg2, backend="torch").numpy())


def test_run_stream_dense_cc_labels_equal_reference():
    edges = jgen.barabasi_albert(120, 3, seed=31)
    n = int(edges.max()) + 1
    rng = np.random.default_rng(32)
    jg = jcore.build_blocks(edges, n, rng.integers(0, 4, n), P=4,
                            deg_slack=24)
    ups = (jupd.sample_insertions(jg, 6, "inter", seed=33)
           + jupd.sample_deletions(jg, 3, "intra", seed=34)
           + jupd.sample_insertions(jg, 5, "intra", seed=35))
    core = jcore.coreness(jg, backend="jnp")
    labels0 = jalg.connected_components(jg, backend="jnp")
    tg = to_port(jg)  # before the reference donates jg
    res = tstream.run_stream(tg, tensor_of(core), list(ups), R=4,
                             backend="dense", cc_labels=tensor_of(labels0))
    want = reference().run_stream(jg, core, list(ups), R=4, backend="dense",
                                  cc_labels=labels0)
    assert_same_graph(res.g, want.g)
    np.testing.assert_array_equal(res.core.numpy(), np.asarray(want.core))
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(want.labels))
    assert res.stats._asdict() == {f: getattr(want.stats, f)
                                   for f in tstream.StreamStats._fields}
    assert res.stats.cc_merges > 0 and res.stats.cc_recomputes > 0
    assert torch.equal(res.labels, tcore.connected_components(res.g))


@pytest.mark.parametrize("n,m,P,seed", GRAPHS)
def test_block_programs_dense_equal_reference(n, m, P, seed):
    jg = _graph(n, m, P, seed)
    tg = to_port(jg)
    lab, s = tcore.connected_components(tg, backend="dense", with_steps=True)
    jlab, js = jalg.connected_components(jg, backend="dense",
                                         with_steps=True)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    assert s == int(js)
    tri, s = tcore.triangle_counts(tg, backend="dense", with_steps=True)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(
        jalg.triangle_counts(jg, backend="dense")))
    assert s == 1
    for tol, steps in ((None, 30), (1e-6, 100)):
        rank, s = tcore.pagerank(tg, tol=tol, max_steps=steps,
                                 backend="dense", with_steps=True)
        jrank, js = jalg.pagerank(jg, tol=tol, max_steps=steps,
                                  backend="dense", with_steps=True)
        np.testing.assert_allclose(rank.numpy(), np.asarray(jrank), atol=2e-6)
        assert s == int(js)
    core, s = ops.run_block_program(tg, talg.CorenessBlockProgram(),
                                    backend="dense", with_steps=True)
    assert torch.equal(core, tcore.coreness(tg, backend="torch"))
    fused = tcore.fused_analytics(tg, steps=20, backend="dense")
    jfused = jalg.fused_analytics(jg, steps=20, backend="dense")
    for got, want in zip(fused[:2], jfused[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(fused[2].numpy(), np.asarray(jfused[2]),
                               atol=2e-6)


def test_combine_dense_equals_reference():
    jg = _graph(120, 300, 4, 2)
    tg = to_port(jg)
    rng = np.random.default_rng(9)
    fields = {"min": rng.integers(-5, jg.N, jg.N).astype(np.int32),
              "sum": rng.random(jg.N).astype(np.float32),
              "hindex": rng.integers(-2, 30, jg.N).astype(np.int32),
              "count_common": np.array(jg.nbr)}
    jadj = jref.ell_to_dense(jg.nbr, jg.N)
    adj = ops.dense_adj(tg, "dense")
    for combine, field in fields.items():
        got = ops.neighbor_combine_blocks(tg, torch.as_tensor(field), combine,
                                          backend="dense", adj=adj)
        want = np.asarray(jops._combine_dense(jadj, jnp.asarray(field),
                                              combine, jg.Cd))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        plain = ops.neighbor_combine_blocks(tg, torch.as_tensor(field),
                                            combine, backend="torch")
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown combine"):
        ops.neighbor_combine_blocks(tg, torch.as_tensor(fields["min"]), "max",
                                    backend="dense")


def test_dense_plain_chunks_equal_one_pass(monkeypatch):
    adj = torch.as_tensor(_adj(97, 0.2, 3)).to(torch.bfloat16)
    est = torch.as_tensor(_est_of(adj.float().numpy(), "degrees", 3))
    f, elig, vis = (torch.as_tensor(a) for a in _masks(97, 8, 3))
    want_h = hindex_counts_plain(adj, est, 64)
    want_f = frontier_step_plain(adj, f, elig, vis)
    monkeypatch.setattr(kcore_hindex, "DENSE_CHUNK", 97 * 10)  # 10 rows
    assert torch.equal(hindex_counts_plain(adj, est, 64), want_h)
    assert torch.equal(frontier_step_plain(adj, f, elig, vis), want_f)


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (GPU only).
# ---------------------------------------------------------------------------


@needs_cuda
@pytest.mark.parametrize("K", [1, 16, 64, None])
@pytest.mark.parametrize("N,p,kind", DENSE_CASES)
def test_hindex_counts_kernel_equals_plain(N, p, kind, K):
    adj = torch.as_tensor(_adj(N, p, N)).to(torch.bfloat16).cuda()
    est = torch.as_tensor(_est_of(adj.float().cpu().numpy(), kind, N)).cuda()
    K = N if K is None else K
    before = hindex_counts.launches
    got = hindex_counts(adj, est, K)
    torch.cuda.synchronize()
    assert hindex_counts.launches == before + 1
    assert torch.equal(got, hindex_counts_plain(adj, est, K))


@needs_cuda
def test_hindex_counts_kernel_deep_rows():
    """K above the kernel's 4096 bins, rows whose h-index passes 4096: the
    kernel's binary-search path."""
    N = 4500
    rng = np.random.default_rng(0)
    a = rng.random((N, N)) < 0.97
    a[:50] = rng.random((50, N)) < 0.01  # and some sparse rows
    adj = torch.as_tensor(a).to(torch.bfloat16).cuda()
    est = rng.integers(4300, 6000, N).astype(np.int32)
    est[rng.random(N) < 0.02] = 3  # a few low estimates
    est = torch.as_tensor(est).cuda()
    got = hindex_counts(adj, est, N)
    assert int(got.max()) > 4096
    assert torch.equal(got, hindex_counts_plain(adj, est, N))


@needs_cuda
@pytest.mark.parametrize("R", [1, 8, 13, 40])
@pytest.mark.parametrize("N,p,kind", DENSE_CASES)
def test_frontier_kernel_equals_plain(N, p, kind, R):
    adj = torch.as_tensor(_adj(N, p, N + R)).to(torch.bfloat16).cuda()
    f, elig, vis = (torch.as_tensor(a).cuda() for a in _masks(N, R, R))
    before = frontier_step.launches
    got = frontier_step(adj, f, elig, vis)
    torch.cuda.synchronize()
    assert frontier_step.launches == before + 1
    assert torch.equal(got, frontier_step_plain(adj, f, elig, vis))


@needs_cuda
def test_dense_backend_on_gpu_launches_the_kernels():
    jg, core = _setup(seed=4)
    ups = _mixed_updates(jg, 3)
    c0 = tensor_of(core)
    g_cpu, core_cpu, st_cpu = tkd.maintain_batch(to_port(jg), c0, ups,
                                                 backend="torch")
    before = (hindex_counts.launches, frontier_step.launches)
    gg = to_port(jg, device="cuda")
    static = tcore.coreness(gg, backend="dense")
    g_gpu, core_gpu, st_gpu = tkd.maintain_batch(gg, c0.cuda(), ups,
                                                 backend="dense")
    torch.cuda.synchronize()
    assert hindex_counts.launches > before[0]
    assert frontier_step.launches > before[1]
    np.testing.assert_array_equal(np_of(static), np.asarray(core))
    assert st_gpu == st_cpu
    np.testing.assert_array_equal(np_of(core_gpu), np_of(core_cpu))
    np.testing.assert_array_equal(np_of(g_gpu.nbr), np_of(g_cpu.nbr))


@needs_cuda
def test_dense_products_refuse_tf32():
    adj = torch.as_tensor(_adj(40, 0.2, 1)).to(torch.bfloat16).cuda()
    f = torch.zeros((40, 2), dtype=torch.bool, device="cuda")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            frontier_step_plain(adj, f, f[:, 0], f)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
