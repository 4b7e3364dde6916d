"""PyTorch port vs the JAX package: the ELL kernels and their variants.

On the CPU the port's wrappers (`hindex_ell` with variants "sort" and
"count", `frontier_step_ell`, `neighbor_min_ell`, `neighbor_sum_ell`,
`neighbor_multi_ell`, `neighbor_common_ell` with variants "merge" and
"allpairs") run their plain PyTorch versions; these are held
against the JAX package's Pallas kernels in interpret mode
(`repro.kernels.ops.*` with ``interpret=True``) and its jnp oracles
(`ref.ell_*`).  Integer and boolean outputs must match EXACTLY; float32
sums to ``rtol=1e-6`` (the two sum in different orders).

Cases: K = Cd on rows whose valid slots are shuffled (PAD anywhere);
K < Cd on sorted, left-filled rows; Cd in {1, 37, 130}; R in {1, 8, 13};
empty and full rows.  The CUDA kernels themselves are held against the
plain versions, on the same cases, by the tests marked `cuda` (they skip
without a GPU).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_port import needs_cuda, require_cuda  # noqa: F401 (fixture)

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ell_cc import (
    MIN_FILL, neighbor_min_ell, neighbor_min_ell_plain)
from repro_torch.kernels.ell_frontier import (
    frontier_step_ell, frontier_step_ell_plain)
from repro_torch.kernels.ell_hindex import (
    hindex_count_ell, hindex_count_ell_plain, hindex_ell, hindex_ell_plain)
from repro_torch.kernels.ell_multi import (
    neighbor_multi_ell, neighbor_multi_ell_plain)
from repro_torch.kernels.ell_pagerank import (
    neighbor_sum_ell, neighbor_sum_ell_plain)
from repro_torch.kernels.ell_triangles import (
    common_allpairs_ell, common_allpairs_ell_plain, common_sorted_ell,
    neighbor_common_ell, neighbor_common_ell_plain)


def _rows(N, Cd, seed, shuffled, max_deg=None, empty=0.15, full=0.15):
    """(N, Cd) int32 neighbor rows: some empty, some full, the rest ragged.

    shuffled=True scatters the valid slots among the PADs; otherwise rows
    are sorted and left-filled (the sorted-ELL invariant).  max_deg caps
    the valid slots per row (for K < Cd)."""
    rng = np.random.default_rng(seed)
    cap = Cd if max_deg is None else max_deg
    deg = rng.integers(0, cap + 1, size=N)
    r = rng.random(N)
    deg[r < empty] = 0
    deg[r > 1 - full] = cap
    nbr = np.full((N, Cd), -1, np.int32)
    for i in range(N):
        ids = np.sort(rng.choice(N, size=deg[i], replace=False))
        if shuffled:
            nbr[i, rng.choice(Cd, size=deg[i], replace=False)] = ids
        else:
            nbr[i, :deg[i]] = ids
    return nbr


def _est(N, seed):
    """Estimates with negatives, zeros and values above Cd."""
    return np.random.default_rng(seed + 100).integers(-2, 40, size=N,
                                                     dtype=np.int32)


HINDEX_CASES = [
    # (N, Cd, K, shuffled, max_deg)
    (64, 12, None, True, None),     # K = Cd, PAD anywhere
    (100, 24, None, True, None),
    (80, 40, 16, False, 16),        # K < Cd, left-filled rows
    (50, 33, 8, False, 7),
    (40, 1, None, True, None),      # a single column
]


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", HINDEX_CASES)
def test_hindex_plain_equals_reference(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    est = _est(N, Cd)
    got = hindex_ell(torch.as_tensor(nbr), torch.as_tensor(est), K=K)
    assert got.dtype == torch.int32 and got.shape == (N,)
    want = np.asarray(jops.hindex_ell(jnp.asarray(nbr), jnp.asarray(est),
                                      interpret=True, K=K))
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = np.asarray(jref.ell_hindex_ref(jnp.asarray(nbr),
                                            jnp.asarray(est)))
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(
        ref.ell_hindex_ref(torch.as_tensor(nbr), torch.as_tensor(est)).numpy(),
        oracle)


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", HINDEX_CASES)
def test_hindex_count_variant_equals_reference(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    est = _est(N, Cd)
    tn, te = torch.as_tensor(nbr), torch.as_tensor(est)
    got = hindex_ell(tn, te, K=K, variant="count")
    assert got.dtype == torch.int32 and got.shape == (N,)
    want = np.asarray(jops.hindex_ell(jnp.asarray(nbr), jnp.asarray(est),
                                      interpret=True, K=K, variant="count"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, hindex_ell(tn, te, K=K))  # == "sort"


def test_hindex_count_plain_chunks_and_rejects(monkeypatch):
    import repro_torch.kernels.ell_hindex as eh
    nbr = torch.as_tensor(_rows(70, 24, 3, True))
    est = torch.as_tensor(_est(70, 3))
    want = hindex_count_ell_plain(nbr, est)
    monkeypatch.setattr(eh, "_COUNT_CHUNK", 24 * 24 * 4)  # 4 rows a chunk
    assert torch.equal(hindex_count_ell_plain(nbr, est), want)
    assert torch.equal(want, hindex_ell_plain(nbr, est))
    with pytest.raises(ValueError, match="unknown variant"):
        hindex_ell(nbr, est, variant="nonsense")


def test_hindex_empty_and_full_rows():
    N, Cd = 16, 8
    nbr = np.full((N, Cd), -1, np.int32)
    nbr[8:] = np.arange(Cd, dtype=np.int32)[None, :] + 1  # full rows
    est = np.full(N, 5, np.int32)
    got = hindex_ell(torch.as_tensor(nbr), torch.as_tensor(est)).numpy()
    np.testing.assert_array_equal(got[:8], 0)  # no neighbor -> 0
    np.testing.assert_array_equal(got[8:], 5)  # 8 neighbors all at 5 -> 5
    np.testing.assert_array_equal(
        got, np.asarray(jops.hindex_ell(jnp.asarray(nbr), jnp.asarray(est),
                                        interpret=True)))


FRONTIER_CASES = [
    # (N, Cd, R, K, shuffled, max_deg)
    (60, 10, 1, None, True, None),
    (90, 16, 8, None, True, None),
    (70, 12, 13, None, True, None),
    (64, 30, 8, 12, False, 12),     # K < Cd, left-filled rows
]


def _masks(N, R, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((N, R)) < 0.2, rng.random((N, R)) < 0.7,
            rng.random((N, R)) < 0.2)


@pytest.mark.parametrize("N,Cd,R,K,shuffled,max_deg", FRONTIER_CASES)
def test_frontier_plain_equals_reference(N, Cd, R, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + R, shuffled, max_deg)
    f, elig, vis = _masks(N, R, R)
    got = frontier_step_ell(*(torch.as_tensor(a)
                              for a in (nbr, f, elig, vis)), K=K)
    assert got.dtype == torch.bool and got.shape == (N, R)
    want = np.asarray(jops.frontier_step_ell(
        jnp.asarray(nbr), jnp.asarray(f), jnp.asarray(elig),
        jnp.asarray(vis), interpret=True, K=K)) > 0
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = np.asarray(jref.ell_frontier_hop_ref(
        jnp.asarray(nbr), jnp.asarray(f), jnp.asarray(elig), jnp.asarray(vis)))
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(
        ref.ell_frontier_hop_ref(*(torch.as_tensor(a)
                                   for a in (nbr, f, elig, vis))).numpy(),
        oracle)


def test_registry_resolution():
    cpu = torch.device("cpu")
    assert ops.resolve_backend("auto", cpu) == "torch"
    assert ops.resolve_backend(None, torch.device("cuda")) == "ell"
    assert ops.resolve_backend("ell", cpu) == "ell"
    assert ops.resolve_backend("dense", cpu) == "dense"  # never by "auto"
    assert ops.BACKENDS == ("torch", "ell", "dense")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.resolve_backend("ell_spmd", cpu)
    with pytest.raises(ValueError):
        ops.resolve_backend("jnp", cpu)
    assert [ops._pow2_bucket(x) for x in (1, 32, 33, 85, 300)] == \
        [32, 32, 64, 128, 512]


def test_wrappers_reject_other_devices():
    nbr = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        hindex_ell(nbr, torch.zeros(4, dtype=torch.int32, device="meta"))
    m = torch.zeros((4, 1), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        frontier_step_ell(nbr, m, m, m)
    i = torch.zeros(4, dtype=torch.int32, device="meta")
    f = torch.zeros(4, dtype=torch.float32, device="meta")
    for call in (lambda: neighbor_min_ell(nbr, i),
                 lambda: neighbor_sum_ell(nbr, f),
                 lambda: neighbor_multi_ell(nbr, (i,), ("min",)),
                 lambda: neighbor_common_ell(nbr, nbr),
                 lambda: hindex_ell(nbr, i, variant="count"),
                 lambda: neighbor_common_ell(nbr, nbr, variant="allpairs")):
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# The neighbor combines of the BlockProgram workloads.
# ---------------------------------------------------------------------------

COMBINE_CASES = [
    # (N, Cd, K, shuffled, max_deg)
    (120, 37, None, True, None),    # K = Cd, PAD anywhere
    (160, 130, None, True, None),
    (140, 130, 64, False, 60),      # K < Cd, left-filled rows
    (64, 37, 16, False, 16),
    (40, 1, None, True, None),      # a single column
]


def _fields(N, seed):
    """An int32 field (negatives, large values) and a float32 field."""
    rng = np.random.default_rng(seed + 200)
    return (rng.integers(-5, N + 5, size=N).astype(np.int32),
            rng.random(N).astype(np.float32))


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMBINE_CASES)
def test_min_sum_plain_equal_reference(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    fi, ff = _fields(N, Cd)
    tn, jn = torch.as_tensor(nbr), jnp.asarray(nbr)
    got_min = neighbor_min_ell(tn, torch.as_tensor(fi), K=K)
    got_sum = neighbor_sum_ell(tn, torch.as_tensor(ff), K=K)
    assert got_min.dtype == torch.int32 and got_sum.dtype == torch.float32
    np.testing.assert_array_equal(
        got_min.numpy(), np.asarray(jops.neighbor_min_ell(
            jn, jnp.asarray(fi), interpret=True, K=K)))
    np.testing.assert_array_equal(
        got_min.numpy(), np.asarray(jref.ell_min_ref(jn, jnp.asarray(fi))))
    np.testing.assert_allclose(
        got_sum.numpy(), np.asarray(jops.neighbor_sum_ell(
            jn, jnp.asarray(ff), interpret=True, K=K)), rtol=1e-6)
    np.testing.assert_allclose(
        got_sum.numpy(), np.asarray(jref.ell_sum_ref(jn, jnp.asarray(ff))),
        rtol=1e-6)
    empty = (nbr < 0).all(axis=1)
    assert (got_min.numpy()[empty] == MIN_FILL).all()
    assert (got_sum.numpy()[empty] == 0).all()


MULTI_COMBINES = [("hindex", "min", "sum"), ("min",), ("sum",), ("hindex",),
                  ("sum", "hindex")]


@pytest.mark.parametrize("combines", MULTI_COMBINES)
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMBINE_CASES[:3])
def test_multi_plain_equals_reference_and_standalone(
        N, Cd, K, shuffled, max_deg, combines):
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    fi, ff = _fields(N, Cd)
    est = _est(N, Cd)
    host = {"min": fi, "sum": ff, "hindex": est}
    fields = [host[c] for c in combines]
    tn = torch.as_tensor(nbr)
    got = neighbor_multi_ell(tn, [torch.as_tensor(f) for f in fields],
                             combines, K=K)
    want = jops.neighbor_multi_ell(
        jnp.asarray(nbr), tuple(jnp.asarray(f) for f in fields), combines,
        interpret=True, K=K)
    alone = {"min": neighbor_min_ell_plain, "sum": neighbor_sum_ell_plain,
             "hindex": hindex_ell_plain}
    for c, f, g_, w in zip(combines, fields, got, want):
        if c == "sum":
            np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
        assert torch.equal(g_, alone[c](tn, torch.as_tensor(f), K))


def test_multi_rejects_bad_combines():
    nbr = torch.zeros((4, 2), dtype=torch.int32)
    f = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="not fusable"):
        neighbor_multi_ell(nbr, (f,), ("count_common",))
    with pytest.raises(ValueError, match="1 to 3"):
        neighbor_multi_ell(nbr, (f,) * 4, ("min",) * 4)


def _dup_rows(N, Cd, seed):
    """A row field with duplicate ids and stray negatives (legal in a raw
    field, not in a validated graph)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2, N // 4, size=(N, Cd)).astype(np.int32)
    rows[rng.random((N, Cd)) < 0.3] = -1
    return rows


COMMON_CASES = COMBINE_CASES + [(48, 12, None, "dup", None)]


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMMON_CASES)
def test_common_plain_equals_reference(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled == True, max_deg)  # noqa: E712
    rows = _dup_rows(N, Cd, N) if shuffled == "dup" else nbr
    got = neighbor_common_ell(torch.as_tensor(nbr), torch.as_tensor(rows), K=K)
    assert got.dtype == torch.int32
    want = np.asarray(jops.neighbor_common_ell(
        jnp.asarray(nbr), jnp.asarray(rows), interpret=True, K=K))
    np.testing.assert_array_equal(got.numpy(), want)
    if Cd <= 40:  # the oracles below hold an (N, Cd, Cd, Cd) match tensor
        C = Cd if K is None else min(Cd, K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jref.ell_common_ref(jnp.asarray(nbr[:, :C]),
                                jnp.asarray(rows[:, :C]))))
        tn, tr = torch.as_tensor(nbr[:, :C]), torch.as_tensor(rows[:, :C])
        nb_rows = torch.where((tn >= 0)[:, :, None],
                              tr[tn.clamp(min=0).long()], -1)
        np.testing.assert_array_equal(
            ref.combine_rows("count_common", tr, nb_rows).numpy(), want)


def test_common_ref_chunks_equal_one_pass(monkeypatch):
    nbr = _rows(70, 37, 5, True)
    want = ref.ell_common_ref(torch.as_tensor(nbr), torch.as_tensor(nbr))
    monkeypatch.setattr(ref, "_COMMON_CHUNK", 37 * 37 * 3)  # 3 rows a chunk
    got = ref.ell_common_ref(torch.as_tensor(nbr), torch.as_tensor(nbr))
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg",
                         [c for c in COMMON_CASES if c[1] <= 40])
def test_common_variants(N, Cd, K, shuffled, max_deg):
    """"allpairs" equals the reference's "allpairs", "merge" and the
    oracle, on sorted and shuffled rows and with duplicate ids."""
    nbr = _rows(N, Cd, N + Cd, shuffled == True, max_deg)  # noqa: E712
    rows = _dup_rows(N, Cd, N) if shuffled == "dup" else nbr
    tn, tr = torch.as_tensor(nbr), torch.as_tensor(rows)
    got = neighbor_common_ell(tn, tr, K=K, variant="allpairs")
    assert got.dtype == torch.int32 and got.shape == (N,)
    want = np.asarray(jops.neighbor_common_ell(
        jnp.asarray(nbr), jnp.asarray(rows), interpret=True, K=K,
        variant="allpairs"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, neighbor_common_ell(tn, tr, K=K))  # == "merge"
    C = Cd if K is None else min(Cd, K)
    np.testing.assert_array_equal(got.numpy(), ref.ell_common_ref(
        tn[:, :C], tr[:, :C]).numpy())
    with pytest.raises(ValueError):
        neighbor_common_ell(tn, tr, variant="nonsense")


def test_allpairs_plain_chunks_equal_one_pass(monkeypatch):
    import repro_torch.kernels.ell_triangles as et
    nbr = torch.as_tensor(_rows(50, 12, 6, True))
    rows = torch.as_tensor(_dup_rows(50, 12, 6))
    want = common_allpairs_ell_plain(nbr, rows)
    monkeypatch.setattr(et, "_ALLPAIRS_CHUNK", 12 ** 3 * 3)  # 3 rows a chunk
    assert torch.equal(common_allpairs_ell_plain(nbr, rows), want)


def test_combine_registry_equals_reference():
    nbr = _rows(60, 37, 9, True)
    fi, ff = _fields(60, 9)

    class G:  # the registry duck-types on .nbr and .device
        pass
    g = G()
    g.nbr, g.device = torch.as_tensor(nbr), torch.device("cpu")
    for combine, field in (("min", fi), ("sum", ff), ("hindex", fi),
                           ("count_common", nbr)):
        got = ops.neighbor_combine_blocks(g, torch.as_tensor(field), combine)
        want = jops._combine_jnp(jnp.asarray(nbr), jnp.asarray(field),
                                 combine)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert torch.equal(got, ops.neighbor_combine_blocks(
            g, torch.as_tensor(field), combine, backend="ell"))
    with pytest.raises(ValueError, match="unknown combine"):
        ops.neighbor_combine_blocks(g, torch.as_tensor(fi), "max")


def test_library_names_follow_every_header(tmp_path, monkeypatch):
    """An edit to a shared header renames (so rebuilds) every library."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    before = {n: _build._library_path(n) for n in _build.SOURCES}
    assert before == {n: _build._library_path(n) for n in _build.SOURCES}
    header = src / "ell_reduce.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in _build.SOURCES}
    includers = [n for n in _build.SOURCES if '#include "ell_reduce.cuh"'
                 in (src / f"{n}.cu").read_text()]
    assert set(includers) >= {"ell_hindex", "ell_cc", "ell_pagerank",
                              "ell_multi", "ell_triangles",
                              "ell_hindex_count", "ell_allpairs",
                              "kcore_hindex"}
    for n in includers:
        assert after[n] != before[n], n


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (GPU only).
# ---------------------------------------------------------------------------


@needs_cuda
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", HINDEX_CASES)
def test_hindex_kernel_equals_plain(N, Cd, K, shuffled, max_deg):
    nbr = torch.as_tensor(_rows(N, Cd, N + Cd, shuffled, max_deg)).cuda()
    est = torch.as_tensor(_est(N, Cd)).cuda()
    before = hindex_ell.launches
    got = hindex_ell(nbr, est, K=K)
    torch.cuda.synchronize()
    assert hindex_ell.launches == before + 1
    torch.testing.assert_close(got, hindex_ell_plain(nbr, est, K), rtol=0,
                               atol=0)


@needs_cuda
@pytest.mark.parametrize("N,Cd,R,K,shuffled,max_deg", FRONTIER_CASES)
def test_frontier_kernel_equals_plain(N, Cd, R, K, shuffled, max_deg):
    nbr = torch.as_tensor(_rows(N, Cd, N + R, shuffled, max_deg)).cuda()
    f, elig, vis = (torch.as_tensor(a).cuda() for a in _masks(N, R, R))
    before = frontier_step_ell.launches
    got = frontier_step_ell(nbr, f, elig, vis, K=K)
    torch.cuda.synchronize()
    assert frontier_step_ell.launches == before + 1
    assert torch.equal(got, frontier_step_ell_plain(nbr, f, elig, vis, K))


@needs_cuda
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMBINE_CASES)
def test_min_sum_kernels_equal_plain(N, Cd, K, shuffled, max_deg):
    nbr = torch.as_tensor(_rows(N, Cd, N + Cd, shuffled, max_deg)).cuda()
    fi, ff = (torch.as_tensor(a).cuda() for a in _fields(N, Cd))
    before = (neighbor_min_ell.launches, neighbor_sum_ell.launches)
    got_min, got_sum = neighbor_min_ell(nbr, fi, K), neighbor_sum_ell(nbr, ff,
                                                                      K)
    torch.cuda.synchronize()
    assert (neighbor_min_ell.launches, neighbor_sum_ell.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got_min, neighbor_min_ell_plain(nbr, fi, K))
    torch.testing.assert_close(got_sum, neighbor_sum_ell_plain(nbr, ff, K),
                               rtol=1e-5, atol=1e-9)


@needs_cuda
@pytest.mark.parametrize("combines", MULTI_COMBINES)
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMBINE_CASES)
def test_multi_kernel_equals_standalone_kernels(N, Cd, K, shuffled, max_deg,
                                                combines):
    nbr = torch.as_tensor(_rows(N, Cd, N + Cd, shuffled, max_deg)).cuda()
    fi, ff = (torch.as_tensor(a).cuda() for a in _fields(N, Cd))
    host = {"min": fi, "sum": ff,
            "hindex": torch.as_tensor(_est(N, Cd)).cuda()}
    fields = [host[c] for c in combines]
    before = neighbor_multi_ell.launches
    got = neighbor_multi_ell(nbr, fields, combines, K)
    torch.cuda.synchronize()
    assert neighbor_multi_ell.launches == before + 1
    alone = {"min": neighbor_min_ell, "sum": neighbor_sum_ell,
             "hindex": hindex_ell}
    plain = neighbor_multi_ell_plain(nbr, fields, combines, K)
    for c, f, g_, p in zip(combines, fields, got, plain):
        assert torch.equal(g_, alone[c](nbr, f, K)), c  # bit-equal, sum too
        torch.testing.assert_close(g_, p, rtol=1e-5 if c == "sum" else 0,
                                   atol=1e-9 if c == "sum" else 0)


@needs_cuda
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMMON_CASES)
def test_common_kernel_equals_plain(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled == True, max_deg)  # noqa: E712
    rows = _dup_rows(N, Cd, N) if shuffled == "dup" else nbr
    nbr, rows = torch.as_tensor(nbr).cuda(), torch.as_tensor(rows).cuda()
    before = neighbor_common_ell.launches
    got = neighbor_common_ell(nbr, rows, K)
    torch.cuda.synchronize()
    assert neighbor_common_ell.launches == before + 1
    assert torch.equal(got, neighbor_common_ell_plain(nbr, rows, K))
    C = rows.shape[1] if K is None else min(K, rows.shape[1])
    alone = common_sorted_ell(nbr, ref.key_sort_rows(rows[:, :C]))
    assert neighbor_common_ell.launches == before + 2
    assert torch.equal(alone, got)


@needs_cuda
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", HINDEX_CASES)
def test_hindex_count_kernel_equals_plain_and_sort(N, Cd, K, shuffled,
                                                   max_deg):
    nbr = torch.as_tensor(_rows(N, Cd, N + Cd, shuffled, max_deg)).cuda()
    est = torch.as_tensor(_est(N, Cd)).cuda()
    before = (hindex_count_ell.launches, hindex_ell.launches)
    got = hindex_ell(nbr, est, K=K, variant="count")
    torch.cuda.synchronize()
    assert (hindex_count_ell.launches, hindex_ell.launches) == \
        (before[0] + 1, before[1])  # its own kernel and count
    assert torch.equal(got, hindex_count_ell_plain(nbr, est, K))
    assert torch.equal(got, hindex_ell(nbr, est, K=K))


@needs_cuda
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMMON_CASES)
def test_allpairs_kernel_equals_plain_and_merge(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled == True, max_deg)  # noqa: E712
    rows = _dup_rows(N, Cd, N) if shuffled == "dup" else nbr
    nbr, rows = torch.as_tensor(nbr).cuda(), torch.as_tensor(rows).cuda()
    before = (common_allpairs_ell.launches, neighbor_common_ell.launches)
    got = neighbor_common_ell(nbr, rows, K, variant="allpairs")
    torch.cuda.synchronize()
    assert (common_allpairs_ell.launches, neighbor_common_ell.launches) == \
        (before[0] + 1, before[1])  # its own kernel and count
    assert torch.equal(got, common_allpairs_ell_plain(nbr, rows, K))
    assert torch.equal(got, neighbor_common_ell(nbr, rows, K))
