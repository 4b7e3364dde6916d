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
empty and full rows; `hindex_ell`, `frontier_step_ell`,
`neighbor_min_ell`, `neighbor_sum_ell`, `neighbor_multi_ell` and
`neighbor_common_ell` with the row lengths `deg` and without (the same
output), the registry handing `deg` to every ELL combine, and every ELL
wrapper on local-frame rows over a field longer than them (a mesh
worker's shard and halo buffer; for the triangles a row field of global
ids, unlike `nbr`'s), against the JAX package's post-halo reduce.  The
CUDA kernels themselves are held against the plain versions, on the same
cases, on rows longer than the kernels' register paths (Cd = 300) and
on the longer fields, by the tests marked `cuda` (they skip without a
GPU).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_port import (  # noqa: F401 (fixtures)
    needs_cuda, one_torch_thread, require_cuda)

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ell_cc import (
    MIN_FILL, neighbor_min_ell, neighbor_min_ell_plain)
from repro_torch.kernels.ell_frontier import (
    frontier_step_ell, frontier_step_ell_plain)
from repro_torch.kernels.ell_hindex import (
    columns, hindex_count_ell, hindex_count_ell_plain, hindex_ell,
    hindex_ell_plain)
from repro_torch.kernels.ell_multi import (
    neighbor_multi_ell, neighbor_multi_ell_plain)
from repro_torch.kernels.ell_pagerank import (
    neighbor_sum_ell, neighbor_sum_ell_plain)
from repro_torch.kernels.ell_triangles import (
    common_allpairs_ell, common_allpairs_ell_plain, field_deg,
    neighbor_common_ell, neighbor_common_ell_plain)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


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


def _row_lengths(nbr):
    """deg: each row's count of valid slots, as a GraphBlocks keeps it."""
    return (nbr >= 0).sum(axis=1).astype(np.int32)


def _holes(nbr, every=7):
    """`nbr` (left-filled) with, in every `every`-th row that holds 1 to
    Cd - 1 valid slots, its first slot moved to the last column: a PAD
    inside the row's `deg` prefix, so a kernel reads the row on past it."""
    out = nbr.copy()
    Cd = nbr.shape[1]
    deg = _row_lengths(nbr)
    for u in range(0, nbr.shape[0], every):
        if 0 < deg[u] < Cd:
            out[u, Cd - 1], out[u, 0] = out[u, 0], -1
    return out


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


#: left-filled rows with holes (`_holes`): a PAD inside the `deg` prefix
#: (K = Cd: a column bound below Cd is exact only on left-filled rows)
HOLES_CASES = [(64, 12, None, "holes", None), (80, 40, None, "holes", 16),
               (120, 37, None, "holes", None)]


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg",
                         HINDEX_CASES + HOLES_CASES)
def test_hindex_count_variant_equals_reference(N, Cd, K, shuffled, max_deg):
    """"count" equals the reference's "count" and "sort", with the row
    lengths `deg` and without, on rows sorted, shuffled and with holes (a
    PAD inside the `deg` prefix)."""
    nbr = _rows(N, Cd, N + Cd, shuffled is True, max_deg)
    deg = torch.as_tensor(_row_lengths(nbr))
    if shuffled == "holes":
        nbr = _holes(nbr)
    est = _est(N, Cd)
    tn, te = torch.as_tensor(nbr), torch.as_tensor(est)
    got = hindex_ell(tn, te, K=K, variant="count")
    assert got.dtype == torch.int32 and got.shape == (N,)
    want = np.asarray(jops.hindex_ell(jnp.asarray(nbr), jnp.asarray(est),
                                      interpret=True, K=K, variant="count"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, hindex_ell(tn, te, K=K))  # == "sort"
    with_deg = hindex_ell(tn, te, K=K, variant="count", deg=deg)
    assert torch.equal(with_deg, got)
    assert torch.equal(hindex_count_ell(tn, te, K, deg), got)
    assert torch.equal(hindex_count_ell_plain(tn, te, K, deg), got)


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


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", HINDEX_CASES)
def test_hindex_with_deg_equals_reference(N, Cd, K, shuffled, max_deg):
    """The row lengths change nothing: with deg, equal to the call without
    it and to the JAX package's kernel."""
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    tn, te = torch.as_tensor(nbr), torch.as_tensor(_est(N, Cd))
    deg = torch.as_tensor(_row_lengths(nbr))
    got = hindex_ell(tn, te, K=K, deg=deg)
    assert torch.equal(got, hindex_ell(tn, te, K=K))
    assert torch.equal(got, hindex_ell_plain(tn, te, K, deg))
    assert torch.equal(got, hindex_ell(tn, te, K=K, variant="count", deg=deg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.hindex_ell(
        jnp.asarray(nbr), jnp.asarray(te.numpy()), interpret=True, K=K)))


@pytest.mark.parametrize("N,Cd,R,K,shuffled,max_deg", FRONTIER_CASES)
def test_frontier_with_deg_equals_reference(N, Cd, R, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + R, shuffled, max_deg)
    f, elig, vis = _masks(N, R, R)
    args = [torch.as_tensor(a) for a in (nbr, f, elig, vis)]
    deg = torch.as_tensor(_row_lengths(nbr))
    got = frontier_step_ell(*args, K=K, deg=deg)
    assert torch.equal(got, frontier_step_ell(*args, K=K))
    assert torch.equal(got, frontier_step_ell_plain(*args, K, deg))
    want = np.asarray(jops.frontier_step_ell(
        jnp.asarray(nbr), jnp.asarray(f), jnp.asarray(elig),
        jnp.asarray(vis), interpret=True, K=K)) > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "strided"])
def test_wrappers_reject_bad_deg(bad):
    """A deg the kernels cannot take raises, on the CPU path too."""
    N = 6
    nbr = torch.as_tensor(_rows(N, 4, 1, False))
    est = torch.zeros(N, dtype=torch.int32)
    m = torch.zeros((N, 2), dtype=torch.bool)
    deg = {"shape": torch.zeros(N + 1, dtype=torch.int32),
           "dtype": torch.zeros(N, dtype=torch.int64),
           "device": torch.zeros(N, dtype=torch.int32, device="meta"),
           "strided": torch.zeros(2 * N, dtype=torch.int32)[::2]}[bad]
    for call in (lambda: hindex_ell(nbr, est, deg=deg),
                 lambda: hindex_ell(nbr, est, variant="count", deg=deg),
                 lambda: hindex_count_ell(nbr, est, deg=deg),
                 lambda: frontier_step_ell(nbr, m, m, m, deg=deg)):
        with pytest.raises(ValueError, match="deg"):
            call()


def test_registry_resolution():
    cpu = torch.device("cpu")
    assert ops.resolve_backend("auto", cpu) == "torch"
    assert ops.resolve_backend(None, torch.device("cuda")) == "ell"
    assert ops.resolve_backend("ell", cpu) == "ell"
    assert ops.resolve_backend("dense", cpu) == "dense"  # never by "auto"
    # the mesh backend resolves to itself and is listed, as in the JAX
    # package (whose "jnp" is the port's "torch"); "auto" never picks it
    assert ops.BACKENDS == ("torch", "ell", "dense", "ell_spmd")
    assert ops.resolve_backend("ell_spmd", cpu) == "ell_spmd" == \
        jops.resolve_backend("ell_spmd", 64)
    assert "ell_spmd" in jops.BACKENDS
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


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMBINE_CASES)
def test_min_sum_with_deg_equals_reference(N, Cd, K, shuffled, max_deg):
    """The row lengths change nothing: with deg, equal to the calls without
    it and to the JAX package's kernels (which take no deg)."""
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    fi, ff = _fields(N, Cd)
    tn, jn = torch.as_tensor(nbr), jnp.asarray(nbr)
    ti, tf = torch.as_tensor(fi), torch.as_tensor(ff)
    deg = torch.as_tensor(_row_lengths(nbr))
    got_min = neighbor_min_ell(tn, ti, K=K, deg=deg)
    got_sum = neighbor_sum_ell(tn, tf, K=K, deg=deg)
    assert torch.equal(got_min, neighbor_min_ell(tn, ti, K=K))
    assert torch.equal(got_min, neighbor_min_ell_plain(tn, ti, K, deg))
    assert torch.equal(got_sum, neighbor_sum_ell(tn, tf, K=K))
    assert torch.equal(got_sum, neighbor_sum_ell_plain(tn, tf, K, deg))
    np.testing.assert_array_equal(
        got_min.numpy(), np.asarray(jops.neighbor_min_ell(
            jn, jnp.asarray(fi), interpret=True, K=K)))
    np.testing.assert_allclose(
        got_sum.numpy(), np.asarray(jops.neighbor_sum_ell(
            jn, jnp.asarray(ff), interpret=True, K=K)), rtol=1e-6)


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
                         [c for c in COMMON_CASES if c[1] <= 40]
                         + HOLES_CASES)
def test_common_variants(N, Cd, K, shuffled, max_deg):
    """"allpairs" equals the reference's "allpairs", "merge" and the
    oracle, on sorted and shuffled rows, with holes (a PAD inside the `deg`
    prefix) and with duplicate ids, with the row lengths `deg` and
    without."""
    nbr = _rows(N, Cd, N + Cd, shuffled is True, max_deg)
    deg = torch.as_tensor(_row_lengths(nbr))
    if shuffled == "holes":
        nbr = _holes(nbr)
    rows = _dup_rows(N, Cd, N) if shuffled == "dup" else nbr
    tn, tr = torch.as_tensor(nbr), torch.as_tensor(rows)
    if shuffled != "dup":
        tr = tn  # whole-graph use: the field is nbr itself
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
    with_deg = neighbor_common_ell(tn, tr, K=K, variant="allpairs", deg=deg)
    assert torch.equal(with_deg, got)
    assert torch.equal(common_allpairs_ell(tn, tr, K, deg), got)
    assert torch.equal(common_allpairs_ell_plain(tn, tr, K, deg), got)
    with pytest.raises(ValueError):
        neighbor_common_ell(tn, tr, variant="nonsense")


def test_allpairs_plain_chunks_equal_one_pass(monkeypatch):
    import repro_torch.kernels.ell_triangles as et
    nbr = torch.as_tensor(_rows(50, 12, 6, True))
    rows = torch.as_tensor(_dup_rows(50, 12, 6))
    want = common_allpairs_ell_plain(nbr, rows)
    monkeypatch.setattr(et, "_ALLPAIRS_CHUNK", 12 ** 3 * 3)  # 3 rows a chunk
    assert torch.equal(common_allpairs_ell_plain(nbr, rows), want)


def _bad_degs(nbr):
    """deg tensors the wrappers must refuse: wrong shape, dtype, device."""
    N = nbr.shape[0]
    return (torch.zeros(N + 1, dtype=torch.int32),
            torch.zeros(N, dtype=torch.int64),
            torch.zeros(N, dtype=torch.int32, device="meta"))


def test_multi_and_common_reject_bad_deg():
    nbr = torch.as_tensor(_rows(12, 5, 3, True))
    f = torch.zeros(12, dtype=torch.int32)
    x = torch.zeros(12, dtype=torch.float32)
    for deg in _bad_degs(nbr):
        for call in (lambda: neighbor_min_ell(nbr, f, deg=deg),
                     lambda: neighbor_sum_ell(nbr, x, deg=deg),
                     lambda: neighbor_multi_ell(nbr, (f,), ("min",), deg=deg),
                     lambda: neighbor_common_ell(nbr, nbr, deg=deg),
                     lambda: neighbor_common_ell(nbr, nbr, variant="allpairs",
                                                 deg=deg),
                     lambda: common_allpairs_ell(nbr, nbr, deg=deg)):
            with pytest.raises(ValueError, match="deg"):
                call()


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMBINE_CASES[:4])
def test_multi_plain_ignores_deg(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    deg = torch.as_tensor(_row_lengths(nbr))
    fi, ff = _fields(N, Cd)
    fields = (torch.as_tensor(_est(N, Cd)), torch.as_tensor(fi),
              torch.as_tensor(ff))
    combines = ("hindex", "min", "sum")
    tn = torch.as_tensor(nbr)
    want = neighbor_multi_ell_plain(tn, fields, combines, K)
    for got in (neighbor_multi_ell_plain(tn, fields, combines, K, deg),
                neighbor_multi_ell(tn, fields, combines, K, deg=deg)):
        for g_, w in zip(got, want):
            assert torch.equal(g_, w)


@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", COMMON_CASES)
def test_common_plain_ignores_deg(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled == True, max_deg)  # noqa: E712
    rows = _dup_rows(N, Cd, N) if shuffled == "dup" else nbr
    deg = torch.as_tensor(_row_lengths(nbr))
    tn, tr = torch.as_tensor(nbr), torch.as_tensor(rows)
    want = neighbor_common_ell_plain(tn, tr, K)
    assert torch.equal(neighbor_common_ell_plain(tn, tr, K, deg), want)
    assert torch.equal(neighbor_common_ell(tn, tr, K, deg=deg), want)
    assert torch.equal(neighbor_common_ell(tn, tr, K, variant="allpairs",
                                           deg=deg), want)


def _stop_rows(nbr, deg, C):
    """The first C columns of each row as a row-length stop reads them:
    every slot after the one where `deg` valid slots were seen is PAD (a
    PAD before that point only sends the stop further on)."""
    sub = nbr[:, :C]
    valid = (sub >= 0).to(torch.int32)
    before = valid.cumsum(dim=1) - valid
    return torch.where(before < deg[:, None], sub, torch.full_like(sub, -1))


@pytest.mark.parametrize("shuffled", [False, True, "dup"])
def test_common_field_deg_rule(shuffled):
    """`deg` bounds the field's rows only when the field is nbr itself; the
    stop that rule allows gives the counts of the full read, on sorted,
    shuffled and duplicate-id inputs; bounding a field that is not nbr by
    nbr's lengths would not."""
    N, Cd = 60, 16
    nbr = _rows(N, Cd, 11, shuffled == True, 10)  # noqa: E712
    deg = torch.as_tensor(_row_lengths(nbr))
    tn = torch.as_tensor(nbr)
    rows = torch.as_tensor(_dup_rows(N, Cd, 12)) if shuffled == "dup" \
        else tn
    fdeg = field_deg(tn, rows, deg)
    assert (fdeg is deg) == (shuffled != "dup")
    assert field_deg(tn, tn.clone(), deg) is None       # other memory
    assert field_deg(tn, tn[:, :Cd - 1], deg) is None   # other shape
    for K in (None, 12):
        C = columns(Cd, K)
        want = neighbor_common_ell_plain(tn, rows, K)
        stopped_rows = rows if fdeg is None else _stop_rows(rows, fdeg, C)
        got = neighbor_common_ell_plain(_stop_rows(tn, deg, C), stopped_rows)
        assert torch.equal(got, want)
        if shuffled == "dup":
            wrong = neighbor_common_ell_plain(_stop_rows(tn, deg, C),
                                              _stop_rows(rows, deg, C))
            assert not torch.equal(wrong, want)


def test_combine_registry_equals_reference():
    nbr = _rows(60, 37, 9, True)
    fi, ff = _fields(60, 9)

    class G:  # the registry duck-types on .nbr, .deg and .device
        pass
    g = G()
    g.nbr, g.device = torch.as_tensor(nbr), torch.device("cpu")
    g.deg = torch.as_tensor(_row_lengths(nbr))
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


@pytest.mark.parametrize("combine", ["min", "sum"])
def test_registry_hands_deg_to_min_and_sum(combine, monkeypatch):
    """On the "ell" route the registry passes each row's length `g.deg` to
    the "min" and "sum" wrappers, as it does to the others."""
    nbr = _rows(40, 9, 5, False)
    fi, ff = _fields(40, 5)
    field = torch.as_tensor(fi if combine == "min" else ff)

    class G:  # the registry duck-types on .nbr, .deg and .device
        pass
    g = G()
    g.nbr, g.device = torch.as_tensor(nbr), torch.device("cpu")
    g.deg = torch.as_tensor(_row_lengths(nbr))
    seen = []
    name = {"min": "neighbor_min_ell", "sum": "neighbor_sum_ell"}[combine]
    wrapper = getattr(ops, name)

    def record(nbr_, field_, K=None, deg=None):
        seen.append(deg)
        return wrapper(nbr_, field_, K=K, deg=deg)

    monkeypatch.setattr(ops, name, record)
    got = ops.neighbor_combine_blocks(g, field, combine, backend="ell")
    assert len(seen) == 1 and seen[0] is g.deg
    assert torch.equal(got, ops.neighbor_combine_blocks(g, field, combine,
                                                        backend="torch"))


def test_library_names_follow_every_header(tmp_path, monkeypatch):
    """An edit to a shared header renames (so rebuilds) every library."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    before = {n: _build._library_path(n) for n in _build.SOURCES}
    assert before == {n: _build._library_path(n) for n in _build.SOURCES}

    def includes(path, header):  # directly or through another header
        text = path.read_text()
        return f'#include "{header}"' in text or any(
            includes(h, header) for h in src.glob("*.cuh")
            if h.name != header and f'#include "{h.name}"' in text)

    for header, users in (
            ("ell_reduce.cuh", {"ell_hindex", "ell_cc", "ell_pagerank",
                                "ell_multi", "ell_triangles",
                                "ell_hindex_count", "ell_allpairs",
                                "kcore_hindex"}),
            ("ell_rows.cuh", {"ell_cc", "ell_pagerank", "ell_multi",
                              "ell_hindex_count"}),
            ("ell_pairs.cuh", {"ell_triangles", "ell_allpairs"})):
        path = src / header
        path.write_text(path.read_text() + "\n// edited\n")
        after = {n: _build._library_path(n) for n in _build.SOURCES}
        includers = [n for n in _build.SOURCES
                     if includes(src / f"{n}.cu", header)]
        assert set(includers) >= users, header
        for n in includers:
            assert after[n] != before[n], (header, n)
        before = after


# ---------------------------------------------------------------------------
# A field longer than the rows (a mesh worker's shard and halo buffer).
# ---------------------------------------------------------------------------


def _halo_rows(N, M, Cd, seed, shuffled):
    """(N, Cd) rows whose ids index a field of M > N rows: own rows
    [0, N) and "halo" rows [N, M - 2), as `runtime.spmd` stages a shard's
    local-frame rows; PAD = -1 in some slots of most rows."""
    rng = np.random.default_rng(seed)
    nbr = np.full((N, Cd), -1, np.int32)
    for u in range(N):
        d = int(rng.integers(0, Cd + 1))
        ids = np.sort(rng.choice(M - 2, size=d, replace=False))
        if shuffled:
            nbr[u, rng.choice(Cd, size=d, replace=False)] = ids
        else:
            nbr[u, :d] = ids
    return nbr


def _hop_numpy(nbr, f, elig, vis):
    """next[u, r] = OR over valid slots of f[nbr[u, j], r], masked."""
    hit = np.zeros(elig.shape, bool)
    for u in range(nbr.shape[0]):
        for v in nbr[u]:
            if v >= 0:
                hit[u] |= f[v]
    return hit & elig & ~vis


@pytest.mark.parametrize("shuffled", [False, True])
def test_hindex_takes_a_longer_field(shuffled):
    """`hindex_ell` on rows indexing a field of more rows than `nbr`
    equals the JAX package's oracle; `check_field(longer=True)` accepts
    such a field and still refuses a shorter one."""
    from repro_torch.kernels.ell_hindex import check_field

    N, M, Cd = 60, 97, 14
    nbr = _halo_rows(N, M, Cd, 5, shuffled)
    est = np.random.default_rng(6).integers(-2, 30, M, dtype=np.int32)
    want = np.asarray(jref.ell_hindex_ref(jnp.asarray(nbr), jnp.asarray(est)))
    tn, te = torch.as_tensor(nbr), torch.as_tensor(est)
    deg = torch.as_tensor(_row_lengths(nbr))
    for variant in ("sort", "count"):
        got = hindex_ell(tn, te, variant=variant, deg=deg)
        assert got.shape == (N,)
        np.testing.assert_array_equal(got.numpy(), want)
    check_field(tn, te, longer=True)
    check_field(tn, te[:N].contiguous(), longer=True)
    with pytest.raises(ValueError, match=r">= 60"):
        check_field(tn, te[:N - 1].contiguous(), longer=True)
    with pytest.raises(ValueError):
        check_field(tn, te)  # the other kernels keep N rows


def _halo_case(N, M, Cd, seed, shuffled):
    """Local-frame rows (N, Cd) over a field of M > N rows, as a mesh
    worker holds them: min/sum fields of M values, and an (M, Cd) row
    field of GLOBAL ids (drawn from [0, 4M), PAD -1, sorted and
    duplicate-free like a graph's rows) — so the ids in `nbr` and in the
    row field differ, and u's own set must come from rows[u]."""
    rng = np.random.default_rng(seed)
    nbr = _halo_rows(N, M, Cd, seed, shuffled)
    ints = rng.integers(-5, 2 * M, M).astype(np.int32)
    floats = rng.random(M).astype(np.float32)
    rows = np.full((M, Cd), -1, np.int32)
    for u in range(M):
        d = int(rng.integers(0, Cd + 1))
        rows[u, :d] = np.sort(rng.choice(4 * M // 3, d, replace=False))
    return nbr, ints, floats, rows


def _mesh_reduce(combine, field, nbr, fill):
    """The JAX package's post-halo local reduce of a mesh worker
    (`ref.combine_rows` on the neighbor values gathered through the
    local-frame rows, PAD slots at the combine's fill)."""
    N = nbr.shape[0]
    nb = jnp.asarray(nbr)
    f = jnp.asarray(field)
    pad = (nb < 0) if f.ndim == 1 else (nb < 0)[:, :, None]
    vals = jnp.where(pad, jnp.asarray(fill, f.dtype), f[jnp.clip(nb, 0)])
    return np.asarray(jref.combine_rows(combine, f[:N], vals))


@pytest.mark.parametrize("shuffled", [False, True])
def test_combines_take_a_longer_field(shuffled):
    """`neighbor_min_ell`, `neighbor_sum_ell`, `neighbor_multi_ell` and
    `neighbor_common_ell` (both variants) on local-frame rows over a
    field of more rows than `nbr` (a mesh worker's shard and halo buffer)
    equal the JAX package's post-halo reduce; the triangles' row field
    holds global ids unlike `nbr`'s, and u's own set is rows[u].  A
    field shorter than `nbr` is refused."""
    from repro_torch.kernels.ell_hindex import check_field
    from repro_torch.kernels.ell_triangles import _check_rows

    N, M, Cd = 60, 97, 14
    nbr, ints, floats, rows = _halo_case(N, M, Cd, 21, shuffled)
    tn = torch.as_tensor(nbr)
    deg = torch.as_tensor(_row_lengths(nbr))
    ti, tf, tr = (torch.as_tensor(a) for a in (ints, floats, rows))
    want = {"min": _mesh_reduce("min", ints, nbr, MIN_FILL),
            "sum": _mesh_reduce("sum", floats, nbr, 0.0),
            "hindex": _mesh_reduce("hindex", ints, nbr, -1),
            "count_common": _mesh_reduce("count_common", rows, nbr, -1)}
    np.testing.assert_array_equal(
        neighbor_min_ell(tn, ti, deg=deg).numpy(), want["min"])
    np.testing.assert_allclose(neighbor_sum_ell(tn, tf, deg=deg).numpy(),
                               want["sum"], rtol=1e-6)
    got = neighbor_multi_ell(tn, (ti, tf, ti), ("min", "sum", "hindex"),
                             deg=deg)
    np.testing.assert_array_equal(got[0].numpy(), want["min"])
    np.testing.assert_allclose(got[1].numpy(), want["sum"], rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), want["hindex"])
    assert want["count_common"].any()
    for variant in ("merge", "allpairs"):
        np.testing.assert_array_equal(
            neighbor_common_ell(tn, tr, variant=variant, deg=deg).numpy(),
            want["count_common"])
    check_field(tn, ti, longer=True)
    _check_rows(tn, tr)
    with pytest.raises(ValueError, match=r">= 60"):
        _check_rows(tn, tr[:N - 1])
    with pytest.raises(ValueError):
        _check_rows(tn, tr[:, :Cd - 1])


@pytest.mark.parametrize("K", [None, 8])
def test_frontier_plain_pads_past_a_longer_field(K):
    """The plain hop maps PAD to a False row appended after the field's
    LAST row: with a field longer than `nbr`, row N is a real row (here
    True in every column), which a PAD slot must not read."""
    from repro_torch.kernels.ell_frontier import _check

    N, M, Cd, R = 50, 83, 10, 4
    nbr = _halo_rows(N, M, Cd, 8, shuffled=K is None)
    rng = np.random.default_rng(9)
    f = rng.random((M, R)) < 0.15
    f[N:] = True  # every extra row is set, row N included
    elig, vis = rng.random((N, R)) < 0.8, rng.random((N, R)) < 0.1
    if K is not None:
        nbr[:, K:] = -1  # rows fit the K columns (left-filled)
    want = _hop_numpy(nbr, f, elig, vis)
    assert (nbr == -1).any() and not want.all()
    got = frontier_step_ell(*(torch.as_tensor(a)
                              for a in (nbr, f, elig, vis)), K=K)
    np.testing.assert_array_equal(got.numpy(), want)
    t = [torch.as_tensor(a) for a in (nbr, f, elig, vis)]
    _check(*t)
    with pytest.raises(ValueError, match="eligible"):
        _check(t[0], t[1], t[1], t[3])  # only the field may be longer


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


#: rows longer than the 256 columns `ell_hindex` keeps in a warp's
#: registers (Cd = 300; the full rows hold 300 slots), and K past 256
LONG_CASES = [(320, 300, None, True, None), (320, 300, None, False, None),
              (320, 300, 270, False, None), (320, 300, 257, True, None)]


@needs_cuda
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg", HINDEX_CASES + LONG_CASES)
def test_hindex_kernel_with_deg_equals_plain(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    deg = torch.as_tensor(_row_lengths(nbr)).cuda()
    nbr = torch.as_tensor(nbr).cuda()
    est = torch.as_tensor(_est(N, Cd)).cuda()
    before = hindex_ell.launches
    got = hindex_ell(nbr, est, K=K, deg=deg)
    torch.cuda.synchronize()
    assert hindex_ell.launches == before + 1
    assert torch.equal(got, hindex_ell_plain(nbr, est, K))
    assert torch.equal(got, hindex_ell(nbr, est, K=K))


@needs_cuda
@pytest.mark.parametrize("R", [1, 8, 13])
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg",
                         [c[:2] + c[3:] for c in FRONTIER_CASES] + LONG_CASES)
def test_frontier_kernel_with_deg_equals_plain(N, Cd, K, shuffled, max_deg,
                                               R):
    nbr = _rows(N, Cd, N + R, shuffled, max_deg)
    deg = torch.as_tensor(_row_lengths(nbr)).cuda()
    nbr = torch.as_tensor(nbr).cuda()
    rng = np.random.default_rng(R)  # a sparse frontier: most rows miss
    f, elig, vis = (torch.as_tensor(rng.random((N, R)) < p).cuda()
                    for p in (0.03, 0.7, 0.2))
    before = frontier_step_ell.launches
    got = frontier_step_ell(nbr, f, elig, vis, K=K, deg=deg)
    torch.cuda.synchronize()
    assert frontier_step_ell.launches == before + 1
    assert torch.equal(got, frontier_step_ell_plain(nbr, f, elig, vis, K))
    assert torch.equal(got, frontier_step_ell(nbr, f, elig, vis, K=K))


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
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg",
                         COMBINE_CASES + LONG_CASES)
def test_min_sum_kernels_with_deg_equal_plain(N, Cd, K, shuffled, max_deg):
    """With deg: the min bit-equal to plain, the sum allclose to plain and
    bit-equal to the kernel without deg; each one launch."""
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    deg = torch.as_tensor(_row_lengths(nbr)).cuda()
    nbr = torch.as_tensor(nbr).cuda()
    fi, ff = (torch.as_tensor(a).cuda() for a in _fields(N, Cd))
    before = (neighbor_min_ell.launches, neighbor_sum_ell.launches)
    got_min = neighbor_min_ell(nbr, fi, K, deg=deg)
    got_sum = neighbor_sum_ell(nbr, ff, K, deg=deg)
    torch.cuda.synchronize()
    assert (neighbor_min_ell.launches, neighbor_sum_ell.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got_min, neighbor_min_ell_plain(nbr, fi, K))
    assert torch.equal(got_min, neighbor_min_ell(nbr, fi, K))
    torch.testing.assert_close(got_sum, neighbor_sum_ell_plain(nbr, ff, K),
                               rtol=1e-5, atol=1e-9)
    assert torch.equal(got_sum.view(torch.int32),
                       neighbor_sum_ell(nbr, ff, K).view(torch.int32))


@needs_cuda
@pytest.mark.parametrize("layout", ["sorted", "shuffled", "holes"])
def test_sum_kernel_bits_do_not_depend_on_deg(layout):
    """Fields whose sum depends on the order of its additions (1e8 beside
    1.0, -0.0, signs mixed) on rows of 0 to 300 slots, left-filled,
    shuffled, or left-filled but for one slot moved to the row's end (a
    PAD inside the deg prefix): `neighbor_sum_ell` with deg has the bits
    of the call without deg and of `neighbor_multi_ell`'s sum, and the
    min equals plain."""
    N, Cd = 320, 300
    rng = np.random.default_rng(16)
    deg = np.array([0, 1, 31, 32, 33, 64, 65, 256, 257, 299, 300, 3, 7, 9,
                    40, 80] * (N // 16))
    nbr = np.full((N, Cd), -1, np.int32)
    for u in range(N):
        ids = np.sort(rng.choice(N, deg[u], replace=False))
        cols = rng.choice(Cd, deg[u], replace=False) \
            if layout == "shuffled" else np.arange(deg[u])
        if layout == "holes" and 0 < deg[u] < Cd:
            cols[0] = Cd - 1
        nbr[u, cols] = ids
    field = rng.choice(np.array([1e8, -1e8, 1.0, -1.0, 0.5, -0.0, 3e-8],
                                np.float32), N)
    labels = rng.integers(-5, N + 5, N).astype(np.int32)
    nbr, deg = torch.as_tensor(nbr).cuda(), torch.as_tensor(
        deg.astype(np.int32)).cuda()
    field, labels = torch.as_tensor(field).cuda(), torch.as_tensor(
        labels).cuda()
    for K in (None, 64, 257):
        want = neighbor_sum_ell(nbr, field, K).view(torch.int32)
        fused, = neighbor_multi_ell(nbr, (field,), ("sum",), K, deg=deg)
        assert torch.equal(neighbor_sum_ell(nbr, field, K, deg=deg).view(
            torch.int32), want)
        assert torch.equal(fused.view(torch.int32), want)
        assert torch.equal(neighbor_min_ell(nbr, labels, K, deg=deg),
                           neighbor_min_ell_plain(nbr, labels, K))


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
    # an independent kernel: "allpairs" sorts nothing and matches all pairs
    assert torch.equal(got, common_allpairs_ell(nbr, rows, K))
    assert neighbor_common_ell.launches == before + 1


@needs_cuda
@pytest.mark.parametrize("combines", MULTI_COMBINES)
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg",
                         COMBINE_CASES + LONG_CASES)
def test_multi_kernel_with_deg_equals_plain(N, Cd, K, shuffled, max_deg,
                                            combines):
    nbr = _rows(N, Cd, N + Cd, shuffled, max_deg)
    deg = torch.as_tensor(_row_lengths(nbr)).cuda()
    nbr = torch.as_tensor(nbr).cuda()
    fi, ff = (torch.as_tensor(a).cuda() for a in _fields(N, Cd))
    host = {"min": fi, "sum": ff,
            "hindex": torch.as_tensor(_est(N, Cd)).cuda()}
    fields = [host[c] for c in combines]
    before = neighbor_multi_ell.launches
    got = neighbor_multi_ell(nbr, fields, combines, K, deg=deg)
    torch.cuda.synchronize()
    assert neighbor_multi_ell.launches == before + 1
    alone = {"min": neighbor_min_ell, "sum": neighbor_sum_ell,
             "hindex": hindex_ell}
    plain = neighbor_multi_ell_plain(nbr, fields, combines, K)
    without = neighbor_multi_ell(nbr, fields, combines, K)
    for c, f, g_, p, w in zip(combines, fields, got, plain, without):
        assert torch.equal(g_, alone[c](nbr, f, K)), c  # bit-equal, sum too
        assert torch.equal(g_, w), c
        torch.testing.assert_close(g_, p, rtol=1e-5 if c == "sum" else 0,
                                   atol=1e-9 if c == "sum" else 0)


@needs_cuda
@pytest.mark.parametrize("shuffled", [False, True])
def test_multi_sum_keeps_the_standalone_fold_order(shuffled):
    """Fields whose sum depends on the order of its additions (1e8 beside
    1.0, -0.0, signs mixed) on rows of 31 to 65 slots: the fused sum has
    the bits of `neighbor_sum_ell`, with `deg` and without."""
    N, Cd = 256, 80
    rng = np.random.default_rng(15)
    deg = np.array([0, 1, 31, 32, 33, 64, 65, 80] * (N // 8))
    nbr = np.full((N, Cd), -1, np.int32)
    for u in range(N):
        ids = np.sort(rng.choice(N, deg[u], replace=False))
        cols = rng.choice(Cd, deg[u], replace=False) if shuffled \
            else np.arange(deg[u])
        nbr[u, cols] = ids
    field = rng.choice(np.array([1e8, -1e8, 1.0, -1.0, 0.5, -0.0, 3e-8],
                                np.float32), N)
    nbr, deg = torch.as_tensor(nbr).cuda(), torch.as_tensor(
        deg.astype(np.int32)).cuda()
    field = torch.as_tensor(field).cuda()
    want = neighbor_sum_ell(nbr, field)
    for d in (None, deg):
        got, = neighbor_multi_ell(nbr, (field,), ("sum",), deg=d)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@needs_cuda
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg",
                         COMMON_CASES + LONG_CASES)
def test_common_kernel_with_deg_equals_plain(N, Cd, K, shuffled, max_deg):
    nbr = _rows(N, Cd, N + Cd, shuffled == True, max_deg)  # noqa: E712
    deg = torch.as_tensor(_row_lengths(nbr)).cuda()
    rows = torch.as_tensor(_dup_rows(N, Cd, N)).cuda() \
        if shuffled == "dup" else None
    nbr = torch.as_tensor(nbr).cuda()
    rows = nbr if rows is None else rows  # whole-graph: the same tensor
    before = neighbor_common_ell.launches
    got = neighbor_common_ell(nbr, rows, K, deg=deg)
    torch.cuda.synchronize()
    assert neighbor_common_ell.launches == before + 1
    assert torch.equal(got, neighbor_common_ell_plain(nbr, rows, K))
    assert torch.equal(got, neighbor_common_ell(nbr, rows, K))
    # a copy of nbr as the field: its rows are read over their C columns
    assert torch.equal(got, neighbor_common_ell(nbr, rows.clone(), K,
                                                deg=deg))


#: rows of at most 64 and at most 256 valid slots (a group's registers, a
#: warp's), sorted and shuffled; LONG_CASES reach past 256 (the warp loop)
TIER_CASES = [(256, 300, None, True, 64), (256, 300, None, False, 64),
              (256, 300, None, True, 256), (256, 300, 200, False, 256)]


@needs_cuda
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg",
                         HINDEX_CASES + HOLES_CASES + LONG_CASES + TIER_CASES)
def test_hindex_count_kernel_equals_plain_and_sort(N, Cd, K, shuffled,
                                                   max_deg):
    """The "count" kernel with the row lengths `deg` and without: equal to
    its plain version and to the "sort" kernel; one launch each, on its
    own counter."""
    nbr = _rows(N, Cd, N + Cd, shuffled is True, max_deg)
    deg = torch.as_tensor(_row_lengths(nbr)).cuda()
    if shuffled == "holes":
        nbr = _holes(nbr)
    nbr = torch.as_tensor(nbr).cuda()
    est = torch.as_tensor(_est(N, Cd)).cuda()
    want = hindex_count_ell_plain(nbr, est, K)
    for d in (None, deg):
        before = (hindex_count_ell.launches, hindex_ell.launches)
        got = hindex_ell(nbr, est, K=K, variant="count", deg=d)
        torch.cuda.synchronize()
        assert (hindex_count_ell.launches, hindex_ell.launches) == \
            (before[0] + 1, before[1])  # its own kernel and count
        assert torch.equal(got, want)
        assert torch.equal(got, hindex_ell(nbr, est, K=K, deg=d))


@needs_cuda
@pytest.mark.parametrize("N,Cd,K,shuffled,max_deg",
                         COMMON_CASES + HOLES_CASES + LONG_CASES + TIER_CASES)
def test_allpairs_kernel_equals_plain_and_merge(N, Cd, K, shuffled, max_deg):
    """The "allpairs" kernel with the row lengths `deg` and without, on the
    field nbr itself (so `deg` bounds its rows too), a copy of it and
    duplicate ids: equal to its plain version and to the "merge" kernel;
    one launch each, on its own counter."""
    nbr = _rows(N, Cd, N + Cd, shuffled is True, max_deg)
    deg = torch.as_tensor(_row_lengths(nbr)).cuda()
    if shuffled == "holes":
        nbr = _holes(nbr)
    nbr = torch.as_tensor(nbr).cuda()
    fields = [nbr, nbr.clone()]
    if shuffled == "dup":
        fields.append(torch.as_tensor(_dup_rows(N, Cd, N)).cuda())
    for rows in fields:
        want = common_allpairs_ell_plain(nbr, rows, K)
        for d in (None, deg):
            before = (common_allpairs_ell.launches,
                      neighbor_common_ell.launches)
            got = neighbor_common_ell(nbr, rows, K, variant="allpairs", deg=d)
            torch.cuda.synchronize()
            assert (common_allpairs_ell.launches,
                    neighbor_common_ell.launches) == \
                (before[0] + 1, before[1])  # its own kernel and count
            assert torch.equal(got, want)
            assert torch.equal(got, neighbor_common_ell(nbr, rows, K, deg=d))


@needs_cuda
@pytest.mark.parametrize("shuffled", [False, True])
def test_kernels_take_a_longer_field(shuffled):
    """Both kernels (with and without `deg`) on rows indexing a field of
    more rows than `nbr`, the mesh runtime's shard and halo buffer, equal
    their plain versions."""
    N, M, Cd, R = 300, 611, 40, 8
    nbr = torch.as_tensor(_halo_rows(N, M, Cd, 11, shuffled)).cuda()
    deg = torch.as_tensor(_row_lengths(nbr.cpu().numpy())).cuda()
    est = torch.as_tensor(np.random.default_rng(12).integers(
        -2, 50, M, dtype=np.int32)).cuda()
    rng = np.random.default_rng(13)
    f = rng.random((M, R)) < 0.1
    f[N:N + 3] = True
    f, elig, vis = (torch.as_tensor(a).cuda() for a in (
        f, rng.random((N, R)) < 0.8, rng.random((N, R)) < 0.1))
    for d in (None, deg):
        for variant in ("sort", "count"):
            torch.testing.assert_close(
                hindex_ell(nbr, est, variant=variant, deg=d),
                hindex_ell_plain(nbr, est), rtol=0, atol=0)
        assert torch.equal(frontier_step_ell(nbr, f, elig, vis, deg=d),
                           frontier_step_ell_plain(nbr, f, elig, vis))


@needs_cuda
@pytest.mark.parametrize("shuffled", [False, True])
def test_combine_kernels_take_a_longer_field(shuffled):
    """`ell_cc`, `ell_pagerank`, `ell_multi`, `ell_triangles` and
    `ell_allpairs` (with and without `deg`) on local-frame rows over a
    field of more rows than `nbr`, the mesh runtime's shard and halo
    buffer, equal their plain versions bit for bit (the sums to float32
    rounding against plain); for the triangles the row field holds global
    ids, unlike `nbr`, and is a different tensor (its lengths are not
    `deg`, `field_deg` gives None)."""
    N, M, Cd = 300, 611, 40
    nbr, ints, floats, rows = _halo_case(N, M, Cd, 23, shuffled)
    deg = torch.as_tensor(_row_lengths(nbr)).cuda()
    tn, ti, tf, tr = (torch.as_tensor(a).cuda()
                      for a in (nbr, ints, floats, rows))
    assert field_deg(tn, tr, deg) is None
    want_tri = neighbor_common_ell_plain(tn, tr)
    assert bool(want_tri.any())
    for d in (None, deg):
        assert torch.equal(neighbor_min_ell(tn, ti, deg=d),
                           neighbor_min_ell_plain(tn, ti))
        torch.testing.assert_close(neighbor_sum_ell(tn, tf, deg=d),
                                   neighbor_sum_ell_plain(tn, tf),
                                   rtol=1e-5, atol=1e-6)
        got = neighbor_multi_ell(tn, (ti, tf, ti), ("min", "sum", "hindex"),
                                 deg=d)
        assert torch.equal(got[0], neighbor_min_ell(tn, ti, deg=d))
        assert torch.equal(got[1], neighbor_sum_ell(tn, tf, deg=d))
        assert torch.equal(got[2], hindex_ell(tn, ti, deg=d))
        for variant in ("merge", "allpairs"):
            assert torch.equal(
                neighbor_common_ell(tn, tr, variant=variant, deg=d),
                want_tri)
