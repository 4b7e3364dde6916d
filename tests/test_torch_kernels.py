"""PyTorch port vs the JAX package: the two ELL kernels of the main path.

On the CPU the port's wrappers (`hindex_ell`, `frontier_step_ell`) run
their plain PyTorch versions; these are held against the JAX package's
Pallas kernels in interpret mode (`repro.kernels.ops.hindex_ell` /
`frontier_step_ell` with ``interpret=True``) and its jnp oracles
(`ref.ell_*`).  Outputs are integers or booleans and must match EXACTLY.

Cases: K = Cd on rows whose valid slots are shuffled (PAD anywhere);
K < Cd on sorted, left-filled rows; R in {1, 8, 13}; empty and full rows.
The CUDA kernels themselves are held against the plain versions, on the
same cases, by the tests marked `cuda` (they skip without a GPU).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_port import needs_cuda, require_cuda  # noqa: F401 (fixture)

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ell_frontier import (
    frontier_step_ell, frontier_step_ell_plain)
from repro_torch.kernels.ell_hindex import hindex_ell, hindex_ell_plain


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
    for b in ("dense", "ell_spmd"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ops.resolve_backend(b, cpu)
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
