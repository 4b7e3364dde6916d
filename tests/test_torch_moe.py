"""PyTorch port vs the JAX package: the Mixture-of-Experts layer.

`repro_torch.models.moe` against `repro.models.moe` at the reduced
configs of the two MoE architectures, on the CPU.  Parameters are the
JAX package's `init_moe` output carried across through
`params_from_numpy`; inputs are made from a seed with numpy.

Tolerances (relative to the largest magnitude of the reference's output):

* `moe_dense` and `moe_capacity` at float32: 2e-5; the aux loss: rtol
  1e-5 (the reference's own `test_moe_capacity_equals_dense_when_ample`);
* which (token, expert) pairs an expert keeps, at `capacity=1` and with
  tied router probabilities: EQUAL to the reference's;
* two runs of the capacity path: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (fixture)

import repro.configs as jcfg
import repro.models.moe as JM

import repro_torch.configs as tcfg
from repro_torch.models import moe as M
from repro_torch.models import params_from_numpy

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MOE = ["deepseek-v3-671b", "llama4-scout-17b-a16e"]
TOL = 2e-5
AUX_RTOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _layer(name, seed=9):
    """(cfg, jax params, port params) of one reduced MoE layer."""
    cfg = jcfg.ARCHS[name].reduced()
    jp = JM.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _x(cfg, B, S, seed=0, scale=0.5):
    x = (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
         * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("path", ["dense", "capacity"])
@pytest.mark.parametrize("name", MOE)
def test_moe_matches_reference(name, path):
    cfg, jp, tp = _layer(name)
    jx, tx = _x(cfg, 2, 16)
    want, waux = getattr(JM, f"moe_{path}")(jp, cfg, jx)
    got, aux = getattr(M, f"moe_{path}")(tp, cfg, tx)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert _rel(got, want) < TOL
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)


@pytest.mark.parametrize("name", MOE)
def test_dense_in_slices_of_experts(name, monkeypatch):
    """The oracle run one expert (and two) at a time equals the reference,
    which holds all (E, T, d) outputs at once."""
    cfg, jp, tp = _layer(name, seed=4)
    jx, tx = _x(cfg, 2, 8, seed=4)
    want, _ = JM.moe_dense(jp, cfg, jx)
    T = 16
    for experts in (1, 2):
        monkeypatch.setattr(M, "_DENSE_SLICE_ELEMS",
                            experts * T * max(cfg.d_model, cfg.moe_d_ff))
        got, _ = M.moe_dense(tp, cfg, tx)
        assert _rel(got, want) < TOL, experts


def _kept(module, monkeypatch, fn):
    """Run `fn()`; return the tokens the capacity dispatch put in each of
    the E·C slots (T for an empty slot), read off the (E, C, d) tile that
    the module's `_expert_ffn` receives."""
    seen = []
    real = module._expert_ffn
    monkeypatch.setattr(module, "_expert_ffn",
                        lambda p, xe: seen.append(np.asarray(xe))
                        or real(p, xe))
    out = fn()
    monkeypatch.setattr(module, "_expert_ffn", real)
    return seen[0], out


def _token_ids(tile, x2):
    """Map each gathered row of `tile` (E, C, d) back to its token (rows of
    x2 are distinct; an empty slot gathers the zero row: T)."""
    rows = tile.reshape(-1, tile.shape[-1])
    T = x2.shape[0]
    ids = np.full(rows.shape[0], -1)
    for s, r in enumerate(rows):
        hit = np.nonzero(np.all(x2 == r, axis=1))[0]
        ids[s] = hit[0] if len(hit) else (T if not r.any() else -1)
    assert (ids >= 0).all()
    return ids


@pytest.mark.parametrize("capacity", [1, 2, None])
@pytest.mark.parametrize("name", MOE)
def test_capacity_keeps_the_reference_pairs(name, capacity, monkeypatch):
    """Which token lands in which expert slot, and which overflow, equals
    the reference's exactly (capacity 1 drops the most), and so do the
    outputs; the port's `dispatch` gives the same slots."""
    cfg, jp, tp = _layer(name, seed=10)
    jx, tx = _x(cfg, 1, 8, seed=10, scale=1.0)
    jtile, (want, _) = _kept(JM, monkeypatch,
                             lambda: JM.moe_capacity(jp, cfg, jx, capacity))
    ttile, (got, _) = _kept(M, monkeypatch,
                            lambda: M.moe_capacity(tp, cfg, tx, capacity))
    x2 = np.asarray(tx).reshape(-1, cfg.d_model)
    jids, tids = _token_ids(jtile, x2), _token_ids(ttile, x2)
    np.testing.assert_array_equal(tids, jids)
    if capacity == 1:  # some pairs overflow
        assert int((tids < 8).sum()) < 8 * cfg.top_k
    _, topi, _ = M._router(tp, cfg, torch.from_numpy(x2))
    buf_t, _ = M.dispatch(cfg, topi, M.capacity_of(cfg, 8, capacity))
    np.testing.assert_array_equal(buf_t.numpy(), jids)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("name", MOE)
def test_top_k_ties_fall_lower_index_first(name, monkeypatch):
    """Router columns made equal tie every token's probabilities: top-k
    keeps the lower expert index first, as `jax.lax.top_k`, and the
    capacity dispatch keeps the reference's pairs."""
    cfg, jp, tp = _layer(name, seed=11)
    w = np.array(jp["router"]["w"])
    w[:, 1] = w[:, 0]
    w[:, 3] = w[:, 2]
    jp = dict(jp, router={"w": jnp.asarray(w)})
    tp = dict(tp, router={"w": torch.from_numpy(w)})
    jx, tx = _x(cfg, 1, 8, seed=11, scale=1.0)
    _, wi, _ = JM._router(jp, cfg, jx.reshape(-1, cfg.d_model))
    _, gi, _ = M._router(tp, cfg, tx.reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    jtile, (want, _) = _kept(JM, monkeypatch,
                             lambda: JM.moe_capacity(jp, cfg, jx, 1))
    ttile, (got, _) = _kept(M, monkeypatch,
                            lambda: M.moe_capacity(tp, cfg, tx, 1))
    x2 = np.asarray(tx).reshape(-1, cfg.d_model)
    np.testing.assert_array_equal(_token_ids(ttile, x2),
                                  _token_ids(jtile, x2))
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("name", MOE)
def test_capacity_equals_dense_when_ample(name):
    cfg, _, tp = _layer(name, seed=9)
    _, tx = _x(cfg, 2, 16, seed=9)
    yd, aux_d = M.moe_dense(tp, cfg, tx)
    yc, aux_c = M.moe_capacity(tp, cfg, tx, capacity=2 * 16 * cfg.top_k)
    assert _rel(yc, yd) < TOL
    np.testing.assert_allclose(float(aux_c), float(aux_d), rtol=AUX_RTOL)


@pytest.mark.parametrize("name", MOE)
def test_capacity_is_deterministic(name):
    """Two runs, overflow dropped (capacity 1), agree bit for bit."""
    cfg, _, tp = _layer(name, seed=10)
    _, tx = _x(cfg, 1, 8, seed=10, scale=1.0)
    y1, a1 = M.moe_capacity(tp, cfg, tx, capacity=1)
    y2, a2 = M.moe_capacity(tp, cfg, tx, capacity=1)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


@pytest.mark.parametrize("name", MOE)
def test_capacity_of_is_the_reference_expression(name):
    cfg = tcfg.get_arch(name)
    for T in (1, 4, 96, 4096):
        want = max(1, int(cfg.capacity_factor * T * cfg.top_k
                          / cfg.n_experts))
        assert M.capacity_of(cfg, T) == want
        assert M.capacity_of(cfg, T, 7) == 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", MOE)
def test_init_moe_tree_and_distributions(name, dtype):
    """The reference's leaves, shapes and dtypes (the router float32), the
    experts drawn one at a time with std 1/sqrt(d) and 1/sqrt(f)."""
    cfg = tcfg.get_arch(name).reduced()
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax.eval_shape(lambda k: JM.init_moe(k, cfg, jd),
                         jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    p = M.init_moe(gen, cfg, dtype)
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), p)
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), torch.float32 if a.dtype == jnp.float32
                   else torch.bfloat16), ref)
    assert got == want
    assert p["router"]["w"].dtype == torch.float32
    d, f = cfg.d_model, cfg.moe_d_ff
    for leaf, std in (("w_gate", d ** -0.5), ("w_up", d ** -0.5),
                      ("w_down", f ** -0.5)):
        w = p[leaf]["w"].float()
        assert abs(float(w.std()) - std) < 0.05 * std, leaf
        assert not torch.equal(w[0], w[1])   # a draw per expert
