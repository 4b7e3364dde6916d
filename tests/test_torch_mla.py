"""PyTorch port vs the JAX package: Multi-head Latent Attention.

`repro_torch.models.attention` against `repro.models.attention` at
deepseek-v3's reduced config, on the CPU.  Parameters are the JAX
package's `init_mla` output (or the model's) carried across through
`params_from_numpy`; inputs are made from a seed with numpy.

Tolerances (relative to the largest magnitude of the reference's output):

* `mla_attention`, naive and absorbed, with and without a cache, and the
  cache it writes: 5e-5;
* absorbed decode against naive decode over 10 steps of the model:
  1e-4, the reference's own `test_mla_absorbed_equals_naive`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (fixture)

import repro.configs as jcfg
import repro.models.attention as JA
from repro.models import build as jbuild
from repro.models import layers as JL

import repro_torch.configs as tcfg
from repro_torch.models import attention as A
from repro_torch.models import build, layers as L, params_from_numpy

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAME = "deepseek-v3-671b"
TOL = 5e-5
ABSORBED_TOL = 1e-4


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _mla(seed=8):
    cfg = jcfg.ARCHS[NAME].reduced()
    jp = JA.init_mla(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _ropes(cfg, S, offset=0):
    dr = cfg.qk_rope_head_dim
    return (L.rope_tables(S, dr, cfg.rope_theta, offset=offset),
            JL.rope_tables(S, dr, cfg.rope_theta, offset=offset))


def _x(cfg, B, S, seed):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_without_cache_matches_reference(absorbed):
    cfg, jp, tp = _mla()
    jx, tx = _x(cfg, 2, 12, seed=0)
    trope, jrope = _ropes(cfg, 12)
    want, wc = JA.mla_attention(jp, cfg, jx, jrope, absorbed=absorbed)
    got, gc = A.mla_attention(tp, cfg, tx, trope, absorbed=absorbed)
    assert wc is None and gc is None
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_with_cache_matches_reference(absorbed):
    """A block of 5 at 0, single tokens at 5..7, then a block that runs
    past the cache's end and one at a negative start (both placed as
    `dynamic_update_slice` places them): outputs and the cache, written
    in place and returned."""
    cfg, jp, tp = _mla(seed=3)
    jc = JA.init_mla_cache(cfg, 2, 10, jnp.float32)
    tc = A.init_mla_cache(cfg, 2, 10, torch.float32)
    ckv = tc["ckv"]
    for step, (pos, S) in enumerate([(0, 5), (5, 1), (6, 1), (7, 1),
                                     (8, 3), (-2, 2)]):
        jx, tx = _x(cfg, 2, S, seed=10 + step)
        trope, jrope = _ropes(cfg, S, offset=pos)
        want, jc = JA.mla_attention(jp, cfg, jx, jrope, cache=jc,
                                    pos=jnp.int32(pos), absorbed=absorbed)
        got, out = A.mla_attention(tp, cfg, tx, trope, cache=tc, pos=pos,
                                   absorbed=absorbed)
        assert out is tc and out["ckv"] is ckv
        assert _rel(got, want) < TOL, (pos, S)
        assert _rel(tc["ckv"], jc["ckv"]) < TOL
        assert _rel(tc["krope"], jc["krope"]) < TOL


def test_absorbed_decode_equals_naive():
    """The reference's `test_mla_absorbed_equals_naive` on the port: the
    model decoded 10 steps naive and absorbed (moe_path="dense")."""
    cfg = tcfg.get_arch(NAME).reduced()
    b = build(cfg)
    jb = jbuild(jcfg.ARCHS[NAME].reduced())
    jp = jb.init(jax.random.PRNGKey(8))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 10)))
    res = {}
    for absorbed in (False, True):
        caches = b.cache_init(2, 10, device="cpu")
        outs = []
        for t in range(10):
            lg, caches = b.decode_fn(params, toks[:, t:t + 1], caches, t,
                                     moe_path="dense", mla_absorbed=absorbed)
            outs.append(lg[:, 0])
        res[absorbed] = torch.stack(outs, 1)
    assert _rel(res[True], res[False]) < ABSORBED_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_mla_tree_and_cache(dtype):
    cfg = tcfg.get_arch(NAME).reduced()
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax.eval_shape(lambda k: JA.init_mla(k, cfg, jd),
                         jax.random.PRNGKey(0))
    p = A.init_mla(torch.Generator().manual_seed(0), cfg, dtype)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), p) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    assert all(t.dtype == dtype for t in jax.tree_util.tree_leaves(p))
    assert torch.all(p["q_norm"]["scale"] == 1)
    c = A.init_mla_cache(cfg, 3, 7, dtype)
    jc = JA.init_mla_cache(cfg, 3, 7, jd)
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert all(int(v.count_nonzero()) == 0 for v in c.values())
