"""PyTorch port vs the JAX package: the Mamba2 (SSD) block.

`repro_torch.models.ssm` against `repro.models.ssm` at mamba2-370m's
reduced config, on the CPU.  Parameters are the JAX package's
`init_mamba` output carried across through `params_from_numpy`; inputs
are made from a seed with numpy.

Tolerances (relative to the largest magnitude of the reference's output):

* `mamba_chunked` at chunk 4, 8 and 16 against the reference and against
  the port's `mamba_sequential_ref`, its final state and a run from an
  initial state: 2e-5 (the reference's own
  `test_mamba_chunked_matches_sequential`);
* `mamba_step` and the cache it writes: 2e-5;
* the prefill-state handoff (the reference's
  `test_mamba_prefill_state_handoff`): 3e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (fixture)

import repro.configs as jcfg
import repro.models.ssm as JS

import repro_torch.configs as tcfg
from repro_torch.models import build, params_from_numpy
from repro_torch.models import ssm as S

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAME = "mamba2-370m"
TOL = 2e-5
HANDOFF_TOL = 3e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _block(seed=6):
    cfg = jcfg.ARCHS[NAME].reduced()
    jp = JS.init_mamba(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _x(cfg, B, T, seed, scale=0.5):
    x = (np.random.default_rng(seed).standard_normal((B, T, cfg.d_model))
         * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_matches_reference_and_sequential(chunk):
    cfg, jp, tp = _block()
    jx, tx = _x(cfg, 2, 32, seed=6)
    want = JS.mamba_chunked(jp, cfg, jx, chunk=chunk)
    got = S.mamba_chunked(tp, cfg, tx, chunk=chunk)
    assert _rel(got, want) < TOL
    seq = S.mamba_sequential_ref(tp, cfg, tx)
    assert _rel(got, seq) < TOL
    assert _rel(seq, JS.mamba_sequential_ref(jp, cfg, jx)) < TOL


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_state_in_and_out_match_reference(chunk):
    """`return_state` gives the reference's final state; a run from it as
    `initial_state` gives the reference's continuation."""
    cfg, jp, tp = _block(seed=2)
    jx, tx = _x(cfg, 2, 32, seed=2)
    want, wstate = JS.mamba_chunked(jp, cfg, jx[:, :16], chunk=chunk,
                                    return_state=True)
    got, state = S.mamba_chunked(tp, cfg, tx[:, :16], chunk=chunk,
                                 return_state=True)
    assert state.dtype == torch.float32
    assert _rel(got, want) < TOL and _rel(state, wstate) < TOL
    want = JS.mamba_chunked(jp, cfg, jx[:, 16:], chunk=chunk,
                            initial_state=wstate)
    got = S.mamba_chunked(tp, cfg, tx[:, 16:], chunk=chunk,
                          initial_state=state)
    assert _rel(got, want) < TOL


def test_mamba_step_matches_reference():
    """Ten decode steps: outputs and the cache, written in place."""
    cfg, jp, tp = _block(seed=5)
    jx, tx = _x(cfg, 2, 10, seed=5)
    jc = JS.init_mamba_cache(cfg, 2, jnp.float32)
    tc = S.init_mamba_cache(cfg, 2, torch.float32)
    state = tc["state"]
    for t in range(10):
        want, jc = JS.mamba_step(jp, cfg, jx[:, t:t + 1], jc)
        got, out = S.mamba_step(tp, cfg, tx[:, t:t + 1], tc)
        assert out is tc and out["state"] is state
        assert _rel(got, want) < TOL, t
        assert _rel(tc["conv"], jc["conv"]) < TOL
        assert _rel(tc["state"], jc["state"]) < TOL


def test_prefill_state_handoff():
    """The reference's `test_mamba_prefill_state_handoff` on the port:
    chunked(return_state) gives the state that 16 steps build, and the
    stepped cache then continues the sequential oracle exactly."""
    cfg, jp, tp = _block(seed=7)
    _, tx = _x(cfg, 1, 24, seed=7)
    full = S.mamba_sequential_ref(tp, cfg, tx)
    _, state = S.mamba_chunked(tp, cfg, tx[:, :16], chunk=8,
                               return_state=True)
    cache = S.init_mamba_cache(cfg, 1, torch.float32)
    for t in range(16):
        _, cache = S.mamba_step(tp, cfg, tx[:, t:t + 1], cache)
    assert _rel(cache["state"], state) < HANDOFF_TOL
    outs = []
    for t in range(16, 24):
        y, cache = S.mamba_step(tp, cfg, tx[:, t:t + 1], cache)
        outs.append(y[:, 0])
    assert _rel(torch.stack(outs, 1), full[:, 16:]) < HANDOFF_TOL


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-7b"])
def test_block_into_a_mamba_cache_raises(name):
    """A mamba cache takes one token a step (the reference's `mamba_step`
    too); a block of more than one raises ValueError saying so, and a
    chunk that does not divide the sequence raises too."""
    cfg, _, tp = _block()
    tc = S.init_mamba_cache(cfg, 1, torch.float32)
    with pytest.raises(ValueError, match="one token a step"):
        S.mamba_step(tp, cfg, torch.zeros(1, 2, cfg.d_model), tc)
    with pytest.raises(ValueError, match="whole number of chunks"):
        S.mamba_chunked(tp, cfg, torch.zeros(1, 12, cfg.d_model), chunk=8)
    b = build(tcfg.get_arch(name).reduced())
    params = b.init(0, device="cpu")
    caches = b.cache_init(2, 8, device="cpu")
    with pytest.raises(ValueError, match="one token a step"):
        b.decode_fn(params, torch.zeros(2, 3, dtype=torch.long), caches, 0)


def test_dtypes_are_the_reference_s():
    """In bfloat16 the float32 leaves stay float32, the cache's state is
    float32 and its conv window bf16; `_causal_conv` runs in the input's
    dtype, `mamba_step` in float32 to the output projection."""
    cfg = dataclasses.replace(tcfg.get_arch(NAME).reduced(),
                              dtype="bfloat16")
    jd = jax.eval_shape(lambda k: JS.init_mamba(k, cfg, jnp.bfloat16),
                        jax.random.PRNGKey(0))
    p = S.init_mamba(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                                  p) == \
        jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), "torch." + str(a.dtype)), jd)
    for leaf in ("A_log", "D", "dt_bias"):
        assert p[leaf].dtype == torch.float32
    c = S.init_mamba_cache(cfg, 2, torch.bfloat16)
    assert c["state"].dtype == torch.float32
    assert c["conv"].dtype == torch.bfloat16
    x = torch.randn(2, 5, S._dims(cfg)[-1]).to(torch.bfloat16)
    assert S._causal_conv(p, cfg, x).dtype == torch.bfloat16
    y, c = S.mamba_step(p, cfg, torch.randn(2, 1, cfg.d_model)
                        .to(torch.bfloat16), c)
    assert y.dtype == torch.bfloat16 and c["state"].dtype == torch.float32
