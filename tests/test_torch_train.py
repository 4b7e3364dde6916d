"""PyTorch port vs the JAX package: training's backward and step.

* gradients: `value_and_grad` of the port's `loss_fn(remat=True)` against
  `jax.value_and_grad` of the reference's, every architecture at its
  reduced float32 config (B = 2, S = 16; prefix embeddings for
  paligemma, `src_embeds` for seamless), weights carried across through
  `params_from_numpy`.  Bound, per leaf: max |Δ| <= GRAD_TOL ·
  max |g_ref| + 1e-9;
* remat: `remat=True` against `remat=False`, loss and every gradient
  bit-equal on the CPU, for one architecture of each block kind;
* bfloat16: every gradient leaf of every architecture exists, has its
  parameter's dtype and is finite;
* steps: three steps of `launch.train.make_step` against the reference's
  `make_step(..., grad_compression=False, mesh=None)` from the same
  weights and the same `SyntheticTokens` batches: losses within LOSS_TOL,
  m and v within MOMENT_TOL of each leaf's largest |value|, and the
  update params and master took from the start within STEP_TOL of the
  leaf's largest update (`_torch_port.update_errors`), but for a counted
  few entries whose gradient is within float32 noise of zero (FLIP).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (fixture)
from _torch_port import update_errors

import repro.configs as jcfg
from repro import optim as joptim
from repro.launch.train import make_step as jmake_step
from repro.models import build as jbuild

import repro_torch.configs as tcfg
from repro_torch import optim
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.train import make_step
from repro_torch.models import build, params_from_numpy, value_and_grad
from repro_torch.models.scan_util import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = sorted(jcfg.ARCHS)
#: gradients, per leaf, relative to the leaf's largest |g_ref|: the
#: measured errors are at most 3.4e-6 (gemma3-1b); float32 sums in
#: another order
GRAD_TOL = 2e-5
#: the three steps' losses, relative
LOSS_TOL = 1e-6
#: m and v after three steps, relative to the leaf's largest |value|:
#: they are sums of the gradients (and their squares)
MOMENT_TOL = 2e-5
#: the update of params and master over the three steps, relative to the
#: leaf's largest update, beyond one float32 ulp of the value per step.
#: AdamW divides each entry's step by that entry's own gradient size, so
#: the gradients' float32 noise grows where a gradient is small: measured
#: at most 1.04e-5 here (internlm2-1.8b), 3.0e-4 between an H100 and the
#: CPU for these architectures (seamless); a missing, halved or reversed
#: last step is 0.2 or more
STEP_TOL = 1e-3
#: an entry whose reference gradient at some step is within GRAD_TOL of
#: the leaf's largest |g| may move by up to FLIP times the summed
#: learning rates instead (AdamW's step there, lr · m̂ / (sqrt(v̂) + eps),
#: hangs on that noise); at most FLIP_SHARE of the entries may need it
#: (measured: 1 to 3 entries of 93,504 to 238,336, at most 2.5 % of the
#: summed learning rates off)
FLIP = 2.0
FLIP_SHARE = 1e-4


def _model(name, seed=3, dtype=None):
    """(cfg, jax bundle, jax params, port bundle, port params), the
    port's weights carried from the JAX init."""
    cfg = jcfg.ARCHS[name].reduced()
    tc = tcfg.ARCHS[name].reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype)
    jb = jbuild(cfg)
    jp = jb.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jb, jp, build(tc), tp


def _batch(cfg, B=2, S=16, seed=0):
    """A numpy batch: tokens, labels, and the model's extra inputs."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.n_prefix_tokens:
        out["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.prefix_dim)) * 0.1).astype(np.float32)
    if cfg.is_encdec:
        out["src_embeds"] = (rng.standard_normal(
            (B, S, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss(bundle, **kw):
    return lambda p, batch: bundle.loss_fn(p, batch, **kw)[0]


def _abs_err(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)))


@pytest.mark.parametrize("name", ARCHS)
def test_gradients_equal_reference(name):
    cfg, jb, jp, tb, tp = _model(name)
    batch = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(_loss(jb, remat=True)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = value_and_grad(_loss(tb, remat=True))(tp, _torch(batch))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(tleaves) == len(jleaves) == len(tree_leaves(tp))
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        bound = GRAD_TOL * float(np.max(np.abs(np.asarray(b)))) + 1e-9
        assert _abs_err(a, b) <= bound, (name, i)


#: one architecture of each block kind (MoE with MLA: deepseek-v3)
KINDS = {"dense_uniform": "internlm2-1.8b", "gemma_period": "gemma3-1b",
         "moe_uniform+mla": "deepseek-v3-671b", "mamba_uniform": "mamba2-370m",
         "zamba_period": "zamba2-7b", "encdec": "seamless-m4t-large-v2"}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_remat_bit_equal(kind):
    cfg = tcfg.ARCHS[KINDS[kind]].reduced()
    b = build(cfg)
    params = b.init(5, device="cpu")
    batch = _torch(_batch(cfg, seed=1))
    l0, g0 = value_and_grad(_loss(b, remat=False))(params, batch)
    l1, g1 = value_and_grad(_loss(b, remat=True))(params, batch)
    assert torch.equal(l0, l1)
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_gradients_finite(name):
    cfg = dataclasses.replace(tcfg.ARCHS[name].reduced(), dtype="bfloat16")
    b = build(cfg)
    params = b.init(1, device="cpu")
    loss, grads = value_and_grad(_loss(b, remat=True))(
        params, _torch(_batch(cfg, seed=2)))
    assert torch.isfinite(loss)
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        assert g.shape == p.shape and g.dtype == p.dtype
        assert torch.isfinite(g).all()


def _launcher_batches(cfg, B, S, steps, seed=0):
    """The launcher's batches (`launch.train._host_batch`): SyntheticTokens,
    zero prefix embeddings, `src_embeds` from `default_rng(step)`."""
    data = SyntheticTokens(cfg.vocab, S, B, seed=seed)
    out = []
    for step in range(steps):
        b = dict(data.batch(step))
        if cfg.n_prefix_tokens:
            b["prefix_embeds"] = np.zeros(
                (B, cfg.n_prefix_tokens, cfg.prefix_dim), np.float32)
        if cfg.is_encdec:
            b["src_embeds"] = np.random.default_rng(step).normal(
                size=(B, S, cfg.d_model)).astype(np.float32) * 0.1
        out.append(b)
    return out


STEP_ARCHS = ["internlm2-1.8b", "llama4-scout-17b-a16e", "mamba2-370m",
              "paligemma-3b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_steps_equal_reference(name):
    cfg, jb, jp, tb, tp = _model(name, seed=0)
    ocfg = optim.AdamWConfig(total_steps=10)
    jocfg = joptim.AdamWConfig(total_steps=10)
    jstate = joptim.init(jp, jocfg)
    # de-alias, as the reference's launcher does before donating
    jp = jax.tree_util.tree_map(lambda x: x.copy(), jp)
    jstate = jax.tree_util.tree_map(lambda x: x.copy(), jstate)
    jstep = jmake_step(jb, jocfg, cfg, False, None)
    # the reference's gradient at each step, for `update_errors`
    jgrad = jax.jit(jax.grad(_loss(jb, remat=True)))
    tstate = optim.init(tp, ocfg)
    tstep = make_step(tb, ocfg, tcfg.ARCHS[name].reduced(), False, None)
    start = [t.clone() for t in tree_leaves(tp)]
    lrs, grads = 0.0, []
    for i, batch in enumerate(_launcher_batches(cfg, 2, 32, 3)):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        grads.append(jax.tree_util.tree_leaves(jgrad(jp, jbatch)))
        jp, jstate, jl = jstep(jp, jstate, jbatch)
        tp, tstate, tl = tstep(tp, tstate, _torch(batch))
        assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl)), i
        lrs += float(optim.cosine_lr(ocfg, i + 1))
    assert int(tstate.step) == int(jstate.step) == 3
    for what, t, j in (("params", tp, jp),
                       ("master", tstate.master, jstate.master)):
        worst, near_worst, used, total = update_errors(
            tree_leaves(t), jax.tree_util.tree_leaves(j), start, grads,
            GRAD_TOL, STEP_TOL)
        assert worst <= STEP_TOL, (what, worst)
        assert near_worst <= FLIP * lrs, (what, near_worst / lrs)
        assert used <= FLIP_SHARE * total, (what, used, total)
    for what, t, j in (("m", tstate.m, jstate.m), ("v", tstate.v, jstate.v)):
        for k, (a, b) in enumerate(zip(tree_leaves(t),
                                       jax.tree_util.tree_leaves(j))):
            bound = MOMENT_TOL * float(np.max(np.abs(np.asarray(b))))
            assert _abs_err(a, b) <= bound, (what, k)
