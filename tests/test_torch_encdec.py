"""PyTorch port vs the JAX package: the encoder-decoder (seamless-m4t).

`repro_torch.models.encdec` and its `model_zoo` bundle against
`repro.models.encdec` at the reduced config on the CPU, with the JAX
package's `init` output carried across through `params_from_numpy`;
inputs are made from a seed with numpy.

Tolerances (relative to the largest magnitude of the reference's output):

* parameter and cache trees, `param_count`: EQUAL;
* `encode`, `encdec_forward`, `prefill_fn`, `loss_fn` and the decode
  steps at float32: MODEL_TOL = 5e-5, the bar of the decoder models;
* decode against the forward, token by token: < 1e-4 absolute, the bar
  of the reference's own `test_encdec_decode_matches_forward`;
* bfloat16: BF16_TOL against JAX's bfloat16 run, and no further from a
  float32 run of the same weights than BF16_VS_F32 times the
  reference's own distance (the decoder models' bar).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401 (fixtures)
    CPU, needs_cuda, one_torch_thread, require_cuda)

import repro.configs as jcfg
from repro.models import build as jbuild
from repro.models import encdec as JED
from repro.models import model_zoo as JZ

import repro_torch.configs as tcfg
from repro_torch.models import (
    build, param_count, params_from_numpy, params_to_numpy)
from repro_torch.models import encdec as ED

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAME = "seamless-m4t-large-v2"
MODEL_TOL = 5e-5
DECODE_ATOL = 1e-4
BF16_TOL = 6e-2
BF16_VS_F32 = 1.5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _cfgs(dtype=None):
    cfg, tc = jcfg.ARCHS[NAME].reduced(), tcfg.get_arch(NAME).reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype)
    return cfg, tc


def _model(seed=5, dtype=None):
    """(cfg, jax bundle, jax params, port bundle, port params), the port's
    weights carried from the JAX init."""
    cfg, tc = _cfgs(dtype)
    jb = jbuild(cfg)
    jp = jb.init(jax.random.PRNGKey(seed))
    tb = build(tc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jb, jp, tb, tp


def _inputs(cfg, B, S, Sm, seed=0):
    """(src embeddings, target tokens) for both packages."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((B, Sm, cfg.d_model)) * 0.3).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S))
    return ((jnp.asarray(src), jnp.asarray(toks, jnp.int32)),
            (torch.from_numpy(src), torch.from_numpy(toks)))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_param_tree_equals_reference(dtype):
    """The port's own init: the reference's tree, shapes, dtypes and
    count, and its distributions (norms ones, embedding std 0.02, linears
    std 1/sqrt(d_in)); a seed gives the same tree, another another."""
    cfg, tc = _cfgs(dtype)
    jp = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
    tp = build(tc).init(0, device="cpu")
    assert _structure(tp) == _structure(jp)
    assert param_count(tp) == JZ.param_count(jp)
    for k in ("enc_norm", "final_norm"):
        assert torch.all(tp[k]["scale"] == 1)
    assert abs(float(tp["embed"]["w"].float().std()) - 0.02) < 0.002
    want = 1 / np.sqrt(cfg.d_model)
    for w in (tp["enc"]["attn"]["wq"]["w"],
              tp["dec"]["cross_attn"]["wk"]["w"]):
        assert abs(float(w.float().std()) - want) < 0.1 * want
    # the stacked layers are drawn one by one, not copies of one layer
    assert not torch.equal(tp["dec"]["mlp"]["up"]["w"][0],
                           tp["dec"]["mlp"]["up"]["w"][1])
    again = build(tc).init(0, device="cpu")
    other = build(tc).init(1, device="cpu")
    assert torch.equal(again["dec"]["self_attn"]["wq"]["w"],
                       tp["dec"]["self_attn"]["wq"]["w"])
    assert not torch.equal(other["embed"]["w"], tp["embed"]["w"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_numpy_round_trip_is_bit_exact(dtype):
    _, _, jp, _, tp = _model(dtype=dtype)
    host = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(host)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(host)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("full", [False, True])
def test_cache_trees_equal_reference(full):
    """`cache_init` (self caches of max_seq, cross caches of mem_len) and
    `encdec_prime_cross` (cross K/V of the memory's length Sm, the self
    entry the caches' own) give the reference's trees, at the reduced
    config and at the published one."""
    cfg = jcfg.ARCHS[NAME] if full else jcfg.ARCHS[NAME].reduced()
    tc = tcfg.get_arch(NAME) if full else tcfg.get_arch(NAME).reduced()
    jb, tb = jbuild(cfg), build(tc)
    want = jax.eval_shape(lambda: jb.cache_init(2, 16))
    got = tb.cache_init(2, 16, device="meta")
    assert _structure(got) == _structure(want)
    if full:
        return
    jp = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    mem = jax.ShapeDtypeStruct((2, 6, cfg.d_model), jnp.float32)
    want = jax.eval_shape(
        lambda p, m: JED.encdec_prime_cross(p, cfg, m, jb.cache_init(2, 16)),
        jp, mem)
    tp = tb.init(0, device="cpu")
    caches = tb.cache_init(2, 16, device="cpu")
    primed = ED.encdec_prime_cross(tp, tc, torch.zeros(2, 6, tc.d_model),
                                   caches)
    assert _structure(primed) == _structure(want)
    assert primed["self"] is caches["self"]


def test_cache_layers_are_distinct():
    """Every layer of the stacked caches has its own storage: a write into
    layer 0 leaves layer 1 as it was (a broadcast view would not)."""
    tb = build(tcfg.get_arch(NAME).reduced())
    caches = tb.cache_init(2, 8, device="cpu")
    for part in ("self", "cross"):
        for t in caches[part].values():
            assert t.stride(0) > 0
            t[0].fill_(1.0)
            assert float(t[1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the model at float32
# ---------------------------------------------------------------------------

def test_encode_and_forward_match_reference():
    cfg, jb, jp, tb, tp = _model()
    (js, jt), (ts, tt) = _inputs(cfg, 2, 12, 7)
    assert _rel(_np(ED.encode(tp, tb.cfg, ts)),
                _np(JED.encode(jp, cfg, js))) < MODEL_TOL
    want, _ = JED.encdec_forward(jp, cfg, js, jt)
    got, aux = ED.encdec_forward(tp, tb.cfg, ts, tt)
    assert _rel(_np(got), _np(want)) < MODEL_TOL
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    # the bundle: prefill_fn is the encoder memory, not primed caches
    mem, aux = tb.prefill_fn(tp, {"src_embeds": ts})
    jmem, jaux = jb.prefill_fn(jp, {"src_embeds": js})
    assert _rel(_np(mem), _np(jmem)) < MODEL_TOL
    assert float(aux) == float(jaux) == 0.0
    batch = {"src_embeds": ts, "tokens": tt, "labels": tt}
    jbatch = {"src_embeds": js, "tokens": jt, "labels": jt}
    loss, _ = tb.loss_fn(tp, batch)
    jloss, _ = jb.loss_fn(jp, jbatch)
    assert abs(float(loss) - float(jloss)) <= MODEL_TOL * abs(float(jloss))


def test_decode_matches_forward_and_reference():
    """The reference's `test_encdec_decode_matches_forward` on the port
    (B, S, Sm = 2, 10, 6: decode token by token against primed cross
    caches, < 1e-4 of the forward), and each step's logits against the
    reference's decode on the same caches."""
    cfg, jb, jp, tb, tp = _model()
    B, S, Sm = 2, 10, 6
    (js, jt), (ts, tt) = _inputs(cfg, B, S, Sm, seed=1)
    want, _ = ED.encdec_forward(tp, tb.cfg, ts, tt)
    memory, _ = tb.prefill_fn(tp, {"src_embeds": ts})
    caches = ED.encdec_prime_cross(tp, tb.cfg, memory,
                                   ED.init_encdec_cache(tb.cfg, B, S, Sm,
                                                        device=CPU))
    jmem = JED.encode(jp, cfg, js)
    jc = JED.encdec_prime_cross(jp, cfg, jmem,
                                JED.init_encdec_cache(cfg, B, S, Sm))
    outs = []
    for t in range(S):
        lg, caches = tb.decode_fn(tp, tt[:, t:t + 1], caches, t)
        jl, jc = jb.decode_fn(jp, jt[:, t:t + 1], jc, jnp.int32(t))
        assert _rel(_np(lg), _np(jl)) < MODEL_TOL, t
        outs.append(lg[:, 0])
    err = float((want - torch.stack(outs, 1)).abs().max())
    assert err < DECODE_ATOL
    for n in ("k", "v"):  # the self caches the steps wrote
        assert _rel(_np(caches["self"][n]), _np(jc["self"][n])) < MODEL_TOL


def test_decode_refuses_a_block():
    """A (B, S > 1) block into `decode_fn` raises ValueError.  The
    reference takes it but rotates every position of the block as `pos`
    (`rope_tables(1, ..., offset=pos)`), so its block result is not its
    forward: the refusal keeps the port from a silently wrong answer."""
    cfg, jb, jp, tb, tp = _model()
    B, S, Sm = 2, 6, 5
    (js, jt), (ts, tt) = _inputs(cfg, B, S, Sm, seed=2)
    caches = tb.cache_init(B, S, device="cpu")
    with pytest.raises(ValueError, match="one token a step"):
        tb.decode_fn(tp, tt, caches, 0)
    with pytest.raises(ValueError, match="one token a step"):
        ED.encdec_decode_step(tp, tb.cfg, tt[:, :2], caches, 0)
    want, _ = JED.encdec_forward(jp, cfg, js, jt)
    jc = JED.encdec_prime_cross(jp, cfg, JED.encode(jp, cfg, js),
                                jb.cache_init(B, S))
    block, _ = jb.decode_fn(jp, jt, jc, jnp.int32(0))
    assert _rel(_np(block[:, 0]), _np(want[:, 0])) < MODEL_TOL  # pos 0
    assert _rel(_np(block), _np(want)) > 1e-2


# ---------------------------------------------------------------------------
# bfloat16, the card, the defaults
# ---------------------------------------------------------------------------

def test_bf16_matches_reference():
    """The reduced config in bfloat16 against JAX's bfloat16 run: the
    forward within BF16_TOL and no further from float32 than BF16_VS_F32
    times the reference's own distance; 8 decode steps within BF16_TOL."""
    cfg, jb, jp, tb, tp = _model(seed=7, dtype="bfloat16")
    assert tp["embed"]["w"].dtype == torch.bfloat16
    B, S, Sm = 2, 8, 6
    (js, jt), (ts, tt) = _inputs(cfg, B, S, Sm, seed=7)
    want, _ = JED.encdec_forward(jp, cfg, js, jt)
    got, _ = ED.encdec_forward(tp, tb.cfg, ts, tt)
    assert got.dtype == torch.bfloat16
    assert _rel(_np(got), _np(want)) < BF16_TOL
    f32 = dataclasses.replace(cfg, dtype="float32")
    truth, _ = JED.encdec_forward(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp), f32,
        js, jt)
    assert _rel(_np(got), _np(truth)) <= \
        BF16_VS_F32 * _rel(_np(want), _np(truth))
    mem, _ = tb.prefill_fn(tp, {"src_embeds": ts})
    tc = ED.encdec_prime_cross(tp, tb.cfg, mem,
                               tb.cache_init(B, S, device="cpu"))
    jmem, _ = jb.prefill_fn(jp, {"src_embeds": js})
    jc = JED.encdec_prime_cross(jp, cfg, jmem, jb.cache_init(B, S))
    for t in range(S):
        tl, tc = tb.decode_fn(tp, tt[:, t:t + 1], tc, t)
        jl, jc = jb.decode_fn(jp, jt[:, t:t + 1], jc, jnp.int32(t))
        assert _rel(_np(tl), _np(jl)) < BF16_TOL, t


def test_build_serves_the_published_config():
    """`build` of the published seamless config returns its bundle (the
    refusal of earlier slices is gone)."""
    b = build(tcfg.get_arch(NAME))
    assert b.cfg.enc_layers == 24 and b.cfg.n_layers == 24
    assert all(callable(f) for f in (b.init, b.loss_fn, b.prefill_fn,
                                     b.decode_fn, b.cache_init))


def test_entry_points_default_to_the_card(monkeypatch):
    """Without `device=` and without CUDA, init and cache_init raise, as
    the decoders' do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = build(tcfg.get_arch(NAME).reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.cache_init(1, 8)
    assert b.init(0, device="cpu")["embed"]["w"].device == CPU
    assert b.cache_init(1, 8, device="cpu")["self"]["k"].device == CPU


@needs_cuda
def test_card_matches_cpu():
    """The reduced float32 config on the card gives the CPU's logits: the
    forward, the memory, and 8 decode steps against primed caches."""
    tb = build(tcfg.get_arch(NAME).reduced())
    tp = tb.init(0, device="cpu")
    dev = torch.device("cuda", 0)
    tpd = params_from_numpy(params_to_numpy(tp), device=dev)
    (_, _), (ts, tt) = _inputs(tb.cfg, 2, 8, 6, seed=3)
    want, _ = ED.encdec_forward(tp, tb.cfg, ts, tt)
    got, _ = ED.encdec_forward(tpd, tb.cfg, ts.to(dev), tt.to(dev))
    assert _rel(_np(got.cpu()), _np(want)) < 1e-4
    mc, _ = tb.prefill_fn(tp, {"src_embeds": ts})
    md, _ = tb.prefill_fn(tpd, {"src_embeds": ts.to(dev)})
    assert _rel(_np(md.cpu()), _np(mc)) < 1e-4
    cc = ED.encdec_prime_cross(tp, tb.cfg, mc, tb.cache_init(2, 8,
                                                              device="cpu"))
    cd = ED.encdec_prime_cross(tpd, tb.cfg, md, tb.cache_init(2, 8,
                                                               device=dev))
    for t in range(8):
        lc, cc = tb.decode_fn(tp, tt[:, t:t + 1], cc, t)
        ld, cd = tb.decode_fn(tpd, tt[:, t:t + 1].to(dev), cd, t)
        assert _rel(_np(ld.cpu()), _np(lc)) < 1e-4, t
