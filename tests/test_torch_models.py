"""PyTorch port vs the JAX package: the LM substrate's serve path.

`repro_torch.configs` and `repro_torch.models` (every decoder-only
architecture: `dense_uniform`, `gemma_period`, the paligemma prefix-LM
stub, `moe_uniform` with GQA or MLA attention, `mamba_uniform`,
`zamba_period`) against `repro.configs` and `repro.models`, at the
reduced configs on the CPU.  MoE models are held to the reference on
its default capacity path, and decode against the forward on the
"dense" path (the two paths' capacities drop different tokens), as the
reference's own `test_decode_matches_forward` does.  A mamba cache takes
one token a step, so mamba prompts go into the cache token by token.
Weights are the JAX package's `init` output carried across through
`params_from_numpy`; inputs are made from a seed with numpy.

Tolerances (relative to the largest magnitude of the reference's output):

* configs, layer plans, parameter trees, `param_count`, greedy token ids:
  EQUAL;
* layers (`linear`, `rmsnorm`, `swiglu`, RoPE, `sdpa` in every masking
  mode, `sdpa_banded`) at float32: 1e-5;
* the model at float32 (`lm_forward`, `prefill_fn(last_only=True)`,
  `cross_entropy`, `loss_fn`, block prefill then decode, the prefix-LM,
  ring and full caches past the window): 5e-5, the bar of the reference's
  own `test_decode_matches_forward`; the MoE aux loss: rtol 1e-5;
* the model in bfloat16: BF16_TOL (below), against JAX's bfloat16 run.
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
import repro.configs.bladyg_graph as jgraph
from repro.models import build as jbuild
from repro.models import layers as JL
from repro.models import model_zoo as JZ
from repro.models import moe as JM
from repro.models import transformer as JT

import repro_torch.configs as tcfg
import repro_torch.configs.bladyg_graph as tgraph
from repro_torch.models import (
    build, cross_entropy, param_count, params_from_numpy, params_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DENSE = ["internlm2-1.8b", "codeqwen1.5-7b", "granite-34b", "gemma3-1b",
         "paligemma-3b"]
#: the architectures of MoE, MLA, Mamba2 and the hybrid
NEW = ["deepseek-v3-671b", "llama4-scout-17b-a16e", "mamba2-370m",
       "zamba2-7b"]
DECODERS = DENSE + NEW
MOE = {"deepseek-v3-671b", "llama4-scout-17b-a16e"}
MAMBA = {"mamba2-370m", "zamba2-7b"}
AUX_RTOL = 1e-5
LAYER_TOL = 1e-5
MODEL_TOL = 5e-5
#: bfloat16 bar, relative to the largest |logit|.  The two packages round
#: bf16 at other points (XLA's CPU `logistic` in bf16 is not the rounded
#: float32 one that torch's is), so each differs from a float32 run of the
#: same weights by 1e-2..4e-2 at the reduced configs, and from each other
#: by as much; see `test_bf16_matches_reference` for the measured errors
BF16_TOL = 6e-2
#: ... and the port's bf16 error against float32 is at most this multiple
#: of the reference's own
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


def _model(name, seed=3, dtype=None):
    """(cfg, jax bundle, jax params, port bundle, port params) at the
    reduced config, the port's weights carried from the JAX init."""
    cfg = jcfg.ARCHS[name].reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jb = jbuild(cfg)
    jp = jb.init(jax.random.PRNGKey(seed))
    tc = tcfg.ARCHS[name].reduced()
    if dtype:
        tc = dataclasses.replace(tc, dtype=dtype)
    tb = build(tc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jb, jp, tb, tp


def _tokens(cfg, B, S, seed=0):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def _prefix(cfg, B, seed=1):
    if not cfg.n_prefix_tokens:
        return None, None
    p = (np.random.default_rng(seed).standard_normal(
        (B, cfg.n_prefix_tokens, cfg.prefix_dim)) * 0.1).astype(np.float32)
    return jnp.asarray(p), torch.from_numpy(p)


# ---------------------------------------------------------------------------
# configs and the layer plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jcfg.ARCHS))
def test_arch_config_equals_reference(name):
    ref, port = jcfg.ARCHS[name], tcfg.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    for c, r in ((port, ref), (port.reduced(), ref.reduced())):
        assert (c.hd, c.is_encdec, c.d_inner, c.n_ssm_heads) == \
            (r.hd, r.is_encdec, r.d_inner, r.n_ssm_heads)
    for shape in jcfg.SHAPES:
        assert tcfg.cell_applicable(port, tcfg.SHAPES_BY_NAME[shape.name]) \
            == jcfg.cell_applicable(ref, shape)
    # the plan of the full config and of the reduced one
    for c, r in ((port, ref), (port.reduced(), ref.reduced())):
        assert [dataclasses.asdict(b) for b in T.layer_plan(c)] == \
            [dataclasses.asdict(b) for b in JT.layer_plan(r)]


def test_registries_equal_reference():
    assert sorted(tcfg.ARCHS) == sorted(jcfg.ARCHS)
    assert [dataclasses.asdict(s) for s in tcfg.SHAPES] == \
        [dataclasses.asdict(s) for s in jcfg.SHAPES]
    assert {k: dataclasses.asdict(v) for k, v in
            tcfg.SHAPES_BY_NAME.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES_BY_NAME.items()}
    assert {k: dataclasses.asdict(v) for k, v in
            tgraph.GRAPH_TASKS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jgraph.GRAPH_TASKS.items()}
    with pytest.raises(KeyError):
        tcfg.get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# parameter tree, conversion, refusals
# ---------------------------------------------------------------------------

def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _first_input_linear(tree):
    """The first linear that reads the residual stream: `wq` (GQA), `wq_a`
    (MLA) or a mamba layer's `in_proj`."""
    if isinstance(tree, dict):
        for k in ("wq", "wq_a", "in_proj"):
            if k in tree:
                return tree[k]["w"]
        for v in tree.values():
            w = _first_input_linear(v)
            if w is not None:
                return w
    return None


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", DECODERS)
def test_param_tree_equals_reference(name, dtype):
    """The port's own init: the reference's tree, shapes, dtypes and
    count, and the reference's distributions (norms ones, embedding std
    0.02, linears std 1/sqrt(d_in))."""
    cfg = jcfg.ARCHS[name].reduced()
    tc = tcfg.ARCHS[name].reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype)
    jp = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
    tp = build(tc).init(0, device="cpu")
    assert _structure(tp) == _structure(jp)
    assert param_count(tp) == JZ.param_count(jp)
    assert torch.all(tp["final_norm"]["scale"] == 1)
    std = float(tp["embed"]["w"].float().std())
    assert abs(std - 0.02) < 0.002, std
    wq = _first_input_linear(tp["blocks"][0])
    want = 1 / np.sqrt(cfg.d_model)
    assert abs(float(wq.float().std()) - want) < 0.1 * want
    # a seed gives the same tree, another seed another
    again = build(tc).init(0, device="cpu")
    other = build(tc).init(1, device="cpu")
    assert torch.equal(again["embed"]["w"], tp["embed"]["w"])
    assert not torch.equal(other["embed"]["w"], tp["embed"]["w"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_numpy_round_trip_is_bit_exact(dtype):
    cfg, _, jp, _, tp = _model("gemma3-1b", dtype=dtype)
    host = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(host)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(host)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NEW)
def test_params_numpy_round_trip_new_leaves(name, dtype):
    """The MoE experts' (E, d, f) leaves and float32 router, the SSM's
    float32 leaves and zamba's top-level shared block carry across both
    ways bit for bit."""
    cfg, _, jp, _, tp = _model(name, dtype=dtype)
    host = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(host)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(host)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    last = tp["blocks"][-1]
    if name in MOE:
        assert last["moe"]["w_gate"]["w"].shape == \
            (last["ln1"]["scale"].shape[0], cfg.n_experts, cfg.d_model,
             cfg.moe_d_ff)
        assert last["moe"]["router"]["w"].dtype == torch.float32
    else:
        m = last["mamba"]["mamba"] if "mamba" in last["mamba"] \
            else last["mamba"]
        for leaf in ("A_log", "D", "dt_bias"):
            assert m[leaf].dtype == torch.float32
    assert ("shared_block" in tp) == (name == "zamba2-7b")


@pytest.mark.parametrize("name", NEW)
def test_cache_tree_equals_reference(name):
    """deepseek-v3, llama4-scout, mamba2 and zamba2 build, full and
    reduced, and their caches have the reference's tree, shapes and
    dtypes (MLA and mamba caches ignore `ring`, as there)."""
    for cfg in (jcfg.ARCHS[name], jcfg.ARCHS[name].reduced()):
        jb = jbuild(cfg)
        tb = build(tcfg.get_arch(name) if cfg.n_layers ==
                   jcfg.ARCHS[name].n_layers
                   else tcfg.get_arch(name).reduced())
        for ring in (False, True):
            want = jax.eval_shape(lambda: jb.cache_init(2, 16, ring=ring))
            got = tb.cache_init(2, 16, ring=ring, device="meta")
            assert _structure(got) == _structure(want), (cfg.name, ring)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without `device=` and without CUDA, init and cache_init raise, as
    `resolve_device` does; a generator on another device is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = build(tcfg.get_arch("internlm2-1.8b").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.cache_init(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        b.init(0, device="cuda")
    g = torch.Generator(device="cpu")
    assert b.init(g, device="cpu")["embed"]["w"].device == CPU
    with pytest.raises(ValueError, match="cannot draw"):
        b.init(g, device="meta")


# ---------------------------------------------------------------------------
# layers at float32
# ---------------------------------------------------------------------------

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_primitives_match_reference():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 24)
    w = {"w": _rand(rng, 24, 40) / 5}
    assert _rel(L.linear(params_from_numpy(w, "cpu"), torch.from_numpy(x)),
                JL.linear(w, jnp.asarray(x))) < LAYER_TOL
    s = {"scale": _rand(rng, 24)}
    assert _rel(L.rmsnorm(params_from_numpy(s, "cpu"), torch.from_numpy(x),
                          1e-6),
                JL.rmsnorm(s, jnp.asarray(x), 1e-6)) < LAYER_TOL
    m = {k: {"w": _rand(rng, *sh) / 5} for k, sh in
         (("gate", (24, 32)), ("up", (24, 32)), ("down", (32, 24)))}
    assert _rel(L.swiglu(params_from_numpy(m, "cpu"), torch.from_numpy(x)),
                JL.swiglu(m, jnp.asarray(x))) < LAYER_TOL
    e = {"w": _rand(rng, 50, 24)}
    ids = rng.integers(0, 50, (2, 7))
    np.testing.assert_array_equal(
        L.embed(params_from_numpy(e, "cpu"), torch.from_numpy(ids)).numpy(),
        np.asarray(JL.embed(e, jnp.asarray(ids))))


@pytest.mark.parametrize("offset", [0, 37])
def test_rope_matches_reference(offset):
    rng = np.random.default_rng(1)
    cos, sin = L.rope_tables(9, 16, 1e6, offset=offset)
    jcos, jsin = JL.rope_tables(9, 16, 1e6, offset=offset)
    assert _rel(cos, jcos) < LAYER_TOL and _rel(sin, jsin) < LAYER_TOL
    x = _rand(rng, 2, 9, 3, 16)
    assert _rel(L.apply_rope(torch.from_numpy(x), cos, sin),
                JL.apply_rope(jnp.asarray(x), jcos, jsin)) < LAYER_TOL


SDPA_CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=5),
    "prefix": dict(causal=True, prefix_len=4),
    "decode": dict(causal=True, q_offset=6, kv_len=9),
    "decode_window": dict(causal=True, window=4, q_offset=9, kv_len=12),
    # a ring of W = 8 slots at pos 11 (full) and pos 2 (slots 3.. unwritten)
    "ring": dict(causal=True, window=8, q_offset=11, kv_len=14,
                 key_positions=11 - (11 - np.arange(8)) % 8),
    "ring_cold": dict(causal=True, window=8, q_offset=2, kv_len=5,
                      key_positions=2 - (2 - np.arange(8)) % 8),
    "scale": dict(causal=True, softmax_scale=0.5),
}


@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_matches_reference(case):
    kw = dict(SDPA_CASES[case])
    rng = np.random.default_rng(2)
    Sq = 3 if "kv_len" in kw else 12
    Sk = 8 if "key_positions" in kw else 12
    q, k, v = (_rand(rng, 2, Sq, 4, 16), _rand(rng, 2, Sk, 2, 16),
               _rand(rng, 2, Sk, 2, 8))
    kp = kw.pop("key_positions", None)
    got = L.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), key_positions=None if kp is None
                 else torch.from_numpy(kp), **kw)
    want = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   key_positions=None if kp is None else jnp.asarray(kp),
                   **kw)
    assert got.shape == (2, Sq, 4, 8)
    assert _rel(got, want) < LAYER_TOL


@pytest.mark.parametrize("B,S,H,Hkv,D,W", [(2, 64, 4, 1, 16, 16),
                                           (1, 128, 4, 2, 32, 32)])
def test_sdpa_banded_equals_masked_full_and_reference(B, S, H, Hkv, D, W):
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, B, S, H, D), _rand(rng, B, S, Hkv, D),
               _rand(rng, B, S, Hkv, D))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    band = L.sdpa_banded(tq, tk, tv, W)
    assert _rel(band, L.sdpa(tq, tk, tv, causal=True, window=W)) < 2e-5
    assert _rel(band, JL.sdpa_banded(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), W)) < LAYER_TOL


def test_banded_switch(monkeypatch):
    monkeypatch.setenv("REPRO_NO_BANDED", "1")
    assert not L.banded_enabled() and not JL.banded_enabled()
    monkeypatch.delenv("REPRO_NO_BANDED")
    assert L.banded_enabled() and JL.banded_enabled()


def test_attention_cache_writes_clamp_like_dynamic_update_slice():
    """A block that would run past the cache's end is written at Smax - S
    and a negative start counts from the end (the reference's
    `dynamic_update_slice`), in place, and the returned cache is the one
    passed in."""
    cfg, jb, jp, tb, tp = _model("internlm2-1.8b")
    ap = jp["blocks"][0]["attn"]
    tap = tp["blocks"][0]["attn"]
    ap1 = jax.tree_util.tree_map(lambda a: a[0], ap)
    tap1 = {k: {"w": v["w"][0]} for k, v in tap.items()}
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 3, cfg.d_model)
    jc = JL.init_attention_cache(cfg, 2, 8, jnp.float32)
    tcache = L.init_attention_cache(cfg, 2, 8, torch.float32)
    k_before = tcache["k"]
    for pos in (0, 6, -2):
        cos, sin = L.rope_tables(3, cfg.hd, cfg.rope_theta, offset=pos)
        jcos, jsin = JL.rope_tables(3, cfg.hd, cfg.rope_theta, offset=pos)
        want, jc = JL.attention(ap1, cfg, jnp.asarray(x), (jcos, jsin),
                                cache=jc, pos=jnp.int32(pos))
        got, out = L.attention(tap1, cfg, torch.from_numpy(x), (cos, sin),
                               cache=tcache, pos=pos)
        assert out is tcache and out["k"] is k_before
        assert _rel(got, want) < LAYER_TOL
        assert _rel(tcache["k"], jc["k"]) < LAYER_TOL
        assert _rel(tcache["v"], jc["v"]) < LAYER_TOL


# ---------------------------------------------------------------------------
# the model at float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DECODERS)
def test_forward_matches_reference(name):
    """The forward, its aux loss (the MoE layers' added up), the serving
    forward, the loss and the cross-entropy; MoE models on both paths."""
    cfg, jb, jp, tb, tp = _model(name)
    jt, tt = _tokens(cfg, 2, 12)
    jpf, tpf = _prefix(cfg, 2)
    want, waux = JT.lm_forward(jp, cfg, jt, prefix_embeds=jpf, remat=False)
    got, aux = T.lm_forward(tp, tb.cfg, tt, prefix_embeds=tpf)
    assert _rel(got, want) < MODEL_TOL
    assert aux.dtype == torch.float32 and aux.shape == ()
    if name in MOE:
        assert float(waux) > 0
        np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)
        dwant, dwaux = JT.lm_forward(jp, cfg, jt, moe_path="dense",
                                     remat=False)
        dgot, daux = T.lm_forward(tp, tb.cfg, tt, moe_path="dense")
        assert _rel(dgot, dwant) < MODEL_TOL
        np.testing.assert_allclose(float(daux), float(dwaux), rtol=AUX_RTOL)
    else:
        assert float(aux) == float(waux) == 0.0
    batch_j = {"tokens": jt, "labels": jt}
    batch_t = {"tokens": tt, "labels": tt}
    if jpf is not None:
        batch_j["prefix_embeds"], batch_t["prefix_embeds"] = jpf, tpf
    last, _ = tb.prefill_fn(tp, batch_t, last_only=True)
    jlast, _ = jb.prefill_fn(jp, batch_j, last_only=True)
    assert last.shape == (2, 1, cfg.vocab)
    assert _rel(last, jlast) < MODEL_TOL
    assert _rel(last, got[:, -1:]) < 1e-6  # (B,1,D) vs (B,S,D) products
    loss, laux = tb.loss_fn(tp, batch_t)
    jloss, _ = jb.loss_fn(jp, batch_j)
    assert abs(float(loss) - float(jloss)) < MODEL_TOL * abs(float(jloss))
    assert float(laux) == float(aux)
    P = cfg.n_prefix_tokens
    ce = cross_entropy(got[:, P:-1], tt[:, 1:])
    jce = JZ.cross_entropy(want[:, P:-1], jt[:, 1:])
    assert abs(float(ce) - float(jce)) < MODEL_TOL * abs(float(jce))


def test_gemma3_forward_same_with_and_without_banded(monkeypatch):
    """64 = 2 windows of the reduced gemma3: the banded path runs, and
    changes nothing against the masked-full form or the reference."""
    cfg, jb, jp, tb, tp = _model("gemma3-1b", seed=13)
    jt, tt = _tokens(cfg, 2, 64)
    calls = []
    real = L.sdpa_banded
    monkeypatch.setattr(L, "sdpa_banded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    opt, _ = T.lm_forward(tp, tb.cfg, tt)
    assert len(calls) == 10  # the 4 local layers of each period, the tail 2
    monkeypatch.setenv("REPRO_NO_BANDED", "1")
    base, _ = T.lm_forward(tp, tb.cfg, tt)
    jbase, _ = JT.lm_forward(jp, cfg, jt, remat=False)
    assert len(calls) == 10
    monkeypatch.delenv("REPRO_NO_BANDED")
    jopt, _ = JT.lm_forward(jp, cfg, jt, remat=False)
    assert _rel(opt, base) < 2e-5
    assert _rel(opt, jopt) < MODEL_TOL and _rel(base, jbase) < MODEL_TOL


def _jdecode(jb, **kw):
    return jax.jit(lambda p, t, c, pos: jb.decode_fn(p, t, c, pos, **kw))


@pytest.mark.parametrize("name", [n for n in DECODERS if n not in MAMBA])
def test_serve_block_prefill_then_decode_matches_reference(name):
    """examples/serve_lm.py's path: the prompts prefilled into the cache
    in one block, then single-token decode; every step's logits against
    the reference's, and against the port's own forward (MoE models on
    the dense path: the capacity path's decode and forward drop other
    tokens)."""
    cfg, jb, jp, tb, tp = _model(name, seed=5)
    mp = "dense" if name in MOE else "capacity"
    B, Sp, G = 2, 10, 6
    P = cfg.n_prefix_tokens
    jt, tt = _tokens(cfg, B, Sp + G, seed=5)
    jpf, tpf = _prefix(cfg, B)
    jc = jb.cache_init(B, P + Sp + G)
    tc = tb.cache_init(B, P + Sp + G, device="cpu")
    want, jc = jb.decode_fn(jp, jt[:, :Sp], jc, jnp.int32(0),
                            prefix_embeds=jpf, moe_path=mp)
    got, tc2 = tb.decode_fn(tp, tt[:, :Sp], tc, 0, prefix_embeds=tpf,
                            moe_path=mp)
    assert tc2 is tc
    assert _rel(got, want) < MODEL_TOL
    outs = [got]
    dec = _jdecode(jb, moe_path=mp)
    for t in range(Sp, Sp + G):
        want, jc = dec(jp, jt[:, t:t + 1], jc, jnp.int32(P + t))
        got, tc = tb.decode_fn(tp, tt[:, t:t + 1], tc, P + t, moe_path=mp)
        assert _rel(got, want) < MODEL_TOL, t
        outs.append(got)
    fwd, _ = T.lm_forward(tp, tb.cfg, tt, prefix_embeds=tpf, moe_path=mp)
    assert _rel(torch.cat(outs, 1), fwd) < MODEL_TOL
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(tc)):
        assert _rel(b, a) < MODEL_TOL


@pytest.mark.parametrize("name",
                         [n for n in DECODERS if n != "paligemma-3b"])
def test_decode_matches_forward_token_by_token(name):
    """The reference's `test_decode_matches_forward` on the port: decode
    from position 0, one token at a time, equals the forward, both on the
    dense MoE path (the prefix-LM decodes after its prefix block:
    `test_prefix_lm_prefill_then_decode`)."""
    cfg, jb, jp, tb, tp = _model(name, seed=3)
    jt, tt = _tokens(cfg, 2, 12, seed=3)
    want, _ = JT.lm_forward(jp, cfg, jt, moe_path="dense", remat=False)
    tc = tb.cache_init(2, 12, device="cpu")
    outs = []
    for t in range(12):
        lg, tc = tb.decode_fn(tp, tt[:, t:t + 1], tc, t, moe_path="dense")
        outs.append(lg[:, 0])
    assert _rel(torch.stack(outs, 1), want) < MODEL_TOL


def test_prefix_lm_prefill_then_decode():
    cfg, jb, jp, tb, tp = _model("paligemma-3b", seed=4)
    B, S, P = 2, 10, cfg.n_prefix_tokens
    jt, tt = _tokens(cfg, B, S, seed=4)
    jpf, tpf = _prefix(cfg, B, seed=4)
    want, _ = JT.lm_forward(jp, cfg, jt, prefix_embeds=jpf, remat=False)
    want = want[:, P:]
    tc = tb.cache_init(B, P + S, device="cpu")
    half = S // 2
    lg, tc = tb.decode_fn(tp, tt[:, :half], tc, 0, prefix_embeds=tpf)
    outs = [lg[:, P + t] for t in range(half)]
    for t in range(half, S):
        lg, tc = tb.decode_fn(tp, tt[:, t:t + 1], tc, P + t)
        outs.append(lg[:, 0])
    assert _rel(torch.stack(outs, 1), want) < MODEL_TOL


def test_ring_and_full_caches_past_the_window():
    """gemma3's ring caches (W = 32 in the reduced config) against the
    full ones, the reference's and the forward, 48 steps from 0."""
    cfg, jb, jp, tb, tp = _model("gemma3-1b", seed=11)
    B, S = 2, 48
    assert S > cfg.sliding_window
    jt, tt = _tokens(cfg, B, S, seed=11)
    want, _ = JT.lm_forward(jp, cfg, jt, remat=False)
    dec = _jdecode(jb)
    got, sizes = {}, {}
    for ring in (False, True):
        jc = jb.cache_init(B, S, ring=ring)
        tc = tb.cache_init(B, S, ring=ring, device="cpu")
        assert _structure(tc) == _structure(jc)
        sizes[ring] = sum(x.numel() for x in
                          jax.tree_util.tree_leaves(tc))
        outs = []
        for t in range(S):
            jl, jc = dec(jp, jt[:, t:t + 1], jc, jnp.int32(t))
            lg, tc = tb.decode_fn(tp, tt[:, t:t + 1], tc, t)
            assert _rel(lg, jl) < MODEL_TOL, (ring, t)
            outs.append(lg[:, 0])
        got[ring] = torch.stack(outs, 1)
        assert _rel(got[ring], want) < MODEL_TOL
    assert _rel(got[True], got[False]) < MODEL_TOL
    assert sizes[True] < sizes[False]


def test_block_caches_are_distinct_layers():
    """A write into one layer's cache leaves every other layer's zero (no
    stride-0 views of one buffer)."""
    tb = build(tcfg.get_arch("gemma3-1b").reduced())
    caches = tb.cache_init(1, 4, device="cpu")
    for t in jax.tree_util.tree_leaves(caches):
        assert 0 not in t.stride()
        first = t[(0,) * (t.dim() - 4)]  # the first layer's (B, S, H, D)
        first.fill_(1)
        assert int(t.sum()) == first.numel()


@pytest.mark.parametrize("name", NEW)
def test_new_block_caches_are_distinct_layers(name):
    """The MLA, mamba and zamba caches are stacked zeros too: a write into
    the first layer's (or period's) slice leaves the rest zero."""
    tb = build(tcfg.get_arch(name).reduced())
    caches = tb.cache_init(1, 4, device="cpu")
    for t in jax.tree_util.tree_leaves(caches):
        assert 0 not in t.stride()
        assert int(t.count_nonzero()) == 0
        t[0].fill_(1)
        assert int(t.sum()) == t[0].numel()


def test_zamba_shared_block_is_one_parameter_set(monkeypatch):
    """zamba2's shared attention + MLP block is one parameter set: every
    period of the forward and of decode applies the same tensors (one
    storage).  At 2 periods and a tail of 3 mamba layers (the full
    model's plan, 13 periods + 3, in small) the port equals the
    reference."""
    cfg = dataclasses.replace(jcfg.ARCHS["zamba2-7b"].reduced(),
                              n_layers=15)
    tc = dataclasses.replace(tcfg.get_arch("zamba2-7b").reduced(),
                             n_layers=15)
    assert [(b.kind, b.count) for b in T.layer_plan(tc)] == \
        [("zamba_period", 2), ("mamba_uniform", 3)]
    jb, tb = jbuild(cfg), build(tc)
    jp = jb.init(jax.random.PRNGKey(12))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    assert _structure(tb.init(0, device="cpu")) == _structure(tp)
    seen = []
    real = T._apply_shared_block
    monkeypatch.setattr(T, "_apply_shared_block",
                        lambda p, *a, **k: seen.append(p) or real(p, *a, **k))
    jt, tt = _tokens(cfg, 2, 8, seed=12)
    want, _ = JT.lm_forward(jp, cfg, jt, remat=False)
    got, _ = T.lm_forward(tp, tc, tt)
    assert _rel(got, want) < MODEL_TOL
    caches = tb.cache_init(2, 8, device="cpu")
    outs, _ = _fill(tb.decode_fn, tp, tt, caches, "zamba2-7b")
    assert _rel(outs, want) < MODEL_TOL
    assert len(seen) == 2 * (1 + 8)  # 2 periods: the forward, 8 steps
    shared = jax.tree_util.tree_leaves(tp["shared_block"])
    for p in seen:
        for a, b in zip(jax.tree_util.tree_leaves(p), shared):
            assert a is b and a.data_ptr() == b.data_ptr()


def _fill(decode, params, toks, caches, name, pos=int, **kw):
    """The prompt into the caches: one block, or for a mamba model token
    by token (a mamba cache takes one token a step, in both packages).
    Returns (logits of every prompt position, caches)."""
    if name not in MAMBA:
        return decode(params, toks, caches, pos(0), **kw)
    outs = []
    for t in range(toks.shape[1]):
        lg, caches = decode(params, toks[:, t:t + 1], caches, pos(t), **kw)
        outs.append(lg)
    cat = torch.cat if isinstance(outs[0], torch.Tensor) else \
        jnp.concatenate
    return cat(outs, 1), caches


@pytest.mark.parametrize("name", ["internlm2-1.8b", "gemma3-1b",
                                  "paligemma-3b"] + NEW)
def test_greedy_ids_equal_reference(name):
    """8 greedy steps after the prompt (a block prefill; mamba models
    token by token): the same token ids.  MoE models on the capacity
    path."""
    cfg, jb, jp, tb, tp = _model(name, seed=6)
    B, Sp, G = 3, 9, 8
    P = cfg.n_prefix_tokens
    jt, tt = _tokens(cfg, B, Sp, seed=6)
    jpf, tpf = _prefix(cfg, B, seed=6)
    jc = jb.cache_init(B, P + Sp + G)
    tc = tb.cache_init(B, P + Sp + G, device="cpu")
    dec = _jdecode(jb)
    kw = {"prefix_embeds": jpf} if P else {}
    jl, jc = _fill(dec if name in MAMBA else jb.decode_fn, jp, jt, jc,
                   name, jnp.int32, **kw)
    tl, tc = _fill(tb.decode_fn, tp, tt, tc, name,
                   prefix_embeds=tpf)
    jids, tids = [], []
    for t in range(P + Sp, P + Sp + G):
        jn = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tn = torch.argmax(tl[:, -1], dim=-1)[:, None]
        jids.append(np.asarray(jn))
        tids.append(tn.numpy())
        jl, jc = dec(jp, jn, jc, jnp.int32(t))
        tl, tc = tb.decode_fn(tp, tn, tc, t)
    np.testing.assert_array_equal(np.concatenate(tids, 1),
                                  np.concatenate(jids, 1))


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

class _Replay:
    """For a MoE model: record the expert ids the reference's router picks
    (an ordered `jax.debug.callback`, so they arrive from inside its layer
    scan in layer order) and make the port's router pick the same ids,
    call for call, weighted by its own probabilities.  Without experts, a
    plain call."""

    def __init__(self, monkeypatch, moe: bool):
        self.ids = []
        if not moe:
            return
        real_j, real_t = JM._router, M._router

        def ref_router(p, cfg, x):
            out = real_j(p, cfg, x)
            jax.debug.callback(self._record, out[1], ordered=True)
            return out

        def port_router(p, cfg, x):
            _, _, aux = real_t(p, cfg, x)
            topi = torch.from_numpy(self.ids.pop(0)).to(x.device)
            probs = torch.softmax(x.float() @ p["router"]["w"].float(), -1)
            topv = probs.gather(1, topi)
            return topv / topv.sum(-1, keepdim=True), topi, aux
        monkeypatch.setattr(JM, "_router", ref_router)
        monkeypatch.setattr(M, "_router", port_router)

    def _record(self, ids):
        if self.keep:
            self.ids.append(np.array(ids))

    def ref(self, fn, keep=True):
        """The reference's fn(); with `keep`, its routes are kept for the
        port's next run."""
        self.keep = keep
        out = fn()
        jax.effects_barrier()
        return out

    def port(self, fn):
        out = fn()
        assert not self.ids, "the port ran fewer MoE layers"
        return out


@pytest.mark.parametrize("name", ["internlm2-1.8b", "gemma3-1b"] + NEW)
def test_bf16_matches_reference(name, monkeypatch):
    """The reduced config in bfloat16 against JAX's bfloat16 run: the
    forward, the prompt into the cache (a block; mamba token by token)
    and 4 decode steps, within BF16_TOL of the largest |logit|; and the
    forward no further from a float32 run of the same weights than
    BF16_VS_F32 times the reference's own distance.
    Measured on the CPU at seed 7 (forward): port vs JAX 8.9e-3
    (internlm2) and 3.98e-2 (gemma3); against float32, the port 1.05e-2
    and 3.36e-2, JAX 1.25e-2 and 3.57e-2.

    MoE models run the dense path with the port's router picking the
    reference's experts (`_Replay`): where a token's k-th and (k+1)-th
    router probabilities nearly tie, bf16 rounding in either package may
    pick another expert, and that token's logits then differ by that
    expert's share, and its successors' through attention (deepseek at
    seeds 7, 5, 8: a token of 32 in one MoE layer, 0.12-0.27 of the
    largest |logit| there, up to 0.096 at the next positions, 0.5-1.5e-2
    elsewhere).  Which experts the router picks is held exactly at
    float32 (`tests/test_torch_moe.py`)."""
    cfg, jb, jp, tb, tp = _model(name, seed=7, dtype="bfloat16")
    assert tp["embed"]["w"].dtype == torch.bfloat16
    kw = {"moe_path": "dense"} if name in MOE else {}
    rp = _Replay(monkeypatch, name in MOE)
    jt, tt = _tokens(cfg, 2, 16, seed=7)
    want, _ = rp.ref(lambda: JT.lm_forward(jp, cfg, jt, remat=False, **kw))
    got, _ = rp.port(lambda: T.lm_forward(tp, tb.cfg, tt, **kw))
    assert got.dtype == torch.bfloat16
    assert _rel(_np(got), _np(want)) < BF16_TOL
    f32 = dataclasses.replace(cfg, dtype="float32")
    truth, _ = rp.ref(lambda: JT.lm_forward(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp), f32,
        jt, remat=False, **kw), keep=False)
    assert _rel(_np(got), _np(truth)) <= \
        BF16_VS_F32 * _rel(_np(want), _np(truth))
    jc = jb.cache_init(2, 16)
    tc = tb.cache_init(2, 16, device="cpu")
    jl, jc = rp.ref(lambda: _fill(jb.decode_fn, jp, jt[:, :12], jc,
                                  name, jnp.int32, **kw))
    tl, tc = rp.port(lambda: _fill(tb.decode_fn, tp, tt[:, :12], tc,
                                   name, **kw))
    assert _rel(_np(tl), _np(jl)) < BF16_TOL
    for t in range(12, 16):
        jl, jc = rp.ref(lambda: jb.decode_fn(jp, jt[:, t:t + 1], jc,
                                             jnp.int32(t), **kw))
        tl, tc = rp.port(lambda: tb.decode_fn(tp, tt[:, t:t + 1], tc, t,
                                              **kw))
        assert _rel(_np(tl), _np(jl)) < BF16_TOL, t


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("name", DECODERS)
def test_card_matches_cpu(name):
    """The reduced float32 config on the card gives the CPU's logits (a
    mamba model's cache built token by token; paligemma with its stub
    prefix embeddings, prefilled with the prompt's first block)."""
    tb = build(tcfg.get_arch(name).reduced())
    tp = tb.init(0, device="cpu")
    dev = torch.device("cuda", 0)
    tpd = params_from_numpy(params_to_numpy(tp), device=dev)
    tt = torch.from_numpy(np.random.default_rng(0).integers(
        0, tb.cfg.vocab, (2, 40)))
    _, pfx = _prefix(tb.cfg, 2, seed=0)
    pfx_d = None if pfx is None else pfx.to(dev)
    P = tb.cfg.n_prefix_tokens
    want, _ = T.lm_forward(tp, tb.cfg, tt, prefix_embeds=pfx)
    got, _ = T.lm_forward(tpd, tb.cfg, tt.to(dev), prefix_embeds=pfx_d)
    assert _rel(got.cpu(), want) < 1e-4
    tc = tb.cache_init(2, P + 40, device=dev)
    mp = "dense" if name in MOE else "capacity"
    want, _ = T.lm_forward(tp, tb.cfg, tt, prefix_embeds=pfx, moe_path=mp)
    lg, tc = _fill(tb.decode_fn, tpd, tt[:, :32].to(dev), tc, name,
                   moe_path=mp, prefix_embeds=pfx_d)
    assert _rel(lg.cpu(), want[:, :P + 32]) < 1e-4
