"""Encoder-decoder stack (seamless-m4t): bidirectional encoder over stub
frame embeddings + causal decoder with cross-attention (the JAX package's
`models.encdec`).

The audio frontend is a STUB per assignment — `src_embeds` arrives
pre-computed as (B, S_src, d_model) frame embeddings.

The parameter tree is the reference's: `embed`, `lm_head`, the encoder's
and the decoder's layers stacked on a leading axis (`enc`, `dec`),
`enc_norm`, `final_norm`.  Each stacked layer is drawn and copied in
before the next is drawn, from the caller's generator.  The caches are
``{"self": {k, v}, "cross": {k, v}}`` with a leading L axis, each layer
its own zeros: decode writes the self cache in place, so a broadcast view
(the reference's `jnp.broadcast_to`) would write every layer at once.

`encdec_decode_step` takes one token: the reference rotates its token
block with `rope_tables(1, ..., offset=pos)`, so a block of S > 1 tokens
would rotate every position as `pos` and differ from the forward; the
port refuses a block with ValueError.
"""
from __future__ import annotations

import torch

from . import scan_util

from .layers import (
    Params, _dtype, init_linear, linear, init_rmsnorm, rmsnorm,
    init_embedding, embed, swiglu_init, swiglu, rope_tables,
    init_attention, attention, init_attention_cache, residual,
)
from .transformer import _remat, _stack_init


def _init_enc_layer(gen, cfg, dtype) -> Params:
    dev = gen.device
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, dev),
        "attn": init_attention(gen, cfg, dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, dev),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def _init_dec_layer(gen, cfg, dtype) -> Params:
    dev = gen.device
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, dev),
        "self_attn": init_attention(gen, cfg, dtype),
        "ln_x": init_rmsnorm(cfg.d_model, dtype, dev),
        "cross_attn": init_attention(gen, cfg, dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, dev),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def init_encdec(gen, cfg) -> Params:
    """The model's parameters, drawn from `gen` on its device."""
    dtype = _dtype(cfg.dtype)
    dev = gen.device
    return {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype),
        "lm_head": init_linear(gen, cfg.d_model, cfg.vocab, dtype),
        "enc": _stack_init(lambda g: _init_enc_layer(g, cfg, dtype), gen,
                           cfg.enc_layers),
        "dec": _stack_init(lambda g: _init_dec_layer(g, cfg, dtype), gen,
                           cfg.n_layers),
        "enc_norm": init_rmsnorm(cfg.d_model, dtype, dev),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, dev),
    }


def encode(params, cfg, src_embeds, *, remat: bool = False):
    """Bidirectional encoder over (B, S_src, D) stub embeddings.  `remat`
    checkpoints each layer, as the reference's `jax.checkpoint`."""
    x = src_embeds.to(_dtype(cfg.dtype))
    rope = rope_tables(x.shape[1], cfg.hd, cfg.rope_theta, device=x.device)

    def body(h, p):
        a, _ = attention(p["attn"], cfg, rmsnorm(p["ln1"], h, cfg.norm_eps),
                         rope, causal=False)
        h = h + residual(a)
        h = h + residual(swiglu(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps)))
        return h, None

    x, _ = scan_util.scan(_remat(body, remat), x, params["enc"])
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(p, cfg, x, rope, memory, self_cache=None, cross_cache=None,
               pos=None):
    a, new_self = attention(p["self_attn"], cfg,
                            rmsnorm(p["ln1"], x, cfg.norm_eps), rope,
                            causal=True, cache=self_cache, pos=pos)
    x = x + residual(a)
    a, new_cross = attention(p["cross_attn"], cfg,
                             rmsnorm(p["ln_x"], x, cfg.norm_eps), None,
                             memory=memory, cache=cross_cache,
                             static_kv=memory is None
                             and cross_cache is not None)
    x = x + residual(a)
    x = x + residual(swiglu(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps)))
    return x, new_self, new_cross


def encdec_forward(params, cfg, src_embeds, tgt_tokens, *,
                   remat: bool = False):
    """Training forward.  Returns (logits, aux): `aux` a float32 zero.
    `remat` checkpoints each encoder and each decoder layer."""
    memory = encode(params, cfg, src_embeds, remat=remat)
    x = embed(params["embed"], tgt_tokens)
    rope = rope_tables(x.shape[1], cfg.hd, cfg.rope_theta, device=x.device)

    def body(h, p):
        h, _, _ = _dec_layer(p, cfg, h, rope, memory)
        return h, None

    x, _ = scan_util.scan(_remat(body, remat), x, params["dec"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return linear(params["lm_head"], x), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def init_encdec_cache(cfg, batch: int, max_seq: int, memory_len: int,
                      device=None):
    """Self-attn KV (L, B, Smax, Hkv, hd) + cross K/V (L, B, memory_len,
    Hkv, hd), real zeros for every layer."""
    dtype = _dtype(cfg.dtype)
    L = cfg.n_layers

    def stacked(seq):
        one = init_attention_cache(cfg, batch, seq, dtype, device)
        return {n: t.new_zeros((L,) + t.shape) for n, t in one.items()}

    return {"self": stacked(max_seq), "cross": stacked(memory_len)}


def encdec_prime_cross(params, cfg, memory, caches):
    """Per-layer cross K/V from the encoder memory (the prefill phase):
    new (L, B, Sm, Hkv, hd) tensors of the memory's length; the "self"
    entry is the caches' own."""
    B, Sm, _ = memory.shape
    L = params["dec"]["cross_attn"]["wk"]["w"].shape[0]

    def per_layer(p):
        k = linear(p["cross_attn"]["wk"], memory).reshape(
            B, Sm, cfg.n_kv_heads, cfg.hd)
        v = linear(p["cross_attn"]["wv"], memory).reshape(
            B, Sm, cfg.n_kv_heads, cfg.hd)
        return {"k": k, "v": v}

    layers = [per_layer(scan_util.tree_map(lambda a: a[i], params["dec"]))
              for i in range(L)]
    cross = {n: torch.stack([c[n] for c in layers]) for n in ("k", "v")}
    return {"self": caches["self"], "cross": cross}


def encdec_decode_step(params, cfg, token, caches, pos):
    """One decoder step (token: (B, 1)) against primed cross caches; `pos`
    is a Python int.  Returns (logits (B, 1, V), caches), the self cache
    written in place.  A block of more than one token raises ValueError
    (see the module docstring)."""
    if token.shape[1] != 1:
        raise ValueError(
            f"encdec_decode_step takes one token a step, not a block of "
            f"{token.shape[1]}: the step rotates its tokens as position "
            f"{pos}")
    x = embed(params["embed"], token)
    rope = rope_tables(1, cfg.hd, cfg.rope_theta, offset=pos,
                       device=x.device)

    def body(h, xs):
        p, cs, cx = xs
        # memory=None with a primed cross cache: attention reads its K/V
        h, _, _ = _dec_layer(p, cfg, h, rope, memory=None, self_cache=cs,
                             cross_cache=cx, pos=pos)
        return h, None

    x, _ = scan_util.scan(body, x, (params["dec"], caches["self"],
                                    caches["cross"]))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return linear(params["lm_head"], x), {"self": caches["self"],
                                          "cross": caches["cross"]}
