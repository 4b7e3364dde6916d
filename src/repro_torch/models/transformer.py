"""Decoder-only transformer assembly (the JAX package's `models.transformer`).

Layers are grouped into homogeneous *blocks* whose parameters are stacked
on a leading axis, and a block applies its layer body to each slice in
turn (`scan_util.scan`):

  dense_uniform  — attention (GQA or MLA) + dense SwiGLU      [codeqwen,
                   granite, internlm2, paligemma, deepseek's first 3]
  moe_uniform    — attention + MoE                            [deepseek tail,
                   llama4-scout]
  gemma_period   — (5 sliding-window + 1 global) per period   [gemma3]
  mamba_uniform  — Mamba2 blocks                              [mamba2]
  zamba_period   — (6 Mamba2 + 1 weight-SHARED attn/MLP)      [zamba2]

`layer_plan` gives every config's plan, as the reference's.  The
encoder-decoder (seamless-m4t) is `encdec.py`'s.

Decode caches are stacked like the parameters and written in place: a
decode step returns the caches it was given.  A mamba layer's cache is
built one token at a time (`ssm.mamba_step`), as in the reference, whose
`lm_decode_step` cannot block-prefill one either; a block of more than
one token into a mamba cache raises ValueError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import scan_util

from .layers import (
    Params, _dtype, init_linear, linear, init_rmsnorm, rmsnorm,
    init_embedding, embed, swiglu_init, swiglu, rope_tables,
    init_attention, attention, init_attention_cache, residual,
)
from .attention import init_mla, mla_attention, init_mla_cache
from .moe import init_moe, moe_dense, moe_capacity
from .ssm import init_mamba, mamba_chunked, mamba_step, init_mamba_cache

KINDS = ("dense_uniform", "moe_uniform", "gemma_period", "mamba_uniform",
         "zamba_period")


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Block:
    kind: str
    count: int          # scan length (layers, or periods for *_period)
    window: int = 0     # sliding window for dense layers in this block
    d_ff: int = 0       # dense ffn width override (deepseek first-3)
    moe: bool = False


def layer_plan(cfg) -> List[Block]:
    if cfg.mixer == "mamba":
        if cfg.shared_attn_period:
            p = cfg.shared_attn_period
            periods, tail = divmod(cfg.n_layers, p)
            plan = [Block("zamba_period", periods)]
            if tail:
                plan.append(Block("mamba_uniform", tail))
            return plan
        return [Block("mamba_uniform", cfg.n_layers)]
    if cfg.n_experts:
        plan = []
        if cfg.first_k_dense:
            plan.append(Block("dense_uniform", cfg.first_k_dense,
                              d_ff=cfg.dense_d_ff or cfg.d_ff))
        plan.append(Block("moe_uniform", cfg.n_layers - cfg.first_k_dense, moe=True))
        return plan
    if cfg.local_global_period:
        p = cfg.local_global_period
        periods, tail = divmod(cfg.n_layers, p)
        plan = [Block("gemma_period", periods, window=cfg.sliding_window)]
        if tail:
            plan.append(Block("dense_uniform", tail, window=cfg.sliding_window,
                              d_ff=cfg.d_ff))
        return plan
    return [Block("dense_uniform", cfg.n_layers, window=cfg.sliding_window,
                  d_ff=cfg.d_ff)]


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# single-layer bodies
# ---------------------------------------------------------------------------

def _init_attn_layer(gen, cfg, dtype, d_ff: int, moe: bool) -> Params:
    dev = gen.device
    p: Params = {"ln1": init_rmsnorm(cfg.d_model, dtype, dev),
                 "ln2": init_rmsnorm(cfg.d_model, dtype, dev)}
    if cfg.attn_impl == "mla":
        p["attn"] = init_mla(gen, cfg, dtype)
    else:
        p["attn"] = init_attention(gen, cfg, dtype)
    if moe:
        p["moe"] = init_moe(gen, cfg, dtype)
    elif d_ff:
        p["mlp"] = swiglu_init(gen, cfg.d_model, d_ff, dtype)
    return p


def _apply_attn_layer(p, cfg, x, rope, *, window: int, moe: bool,
                      moe_path: str, prefix_len: int, cache=None, pos=None,
                      mla_absorbed: bool = False):
    """Returns (x, aux, cache): `aux` is the MoE layer's load-balancing
    loss, a Python 0.0 without experts (made a float32 tensor once per
    forward, `lm_forward`)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attn_impl == "mla":
        attn_out, new_cache = mla_attention(
            p["attn"], cfg, h, rope, cache=cache, pos=pos,
            absorbed=mla_absorbed)
    else:
        attn_out, new_cache = attention(
            p["attn"], cfg, h, rope, causal=True, window=window,
            prefix_len=prefix_len, cache=cache, pos=pos,
        )
    x = x + residual(attn_out)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    aux = 0.0
    if moe:
        fn = moe_dense if moe_path == "dense" else moe_capacity
        mlp_out, aux = fn(p["moe"], cfg, h)
    elif "mlp" in p:
        mlp_out = swiglu(p["mlp"], h)
    else:
        mlp_out = torch.zeros_like(h)
    return x + residual(mlp_out), aux, new_cache


def _init_mamba_layer(gen, cfg, dtype) -> Params:
    return {"ln": init_rmsnorm(cfg.d_model, dtype, gen.device),
            "mamba": init_mamba(gen, cfg, dtype)}


def _apply_mamba_layer(p, cfg, x, cache=None):
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    if cache is None:
        return x + residual(mamba_chunked(p["mamba"], cfg, h)), None
    out, cache = mamba_step(p["mamba"], cfg, h, cache)
    return x + residual(out), cache


def _init_shared_block(gen, cfg, dtype) -> Params:
    """zamba2's weight-shared attention + MLP block."""
    dev = gen.device
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, dev),
        "attn": init_attention(gen, cfg, dtype),
        "ln2": init_rmsnorm(cfg.d_model, dtype, dev),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def _apply_shared_block(p, cfg, x, rope, cache=None, pos=None):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, new_cache = attention(p["attn"], cfg, h, rope, causal=True,
                                    cache=cache, pos=pos)
    x = x + residual(attn_out)
    x = x + residual(swiglu(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps)))
    return x, new_cache


# ---------------------------------------------------------------------------
# the blocks: init / train-apply / cache / decode-apply
# ---------------------------------------------------------------------------

def _stack_init(init_fn, gen, count: int):
    """`count` layers from `init_fn`, stacked on a leading axis.  Each
    layer is drawn and copied into the stacked tensors before the next is
    drawn, so at most one layer is held twice (a whole block of deepseek's
    or llama4's experts would not fit twice on one card)."""
    out = None
    for i in range(count):
        layer = init_fn(gen)
        if out is None:
            out = scan_util.tree_map(
                lambda t: t.new_empty((count,) + t.shape), layer)
        scan_util.tree_map(lambda o, t: o[i].copy_(t), out, layer)
        del layer
    return out


def init_block(gen, cfg, blk: Block, dtype) -> Params:
    _check_kind(blk.kind)
    if blk.kind in ("dense_uniform", "moe_uniform"):
        return _stack_init(
            lambda g: _init_attn_layer(g, cfg, dtype, blk.d_ff or cfg.d_ff,
                                       blk.moe),
            gen, blk.count)
    if blk.kind == "gemma_period":
        pl = cfg.local_global_period - 1
        return {
            "local": _stack_init(
                lambda g: _stack_init(
                    lambda gg: _init_attn_layer(gg, cfg, dtype, cfg.d_ff,
                                                False),
                    g, pl),
                gen, blk.count),
            "global": _stack_init(
                lambda g: _init_attn_layer(g, cfg, dtype, cfg.d_ff, False),
                gen, blk.count),
        }
    if blk.kind == "mamba_uniform":
        return _stack_init(lambda g: _init_mamba_layer(g, cfg, dtype), gen,
                           blk.count)
    p = cfg.shared_attn_period
    return {
        "mamba": _stack_init(
            lambda g: _stack_init(
                lambda gg: _init_mamba_layer(gg, cfg, dtype), g, p),
            gen, blk.count),
    }


def _remat(fn, remat: bool):
    """`fn` under activation checkpointing when `remat` (the reference's
    `jax.checkpoint`): its activations are recomputed in the backward
    instead of kept.  The non-reentrant form takes the carries' Python
    float `aux` and the parameter dicts as they are."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def apply_block_train(
    params, cfg, blk: Block, x, rope, *, moe_path: str, prefix_len: int,
    shared_block: Optional[Params], remat: bool,
):
    """Training / loss forward (no caches).  Returns (x, aux_sum).

    `remat` checkpoints the bodies the reference wraps in
    `jax.checkpoint`: one layer of a uniform block, one period of
    `gemma_period` and `zamba_period`."""
    _check_kind(blk.kind)

    def layer(carry, p, window, moe):
        h, aux = carry
        h, a, _ = _apply_attn_layer(p, cfg, h, rope, window=window, moe=moe,
                                    moe_path=moe_path, prefix_len=prefix_len)
        return (h, aux + a), None

    if blk.kind in ("dense_uniform", "moe_uniform"):
        (x, aux), _ = scan_util.scan(
            _remat(lambda c, p: layer(c, p, blk.window, blk.moe), remat),
            (x, 0.0), params)
        return x, aux

    if blk.kind == "gemma_period":
        def period(carry, p):
            carry, _ = scan_util.scan(
                lambda c, lp: layer(c, lp, blk.window, False), carry,
                p["local"])
            return layer(carry, p["global"], 0, False)

        (x, aux), _ = scan_util.scan(_remat(period, remat), (x, 0.0), params)
        return x, aux

    def mamba_layer(h, lp):
        return _apply_mamba_layer(lp, cfg, h)

    if blk.kind == "mamba_uniform":
        x, _ = scan_util.scan(_remat(mamba_layer, remat), x, params)
        return x, 0.0

    def zamba(h, p):
        h, _ = scan_util.scan(mamba_layer, h, p["mamba"])
        return _apply_shared_block(shared_block, cfg, h, rope)

    x, _ = scan_util.scan(_remat(zamba, remat), x, params)
    return x, 0.0


def init_block_cache(cfg, blk: Block, batch: int, max_seq: int, dtype,
                     ring: bool = False, device=None):
    """The block's decode caches, stacked like its parameters.  Each layer
    gets its own zeros (no broadcast views), since decode writes them in
    place.  MLA, mamba and zamba's shared attention ignore `ring`, as in
    the reference."""
    _check_kind(blk.kind)
    # ring caches: sliding-window layers only keep the last W slots
    win_seq = min(max_seq, blk.window) if ring and blk.window else max_seq

    def stacked(lead, one):
        return {n: t.new_zeros(lead + t.shape) for n, t in one.items()}

    def attn(seq):
        return init_attention_cache(cfg, batch, seq, dtype, device)

    if blk.kind in ("dense_uniform", "moe_uniform"):
        if cfg.attn_impl == "mla":
            return stacked((blk.count,),
                           init_mla_cache(cfg, batch, max_seq, dtype, device))
        return stacked((blk.count,), attn(win_seq))
    if blk.kind == "gemma_period":
        pl = cfg.local_global_period - 1
        return {"local": stacked((blk.count, pl), attn(win_seq)),
                "global": stacked((blk.count,), attn(max_seq))}
    mamba = init_mamba_cache(cfg, batch, dtype, device)
    if blk.kind == "mamba_uniform":
        return stacked((blk.count,), mamba)
    return {"mamba": stacked((blk.count, cfg.shared_attn_period), mamba),
            "shared": stacked((blk.count,), attn(max_seq))}


def apply_block_decode(
    params, cfg, blk: Block, x, rope, cache, pos, *,
    shared_block: Optional[Params], mla_absorbed: bool = False,
    prefix_len: int = 0, moe_path: str = "capacity",
):
    """Single-token decode (or, for attention blocks, a block prefill)
    through the block.  Returns (x, cache): `cache` written in place."""
    _check_kind(blk.kind)

    def layer(h, xs, window, moe):
        p, c = xs
        h, _, _ = _apply_attn_layer(p, cfg, h, rope, window=window, moe=moe,
                                    moe_path=moe_path, prefix_len=prefix_len,
                                    cache=c, pos=pos,
                                    mla_absorbed=mla_absorbed)
        return h, None

    if blk.kind in ("dense_uniform", "moe_uniform"):
        x, _ = scan_util.scan(lambda h, xs: layer(h, xs, blk.window, blk.moe),
                              x, (params, cache))
        return x, cache

    if blk.kind == "gemma_period":
        def period(h, xs):
            p, c = xs
            h, _ = scan_util.scan(
                lambda hh, xs2: layer(hh, xs2, blk.window, False), h,
                (p["local"], c["local"]))
            return layer(h, (p["global"], c["global"]), 0, False)

        x, _ = scan_util.scan(period, x, (params, cache))
        return x, cache

    def mamba_layer(h, xs):
        lp, lc = xs
        h, _ = _apply_mamba_layer(lp, cfg, h, cache=lc)
        return h, None

    if blk.kind == "mamba_uniform":
        x, _ = scan_util.scan(mamba_layer, x, (params, cache))
        return x, cache

    def zamba(h, xs):
        p, c = xs
        h, _ = scan_util.scan(mamba_layer, h, (p["mamba"], c["mamba"]))
        h, _ = _apply_shared_block(shared_block, cfg, h, rope,
                                   cache=c["shared"], pos=pos)
        return h, None

    x, _ = scan_util.scan(zamba, x, (params, cache))
    return x, cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_lm(gen, cfg) -> Params:
    """The model's parameters, drawn from `gen` on its device."""
    dtype = _dtype(cfg.dtype)
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "blocks": [init_block(gen, cfg, blk, dtype)
                   for blk in layer_plan(cfg)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab, dtype)
    if cfg.shared_attn_period:
        # one parameter set, applied in every period
        params["shared_block"] = _init_shared_block(gen, cfg, dtype)
    if cfg.n_prefix_tokens:
        params["prefix_proj"] = init_linear(gen, cfg.prefix_dim, cfg.d_model,
                                            dtype)
    return params


def _embed_inputs(params, cfg, tokens, prefix_embeds):
    x = embed(params["embed"], tokens)
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)  # gemma-style, in the embedding dtype
    if prefix_embeds is not None:
        pfx = residual(linear(params["prefix_proj"],
                              prefix_embeds.to(x.dtype)))
        x = torch.cat([pfx, x], dim=1)
    return residual(x)


def _logits(params, cfg, x):
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"]["w"].T
    return linear(params["lm_head"], h)


def _rope_dim(cfg) -> int:
    return cfg.hd if cfg.attn_impl != "mla" else cfg.qk_rope_head_dim


def lm_forward(
    params, cfg, tokens, prefix_embeds=None, *,
    moe_path: str = "capacity", remat: bool = False, last_only: bool = False,
):
    """Full forward (training / evaluation).  Returns (logits, aux_loss):
    `aux_loss` the MoE layers' load-balancing losses added up, a float32
    scalar tensor.

    last_only: serving prefill — the lm_head logits of the final position
    only (the body's work is the same; the (B, S, V) logits matmul goes).
    """
    x = _embed_inputs(params, cfg, tokens, prefix_embeds)
    S = x.shape[1]
    rope = rope_tables(S, _rope_dim(cfg), cfg.rope_theta, device=x.device)
    prefix_len = cfg.n_prefix_tokens
    shared = params.get("shared_block")
    aux = 0.0
    for blk, bp in zip(layer_plan(cfg), params["blocks"]):
        x, a = apply_block_train(bp, cfg, blk, x, rope, moe_path=moe_path,
                                 prefix_len=prefix_len, shared_block=shared,
                                 remat=remat)
        aux = aux + a
    if last_only:
        x = x[:, -1:]
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux


def init_lm_cache(cfg, batch: int, max_seq: int, ring: bool = False,
                  device=None):
    dtype = _dtype(cfg.dtype)
    return [init_block_cache(cfg, blk, batch, max_seq, dtype, ring=ring,
                             device=device)
            for blk in layer_plan(cfg)]


def lm_decode_step(params, cfg, token, caches, pos, *, mla_absorbed=False,
                   moe_path: str = "capacity", prefix_embeds=None):
    """One decode step (token: (B, 1)) or a block prefill-into-cache
    (token: (B, S), pos = start offset; attention archs only — a mamba
    cache takes one token a step, and a mamba prompt without a cache goes
    through `lm_forward`).  `pos` is a Python int.

    Returns (logits (B, S, V), caches), the caches written in place.
    """
    x = _embed_inputs(params, cfg, token, prefix_embeds)
    rope = rope_tables(x.shape[1], _rope_dim(cfg), cfg.rope_theta,
                       offset=pos, device=x.device)
    shared = params.get("shared_block")
    for blk, bp, c in zip(layer_plan(cfg), params["blocks"], caches):
        x, _ = apply_block_decode(bp, cfg, blk, x, rope, c, pos,
                                  shared_block=shared,
                                  mla_absorbed=mla_absorbed,
                                  prefix_len=cfg.n_prefix_tokens,
                                  moe_path=moe_path)
    return _logits(params, cfg, x), caches
