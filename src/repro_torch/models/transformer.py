"""Decoder-only transformer assembly (the JAX package's `models.transformer`).

Layers are grouped into homogeneous *blocks* whose parameters are stacked
on a leading axis, and a block applies its layer body to each slice in
turn (`scan_util.scan`):

  dense_uniform  — attention (GQA) + dense SwiGLU             [codeqwen,
                   granite, internlm2, paligemma]
  gemma_period   — (5 sliding-window + 1 global) per period   [gemma3]
  moe_uniform    — attention + MoE                            [deepseek tail,
                   llama4-scout]
  mamba_uniform  — Mamba2 blocks                              [mamba2]
  zamba_period   — (6 Mamba2 + 1 weight-SHARED attn/MLP)      [zamba2]

`layer_plan` gives every config's plan, as the reference's.  The dense
kinds are ported; `moe_uniform`, `mamba_uniform`, `zamba_period` and MLA
attention raise `NotImplementedError` naming their step of ROADMAP.md
Queue 1 item 9.

Decode caches are stacked like the parameters and written in place: a
decode step returns the caches it was given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from . import scan_util

from .layers import (
    Params, _dtype, init_linear, linear, init_rmsnorm, rmsnorm,
    init_embedding, embed, swiglu_init, swiglu, rope_tables,
    init_attention, attention, init_attention_cache,
)

#: the later steps of ROADMAP.md Queue 1 item 9, by what they port
LATER_STEPS = {
    "mla": "step 2 (MLA and MoE: models/attention.py, models/moe.py)",
    "moe": "step 2 (MLA and MoE: models/attention.py, models/moe.py)",
    "mamba": "step 3 (Mamba2 and the hybrid: models/ssm.py)",
    "encdec": "step 4 (the encoder-decoder: models/encdec.py)",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue 1 item 9, "
        f"{LATER_STEPS[key]}")


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


def check_ported(cfg) -> None:
    """Raise `NotImplementedError` unless every block of `cfg`'s plan is a
    ported kind (the dense kinds with GQA attention)."""
    if cfg.is_encdec:
        raise _not_ported(f"{cfg.name}: the encoder-decoder", "encdec")
    if cfg.attn_impl == "mla":
        raise _not_ported(f"{cfg.name}: MLA attention", "mla")
    for blk in layer_plan(cfg):
        _check_kind(blk.kind)


def _check_kind(kind: str) -> None:
    if kind == "moe_uniform":
        raise _not_ported("the moe_uniform block", "moe")
    if kind in ("mamba_uniform", "zamba_period"):
        raise _not_ported(f"the {kind} block", "mamba")
    if kind not in ("dense_uniform", "gemma_period"):
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# single-layer bodies
# ---------------------------------------------------------------------------

def _init_attn_layer(gen, cfg, dtype, d_ff: int) -> Params:
    if cfg.attn_impl == "mla":
        raise _not_ported("MLA attention", "mla")
    dev = gen.device
    p: Params = {"ln1": init_rmsnorm(cfg.d_model, dtype, dev),
                 "ln2": init_rmsnorm(cfg.d_model, dtype, dev),
                 "attn": init_attention(gen, cfg, dtype)}
    if d_ff:
        p["mlp"] = swiglu_init(gen, cfg.d_model, d_ff, dtype)
    return p


def _apply_attn_layer(p, cfg, x, rope, *, window: int, prefix_len: int,
                      cache=None, pos=None):
    if cfg.attn_impl == "mla":
        raise _not_ported("MLA attention", "mla")
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, new_cache = attention(
        p["attn"], cfg, h, rope, causal=True, window=window,
        prefix_len=prefix_len, cache=cache, pos=pos,
    )
    x = x + attn_out
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "mlp" in p:
        mlp_out = swiglu(p["mlp"], h)
    else:
        mlp_out = torch.zeros_like(h)
    # no experts, no load-balancing loss: the aux term is a Python 0.0,
    # made a float32 tensor once per forward (`lm_forward`)
    return x + mlp_out, 0.0, new_cache


# ---------------------------------------------------------------------------
# the blocks: init / train-apply / cache / decode-apply
# ---------------------------------------------------------------------------

def _stack_init(init_fn, gen, count: int):
    return scan_util.tree_stack([init_fn(gen) for _ in range(count)])


def init_block(gen, cfg, blk: Block, dtype) -> Params:
    _check_kind(blk.kind)
    if blk.kind == "dense_uniform":
        return _stack_init(
            lambda g: _init_attn_layer(g, cfg, dtype, blk.d_ff or cfg.d_ff),
            gen, blk.count)
    pl = cfg.local_global_period - 1
    return {
        "local": _stack_init(
            lambda g: _stack_init(
                lambda gg: _init_attn_layer(gg, cfg, dtype, cfg.d_ff),
                g, pl),
            gen, blk.count),
        "global": _stack_init(
            lambda g: _init_attn_layer(g, cfg, dtype, cfg.d_ff),
            gen, blk.count),
    }


def apply_block_train(
    params, cfg, blk: Block, x, rope, *, moe_path: str, prefix_len: int,
    shared_block: Optional[Params], remat: bool,
):
    """Training / loss forward (no caches).  Returns (x, aux_sum).

    `remat` (activation checkpointing in the reference) changes nothing
    in a forward; it is accepted and ignored."""
    _check_kind(blk.kind)

    def layer(carry, p, window):
        h, aux = carry
        h, a, _ = _apply_attn_layer(p, cfg, h, rope, window=window,
                                    prefix_len=prefix_len)
        return (h, aux + a), None

    if blk.kind == "dense_uniform":
        (x, aux), _ = scan_util.scan(
            lambda c, p: layer(c, p, blk.window), (x, 0.0), params)
        return x, aux

    def period(carry, p):
        carry, _ = scan_util.scan(
            lambda c, lp: layer(c, lp, blk.window), carry, p["local"])
        return layer(carry, p["global"], 0)

    (x, aux), _ = scan_util.scan(period, (x, 0.0), params)
    return x, aux


def init_block_cache(cfg, blk: Block, batch: int, max_seq: int, dtype,
                     ring: bool = False, device=None):
    """The block's decode caches, stacked like its parameters.  Each layer
    gets its own zeros (no broadcast views), since decode writes them in
    place."""
    _check_kind(blk.kind)
    if cfg.attn_impl == "mla":
        raise _not_ported("the MLA cache", "mla")
    # ring caches: sliding-window layers only keep the last W slots
    win_seq = min(max_seq, blk.window) if ring and blk.window else max_seq

    def stacked(lead, seq):
        one = init_attention_cache(cfg, batch, seq, dtype, device)
        return {n: t.new_zeros(lead + t.shape) for n, t in one.items()}

    if blk.kind == "dense_uniform":
        return stacked((blk.count,), win_seq)
    pl = cfg.local_global_period - 1
    return {"local": stacked((blk.count, pl), win_seq),
            "global": stacked((blk.count,), max_seq)}


def apply_block_decode(
    params, cfg, blk: Block, x, rope, cache, pos, *,
    shared_block: Optional[Params], mla_absorbed: bool = False,
    prefix_len: int = 0, moe_path: str = "capacity",
):
    """Single-token decode (or a block prefill) through the block.
    Returns (x, cache): `cache` written in place."""
    _check_kind(blk.kind)

    def layer(h, xs, window):
        p, c = xs
        h, _, _ = _apply_attn_layer(p, cfg, h, rope, window=window,
                                    prefix_len=prefix_len, cache=c, pos=pos)
        return h, None

    if blk.kind == "dense_uniform":
        x, _ = scan_util.scan(lambda h, xs: layer(h, xs, blk.window), x,
                              (params, cache))
        return x, cache

    def period(h, xs):
        p, c = xs
        h, _ = scan_util.scan(lambda hh, xs2: layer(hh, xs2, blk.window), h,
                              (p["local"], c["local"]))
        return layer(h, (p["global"], c["global"]), 0)

    x, _ = scan_util.scan(period, x, (params, cache))
    return x, cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_lm(gen, cfg) -> Params:
    """The model's parameters, drawn from `gen` on its device."""
    check_ported(cfg)
    dtype = _dtype(cfg.dtype)
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "blocks": [init_block(gen, cfg, blk, dtype)
                   for blk in layer_plan(cfg)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab, dtype)
    if cfg.n_prefix_tokens:
        params["prefix_proj"] = init_linear(gen, cfg.prefix_dim, cfg.d_model,
                                            dtype)
    return params


def _embed_inputs(params, cfg, tokens, prefix_embeds):
    x = embed(params["embed"], tokens)
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)  # gemma-style, in the embedding dtype
    if prefix_embeds is not None:
        pfx = linear(params["prefix_proj"], prefix_embeds.to(x.dtype))
        x = torch.cat([pfx, x], dim=1)
    return x


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
    """Full forward (training / evaluation).  Returns (logits, aux_loss).

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
    aux = torch.tensor(aux, dtype=torch.float32, device=x.device)
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
    (token: (B, S), pos = start offset).  `pos` is a Python int.

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
