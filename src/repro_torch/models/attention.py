"""Multi-head Latent Attention (DeepSeek-V3) — latent-compressed KV (the JAX
package's `models.attention`).

Two decode paths:
  * naive    — expand K/V from the cached latent every step.
  * absorbed — fold W^UK into the query and W^UV into the output projection
    so attention runs directly in latent space.

The cache stores only (ckv: (B, S, r), krope: (B, S, d_rope)), written in
place at `pos` as `layers.attention` writes its K/V: the returned cache is
the one passed in.  Masking is the reference's: causal, plus `kpos < pos +
S` with a cache; no window, no prefix; float32 logits scaled by
1/√(d_nope + d_rope), filled with -1e30.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from .layers import _write, apply_rope, init_linear, init_rmsnorm, linear, \
    rmsnorm

Params = Dict[str, Any]


def init_mla(gen: torch.Generator, cfg, dtype) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dev = gen.device
    return {
        "wq_a": init_linear(gen, d, cfg.q_lora_rank, dtype),
        "q_norm": init_rmsnorm(cfg.q_lora_rank, dtype, dev),
        "wq_b": init_linear(gen, cfg.q_lora_rank, H * (dn + dr), dtype),
        "wkv_a": init_linear(gen, d, cfg.kv_lora_rank + dr, dtype),
        "kv_norm": init_rmsnorm(cfg.kv_lora_rank, dtype, dev),
        "wkv_b": init_linear(gen, cfg.kv_lora_rank, H * (dn + dv), dtype),
        "wo": init_linear(gen, H * dv, d, dtype),
    }


def _project_q(p, cfg, x, rope):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = linear(p["wq_b"], rmsnorm(p["q_norm"], linear(p["wq_a"], x)))
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope
    return q_nope, apply_rope(q_rope, cos, sin)


def _latent_kv(p, cfg, x, rope):
    """Returns (c_kv normalized (B,S,r), k_rope roped (B,S,dr))."""
    kv_a = linear(p["wkv_a"], x)
    c_kv, k_rope = kv_a[..., :cfg.kv_lora_rank], kv_a[..., cfg.kv_lora_rank:]
    c_kv = rmsnorm(p["kv_norm"], c_kv)
    cos, sin = rope
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_rope


def mla_attention(
    p: Params,
    cfg,
    x: torch.Tensor,
    rope: Tuple[torch.Tensor, torch.Tensor],
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {'ckv','krope'}
    pos: Optional[int] = None,
    absorbed: bool = False,
):
    """Returns (out (B,S,D), new_cache); `new_cache` is `cache`, written in
    place, or None without one."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(dn + cfg.qk_rope_head_dim)

    q_nope, q_rope = _project_q(p, cfg, x, rope)
    c_new, kr_new = _latent_kv(p, cfg, x, rope)

    if cache is not None:
        _write(cache["ckv"], c_new, pos)
        _write(cache["krope"], kr_new, pos)
        ckv, krope = cache["ckv"], cache["krope"]
        kv_len = pos + S
        q_offset = pos
    else:
        ckv, krope = c_new, kr_new
        kv_len = None
        q_offset = 0

    Sk = ckv.shape[1]
    wkv_b = p["wkv_b"]["w"].reshape(cfg.kv_lora_rank, H, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]

    if absorbed:
        # latent-space attention: scores = (q_nope W_uk^T) · c + q_rope · k_rope
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
        logits = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckv)
                  + torch.einsum("bqhd,bkd->bhqk", q_rope, krope))
    else:
        kv = torch.einsum("bkr,rhd->bkhd", ckv, wkv_b)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
                  + torch.einsum("bqhd,bkd->bhqk", q_rope, krope))
    logits = logits.float() * scale

    qpos = torch.arange(S, device=x.device) + q_offset
    kpos = torch.arange(Sk, device=x.device)
    mask = qpos[:, None] >= kpos[None, :]
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    logits = logits.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)

    if absorbed:
        out_lat = torch.einsum("bhqk,bkr->bqhr", probs, ckv)
        out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_uv)
    else:
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)

    return linear(p["wo"], out.reshape(B, S, H * dv)), cache


def init_mla_cache(cfg, batch: int, max_seq: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    return {
        "ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                             dtype=dtype, device=device),
    }
