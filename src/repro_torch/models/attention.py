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
    merge_heads, residual, rmsnorm, split_dim

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
    # the q latent whole on every rank (`residual`), so that wq_b is a
    # column-parallel product whose output shards the heads
    q = linear(p["wq_b"], residual(rmsnorm(p["q_norm"],
                                           linear(p["wq_a"], x))))
    q = split_dim(q, 2, B, S, H, dn + dr)
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


def _mla_core(q_nope, q_rope, ckv, krope, wkv_b, *, dn: int, scale: float,
              q_offset, kv_len, absorbed: bool):
    """The attention of MLA's queries (B, S, H, ·) over the latent cache
    (B, Sk, r) and its rope keys (B, Sk, dr); `wkv_b` (r, H, dn + dv).
    Returns (B, S, H, dv)."""
    S, Sk = q_nope.shape[1], ckv.shape[1]
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

    qpos = torch.arange(S, device=q_nope.device) + q_offset
    kpos = torch.arange(Sk, device=q_nope.device)
    mask = qpos[:, None] >= kpos[None, :]
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    logits = logits.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q_nope.dtype)

    if absorbed:
        out_lat = torch.einsum("bhqk,bkr->bqhr", probs, ckv)
        return torch.einsum("bqhr,rhd->bqhd", out_lat, w_uv)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _mla_heads(q_nope, q_rope, ckv, krope, wkv_b, **kw):
    """`_mla_core`, on DTensors head by head through `local_map`, as
    `layers.head_parallel` runs GQA attention: each rank its batch rows
    and query heads (over ``model`` when H divides among its ranks), the
    latent cache and rope keys whole over ``model`` (their gradients
    partial sums over the head shards, as `wkv_b`'s over the row
    shards).  A cache sharded along its positions is left to DTensor."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map

    from .layers import _sharded_dim, contiguous_local, split_placements

    if not isinstance(q_nope, DTensor) or _sharded_dim(ckv, 1):
        return _mla_core(q_nope, q_rope, ckv, krope, wkv_b, **kw)
    mesh, H = q_nope.device_mesh, q_nope.shape[2]
    batch = [isinstance(pl, Shard) and pl.dim == 0
             for pl in q_nope.placements]
    heads = [not b and H % mesh.size(i) == 0 and any(
        isinstance(pl, Shard) and pl.dim == 2
        for pl in (q_nope.placements[i],)) for i, b in enumerate(batch)]

    def on(dim_b, dim_h, grad=False):
        return split_placements(batch, heads, dim_b, dim_h, grad)

    q_pl, kv_pl, w_pl = on(0, 2), on(0, None), on(None, 1)
    ins = [t.redistribute(mesh, pl) for t, pl in (
        (q_nope, q_pl), (q_rope, q_pl), (ckv, kv_pl), (krope, kv_pl),
        (wkv_b, w_pl))]
    return local_map(
        contiguous_local(lambda *a: _mla_core(*a, **kw)),
        out_placements=(q_pl,), in_placements=(q_pl, q_pl, kv_pl, kv_pl,
                                               w_pl),
        in_grad_placements=(q_pl, q_pl, on(0, None, True),
                            on(0, None, True), on(None, 1, True)),
        device_mesh=mesh)(*ins)


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

    wkv_b = split_dim(p["wkv_b"]["w"], 1, cfg.kv_lora_rank, H, dn + dv)
    out = _mla_heads(q_nope, q_rope, ckv, krope, wkv_b, dn=dn, scale=scale,
                     q_offset=q_offset, kv_len=kv_len, absorbed=absorbed)

    return linear(p["wo"], merge_heads(out)), cache


def init_mla_cache(cfg, batch: int, max_seq: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    return {
        "ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                             dtype=dtype, device=device),
    }
