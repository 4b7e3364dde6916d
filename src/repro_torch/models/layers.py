"""Shared neural layers (plain PyTorch, params as nested dicts of tensors).

The JAX package's `models.layers`, function for function: every layer is
an (init, apply) pair on plain dicts.  Compute dtype follows the param
dtype; norms, RoPE and softmax accumulate in float32 and cast back where
the reference does, so bf16 results round at the same points.

Inits draw from an explicit `torch.Generator` on the device the tensors
are made on, with the reference's distributions, shapes and dtypes
(normal·1/√d_in for linears, normal·0.02 for embeddings, ones for norms);
the draws themselves differ from `jax.random`'s, so weights carry across
through `model_zoo.params_from_numpy`.

Decode caches are written IN PLACE: `attention` returns the cache dict it
was given, its tensors updated.  `jax.lax.dynamic_update_slice` reads a
negative start index from the end and clamps it to ``[0, Smax - S]``; the
writes here do the same.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, Any]


def _dtype(cfg_dtype: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg_dtype]


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """float32 standard normals · std, cast to `dtype`, on `gen`'s device.
    A meta tensor holds no values, so on the meta device nothing is drawn
    (PyTorch's meta draws run in Python, a millisecond each)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype) -> Params:
    return {"w": _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]


def init_rmsnorm(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["scale"].float()).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"w": _normal(gen, (vocab, d), 0.02, dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["w"][ids]


def swiglu_init(gen: torch.Generator, d: int, ff: int, dtype) -> Params:
    return {
        "gate": init_linear(gen, d, ff, dtype),
        "up": init_linear(gen, d, ff, dtype),
        "down": init_linear(gen, ff, d, dtype),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = linear(p["gate"], x)
    return linear(p["down"], g * torch.sigmoid(g) * linear(p["up"], x))


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_tables(seq: int, dim: int, theta: float, offset: Any = 0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (seq, dim/2), float32."""
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)
    ang = pos[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D/2).  Split-half rotation."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# scaled-dot-product attention core (GQA, windows, prefix-LM, cross)
# --------------------------------------------------------------------------

def sdpa(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Sk, Hkv, D)
    v: torch.Tensor,          # (B, Sk, Hkv, Dv)
    causal: bool,
    window: int = 0,          # >0: sliding window over keys
    q_offset: Any = 0,        # absolute position of q[0]
    prefix_len: int = 0,      # prefix-LM: first `prefix_len` positions dense
    kv_len: Optional[Any] = None,  # decode: #valid cache entries
    softmax_scale: Optional[float] = None,
    key_positions: Optional[torch.Tensor] = None,  # ring caches: abs pos per slot
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)

    qg = q.reshape(B, Sq, Hkv, G, D)
    # the product in the parameter dtype, then float32, as the reference
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale

    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = (torch.arange(Sk, device=q.device) if key_positions is None
            else key_positions)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        cm = qpos[:, None] >= kpos[None, :]
        if prefix_len:
            cm = cm | ((qpos[:, None] < prefix_len)
                       & (kpos[None, :] < prefix_len))
        mask = mask & cm
    if window:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    if key_positions is not None:
        mask = mask & (kpos[None, :] >= 0)  # ring slots not yet written
    logits = logits.masked_fill(~mask[None, None, None], -1e30)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def sdpa_banded(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal sliding-window attention in banded/blocked form.

    Split the sequence into blocks of W = window; a query block attends
    only to its own block and the previous one (2W keys), which covers
    every key with 0 ≤ qpos − kpos < W exactly, without the (S, S) scores
    of the masked-full form.  Requires S % window == 0.
    """
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    W = window
    nb = S // W
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)

    qb = q.reshape(B, nb, W, Hkv, G, D)
    kb = k.reshape(B, nb, W, Hkv, D)
    vb = v.reshape(B, nb, W, Hkv, v.shape[-1])
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)   # (B, nb, 2W, Hkv, D)
    v2 = torch.cat([vprev, vb], dim=2)

    logits = torch.einsum("bnqhgd,bnkhd->bnhgqk", qb, k2).float()
    logits = logits * scale

    qi = torch.arange(W, device=q.device)[:, None]      # position in block
    kj = torch.arange(2 * W, device=q.device)[None, :]  # in [prev | own]
    delta = qi + W - kj                                 # qpos - kpos
    mask = (delta >= 0) & (delta < W)                   # causal, in window
    first = (torch.arange(nb, device=q.device) == 0)[:, None, None]
    mask = mask[None, :, :] & (~first | (kj >= W))      # no block -1 at i=0
    logits = logits.masked_fill(~mask[None, :, None, None], -1e30)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", probs, v2)
    return out.reshape(B, S, H, v.shape[-1])


def banded_enabled() -> bool:
    return os.environ.get("REPRO_NO_BANDED", "0") != "1"


# --------------------------------------------------------------------------
# GQA attention layer (self or cross), with decode KV cache
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, dtype,
                   d_model: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    hd = cfg.hd
    return {
        "wq": init_linear(gen, d, cfg.n_heads * hd, dtype),
        "wk": init_linear(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": init_linear(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": init_linear(gen, cfg.n_heads * hd, d, dtype),
    }


def _write(buf: torch.Tensor, x: torch.Tensor, start: int) -> None:
    """`buf[:, start:start+S] = x` in place, `start` placed as
    `jax.lax.dynamic_update_slice` places it: a negative one counts from
    the end, then it is clamped to ``[0, Smax - S]``."""
    S, Smax = x.shape[1], buf.shape[1]
    if S > Smax:
        raise ValueError(f"a block of {S} positions does not fit a cache "
                         f"of {Smax}")
    start = int(start)
    start = min(max(start + Smax if start < 0 else start, 0), Smax - S)
    buf[:, start:start + S] = x.to(buf.dtype)


def attention(
    p: Params,
    cfg,
    x: torch.Tensor,                   # (B, S, D)
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    memory: Optional[torch.Tensor] = None,   # cross-attention source
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {'k','v'} (B, Smax, Hkv, hd)
    pos: Optional[int] = None,         # decode position
    static_kv: bool = False,           # cache holds primed cross K/V
):
    """Returns (out, new_cache); `new_cache` is `cache`, written in place."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, hd)

    new_cache = cache
    kv_len = None
    q_offset = 0
    key_positions = None
    if static_kv:
        # cross-attention against precomputed K/V (decode phase)
        k, v = cache["k"], cache["v"]
        causal = False
    else:
        src = memory if memory is not None else x
        k = linear(p["wk"], src).reshape(B, src.shape[1], cfg.n_kv_heads, hd)
        v = linear(p["wv"], src).reshape(B, src.shape[1], cfg.n_kv_heads, hd)
        if rope is not None and memory is None:
            cos, sin = rope
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        if memory is not None:
            causal = False
        elif cache is not None and window and cache["k"].shape[1] == window:
            # ring-buffer cache for sliding-window layers: the cache holds
            # only the last W positions, slot = pos % W.  Chosen by the
            # cache's length, as the reference chooses it.
            W = cache["k"].shape[1]
            slot = pos % W
            _write(cache["k"], k, slot)
            _write(cache["v"], v, slot)
            k, v = cache["k"], cache["v"]
            # absolute position held by each slot j: pos - ((pos - j) mod W)
            j = torch.arange(W, device=x.device)
            key_positions = pos - torch.remainder(pos - j, W)
            kv_len = pos + S
            q_offset = pos
        elif cache is not None:
            # decode self-attention: write k/v at `pos`, attend over cache
            _write(cache["k"], k, pos)
            _write(cache["v"], v, pos)
            k, v = cache["k"], cache["v"]
            kv_len = pos + S
            q_offset = pos

    if (window and causal and cache is None and memory is None
            and not static_kv and prefix_len == 0 and S % window == 0
            and S // window >= 2 and banded_enabled()):
        out = sdpa_banded(q, k, v, window)
    else:
        out = sdpa(
            q, k, v,
            causal=causal,
            window=window,
            q_offset=q_offset,
            prefix_len=prefix_len,
            kv_len=kv_len,
            key_positions=key_positions,
        )
    return linear(p["wo"], out.reshape(B, S, cfg.n_heads * hd)), new_cache


def init_attention_cache(cfg, batch: int, max_seq: int, dtype,
                         device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
