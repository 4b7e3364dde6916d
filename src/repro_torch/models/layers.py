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


def _sharded_dim(t, dim: int) -> bool:
    """Whether `t` is a DTensor sharded on `dim` over some mesh dim."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(t, DTensor) and any(
        isinstance(pl, Shard) and pl.dim == dim for pl in t.placements)


def _residual_placement(x):
    from torch.distributed.tensor import Replicate, Shard

    return [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in x.placements]


def _to_residual(x):
    want = _residual_placement(x)
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _Residual(torch.autograd.Function):
    """`residual` on DTensors: forward and backward alike."""

    @staticmethod
    def forward(ctx, x):
        return _to_residual(x)

    @staticmethod
    def backward(ctx, g):
        return _to_residual(g)


def residual(x: torch.Tensor) -> torch.Tensor:
    """A DTensor activation (B, ...) at the residual stream's placement:
    its rows sharded as the batch is, everything else whole on every
    rank (a pending sum, as a row-parallel product leaves it, is
    all-reduced; a shard of another dim gathered), and its gradient
    brought to that placement too.  Tensor parallelism keeps the stream
    so between layers, in the forward and the backward: each layer's
    column-parallel products shard their outputs over ``model`` and its
    row-parallel ones end in one all-reduce, and the backward mirrors
    it.  DTensor's per-op choices alone, which weigh only the bytes
    moved, leave the stream sharded on its width, the logits as partial
    sums, and in the backward gather whole weights and compute every
    rank's share on every rank.  A plain tensor comes back as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _Residual.apply(x)


def split_dim(t: torch.Tensor, dim: int, *shape) -> torch.Tensor:
    """`t.reshape(*shape)` where `shape` splits dim `dim` of `t` into
    (shape[dim], ...).  On a DTensor whose dim `dim` is sharded over
    mesh dims that shape[dim] does not divide among (8 kv heads over a
    ``model`` axis of 16), those mesh dims are gathered first: DTensor
    cannot split such a shard, where GSPMD would re-tile it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(t, DTensor):
        dim %= t.ndim
        mesh, pls = t.device_mesh, list(t.placements)
        on = [i for i, pl in enumerate(pls)
              if isinstance(pl, Shard) and pl.dim == dim]
        if shape[dim] % math.prod(mesh.size(i) for i in on):
            for i in on:
                pls[i] = Replicate()
            t = t.redistribute(mesh, pls)
    return t.reshape(*shape)


class _MergeHeads(torch.autograd.Function):
    """(B, S, H, D) -> (B, S, H·D), whose backward splits the gradient
    with `split_dim`: a gradient sharded on H·D over more ranks than H
    divides among cannot be viewed back as (H, D) by DTensor."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = tuple(x.shape)
        B, S, H, D = x.shape
        return x.reshape(B, S, H * D)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, 2, *ctx.shape)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H·D) (`_MergeHeads` on a DTensor)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _MergeHeads.apply(x)
    B, S, H, D = x.shape
    return x.reshape(B, S, H * D)


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """The rows of `ids`.  A table sharded over the vocabulary (dim 0)
    goes through `F.embedding`, whose DTensor rule has each rank look up
    the ids it holds and all-reduces the rows, instead of gathering the
    table.  The rows leave it at the residual placement (`residual`):
    reduced, as a later elementwise op could not reduce the lookup's
    masked partial sum into a shard, and their gradient whole."""
    from torch.distributed.tensor import DTensor

    w = p["w"]
    if _sharded_dim(w, 0):
        return residual(torch.nn.functional.embedding(ids, w))
    if isinstance(w, DTensor):
        return _embed_local(w, ids)
    return w[ids]


def _embed_local(w, ids):
    """The lookup of a table whole on every rank, on each rank's own ids
    through `local_map`: the plain lookup and its backward, with the
    table's gradient a partial sum over the ranks that split the ids
    (DTensor's own `index_put` rule for that backward fails in some
    PyTorch versions)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ids = ids.redistribute(mesh, [pl if isinstance(pl, Shard) and pl.dim == 0
                                  else Replicate() for pl in ids.placements])
    rows = tuple(ids.placements)
    grad = [Partial() if isinstance(pl, Shard) else Replicate()
            for pl in rows]
    return local_map(lambda t, i: t[i], out_placements=(rows,),
                     in_placements=(tuple(w.placements), rows),
                     in_grad_placements=(grad, rows),
                     device_mesh=mesh)(w, ids)


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

class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_local(fn):
    """`fn` on local tensors (the body of a `local_map`), its outputs and
    its inputs' gradients made contiguous: DTensor views a local tensor
    by the strides of the whole, which a transposed result (an einsum's,
    or its backward's) does not have."""
    def wrapped(*args, **kwargs):
        args = [_ContiguousGrad.apply(a)
                if isinstance(a, torch.Tensor) and a.requires_grad else a
                for a in args]
        out = fn(*args, **kwargs)
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()
    return wrapped


def split_placements(rows, split, dim_rows, dim_split, grad=False):
    """The placements, one per mesh dim, of a tensor in a `local_map`
    region that the mesh dims in `rows` split by batch rows and those in
    `split` by heads or channels (lists of bools): ``Shard(dim_rows)``
    and ``Shard(dim_split)`` where the tensor has that dim (None: it has
    not); where it has not, ``Partial()`` for the gradient of an input
    that every such shard reads (`grad`), else ``Replicate()``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for r, s in zip(rows, split):
        dim = dim_rows if r else dim_split if s else None
        out.append(Shard(dim) if dim is not None
                   else Partial() if grad and (r or s) else Replicate())
    return out


def head_parallel(fn, q, k, v, *args, **kwargs):
    """`fn(q, k, v, *args, **kwargs)` (`sdpa`, `sdpa_banded`), on
    DTensors head by head: each rank attends its own (batch rows,
    query heads) on its local tensors through `local_map`, as tensor
    parallelism does.  The kv heads are sharded as the query heads when
    they divide among the same ranks, else repeated for the G query
    heads of their group first (8 kv heads over a ``model`` axis of 16).
    DTensor's own rules would merge the batch and head dims into one
    product dim, which they cannot keep sharded on both, and compute
    every head on every rank.  Keys sharded along the sequence (a
    ``long_500k`` cache) are left to DTensor, which reduces the softmax
    over the shards.  Plain tensors go to `fn` as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor) or _sharded_dim(k, 1):
        return fn(q, k, v, *args, **kwargs)
    mesh = q.device_mesh
    want = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
            else Shard(2) if isinstance(pl, Shard) and pl.dim == 2
            else Replicate() for pl in q.placements]
    n = math.prod(mesh.size(i) for i, pl in enumerate(want)
                  if isinstance(pl, Shard) and pl.dim == 2)
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv % n:  # each kv head for its G query heads
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    q, k, v = (t.redistribute(mesh, want) for t in (q, k, v))
    return local_map(lambda a, b, c: contiguous_local(fn)(a, b, c, *args,
                                                          **kwargs),
                     out_placements=(want,), in_placements=(want,) * 3,
                     device_mesh=mesh)(q, k, v)


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

    qg = split_dim(q, 2, B, Sq, Hkv, G, D)
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
    if _sharded_dim(buf, 1):
        _write_local(buf, x, start)
        return
    buf[:, start:start + S] = x.to(buf.dtype)


def local_range(t, dim: int):
    """(lo, n): this rank's slice [lo, lo + n) of dim `dim` of the DTensor
    `t` (`distributed.sharding.local_slice`)."""
    from ..distributed.sharding import local_slice

    return local_slice(t.shape, t.device_mesh, t.placements, dim)


def _write_local(buf, x, start: int) -> None:
    """`_write` into a DTensor cache whose positions (dim 1) are sharded:
    each rank writes only the rows of the block that fall in its own
    slice of the positions, as XLA's `dynamic_update_slice` on a sharded
    dim does; the cache is never gathered.  The block (a few tokens) is
    first replicated over the dims that shard the positions."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, pls = buf.device_mesh, buf.placements
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
            for pl in pls]
    x = x.to(buf.dtype)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    xl = x.redistribute(mesh, want).to_local()
    lo, n = local_range(buf, 1)
    S = x.shape[1]
    a, b = max(start, lo), min(start + S, lo + n)
    if a < b:
        buf.to_local()[:, a - lo:b - lo] = xl[:, a - start:b - start]


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
    q = split_dim(linear(p["wq"], x), 2, B, S, cfg.n_heads, hd)

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
        k = split_dim(linear(p["wk"], src), 2, B, src.shape[1],
                      cfg.n_kv_heads, hd)
        v = split_dim(linear(p["wv"], src), 2, B, src.shape[1],
                      cfg.n_kv_heads, hd)
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
        out = head_parallel(sdpa_banded, q, k, v, window)
    else:
        out = head_parallel(
            sdpa, q, k, v,
            causal=causal,
            window=window,
            q_offset=q_offset,
            prefix_len=prefix_len,
            kv_len=kv_len,
            key_positions=key_positions,
        )
    return linear(p["wo"], merge_heads(out)), new_cache


def init_attention_cache(cfg, batch: int, max_seq: int, dtype,
                         device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
