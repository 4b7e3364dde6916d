"""Mixture-of-Experts layer: top-k router + capacity-bounded dispatch (the
JAX package's `models.moe`).

Two execution paths with the reference's semantics:

  * `dense`    — every expert processes every token, gates mask the output.
    The oracle.  Experts run in slices (`_DENSE_SLICE_ELEMS`), so the
    (E, T, d) outputs are never held at once; the slices' gated outputs
    are added up in float32 in expert order.
  * `capacity` — sort-based dispatch: tokens sorted by expert, each expert
    processes a static-capacity tile (E, C, d) through batched matmuls;
    overflow tokens are dropped (capacity-factor semantics).

The reference's choices that decide which tokens an expert keeps are kept
exactly: top-k ties fall lower expert index first (`jax.lax.top_k`; here a
stable descending sort), the dispatch order is a stable argsort, and each
expert's segment starts at `searchsorted(..., side="left")`.  Nothing is
read back to the host and every shape is static.

The combine is deterministic: the reference scatter-adds each slot's
weighted output into its token (`y.at[buf_t].add`), which on CUDA would be
atomics; here each token gathers its k weighted expert rows (an overflow
pair gathers a zero row) and sums them in float32 in top-k order, so two
runs agree bit for bit.

On DTensors (a step placed over a mesh, `distributed.sharding`), the
capacity path keeps the reference's global semantics: each rank routes
its own rows, then the routing and the tokens are gathered on every
rank, so the sort and the capacity see the whole batch, and the
dispatch (`argsort`, `searchsorted`, `repeat_interleave`, which have no
sharding rules) runs on the replicated routing through `local_map`, so
every rank picks the same experts.  The expert stacks (E, ...) are
sharded over ``model`` (EP): the (E, C, d) tile is cut to each rank's
experts and, over the other mesh dims, to a share of their slots, its
outputs gathered back, and each rank combines its own rows as above.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from .layers import init_linear, linear, swiglu, swiglu_init

Params = Dict[str, Any]

#: the dense path runs at most this many (expert, token, width) elements
#: of expert activations at a time
_DENSE_SLICE_ELEMS = 1 << 27


def _experts(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """(E, d_in, d_out) normals · std in `dtype`, drawn one expert at a time
    in float32 into a preallocated tensor: one draw of deepseek's
    (256, 7168, 2048) would hold 15 GB of float32 at once."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if gen.device.type == "meta":  # shapes only: nothing to draw
        return out
    for e in range(shape[0]):
        x = torch.randn(shape[1:], generator=gen, device=gen.device,
                        dtype=torch.float32)
        out[e] = x * std
    return out


def init_moe(gen: torch.Generator, cfg, dtype,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.moe_d_ff
    E = cfg.n_experts
    p: Params = {
        "router": init_linear(gen, d, E, torch.float32),  # router in f32
        "w_gate": {"w": _experts(gen, (E, d, f), 1.0 / math.sqrt(d), dtype)},
        "w_up": {"w": _experts(gen, (E, d, f), 1.0 / math.sqrt(d), dtype)},
        "w_down": {"w": _experts(gen, (E, f, d), 1.0 / math.sqrt(f), dtype)},
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, d, f * cfg.n_shared_experts, dtype)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last axis: ties lower index first."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _router(p: Params, cfg, x2d: torch.Tensor):
    """Returns (top-k weights (T,k) float32, top-k expert ids (T,k), aux
    loss: Switch load balance + 1e-3 · router z-loss)."""
    logits = linear(p["router"], x2d.float())    # the router is float32
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, cfg.top_k)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)  # renormalize
    E = probs.shape[1]
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.nn.functional.one_hot(topi, E).float().sum(1),
                    dim=0)
    lb = E * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return topv, topi, lb + 1e-3 * z


def _expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d) via per-expert SwiGLU (batched matmul)."""
    g = torch.bmm(xe, p["w_gate"]["w"])
    u = torch.bmm(xe, p["w_up"]["w"])
    return torch.bmm(g * torch.sigmoid(g) * u, p["w_down"]["w"])


def _slice_experts(p: Params, lo: int, hi: int) -> Params:
    return {n: {"w": p[n]["w"][lo:hi]} for n in ("w_gate", "w_up", "w_down")}


def moe_dense(p: Params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle path: all experts on all tokens.  Gates in the input dtype,
    as the reference builds them; the gated sum in float32."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    topv, topi, aux = _router(p, cfg, x2)
    E = cfg.n_experts
    gates = torch.zeros((T, E), dtype=x.dtype, device=x.device)
    gates.scatter_(1, topi, topv.to(x.dtype))
    width = max(d, p["w_gate"]["w"].shape[-1])
    step = max(1, min(E, _DENSE_SLICE_ELEMS // (T * width)))
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for lo in range(0, E, step):
        hi = min(E, lo + step)
        ye = _expert_ffn(_slice_experts(p, lo, hi),
                         x2[None].expand(hi - lo, T, d))   # (e, T, d)
        y += torch.einsum("te,etd->td", gates[:, lo:hi].float(), ye.float())
    y = y.to(x.dtype)
    if "shared" in p:
        y = y + swiglu(p["shared"], x2)
    return y.reshape(B, S, d), aux


def capacity_of(cfg, T: int, capacity: Optional[int] = None) -> int:
    """Slots per expert: the reference's Python float expression."""
    return capacity or max(1, int(cfg.capacity_factor * T * cfg.top_k
                                  / cfg.n_experts))


def dispatch(cfg, topi: torch.Tensor, C: int):
    """The capacity dispatch of (T, k) expert ids into E·C slots.

    Returns (buf_t (E·C,) the token in each slot, T if empty; pair_slot
    (T, k) the slot of each (token, choice) pair, E·C if dropped)."""
    T, k = topi.shape
    E = cfg.n_experts
    dev = topi.device
    flat_e = topi.reshape(-1)                                 # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    # position within expert group
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[se]
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e,
                       torch.full_like(se, E * C))            # overflow
    buf_t = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    buf_t[slot] = st           # kept slots are distinct; E*C is scratch
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    return buf_t[:-1], pair_slot.reshape(T, k)


def _replicated(t):
    """A DTensor replicated on every mesh dim (gathered where sharded)."""
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _dispatch_placed(cfg, topi, C: int):
    """`dispatch` of replicated DTensor routing, on each rank's (equal)
    local copy, its outputs replicated DTensors."""
    from torch.distributed.tensor.experimental import local_map

    rep = tuple(topi.placements)
    return local_map(lambda t: dispatch(cfg, t, C), out_placements=(rep, rep),
                     in_placements=(rep,), device_mesh=topi.device_mesh)(topi)


def _tile_placements(p: Params, xe):
    """The (E, C, d) tile's placement: its experts as the expert stacks
    are sharded (``model``, EP), its slots over the other mesh dims, so
    that no two ranks run the same rows through the same expert."""
    from torch.distributed.tensor import Shard

    w = p["w_gate"]["w"]
    return [pl if isinstance(pl, Shard) and pl.dim == 0 else Shard(1)
            for pl in w.placements]


def moe_capacity(
    p: Params, cfg, x: torch.Tensor, capacity: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Production path: sort-based capacity dispatch."""
    from torch.distributed.tensor import DTensor

    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    E = cfg.n_experts
    C = capacity_of(cfg, T, capacity)
    placed = isinstance(x2, DTensor)

    topv, topi, aux = _router(p, cfg, x2)
    if placed:  # the whole batch's routing on every rank
        x_loc, x2 = x2, _replicated(x2)
        topv, topi = _replicated(topv), _replicated(topi)
    buf_t, pair_slot = (_dispatch_placed if placed else dispatch)(cfg, topi,
                                                                  C)

    x_pad = torch.cat([x2, x2.new_zeros((1, d))], dim=0)
    xe = x_pad[buf_t].reshape(E, C, d)
    if placed:  # each rank's experts and slots, the outputs gathered back
        xe = xe.redistribute(xe.device_mesh, _tile_placements(p, xe))
        ye = _replicated(_expert_ffn(p, xe)).reshape(E * C, d)
        # the combine for this rank's rows only
        pair_slot = pair_slot.redistribute(x_loc.device_mesh,
                                           x_loc.placements)
        topv = topv.redistribute(x_loc.device_mesh, x_loc.placements)
        x2 = x_loc
    else:
        ye = _expert_ffn(p, xe).reshape(E * C, d)
    ye_pad = torch.cat([ye, ye.new_zeros((1, d))], dim=0)    # dropped: 0

    y = torch.zeros_like(x2, dtype=torch.float32)
    for j in range(cfg.top_k):  # a fixed order: runs repeat bit for bit
        y += ye_pad[pair_slot[:, j]].float() * topv[:, j:j + 1]
    y = y.to(x.dtype)
    if "shared" in p:
        y = y + swiglu(p["shared"], x2)
    return y.reshape(B, S, d), aux
