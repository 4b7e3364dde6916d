"""AdamW with fp32 master weights, global-norm clipping, cosine schedule
(the JAX package's `optim.adamw`).

The optimizer state holds the fp32 master copy plus moments; model params
stay in the compute dtype (bf16 on the card).  The state mirrors the
params' tree (nested dicts and lists of tensors), on the params' device.

`update` is functional, as the reference's: it returns new tensors and
writes none of its inputs.  The learning rate, the clip scale and the
bias corrections ``1 - b ** step`` are float32 tensors computed from the
int32 `step` tensor, as the reference's traced arithmetic computes them
(not Python floats), so no step reads the device from the host.

On DTensors (`distributed.sharding.place`), the state is ZeRO-placed:
master, m and v take the parameter's placement plus ``data`` on the
first free dim (`sharding.opt_shardings`).  `update` runs at that
placement: each gradient is redistributed to its master's placement (a
gradient still pending a sum over ``data`` is reduce-scattered, one
pending over ``model`` all-reduced), and the new compute-dtype
parameters return to the parameter's placement, the master's with
``data`` replicated (an all-gather).  The parameter rules never use
``data``, so that placement is the parameter's own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..models.scan_util import tree_leaves, tree_map

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    master: Params         # fp32 master weights
    m: Params              # first moment (moments_dtype)
    v: Params              # second moment (moments_dtype)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"   # 'bfloat16' halves optimizer memory


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to `lr_peak`, then a cosine to `lr_min`: a float32
    tensor of `step`'s shape and device (an int is taken as int32)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr_peak * torch.clamp(
        (step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _tree_map_n(fn: Callable, tree, *rest) -> tuple:
    """`fn` over the leaves of `tree` (and the same leaves of `rest`),
    `fn` returning a tuple: the tuple of trees of its results."""
    outs = []
    tree_map(lambda *a: outs.append(fn(*a)), tree, *rest)
    cols = list(zip(*outs))
    return tuple(tree_map(lambda _, it=iter(c): next(it), tree) for c in cols)


def init(params: Params, cfg: AdamWConfig) -> AdamWState:
    """Step 0, an fp32 copy of `params` and zero moments, on the params'
    device."""
    mdt = {"float32": torch.float32,
           "bfloat16": torch.bfloat16}[cfg.moments_dtype]
    master = tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda: tree_map(lambda x: torch.zeros(x.shape, dtype=mdt,
                                                   device=x.device), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      master, zeros(), zeros())


def global_norm(tree: Params) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in leaves))


def _to_state(g, master):
    """A gradient at its master's placement (module docstring)."""
    from torch.distributed.tensor import DTensor

    if isinstance(master, DTensor):
        return g.redistribute(master.device_mesh, master.placements)
    return g


def _to_param(x):
    """A new parameter at the parameter's placement: the master's with
    the ``data`` mesh dim replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, [
        Replicate() if name == "data" else pl
        for name, pl in zip(mesh.mesh_dim_names, x.placements)])


def update(
    grads: Params, state: AdamWState, cfg: AdamWConfig,
    compute_dtype=torch.bfloat16,
) -> Tuple[Params, AdamWState]:
    """Returns (new compute-dtype params, new state)."""
    grads = tree_map(_to_state, grads, state.master)
    step = state.step + 1
    lr = cosine_lr(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step

    def upd(g, master, m, v):
        g = g.float() * scale
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m2 / bc1
        vhat = v2 / bc2
        new_master = master - lr * (
            mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * master
        )
        return new_master, m2.to(m.dtype), v2.to(v.dtype)

    new_master, new_m, new_v = _tree_map_n(upd, grads, state.master,
                                           state.m, state.v)
    new_params = tree_map(lambda x: _to_param(x.to(compute_dtype)),
                          new_master)
    return new_params, AdamWState(step, new_master, new_m, new_v)
