"""Gradient compression: int8 quantization with error feedback (the JAX
package's `optim.compress`).

Used for the data-parallel gradient all-reduce at scale (cuts DP collective
bytes 4x vs fp32 / 2x vs bf16).  Error feedback [Karimireddy et al. 2019]
keeps the quantization error in a local buffer and re-injects it next step,
preserving convergence.

`compressed_psum_mean` runs on `torch.distributed`: a process group takes
the place of the reference's `shard_map` axis name, and the mean is an
`all_reduce` SUM of the dequantized float32 tensors divided by the
group's size.  `torch.round` rounds half to even, as `jnp.round` does, so
`quantize_int8` gives the reference's int8 values bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.scan_util import tree_map
from .adamw import _tree_map_n

Params = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(grads: Params) -> Params:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_psum_mean(
    grads: Params, ef: Params, group=None
) -> Tuple[Params, Params]:
    """int8 all-reduce-mean over the process group `group` (the default
    group when None; it must be initialized) with error feedback.

    Returns (reduced grads fp32, new error-feedback buffers).
    """
    import torch.distributed as dist

    world = dist.get_world_size(group)

    def one(g, e):
        target = g.float() + e
        q, scale = quantize_int8(target)
        deq = dequantize_int8(q, scale)
        new_e = target - deq
        # all-reduce the dequantized value (wire format int8+scale; the
        # collective carries the dequantized tensor, as the reference's)
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        return deq / world, new_e

    return _tree_map_n(one, grads, ef)
