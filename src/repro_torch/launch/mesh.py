"""Mesh construction (the JAX package's `launch.mesh`).  Functions only:
importing this module touches no device and no process group.

A mesh here is a description, `distributed.sharding.Mesh`: axis names
and sizes, as jax's `Mesh` has them (`.shape`, `.axis_names`).  The ranks
behind it are `torch.distributed`'s process group, one rank a device.
"""
from __future__ import annotations

from ..distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh: 16x16 per pod; 2 pods for multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_test_mesh(dp: int = 1, tp: int = 1) -> Mesh:
    """A (dp, tp) mesh over the ranks that exist: the default process
    group's, or the one process without a group.  Raises ValueError when
    dp * tp differs from that count, as `jax.make_mesh` refuses a shape
    the devices do not fill."""
    import torch.distributed as dist

    ranks = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    if dp * tp != ranks:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} ranks; "
                         f"there are {ranks}")
    return Mesh(("data", "model"), (dp, tp))
