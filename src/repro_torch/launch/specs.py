"""Abstract inputs of every (arch × shape) cell (the JAX package's
`launch.specs`): `ShapeDtypeStruct` stand-ins (shape, dtype, sharding;
zero allocation) for every model input, plus the step functions.

The shapes come from running `init`, `optim.init` and `cache_init` on
PyTorch's meta device, which records shapes and dtypes and allocates
nothing (deepseek-v3-671b whole is 1.3 TB in bf16).  `eval_shape` runs a
step on meta tensors, the port's `jax.eval_shape`.  `abstract_cell`
returns the reference's ``donate_argnums`` too; eager PyTorch donates
nothing and does not read it.

Given a `DeviceMesh` (``device_mesh=``, `distributed.sharding.
device_mesh`), `abstract_cell` returns the inputs as DTensors instead:
fake tensors (`FakeTensorMode`, which the caller must have entered: no
memory is allocated) on the mesh's device type, each placed by its
NamedSharding, so that the step runs on them as it would on the mesh's
ranks (`launch.dryrun`).  A 0-d integer input (the decode position) is
the Python int 0 there, as in `eval_shape`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .. import optim
from ..configs.base import ArchConfig, ShapeConfig
from ..distributed import sharding as SH
from ..distributed.sharding import Mesh, NamedSharding, P
from ..models import build
from ..models.scan_util import tree_map
from .train import make_step

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None


def _sds(shape, dtype, sharding=None):
    return ShapeDtypeStruct(tuple(shape), dtype, sharding)


def _shard_like(tree_shapes, shardings):
    return tree_map(lambda s, sh: _sds(s.shape, s.dtype, sh), tree_shapes,
                    shardings)


def _meta(tree):
    """Meta tensors of a tree of ShapeDtypeStructs (or tensors)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=META), tree)


def eval_shape(fn, *args, **kwargs):
    """`fn` run on meta tensors of the ShapeDtypeStructs in its arguments;
    returns its outputs' ShapeDtypeStructs (no sharding).  A 0-d integer
    argument is passed as the Python int 0: the port's decode position
    is a Python int."""
    def arg(s):
        if isinstance(s, ShapeDtypeStruct) and s.shape == () \
                and not s.dtype.is_floating_point:
            return 0
        return _meta(s)

    out = fn(*(arg(a) for a in args), **{k: arg(v) for k, v in
                                         kwargs.items()})
    return tree_map(lambda t: _sds(t.shape, t.dtype), out)


def abstract_params(cfg: ArchConfig, mesh: Mesh):
    shapes = build(cfg).init(0, device=META)
    return _shard_like(shapes, SH.param_shardings(shapes, mesh))


def abstract_opt_state(cfg: ArchConfig, mesh: Mesh, params_abs, ocfg):
    shapes = optim.init(_meta(params_abs), ocfg)
    shardings = SH.opt_shardings(shapes, params_abs, mesh)
    return optim.AdamWState(
        step=_sds((), torch.int32, shardings.step),
        master=_shard_like(shapes.master, shardings.master),
        m=_shard_like(shapes.m, shardings.m),
        v=_shard_like(shapes.v, shardings.v),
    )


def abstract_batch(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, train: bool):
    B, S = shape.global_batch, shape.seq_len
    bspec = NamedSharding(mesh, SH.batch_spec(mesh, B, 1))
    out: Dict[str, Any] = {"tokens": _sds((B, S), torch.int32, bspec)}
    if train:
        out["labels"] = _sds((B, S), torch.int32, bspec)
    if cfg.n_prefix_tokens:
        e3 = NamedSharding(mesh, SH.batch_spec(mesh, B, 2))
        out["prefix_embeds"] = _sds(
            (B, cfg.n_prefix_tokens, cfg.prefix_dim), torch.bfloat16, e3)
    if cfg.is_encdec:
        e3 = NamedSharding(mesh, SH.batch_spec(mesh, B, 2))
        out["src_embeds"] = _sds((B, S, cfg.d_model), torch.bfloat16, e3)
    return out


def abstract_caches(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                    ring: bool = False):
    """The decode caches' stand-ins.  The encoder-decoder's `cache_init`
    takes no `ring`, as the reference's: it raises TypeError here, as the
    reference's `abstract_caches` does."""
    B, S = shape.global_batch, shape.seq_len
    shapes = build(cfg).cache_init(B, S, ring=ring, device=META)
    return _shard_like(shapes, SH.cache_shardings(shapes, mesh))


def make_train_step(cfg: ArchConfig, ocfg):
    """The launcher's step (`train.make_step`, uncompressed, on one rank):
    the loss under ``moe_path="capacity"`` and ``remat=True``, its
    gradients, the AdamW update."""
    step = make_step(build(cfg), ocfg, cfg, False, None)

    def train_step(params, opt_state, batch):
        new_params, new_state, loss = step(params, opt_state, batch)
        return new_params, new_state, {"loss": loss}

    return train_step


def _placed_context(params):
    """`sharding.step_context()` for a step on DTensors, else nothing."""
    import contextlib

    return SH.step_context() if SH.is_placed(params) \
        else contextlib.nullcontext()


def make_prefill_step(cfg: ArchConfig, *, last_only: bool = False):
    bundle = build(cfg)

    def prefill_step(params, batch):
        with _placed_context(params):
            if cfg.is_encdec:
                out, aux = bundle.prefill_fn(params, batch)
            else:
                out, aux = bundle.prefill_fn(params, batch,
                                             last_only=last_only)
        return out

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, mla_absorbed: bool = False):
    bundle = build(cfg)

    def serve_step(params, token, caches, pos):
        with _placed_context(params):
            logits, new_caches = bundle.decode_fn(
                params, token, caches, pos, mla_absorbed=mla_absorbed)
        return logits, new_caches

    return serve_step


def _fake_placed(kwargs, dmesh):
    """Fake DTensors of a cell's ShapeDtypeStruct inputs (module
    docstring); a 0-d integer input is the Python int 0, as in
    `eval_shape`."""
    from torch._guards import detect_fake_mode

    if detect_fake_mode() is None:
        raise ValueError("abstract_cell(device_mesh=...) makes fake "
                         "tensors: call it under a FakeTensorMode")

    from torch.distributed.tensor import DTensor

    def one(s):  # this rank's shard only: nothing whole is made
        pls = SH.placements(s.sharding.spec, dmesh)
        local = [SH.local_slice(s.shape, dmesh, pls, d)[1]
                 for d in range(len(s.shape))]
        t = torch.empty(local, dtype=s.dtype, device=dmesh.device_type)
        return DTensor.from_local(t, dmesh, pls, run_check=False,
                                  shape=torch.Size(s.shape),
                                  stride=torch.empty(s.shape,
                                                     device="meta").stride())

    def arg(v):
        if isinstance(v, ShapeDtypeStruct) and v.shape == () \
                and not v.dtype.is_floating_point:
            return 0
        return tree_map(one, v)

    return {k: arg(v) for k, v in kwargs.items()}


def abstract_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, ocfg,
                  *, mla_absorbed: bool = False, ring: bool = False,
                  prefill_last_only: bool = False, device_mesh=None):
    """Returns (step_fn, kwargs of abstract inputs, donate_argnums): the
    inputs ShapeDtypeStructs, or fake DTensors on `device_mesh` (module
    docstring)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():  # the meta inits, outside a fake mode
        step, kwargs, donate = _abstract_cell(
            cfg, shape, mesh, ocfg, mla_absorbed=mla_absorbed, ring=ring,
            prefill_last_only=prefill_last_only)
    if device_mesh is not None:
        kwargs = _fake_placed(kwargs, device_mesh)
    return step, kwargs, donate


def _abstract_cell(cfg, shape, mesh, ocfg, *, mla_absorbed, ring,
                   prefill_last_only):
    params = abstract_params(cfg, mesh)
    if shape.kind == "train":
        step = make_train_step(cfg, ocfg)
        opt = abstract_opt_state(cfg, mesh, params, ocfg)
        batch = abstract_batch(cfg, shape, mesh, train=True)
        return step, dict(params=params, opt_state=opt, batch=batch), (0, 1)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, last_only=prefill_last_only)
        batch = abstract_batch(cfg, shape, mesh, train=False)
        return step, dict(params=params, batch=batch), ()
    if shape.kind == "decode":
        step = make_serve_step(cfg, mla_absorbed=mla_absorbed)
        B = shape.global_batch
        tok_spec = NamedSharding(mesh, SH.batch_spec(mesh, B, 1))
        token = _sds((B, 1), torch.int32, tok_spec)
        caches = abstract_caches(cfg, shape, mesh, ring=ring)
        pos = _sds((), torch.int32, NamedSharding(mesh, P()))
        return step, dict(params=params, token=token, caches=caches, pos=pos), (2,)
    raise ValueError(shape.kind)
