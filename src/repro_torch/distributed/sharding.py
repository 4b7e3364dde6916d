"""Sharding rules: parameter / optimizer / activation / cache layouts (the
JAX package's `distributed.sharding`, rule for rule).

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  Batch (and sequence, for serve shapes) shards over the
data-parallel axes; weights shard over ``model`` (TP/EP); optimizer state is
additionally ZeRO-sharded over ``data``.

Rules are *name-anchored on the trailing dimensions* of each leaf, so the
same rule covers a plain layer and its scan-stacked (L, ...) or
(periods, p, ...) variants.  Every rule degrades to replication when the
dimension is not divisible by the axis size — a config can therefore never
fail to shard, it only loses parallelism.

jax's sharding types have counterparts of their own here: `Mesh` (axis
names and sizes, no devices), `PartitionSpec` (a tuple whose entries are
None, an axis name or a tuple of names) and `NamedSharding(mesh, spec)`.
The rules are pure functions of paths and shapes.

The rules place tensors through DTensor (`torch.distributed.tensor`),
which propagates shardings op by op as GSPMD does: `device_mesh` builds
a `DeviceMesh` of the mesh's axes over the default process group,
`placements` maps a spec to DTensor placements (an axis on dim i is
``Shard(i)`` on that mesh dim; a tuple of axes on one dim shards it on
each of them in the spec's order, so the local shard is the reference's
`NamedSharding.shard_shape`), `place` distributes a tree of whole
tensors (each rank holds the same whole tensor: no data moves) and
`gather` brings a tree of DTensors back whole on every rank.

The models are plain PyTorch and make tensors of their own (RoPE tables,
masks, zero states, ring positions).  A step on DTensors runs inside
`step_context`, `implicit_replication()`, under which such a plain
tensor counts as replicated on every rank (it is: every rank makes the
same one); the models' own DTensor branches (`models.layers.residual`,
`head_parallel`, the vocabulary-parallel cross-entropy, the MoE
dispatch) say where each sharded tensor goes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

from ..optim.adamw import AdamWState

Params = Any


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh's axis names and sizes (jax's `Mesh` without devices)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), an axis name, or a
    tuple of axis names; equal to the tuple of its entries.  A tuple of
    one name is that name, as jax's `PartitionSpec` normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


# (suffix, trailing-ndim, trailing spec) — first match wins.
# 'M' = model axis, None = replicated.
_RULES: Tuple[Tuple[str, int, Tuple], ...] = (
    ("embed/w", 2, ("M", None)),
    ("lm_head/w", 2, (None, "M")),
    ("prefix_proj/w", 2, (None, "M")),
    ("router/w", 2, (None, None)),
    ("w_gate/w", 3, ("M", None, None)),     # experts on EP axis
    ("w_up/w", 3, ("M", None, None)),
    ("w_down/w", 3, ("M", None, None)),
    ("gate/w", 2, (None, "M")),
    ("up/w", 2, (None, "M")),
    ("down/w", 2, ("M", None)),
    ("wq_a/w", 2, (None, "M")),
    ("wq_b/w", 2, (None, "M")),
    ("wkv_a/w", 2, (None, None)),           # small latent proj, replicated
    ("wkv_b/w", 2, (None, "M")),
    ("wq/w", 2, (None, "M")),
    ("wk/w", 2, (None, "M")),
    ("wv/w", 2, (None, "M")),
    ("wo/w", 2, ("M", None)),
    ("in_proj/w", 2, (None, "M")),
    ("out_proj/w", 2, ("M", None)),
    ("conv_w", 2, (None, "M")),
    ("conv_b", 1, ("M",)),
)


def _path_str(path) -> str:
    """A leaf's path (dict keys, list indices, NamedTuple field names) as
    the reference writes it: ``"blocks/0/attn/wq/w"``."""
    return "/".join(str(p) for p in path)


def _tree_map_with_path(fn, tree, path: Tuple = ()):
    """`fn(path, leaf)` over the leaves of a tree of dicts, lists and
    tuples (NamedTuples by field name), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def _resolve(spec: Sequence, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Map 'M' -> 'model' with divisibility check; pad leading dims."""
    tp = _axis_size(mesh, "model")
    trailing = []
    for dim, s in zip(shape[len(shape) - len(spec):], spec):
        if s == "M" and tp > 1 and dim % tp == 0:
            trailing.append("model")
        else:
            trailing.append(None)
    lead = [None] * (len(shape) - len(spec))
    return P(*(lead + trailing))


def param_spec(path: str, shape: Tuple[int, ...], mesh: Mesh) -> P:
    for suffix, nd, spec in _RULES:
        if path.endswith(suffix) and len(shape) >= nd:
            return _resolve(spec, shape, mesh)
    return P()  # norms, scalars, biases: replicated


def param_shardings(params_shapes: Params, mesh: Mesh) -> Params:
    """Tree of NamedSharding for a tree of tensors or ShapeDtypeStructs."""
    def f(path, leaf):
        return NamedSharding(mesh, param_spec(_path_str(path),
                                              tuple(leaf.shape), mesh))
    return _tree_map_with_path(f, params_shapes)


def zero_spec(pspec: P, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """ZeRO: additionally shard the first replicated dim over 'data'."""
    dp = _axis_size(mesh, "data")
    if dp <= 1:
        return pspec
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % dp == 0 and dim >= dp:
            spec[i] = "data"
            return P(*spec)
    return P(*spec)


def opt_shardings(opt_shapes, params_shapes, mesh: Mesh) -> AdamWState:
    """AdamWState shardings: master/m/v get param spec + ZeRO over data."""
    def record(path, leaf):
        shape = tuple(leaf.shape)
        ps = param_spec(_path_str(path), shape, mesh)
        return NamedSharding(mesh, zero_spec(ps, shape, mesh))

    def for_tree(tree):
        return _tree_map_with_path(record, tree)

    return AdamWState(
        step=NamedSharding(mesh, P()),
        master=for_tree(opt_shapes.master),
        m=for_tree(opt_shapes.m),
        v=for_tree(opt_shapes.v),
    )


# ---------------------------------------------------------------------------
# activations / batch / caches
# ---------------------------------------------------------------------------

def dp_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_size(mesh: Mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in dp_axes(mesh))


def batch_spec(mesh: Mesh, batch: int, extra_dims: int = 1) -> P:
    """Shard leading batch dim over the dp axes if divisible."""
    if batch % dp_size(mesh) == 0:
        return P(dp_axes(mesh), *([None] * extra_dims))
    return P(*([None] * (1 + extra_dims)))


def cache_sharding(mesh: Mesh, shape: Tuple[int, ...], kind: str) -> NamedSharding:
    """KV / state cache layout.

    kind 'kv':      (L, B, S, Hkv, hd)  — B over dp; else S over model(+dp)
    kind 'mla':     (L, B, S, r)        — B over dp; else S over model(+dp)
    kind 'ssm':     (L, B, H, P, N)     — B over dp; H over model
    kind 'conv':    (L, B, W, C)        — B over dp; C over model
    Leading extra dims (period stacking) are replicated.
    """
    dp = dp_size(mesh)
    tp = _axis_size(mesh, "model")
    nd = len(shape)
    spec = [None] * nd

    def core_dims(n):  # index of the trailing n dims
        return list(range(nd - n, nd))

    if kind in ("kv", "mla"):
        n = 5 if kind == "kv" else 4
        li, bi, si = core_dims(n)[0:3]
        if shape[bi] % dp == 0 and shape[bi] >= dp:
            spec[bi] = dp_axes(mesh)
            if kind == "kv" and shape[nd - 2] % tp == 0 and shape[nd - 2] >= tp:
                spec[nd - 2] = "model"  # kv heads over model when divisible
        else:
            axes = dp_axes(mesh) + ("model",)
            total = dp * tp
            if shape[si] % total == 0:
                spec[si] = axes
            elif shape[si] % tp == 0:
                spec[si] = "model"
    elif kind == "ssm":
        li, bi, hi, pi, ni = core_dims(5)
        if shape[bi] % dp == 0 and shape[bi] >= dp:
            spec[bi] = dp_axes(mesh)
        if shape[hi] % tp == 0 and shape[hi] >= tp:
            spec[hi] = "model"
    elif kind == "conv":
        li, bi, wi, ci = core_dims(4)
        if shape[bi] % dp == 0 and shape[bi] >= dp:
            spec[bi] = dp_axes(mesh)
        if shape[ci] % tp == 0:
            spec[ci] = "model"
    return NamedSharding(mesh, P(*spec))


def cache_shardings(cache_shapes, mesh: Mesh):
    """Walk a cache tree, classify each leaf by its key name."""
    def f(path, leaf):
        name = _path_str(path)
        last = name.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        if last in ("k", "v"):
            return cache_sharding(mesh, shape, "kv")
        if last in ("ckv", "krope"):
            return cache_sharding(mesh, shape, "mla")
        if last == "state":
            return cache_sharding(mesh, shape, "ssm")
        if last == "conv":
            return cache_sharding(mesh, shape, "conv")
        return NamedSharding(mesh, P())
    return _tree_map_with_path(f, cache_shapes)


# ---------------------------------------------------------------------------
# DTensor: the rules on a device mesh
# ---------------------------------------------------------------------------

def device_mesh(mesh: Mesh, device="cuda"):
    """A `DeviceMesh` with `mesh`'s axis names and sizes over the default
    process group (`device` is its device type: "cuda" or "cpu").
    Raises ValueError when the group's size differs from the mesh's, as
    `launch.mesh.make_test_mesh` does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    ranks = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    if ranks != mesh.size or not dist.is_initialized():
        raise ValueError(f"a {dict(mesh.shape)} mesh needs a process group "
                         f"of {mesh.size} ranks; there are {ranks}"
                         + ("" if dist.is_initialized() else " (no group)"))
    dtype = getattr(device, "type", device)
    return init_device_mesh(str(dtype), tuple(mesh.axis_sizes),
                            mesh_dim_names=tuple(mesh.axis_names))


def placements(spec: Sequence, dmesh) -> tuple:
    """The DTensor placements of a spec on `dmesh`: one per mesh dim,
    ``Shard(i)`` on each mesh dim that dim i of the spec names,
    ``Replicate()`` elsewhere.  Axes that share a dim must come in the
    mesh's order (jax's major-to-minor order of a tuple is the order in
    which DTensor nests its shards)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(dmesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} on dim {i} are not in the "
                             f"mesh's order {names}")
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)


def local_slice(shape, dmesh, pls, dim: int):
    """(lo, n): this rank's slice [lo, lo + n) of dim `dim` of a tensor of
    `shape` placed by `pls` on `dmesh`.  The shards nest in mesh order,
    each a chunk of ceil(len / size) as `Shard` cuts them; computed from
    the mesh coordinate, with no tensor op (none may run under a fake
    tensor mode)."""
    from torch.distributed.tensor import Shard

    lo, n = 0, shape[dim]
    coord = dmesh.get_coordinate()
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard) and pl.dim == dim:
            chunk = -(-n // dmesh.size(i))
            lo, n = lo + min(coord[i] * chunk, n), max(
                0, min(chunk, n - coord[i] * chunk))
    return lo, n


def _spec_of(sharding):
    return sharding.spec if isinstance(sharding, NamedSharding) else sharding


def place(tree, shardings, dmesh):
    """`tree`'s tensors as DTensors on `dmesh`, each placed by its
    NamedSharding (or spec) in `shardings`, a tree of the same shape.
    Every rank must hold the same whole tensors (the same seed, the same
    batch, a restored checkpoint): each takes its own shard and nothing
    is sent."""
    from torch.distributed.tensor import distribute_tensor

    from ..models.scan_util import tree_map

    return tree_map(
        lambda t, sh: distribute_tensor(
            t, dmesh, placements(_spec_of(sh), dmesh), src_data_rank=None),
        tree, shardings)


def gather(tree):
    """The whole tensors of a tree of DTensors, on every rank (each rank
    must call it: it all-gathers); a plain tensor comes back as it is."""
    from torch.distributed.tensor import DTensor

    from ..models.scan_util import tree_map

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def is_placed(tree) -> bool:
    """Whether `tree`'s first leaf is a DTensor."""
    from torch.distributed.tensor import DTensor

    from ..models.scan_util import tree_leaves

    leaves = tree_leaves(tree)
    return bool(leaves) and isinstance(leaves[0], DTensor)


def step_context():
    """The context a step on DTensors runs in (module docstring):
    `implicit_replication()`."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()
