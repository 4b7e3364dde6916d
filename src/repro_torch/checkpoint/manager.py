"""Checkpointing: atomic, keep-N, async-capable, the JAX package's layout.

Layout (one directory per step):

    <dir>/step_00000120/
        manifest.json        # step, structure, leaf shapes/dtypes, meta
        leaf_00000.npy ...   # one file per leaf (the full logical array)
        COMMIT               # written last: marks the checkpoint complete

Atomicity: leaves and manifest are written into ``step_XXXXXXXX.tmp`` and
renamed to ``step_XXXXXXXX`` after the COMMIT marker is in place, so a
crashed save is never mistaken for a valid checkpoint.

Leaves are numbered in the JAX package's pytree order: a dict's values by
sorted key, a list's or tuple's (a NamedTuple's too) in order, a
`GraphBlocks` as ``nbr, deg, node_mask, orig_id``; None holds no leaf.  A
flat dict of tensors also records its keys, so it restores with no
template (`restore_dict`) — and a flat-dict checkpoint written by either
package restores in the other.

A bfloat16 leaf is written as the JAX package writes one (its 16-bit
patterns in an ``.npy`` of numpy's 2-byte void type, "bfloat16" in the
manifest) and restored through the manifest's dtype; numpy has no
bfloat16 of its own, so no ml_dtypes is needed either way.

A DTensor leaf (a tree placed over a mesh, `distributed.sharding`) is
saved whole (`full_tensor()`, a collective: every rank must call
`save`) in the same layout, and `restore` into a template of DTensors
places each whole leaf as the template's leaf is placed.

Async: `save(..., blocking=False)` copies every tensor to host memory
before it returns (the caller may update the live tensors in place right
after) and writes the files on a daemon thread; `wait` joins it.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

from ..core.graph import FIELDS, GraphBlocks
from ..device import DeviceLike, resolve_device

Tree = Any


def _children(tree) -> Optional[list]:
    """The subtrees of a node in pytree order, or None for a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    if isinstance(tree, GraphBlocks):
        return [getattr(tree, f) for f in FIELDS]
    return None


def _flatten(tree) -> List[Any]:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in _flatten(k)]


def _structure(tree) -> str:
    """A readable description of the tree's structure, `*` per leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, GraphBlocks):
        return (f"GraphBlocks[P={tree.P}, Cn={tree.Cn}, Cd={tree.Cd}]"
                "(*, *, *, *)")
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__ + "("
                + ", ".join(_structure(k) for k in tree) + ")")
    return "*"


def _unflatten(like, leaves):
    """Rebuild `like`'s structure from an iterator of leaves in pytree
    order."""
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, GraphBlocks):
        return dataclasses.replace(
            like, **{f: next(leaves) for f in FIELDS})
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(k, leaves) for k in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(k, leaves) for k in like)
    if like is None:
        return None
    return next(leaves)


def _to_host(x) -> np.ndarray:
    """A host COPY of a leaf: the caller may write the tensor in place as
    soon as `save` returns.  A bfloat16 tensor comes back as its 16-bit
    patterns in numpy's 2-byte void type."""
    if isinstance(x, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            x = x.full_tensor()
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.array(x, copy=True)


def _dtype_name(x, leaf: np.ndarray) -> str:
    """The manifest's dtype of a leaf, as the JAX package names it."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(leaf.dtype)


def _save_leaf(path: Path, leaf: np.ndarray, dtype_name: str) -> None:
    """`np.save`, but a "bfloat16" leaf under the header the JAX package's
    `np.save` of an `ml_dtypes.bfloat16` array writes ('<V2'), so the
    files are the same bytes."""
    if dtype_name != "bfloat16":
        np.save(path, leaf)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": leaf.shape})
        f.write(np.ascontiguousarray(leaf).tobytes())


def _load_leaf(path: Path, dtype_name: str) -> torch.Tensor:
    """A leaf file as a CPU tensor; a "bfloat16" leaf from its 16-bit
    patterns."""
    arr = np.load(path)
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _placed_like(t: torch.Tensor, ref) -> torch.Tensor:
    """`t` (whole, the same on every rank) placed as `ref` is, when `ref`
    is a DTensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(ref, DTensor):
        return t
    return distribute_tensor(t, ref.device_mesh, ref.placements,
                             src_data_rank=None)


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype


class CheckpointManager:
    # one in-flight async writer per directory, across manager instances
    _threads: dict = {}
    _lock = threading.Lock()

    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n

    @property
    def _thread(self) -> Optional[threading.Thread]:
        return CheckpointManager._threads.get(str(self.dir.resolve()))

    @_thread.setter
    def _thread(self, t: Optional[threading.Thread]):
        with CheckpointManager._lock:
            CheckpointManager._threads[str(self.dir.resolve())] = t

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Tree, blocking: bool = True,
             meta: Optional[dict] = None):
        """Snapshot `tree` at `step`.  Every leaf is copied to the host
        before this returns, also when `blocking=False`.

        `meta` (a JSON-able dict) rides in the manifest: a stream session
        stores its statics and counters there, so a restore needs no
        template (`restore_dict` + `load_meta`).  When `tree` is a flat
        dict of arrays, the manifest also records the key order.
        """
        flat = _flatten(tree)
        host_leaves = [_to_host(x) for x in flat]
        dtypes = [_dtype_name(x, h) for x, h in zip(flat, host_leaves)]
        structure = _structure(tree)
        keys = (sorted(str(k) for k in tree)
                if isinstance(tree, dict) and len(tree) == len(flat)
                else None)

        if self._thread is not None:
            self._thread.join()  # one in-flight async save at a time

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "treedef": structure, "leaves": []}
            if keys is not None:
                manifest["keys"] = keys
            if meta is not None:
                manifest["meta"] = meta
            for i, leaf in enumerate(host_leaves):
                _save_leaf(tmp / f"leaf_{i:05d}.npy", leaf, dtypes[i])
                manifest["leaves"].append(
                    {"i": i, "shape": list(leaf.shape),
                     "dtype": dtypes[i]})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / "COMMIT").write_text("ok")
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the in-flight async save, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        """Committed steps, ascending (torn `.tmp` and uncommitted
        directories are never listed)."""
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if p.suffix == ".tmp" or not (p / "COMMIT").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> dict:
        d = self.dir / f"step_{step:08d}"
        if not (d / "COMMIT").exists():
            raise FileNotFoundError(f"no committed checkpoint at {d}")
        return json.loads((d / "manifest.json").read_text())

    def load_meta(self, step: int) -> Optional[dict]:
        """The `meta` dict saved with `step` (None if none was)."""
        return self._manifest(step).get("meta")

    def restore_dict(self, step: int, device: DeviceLike = None) -> dict:
        """Restore a flat-dict checkpoint WITHOUT a template, as tensors
        on `device` (default CUDA, see `device.resolve_device`).

        Only valid for checkpoints saved from a flat dict of arrays (the
        manifest then carries the key order): shapes and dtypes come from
        the files themselves, so the caller need not know what capacities
        the graph had grown to.
        """
        manifest = self._manifest(step)
        keys = manifest.get("keys")
        if keys is None:
            raise ValueError(
                f"step {step} was not saved from a flat dict; use "
                "restore(step, like) with a structure template")
        dev = resolve_device(device)
        d = self.dir / f"step_{step:08d}"
        return {k: _load_leaf(d / f"leaf_{i:05d}.npy",
                              manifest["leaves"][i]["dtype"]).to(dev)
                for i, k in enumerate(keys)}

    def restore(self, step: int, like: Tree,
                device: DeviceLike = None) -> Tree:
        """Restore into the structure of `like` (leaf count and shapes
        validated, dtypes cast to `like`'s), as tensors on `device`
        (default CUDA)."""
        manifest = self._manifest(step)
        flat_like = _flatten(like)
        if len(manifest["leaves"]) != len(flat_like):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"the structure expects {len(flat_like)} — mismatch")
        dev = resolve_device(device)
        d = self.dir / f"step_{step:08d}"
        out = []
        for i, ref in enumerate(flat_like):
            t = _load_leaf(d / f"leaf_{i:05d}.npy",
                           manifest["leaves"][i]["dtype"])
            if tuple(t.shape) != _shape(ref):
                raise ValueError(
                    f"leaf {i}: shape {tuple(t.shape)} != {_shape(ref)}")
            out.append(_placed_like(t.to(dev, _torch_dtype(ref)), ref))
        return _unflatten(like, iter(out))
