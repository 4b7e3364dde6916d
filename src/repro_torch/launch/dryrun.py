"""Multi-pod dry run (the JAX package's `launch.dryrun`): every
(architecture × input shape) cell on the production mesh, 256 or 512
ranks that do not exist, with the per-device FLOPs, bytes, collective
bytes by kind and memory that make its three roofline terms.

The reference lowers and compiles each cell as one partitioned XLA
program and reads XLA's analyses.  Here the step runs once, eagerly, on
DTensors of fake tensors (no memory, no device) over a `fake` process
group of 256 or 512 ranks in this one process: DTensor propagates the
reference's shardings op by op (`distributed.sharding`, as GSPMD does)
and issues the collectives that rank 0 would issue; the fake group
returns at once.  One `TorchDispatchMode` watches every op that reaches
rank 0's local shards:

* ``per_device_flops``: the matmul-class FLOPs of each local op, by
  `torch.utils.flop_counter`'s formulas (FlopCounterMode's own);
* ``per_device_bytes``: the bytes each local op reads and writes (every
  tensor input and output; views, waits and ops that return no tensor
  excluded).  Eager
  PyTorch fuses nothing, so this is the step's real unfused traffic,
  not a fused program's;
* ``collective_bytes_per_device``: the output bytes of each
  `_c10d_functional` collective (and DTensor's all-to-all) on rank 0, by
  the reference's kinds (`all-reduce`, `all-gather`, `reduce-scatter`,
  `all-to-all`; DTensor issues no `collective-permute`);
* ``memory_analysis``: the local bytes of the step's arguments, its
  outputs, and the peak of the bytes alive beyond the arguments while it
  runs (``temp_size_in_bytes``), from the lifetimes of the fake storages.

The rates are the NVIDIA H100 SXM's data sheet, not measurements: dense
bf16 `PEAK_FLOPS`, `HBM_BW`, and the per-GPU link rate of a collective
whose group leaves one 8-GPU NVLink node (`LINK_BW`, InfiniBand NDR)
or stays inside one (`NVLINK_BW`).  Ranks fill nodes in order, so each
axis of the 16 x 16 and 2 x 16 x 16 meshes leaves its node.

The fake tensors lie on the card's device type when this PyTorch has
CUDA, else on the CPU's: a CPU-only build cannot run autograd on fake
CUDA tensors, and on a CPU mesh DTensor swaps a sharded dim for another
through an all-gather and a chunk where a CUDA mesh uses an all-to-all
(the record names its ``mesh_device``).

The port's layer loops are Python loops, so every cell is unrolled
(``--unroll`` is kept for the reference's flags and changes nothing).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import optim
from ..configs import ARCHS, SHAPES, SHAPES_BY_NAME, cell_applicable
from ..distributed import sharding as SH
from . import specs as SP
from .mesh import make_production_mesh

# NVIDIA H100 SXM (per GPU), from the data sheet
PEAK_FLOPS = 989e12      # dense bf16
HBM_BW = 3.35e12         # bytes/s, HBM3
LINK_BW = 50e9           # bytes/s per GPU, InfiniBand NDR 400 Gb/s
NVLINK_BW = 450e9        # bytes/s per GPU and direction, NVLink 4
GPUS_PER_NODE = 8

#: collective ops on local tensors, by the reference's kind names
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
#: ops that move no data (metadata, waits, autograd wrappers)
_NO_BYTES = {"wait_tensor", "detach", "alias", "lift_fresh",
             "_wrap_tensor_autograd"}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of lists, tuples and dicts.  A loop, not a
    recursive closure: a closure that calls itself is a reference cycle,
    which would keep every list it filled, and the tensors in it, alive
    until the garbage collector ran, and the peak count with them."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(args) -> Optional[Tuple[int, ...]]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return tuple(dist.get_process_group_ranks(
                    _resolve_process_group(a)))
            except Exception:  # not a group name
                continue
    return None


class CellCounter(TorchDispatchMode):
    """Counts what reaches the local shards (module docstring).  An op
    on DTensors returns NotImplemented, which lets DTensor run first: the
    local ops it desugars into, collectives included, come back here and
    are the ones counted (the idiom of DTensor's own `CommDebugMode`)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: List[Tuple[str, int, Optional[Tuple[int, ...]]]] \
            = []
        self.live = 0
        self.peak = 0
        self.paused = 0
        self.output_bytes = 0
        self._refs: Dict[int, int] = {}
        self._sizes: Dict[int, int] = {}

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except Exception:  # a tensor without storage
            return
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            self.live -= self._sizes.pop(key)
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        if name in _KINDS:
            self.collectives.append((_KINDS[name],
                                     sum(_nbytes(t) for t in outs),
                                     _group_ranks(args)))
        packet = func.overloadpacket
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if outs and name not in _NO_BYTES and not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


def collective_bytes(records) -> Dict[str, int]:
    """Per-device bytes by collective kind, from a counter's records
    ``(kind, bytes, group ranks)`` (the reference reads the HLO text)."""
    out: Dict[str, int] = {}
    for kind, n, _ in records:
        out[kind] = out.get(kind, 0) + n
    return out


def _link_bw(ranks: Optional[Tuple[int, ...]]) -> float:
    """The per-GPU rate of a collective over `ranks`: NVLink when they
    share one node, else the inter-node link."""
    if ranks and len({r // GPUS_PER_NODE for r in ranks}) == 1:
        return NVLINK_BW
    return LINK_BW


def collective_seconds(records) -> float:
    """The collectives' bytes each over its group's link rate."""
    return sum(n / _link_bw(ranks) for _, n, ranks in records)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def fake_group(world_size: int):
    """A `fake` default process group of `world_size` ranks in this
    process (this rank is 0).  Raises ValueError if a group exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise ValueError("a default process group exists: the dry run "
                         "makes its own fake group of "
                         f"{world_size} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


@contextlib.contextmanager
def _metadata_uncounted(counter: CellCounter):
    """DTensor's own metadata work is not the step's, so it is not
    counted.  Two pieces of it run tensor ops: the output shapes of an op
    it has not seen (`ShardingPropagator._propagate_tensor_meta_non_cached`
    runs the op once at global shapes on fake tensors; cached after), run
    here with the counter paused; and a strided shard's offsets (`_StridedShard.
    local_shard_size_and_offset`, reached when a reshape merges two
    sharded dims), computed from small index tensors that under the
    ambient FakeTensorMode would hold no values, run here with the modes
    off.  The counts then do not hang on what DTensor has cached."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    meta = ShardingPropagator._propagate_tensor_meta_non_cached
    offsets = _StridedShard.local_shard_size_and_offset

    def paused(self, *args, **kwargs):
        counter.paused += 1
        try:
            return meta(self, *args, **kwargs)
        finally:
            counter.paused -= 1

    def outside(self, *args, **kwargs):
        with _disable_current_modes():
            return offsets(self, *args, **kwargs)

    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    _StridedShard.local_shard_size_and_offset = outside
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = meta
        _StridedShard.local_shard_size_and_offset = offsets


def count_step(step, kwargs) -> CellCounter:
    """Run `step(**kwargs)` once under a `CellCounter` and return the
    counter."""
    counter = CellCounter()
    with _metadata_uncounted(counter), counter:
        out = step(**kwargs)
    counter.output_bytes = _local_bytes(out)
    del out
    return counter


def _shape(shape):
    return SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape


def _default_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def measure_cell(cfg, shape_name, mesh, device: Optional[str] = None,
                 mla_absorbed: bool = False, ring: bool = False,
                 prefill_last_only: bool = False) -> dict:
    """The counts of one cell (`shape_name` a name of `SHAPES` or a
    `ShapeConfig`) on `mesh` (a `sharding.Mesh`) over a fake group of
    its size made here and destroyed on the way out: {"flops", "bytes",
    "coll", "coll_by_kind", "coll_s", "argument_bytes", "output_bytes",
    "temp_bytes", "build_s", "run_s"}."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = device or _default_device()
    fake_group(mesh.size)
    try:
        t0 = time.perf_counter()
        dmesh = SH.device_mesh(mesh, device)
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, kwargs, _ = SP.abstract_cell(
                cfg, _shape(shape_name), mesh, optim.AdamWConfig(),
                mla_absorbed=mla_absorbed, ring=ring,
                prefill_last_only=prefill_last_only, device_mesh=dmesh)
            t1 = time.perf_counter()
            c = count_step(step, kwargs)
            t2 = time.perf_counter()
            args = _local_bytes(kwargs)
            del kwargs
    finally:
        dist.destroy_process_group()
    coll = collective_bytes(c.collectives)
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "coll": float(sum(coll.values())), "coll_by_kind": coll,
            "coll_s": collective_seconds(c.collectives),
            "argument_bytes": args, "output_bytes": c.output_bytes,
            "temp_bytes": c.peak, "build_s": t1 - t0, "run_s": t2 - t1}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             mla_absorbed: bool = False, ring: bool = False,
             prefill_last_only: bool = False, verbose: bool = True,
             cfg=None, mesh=None, device: Optional[str] = None):
    """The reference's record of one cell on the production mesh (or on
    `mesh`, a `sharding.Mesh`; `cfg` in place of ``ARCHS[arch]``)."""
    cfg = cfg if cfg is not None else ARCHS[arch]
    shape = _shape(shape_name)
    ok, reason = cell_applicable(cfg, shape)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    rec = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "mla_absorbed": mla_absorbed,
        "ring": ring,
        "prefill_last_only": prefill_last_only,
        "unrolled": True,
    }
    if not ok:
        rec["status"] = "SKIP"
        rec["reason"] = reason
        return rec

    m = measure_cell(cfg, shape, mesh, device, mla_absorbed=mla_absorbed,
                     ring=ring, prefill_last_only=prefill_last_only)
    rec.update({
        "status": "OK",
        "chips": mesh.size,
        "lower_s": round(m["build_s"], 2),
        "compile_s": round(m["run_s"], 2),
        "per_device_flops": m["flops"],
        "per_device_bytes": m["bytes"],
        "collective_bytes_per_device": m["coll_by_kind"],
        "collective_bytes_total": m["coll"],
        "compute_term_s": m["flops"] / PEAK_FLOPS,
        "memory_term_s": m["bytes"] / HBM_BW,
        "collective_term_s": m["coll_s"],
        "memory_analysis": {
            "argument_size_in_bytes": m["argument_bytes"],
            "output_size_in_bytes": m["output_bytes"],
            "temp_size_in_bytes": m["temp_bytes"],
            "alias_size_in_bytes": 0,
            "generated_code_size_in_bytes": 0,
        },
        "bytes_are": "unfused eager traffic",
        "rates": "NVIDIA H100 SXM data sheet",
        "mesh_device": device or _default_device(),
    })
    if verbose:
        mem = rec["memory_analysis"]
        print(f"[{arch} × {shape.name} × {rec['mesh']}] OK "
              f"run={rec['compile_s']}s flops/dev={m['flops']:.3e} "
              f"bytes/dev={m['bytes']:.3e} coll/dev={m['coll']:.3e}")
        print(f"  memory_analysis: {mem}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mla-absorbed", action="store_true")
    ap.add_argument("--ring", action="store_true",
                    help="window-sized ring KV caches for sliding layers")
    ap.add_argument("--prefill-last-only", action="store_true",
                    help="prefill computes last-position logits only")
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's flag: the port's layer loops are "
                         "always unrolled")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
            if args.mla_absorbed:
                tag += "_absorbed"
            if args.ring:
                tag += "_ring"
            if args.prefill_last_only:
                tag += "_lastonly"
            if args.unroll:
                tag += "_unrolled"
            fp = outdir / f"{tag}.json"
            try:
                rec = run_cell(arch, shape, mp, mla_absorbed=args.mla_absorbed,
                               ring=args.ring,
                               prefill_last_only=args.prefill_last_only)
            except Exception as e:
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                failures += 1
                print(f"[{arch} × {shape}] FAIL: {rec['error'][:200]}")
            fp.write_text(json.dumps(rec, indent=2, default=str))
    print(f"done; {failures} failures")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
