"""The entry-point audit: host-read budgets and sync probes, as a manifest.

Every registered public entry point states its **host-read budget**: how
many times one execution may read a tensor of the audited device on the
host — ``bool()``, ``int()``, ``float()``, ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``np.asarray()``, ``.to("cpu")``, ...
(`count_host_reads`, a `torch.overrides.TorchFunctionMode`).  The budget
is an int or a function of the supersteps the run reports, so one
manifest holds on the tiny graph here and on a full-size graph on the
card.  Each entry's `invariant` gives its budget as a formula beside the
JAX package's budget for the same entry (`jax.device_get` calls there).

Some operations synchronize without any counted method: an op whose
output shape depends on the data (``nonzero``, ``unique``,
``masked_select``, a bool-mask index, ``repeat_interleave`` without
``output_size``), and a copy of host data to the card.  Two passes see
them:

* on a CUDA device the audit counts every synchronization CUDA reports
  under ``torch.cuda.set_sync_debug_mode("warn")`` (`count_cuda_syncs`)
  and holds it to the entry's `max_cuda_syncs`;
* an entry with ``probe=True`` must not synchronize at all
  (`probe_syncs`): on the CPU the probe lists the calls of the
  data-dependent-shape ops above; on a CUDA device it runs the entry
  under ``set_sync_debug_mode("error")``.

The JAX package's counterparts, `count_device_gets` (a patch of
`jax.device_get`) and `forbidden_primitives` (a scan of a jaxpr for
callback/infeed/outfeed), have no meaning in eager PyTorch, which has
neither a transfer function every read goes through nor a program to
scan before it runs.

Everything runs by default on a tiny deterministic graph (two blocks, a
few path components; the JAX package's, edge for edge), so the audit is
cheap enough for the CPU tests; `World` runs the same manifest on any
graph.  Each entry names the JAX package's entry it stands for
(`EntryPoint.reference`); `LEFT_OUT` gives the JAX package's entries
that have no counterpart here, each with its reason.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
import warnings
import weakref
from collections import Counter
from functools import partial
from pathlib import Path
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import torch
from torch.overrides import TorchFunctionMode

from .engine import Finding

RULE_ID = "entrypoint-audit"

#: tensor methods and functions that read a tensor's value on the host
HOST_READS = frozenset({
    "__bool__", "__int__", "__float__", "__index__", "__format__",
    "item", "tolist", "cpu", "numpy", "__array__",
    "equal", "allclose", "is_nonzero",
})

#: ops whose output shape depends on the data: on a CUDA device each one
#: synchronizes to learn the size of its result
DATA_SHAPE_OPS = frozenset({
    "nonzero", "argwhere", "unique", "unique_consecutive", "masked_select",
})

_THIS_FILE = Path(__file__).resolve()
_TORCH_DIR = Path(torch.__file__).resolve().parent
_WARNINGS_FILE = Path(warnings.__file__).resolve()


def _file_name(filename: str) -> str:
    """A source file's path from `repro_torch/` or `torch/` on, or its
    bare name."""
    parts = Path(filename).parts
    for pkg in ("repro_torch", "torch"):
        if pkg in parts:
            return "/".join(parts[len(parts) - parts[::-1].index(pkg) - 1:])
    return Path(filename).name


def _site() -> str:
    """'file:line (function)' of the innermost caller outside torch, the
    warnings module and this module — where a counted read or sync sits —
    followed by the innermost torch frame above it, if any."""
    f = sys._getframe(2)
    via = ""
    while f is not None:
        path = Path(f.f_code.co_filename).resolve()
        here = f"{_file_name(str(path))}:{f.f_lineno} ({f.f_code.co_name})"
        if _TORCH_DIR in path.parents:
            via = via or f" via {here}"
        elif path not in (_THIS_FILE, _WARNINGS_FILE):
            return here + via
        f = f.f_back
    return "<unknown>" + via


class SyncCount:
    """A count of host reads or syncs, and where each happened."""

    def __init__(self):
        self.count = 0
        self.sites: Counter = Counter()

    def add(self, site: str) -> None:
        self.count += 1
        self.sites[site] += 1


def _same_device(t: torch.device, device: torch.device) -> bool:
    if t.type != device.type:
        return False
    if device.type != "cuda":
        return True
    want = device.index if device.index is not None \
        else torch.cuda.current_device()
    return (t.index if t.index is not None
            else torch.cuda.current_device()) == want


def _device_of_target(args, kwargs) -> Optional[torch.device]:
    """The device a ``Tensor.to(...)`` call targets, if it names one."""
    for a in list(args) + [kwargs.get("device"), kwargs.get("other")]:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (str, torch.device)):
            try:
                return torch.device(a)
            except RuntimeError:
                continue
    return None


def _bool_index(idx) -> bool:
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in items)


class _AuditMode(TorchFunctionMode):
    """Counts host reads of tensors on `device` (`reads`) and/or records
    data-dependent-shape ops (`shape_ops`).

    A tensor a counted ``.cpu()`` / ``.to(cpu)`` returns is a host copy:
    reads of it are not counted again.  On a CPU device those calls
    return their input itself, so the mode returns a clone instead — the
    copy the same call makes on a card — and later reads of the original
    still count.
    """

    def __init__(self, device: torch.device, reads: Optional[SyncCount],
                 shape_ops: Optional[List[str]]):
        super().__init__()
        self.device = device
        self.reads = reads
        self.shape_ops = shape_ops
        self._host_ids: set = set()

    def _on_device(self, x) -> bool:
        return (isinstance(x, torch.Tensor) and id(x) not in self._host_ids
                and _same_device(x.device, self.device))

    def _mark_host(self, t: torch.Tensor) -> None:
        self._host_ids.add(id(t))
        weakref.finalize(t, self._host_ids.discard, id(t))

    def _reads_to_cpu(self, args, kwargs) -> bool:
        """Whether ``t.to(*args, **kwargs)`` of a tensor on the device is a
        host read.  On a card: any CPU target.  On the CPU every ``.to``
        of a CPU tensor to the CPU is a no-op, whether the code reads
        (``.to("cpu")``) or stages data on its own device (``.to(dev)``);
        only the literal string "cpu", the read idiom, counts there."""
        target = _device_of_target(args, kwargs)
        if target is None or target.type != "cpu":
            return False
        if self.device.type != "cpu":
            return True
        return any(isinstance(a, str) for a in
                   list(args) + [kwargs.get("device")])

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if self.shape_ops is not None:
            self._probe(name, args, kwargs)
        counted = copies = False
        if self.reads is not None and args:
            if name in HOST_READS:
                counted = any(self._on_device(a) for a in args[:2])
                copies = name == "cpu"
            elif name == "to" and self._on_device(args[0]):
                counted = copies = self._reads_to_cpu(args[1:], kwargs)
        out = func(*args, **kwargs)
        if counted:
            self.reads.add(_site())
            if copies and isinstance(out, torch.Tensor):
                if out is args[0]:
                    out = out.clone()
                self._mark_host(out)
        return out

    def _probe(self, name: str, args, kwargs) -> None:
        hit = None
        if name in DATA_SHAPE_OPS:
            hit = name
        elif name == "where" and len(args) + len(kwargs) == 1:
            hit = "where(condition)"
        elif name == "__getitem__" and len(args) > 1 and _bool_index(args[1]):
            hit = "bool-mask __getitem__"
        elif (name == "__setitem__" and len(args) > 2
              and _bool_index(args[1]) and isinstance(args[2], torch.Tensor)
              and args[2].dim() > 0):
            hit = "bool-mask __setitem__ of a tensor"
        elif (name == "repeat_interleave" and "output_size" not in kwargs
              and any(isinstance(a, torch.Tensor) and a.dim() > 0
                      for a in list(args[1:]) + [kwargs.get("repeats")])):
            hit = "repeat_interleave without output_size"
        if hit is not None:
            self.shape_ops.append(f"{hit} at {_site()}")


@contextlib.contextmanager
def count_host_reads(device) -> Iterator[SyncCount]:
    """Context manager counting host reads of tensors on `device`; yields
    a `SyncCount` (count and sites)."""
    box = SyncCount()
    with _AuditMode(torch.device(device), box, None):
        yield box


#: what CUDA's sync debug mode says of each synchronizing operation (its
#: other warnings, such as the mode's own prototype notice, are not syncs)
SYNC_MESSAGE = "called a synchronizing CUDA operation"


def _is_sync_message(text: str) -> bool:
    return SYNC_MESSAGE in text


@contextlib.contextmanager
def count_cuda_syncs() -> Iterator[SyncCount]:
    """Context manager counting the synchronizations CUDA reports under
    ``torch.cuda.set_sync_debug_mode("warn")``; yields a `SyncCount`,
    each sync at the innermost caller outside torch and this module.
    Raises if the sync debug mode is unavailable (it is never skipped)."""
    box = SyncCount()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def record(message, category, filename, lineno, *args, **kwargs):
            if _is_sync_message(str(message)):
                box.add(_site())
            else:
                shown(message, category, filename, lineno, *args, **kwargs)

        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def probe_syncs(device) -> Iterator[List[str]]:
    """Context manager that records what would synchronize inside it;
    yields the list of what it saw (empty: nothing).

    On a CPU device: the calls of data-dependent-shape ops.  On a CUDA
    device: the entry runs under ``set_sync_debug_mode("error")``, and the
    first synchronization's error is recorded and ends it."""
    seen: List[str] = []
    device = torch.device(device)
    if device.type != "cuda":
        with _AuditMode(device, None, seen):
            yield seen
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield seen
    except RuntimeError as e:
        if not _is_sync_message(str(e)):
            raise
        seen.append(str(e).splitlines()[0])
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# ---------------------------------------------------------------------------
# The graph the entries run on
# ---------------------------------------------------------------------------

#: the tiny graph: two blocks x 8 rows, four 2-node path components per
#: block (the JAX package's audit graph, edge for edge)
TINY_EDGES = ((0, 1), (2, 3), (4, 5), (6, 7),
              (8, 9), (10, 11), (12, 13), (14, 15))
#: the stream entries' window width
WINDOW_R = 4


class World:
    """A graph on a device, and what the entries derive from it (made once,
    outside any count): the coreness, a stream window and its routing
    inputs, a snapshot and a one-worker mesh executor.

    `window` is a list of ``(u, v, op)`` in padded ids that routes clean
    (block-local, no spill, no conflict): the routing and clean-window
    entries' window.  `escalated` is a window of the same form in which
    some update escalates to the sequential path (cross-block, spill or
    conflict), as most of a stream's windows do: the escalated-window
    entry's.  `core` and `route` (the routing inputs) may be given; they
    are made from the graph otherwise.
    """

    def __init__(self, g, window: Sequence[Tuple[int, int, int]],
                 R: int = WINDOW_R, name: str = "graph",
                 core: Optional[torch.Tensor] = None,
                 route: Optional[tuple] = None,
                 escalated: Optional[Sequence[Tuple[int, int, int]]] = None):
        self.g, self.window, self.R, self.name = g, list(window), R, name
        self.escalated = None if escalated is None else list(escalated)
        self._made: Dict[str, Any] = {
            k: v for k, v in (("core", core), ("route", route))
            if v is not None}

    @property
    def device(self) -> torch.device:
        return self.g.device

    def made(self, key: str, make: Callable[[], Any]) -> Any:
        if key not in self._made:
            self._made[key] = make()
        return self._made[key]

    def core(self) -> torch.Tensor:
        from ..kernels import ops

        return self.made("core", lambda: ops.coreness_blocks(self.g))

    def route_inputs(self) -> tuple:
        """(cand, us, vs, ops, valid) of the window padded to R, as
        `StreamSession.apply_window` hands them to `_route_window`."""
        def make():
            from ..core import kcore_dynamic as kd

            n, dev = len(self.window), self.device
            cols = list(zip(*(self.window + [(0, 0, 0)] * (self.R - n))))
            us, vs, ops_ = (torch.tensor(c, dtype=torch.int64, device=dev)
                            for c in cols)
            valid = torch.arange(self.R, device=dev) < n
            cand, _ = kd._batch_candidates(self.g, self.core(), us, vs,
                                           valid)
            return cand, us, vs, ops_, valid
        return self.made("route", make)

    def snapshot(self):
        """An epoch snapshot of the graph, cut as the service cuts it,
        with 4 supersteps: core and labels from `fused_analytics`, the
        rank from the standalone PageRank program (bit-identical to the
        fused pass's at the same supersteps), so the query entries' set-up
        also runs the sum kernel."""
        def make():
            from ..core.algorithms import fused_analytics, pagerank
            from ..service.state import EpochSnapshot

            g = self.g
            core, labels, _ = fused_analytics(g, steps=4)
            rank = pagerank(g, tol=None, max_steps=4)
            return EpochSnapshot(
                epoch=0, windows=0, core=core, labels=labels, rank=rank,
                deg=g.deg, nbr=g.nbr, node_mask=g.node_mask,
                orig_id=g.orig_id)
        return self.made("snapshot", make)

    def executor(self):
        from ..runtime.spmd import SpmdExecutor

        return self.made("executor", lambda: SpmdExecutor(self.g))


def clean_window(g, updates: Sequence[Tuple[int, int, int]],
                 R: int = WINDOW_R) -> Optional[List[Tuple[int, int, int]]]:
    """The first window of `R` consecutive `updates` (padded ids, each
    valid on `g`) that routes clean on `g` — every update block-local,
    no candidate set leaving its block or overlapping another's — else
    the first single update that does; None if none.  Routing runs on the
    device as `StreamSession.apply_window` runs it, and changes nothing."""
    from ..core import kcore_dynamic as kd
    from ..kernels import ops
    from ..runtime.stream import _route_window

    core = ops.coreness_blocks(g)
    windows = [list(updates[i:i + R]) for i in range(0, len(updates), R)]
    windows += [[u] for u in updates]
    for window in windows:
        cand, us, vs, ops_, valid = World(g, window, R,
                                          core=core).route_inputs()
        route = _route_window(cand, us, vs, ops_, valid, Cn=g.Cn)
        if bool((route.accept == valid).all()):
            return window
    return None


def _padded_of(g, orig: int) -> int:
    return int((g.orig_id == orig).nonzero()[0, 0])


def tiny_world(device) -> World:
    """The tiny graph on `device`: its clean window is one block-local
    insert joining two block-0 path components (candidate sets stay in
    the block, the window routes clean), and its routing inputs are the
    JAX package's audit inputs.  Its escalated window adds a cross-block
    insert to that one: one update on the batched path, one on the
    sequential path."""
    import numpy as np

    from ..core.graph import build_blocks

    edges = np.asarray(TINY_EDGES, np.int32)
    assign = np.asarray([0] * 8 + [1] * 8, np.int32)
    g = build_blocks(edges, 16, assign, P=2, deg_slack=6, device=device)
    cand = torch.zeros((g.N, WINDOW_R), dtype=torch.bool, device=g.device)
    cand[0, 0] = cand[2, 0] = True
    route = (cand,
             torch.tensor([0, 0, 0, 0], dtype=torch.int64, device=g.device),
             torch.tensor([2, 0, 0, 0], dtype=torch.int64, device=g.device),
             torch.tensor([1, 0, 0, 0], dtype=torch.int64, device=g.device),
             torch.tensor([True, False, False, False], device=g.device))
    local = (_padded_of(g, 0), _padded_of(g, 2), 1)
    cross = (_padded_of(g, 1), _padded_of(g, 9), 1)
    return World(g, [local], name="tiny", route=route,
                 escalated=[local, cross])


# ---------------------------------------------------------------------------
# The manifest
# ---------------------------------------------------------------------------

#: a budget: an int, or a function of the supersteps an entry reports
Budget = Union[int, Callable[[Any], int]]


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One audited public entry point.

    `prepare(world)` builds everything host-side (graphs, executors,
    sessions — uncounted) and returns `(fn, args)`; the audit then runs
    `fn(*args)` under the host-read counter (and, on a CUDA device, the
    sync counter) and compares with `max_host_reads` (and
    `max_cuda_syncs`; None: the same budget).  `steps(out)` gives the
    supersteps the run reports, which a budget function takes.  With
    `probe=True` the audit also runs the entry under `probe_syncs`, which
    must see nothing: only set it on entries that are pure device code.
    """

    name: str
    invariant: str           # the contract this budget pins down
    max_host_reads: Budget
    prepare: Callable[[World], Tuple[Callable, tuple]]
    probe: bool = False
    max_cuda_syncs: Optional[Budget] = None
    steps: Optional[Callable[[Any], Any]] = None
    #: the JAX package's entry this one stands for (None: it has none)
    reference: Optional[str] = None
    #: that entry's budget (`jax.device_get`s); None without one
    reference_budget: Optional[int] = 0


def _budget(b: Budget, steps: Any) -> int:
    return int(b(steps) if callable(b) else b)


def chunks(steps: int) -> int:
    """Host reads of a loop's convergence counter over `steps` supersteps:
    one per `kernels.ops.SYNC_EVERY` supersteps begun."""
    from ..kernels.ops import SYNC_EVERY

    return math.ceil(steps / SYNC_EVERY)


def loops(steps: int, n: int) -> int:
    """Host reads of `n` fixpoint loops of `steps` supersteps in all,
    each reading once per `SYNC_EVERY` supersteps begun and once at its
    end.  Only the total is reported, and the sum of the loops' chunks
    is at most ``chunks(steps) + n - 1``: exact for one loop."""
    return chunks(steps) + 2 * n - 1 if n else 0


def window_reads(s) -> int:
    """Host reads of one `StreamSession.apply_window`, from its stats
    ``(bfs, rec, block_local, escalated)``: the two validation copies and
    the verdict copy; the batched search, one loop; the batched
    recompute, one loop when any update was accepted; per escalated
    update a search loop, a recompute loop and its stats copy."""
    bfs, rec, local, esc = s
    return (3 + esc + loops(bfs, 1 + esc)
            + loops(rec, int(local > 0) + esc))


def window_syncs(s) -> int:
    """CUDA syncs of the same window: its host reads, the uploads of the
    window's four columns, and per escalated update the two root writes
    of `kcore_dynamic._maintain_edge` (``roots[u] = True`` copies a host
    scalar to the card)."""
    return window_reads(s) + 4 + 2 * s[3]


# -- prepare() builders ------------------------------------------------------


def _prep_route_window(w: World):
    from ..runtime.stream import _route_window

    cand, us, vs, ops_, valid = w.route_inputs()
    fn = partial(_route_window, Cn=w.g.Cn)
    return fn, (cand, us, vs, ops_, valid)


def _prep_block_program_cc(w: World):
    from ..core.algorithms import connected_components

    return partial(connected_components, with_steps=True), (w.g,)


def _prep_fused_analytics(w: World):
    from ..core.algorithms import fused_analytics

    return partial(fused_analytics, steps=4, with_steps=True), (w.g,)


def _prep_coreness(backend: str, w: World):
    from ..kernels import ops

    return partial(ops.coreness_blocks, backend=backend,
                   with_steps=True), (w.g,)


def _prep_spmd_hindex(w: World):
    ex = w.executor()
    est = torch.where(w.g.node_mask, w.g.deg, 0).to(torch.int32)
    return ex.hindex, (est,)


def _prep_spmd_coreness(w: World):
    return w.executor().coreness, ()


def _prep_apply_window_clean(w: World):
    from ..runtime.stream import StreamSession

    g = w.g.clone()  # the session updates its graph in place
    sess = StreamSession(g, w.core().clone(), R=w.R)

    def apply_window(window):
        sess.apply_window(window)
        return sess.result()  # a host snapshot of the session: no reads
    return apply_window, (list(w.window),)


def _prep_apply_window_escalated(w: World):
    if w.escalated is None:
        raise ValueError(f"world {w.name!r} has no escalated window")
    return _prep_apply_window_clean(w)[0], (list(w.escalated),)


def _prep_run_batch_core(w: World):
    from ..service import queries as q

    batch = [q.core_of(1), q.core_of(2), q.core_of(3)]
    return partial(q.run_batch, w.snapshot(), "core"), (batch,)


def _prep_run_batch_topk(w: World):
    from ..service import queries as q

    snap = w.snapshot()
    k = q.topk_bucket(2, int(snap.core.shape[0]))
    return partial(q.run_batch, snap, "topk_pagerank", k=k), (
        [q.topk_pagerank(2)],)


def _second(out):
    return out[1]


def _window_steps(res):
    st = res.stats
    return st.bfs_steps, st.recompute_steps, st.block_local, st.escalated


#: the JAX package's manifest entries the port's leaves out, and why
LEFT_OUT = {
    "queries._batch_gather":
        "the JAX package's gather of a field by the padded ids is "
        "`field[ids]` inline in the port's `run_batch`; an integer index "
        "in eager PyTorch launches a gather and cannot synchronize, so "
        "the entry would check nothing (the `run_batch` entries run it)",
}


MANIFEST: Tuple[EntryPoint, ...] = (
    EntryPoint(
        name="stream._route_window",
        invariant="window routing is pure device code: the (N, R) "
                  "candidate matrix never reaches the host (budget 0; "
                  "the JAX package's: 0)",
        max_host_reads=0, prepare=_prep_route_window, probe=True,
        reference="stream._route_window"),
    EntryPoint(
        name="ops.run_block_program[cc]",
        invariant="a block program reads the host once per SYNC_EVERY "
                  "supersteps and once at the end, plus the real-node "
                  "count at entry: ceil(steps/8) + 2 (the JAX package's "
                  "fused while_loop: 0)",
        max_host_reads=lambda s: chunks(s) + 2,
        prepare=_prep_block_program_cc, steps=_second,
        reference="ops.run_block_program[cc,jnp]"),
    EntryPoint(
        name="algorithms.fused_analytics",
        invariant="the fused multi-field pass: ceil(steps/8) + 2 (the "
                  "JAX package's: 0)",
        max_host_reads=lambda s: chunks(s) + 2,
        prepare=_prep_fused_analytics, steps=_second,
        reference="algorithms.fused_analytics[jnp]"),
    EntryPoint(
        name="ops.coreness_blocks[torch]",
        invariant="the plain min-H fixpoint reads its change counter once "
                  "per SYNC_EVERY supersteps and once at the end: "
                  "ceil(steps/8) + 1 (the JAX package's jnp loop: 0)",
        max_host_reads=lambda s: chunks(s) + 1,
        prepare=partial(_prep_coreness, "torch"), steps=_second,
        reference="ops.coreness_blocks[jnp]"),
    EntryPoint(
        name="ops.coreness_blocks[ell]",
        invariant="the ELL fixpoint: the degree bound once, then "
                  "ceil(steps/8) + 1 (the JAX package's: 1, the degree "
                  "bound)",
        max_host_reads=lambda s: chunks(s) + 2,
        prepare=partial(_prep_coreness, "ell"), steps=_second,
        reference="ops.coreness_blocks[ell]", reference_budget=1),
    EntryPoint(
        name="SpmdExecutor.hindex",
        invariant="a mesh superstep (halo exchange + kernel) is pure "
                  "device code (budget 0; the JAX package's: 0)",
        max_host_reads=0, prepare=_prep_spmd_hindex,
        reference="SpmdExecutor.hindex"),
    EntryPoint(
        name="SpmdExecutor.coreness",
        invariant="the on-mesh coreness loop: ceil(steps/8) + 1 (the JAX "
                  "package's: 1, the fixpoint pull)",
        max_host_reads=lambda s: chunks(s) + 1,
        prepare=_prep_spmd_coreness, steps=_second,
        reference="SpmdExecutor.coreness", reference_budget=1),
    EntryPoint(
        name="StreamSession.apply_window[clean]",
        invariant="a clean window: the two validation copies, the "
                  "batched search's ceil(bfs/8) + 1, the verdict copy, the "
                  "recompute's ceil(rec/8) + 1 (`window_reads`); CUDA syncs "
                  "4 more, the uploads of the window's columns "
                  "(`window_syncs`; the JAX package's: 1, the verdict)",
        max_host_reads=window_reads, max_cuda_syncs=window_syncs,
        prepare=_prep_apply_window_clean, steps=_window_steps,
        reference="StreamSession.apply_window[clean]", reference_budget=1),
    EntryPoint(
        name="StreamSession.apply_window[escalated]",
        invariant="a window with escalated updates, as most of a stream's "
                  "are: the clean window's reads, plus per escalated "
                  "update a search loop, a recompute loop (each "
                  "ceil(steps/8) + 1, bounded from the reported totals) "
                  "and its stats copy (`window_reads`); CUDA syncs 4 more, "
                  "the uploads of the window's columns, and 2 per escalated "
                  "update, its root writes (`window_syncs`; the JAX "
                  "package's manifest has no such entry)",
        max_host_reads=window_reads, max_cuda_syncs=window_syncs,
        prepare=_prep_apply_window_escalated, steps=_window_steps,
        reference_budget=None),
    EntryPoint(
        name="queries.run_batch[core]",
        invariant="an answered query batch makes ONE copy: the compact "
                  "answer array; CUDA syncs 1 more, the upload of the "
                  "padded ids (the JAX package's: 1)",
        max_host_reads=1, max_cuda_syncs=2, prepare=_prep_run_batch_core,
        reference="queries.run_batch[core]", reference_budget=1),
    EntryPoint(
        name="queries.run_batch[topk_pagerank]",
        invariant="a top-k batch makes ONE copy: the (values, ids) pair "
                  "(the JAX package's: 1)",
        max_host_reads=1, prepare=_prep_run_batch_topk,
        reference="queries.run_batch[topk_pagerank]", reference_budget=1),
)


# ---------------------------------------------------------------------------
# Running it
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AuditResult:
    """One entry's run: its counts, budgets, supersteps and wall time."""

    name: str
    host_reads: int
    read_budget: int
    cuda_syncs: Optional[int]     # None off CUDA
    sync_budget: Optional[int]
    steps: Any
    ms: float
    read_sites: Dict[str, int]
    sync_sites: Dict[str, int]
    probe: List[str]
    error: Optional[str] = None
    out: Any = None

    def findings(self, ep: EntryPoint) -> List[Finding]:
        def finding(msg):
            return Finding(path="<audit>", line=0, rule=RULE_ID,
                           message=f"{self.name}: {msg}", snippet=self.name)

        if self.error is not None:
            return [finding(f"failed to execute: {self.error}")]
        out = []
        if self.host_reads > self.read_budget:
            out.append(finding(
                f"{self.host_reads} host read(s), budget "
                f"{self.read_budget} at {self.steps} supersteps — violated "
                f"invariant: {ep.invariant} (reads at "
                f"{dict(self.read_sites)})"))
        if self.cuda_syncs is not None and self.cuda_syncs > self.sync_budget:
            out.append(finding(
                f"{self.cuda_syncs} CUDA sync(s), budget {self.sync_budget}"
                f" at {self.steps} supersteps — violated invariant: "
                f"{ep.invariant} (syncs at {dict(self.sync_sites)})"))
        if self.probe:
            out.append(finding(f"synchronizes inside a pure entry: "
                               f"{self.probe}"))
        return out


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_run(ep: EntryPoint, world: World) -> float:
    """Wall ms of one uncounted run of the entry on fresh inputs."""
    fn, args = ep.prepare(world)
    _synchronize(world.device)
    t0 = time.perf_counter()
    fn(*args)
    _synchronize(world.device)
    return (time.perf_counter() - t0) * 1e3


def audit_entry(ep: EntryPoint, world: World) -> AuditResult:
    """Run one entry on `world`'s graph under the counters (and its probe,
    once more, when it has one).

    The entry runs uncounted first, on inputs of its own: once to warm up
    (CUDA and its libraries initialise lazily at a process's first use of
    an op, and what the budgets hold is every later call), once more for
    its wall time (`ms`: the counters add a Python call to every torch
    call)."""
    device = world.device
    try:
        _timed_run(ep, world)
        ms = _timed_run(ep, world)
        fn, args = ep.prepare(world)
        _synchronize(device)
        syncs = None
        with contextlib.ExitStack() as stack:
            if device.type == "cuda":
                syncs = stack.enter_context(count_cuda_syncs())
            reads = stack.enter_context(count_host_reads(device))
            out = fn(*args)
        _synchronize(device)
    except Exception as e:  # an entry that cannot run is a finding
        return AuditResult(ep.name, 0, 0, None, None, None, 0.0, {}, {}, [],
                           error=repr(e))
    steps = ep.steps(out) if ep.steps is not None else None
    read_budget = _budget(ep.max_host_reads, steps)
    sync_budget = None
    if syncs is not None:
        sync_budget = _budget(ep.max_cuda_syncs if ep.max_cuda_syncs
                              is not None else ep.max_host_reads, steps)
    probe: List[str] = []
    if ep.probe:
        fn, args = ep.prepare(world)
        _synchronize(device)
        with probe_syncs(device) as probe:
            fn(*args)
        _synchronize(device)
    return AuditResult(
        ep.name, reads.count, read_budget,
        None if syncs is None else syncs.count, sync_budget, steps, ms,
        dict(reads.sites), {} if syncs is None else dict(syncs.sites),
        list(probe), out=out)


def run_audit(
    entries: Optional[Sequence[EntryPoint]] = None, device=None,
) -> List[Finding]:
    """Execute the manifest on the tiny graph on `device`; one finding per
    violated budget or probe.  `device` follows the port's entry points:
    None is the current CUDA device, and raises without one; pass
    ``device="cpu"`` to audit the plain versions."""
    from ..device import resolve_device

    world = tiny_world(resolve_device(device))
    findings: List[Finding] = []
    for ep in (MANIFEST if entries is None else entries):
        findings.extend(audit_entry(ep, world).findings(ep))
    return findings
