"""One run of one cell: the driver its traffic names, the judgement, the
result line."""
from __future__ import annotations

import gc
import math
import sys
from typing import Dict, Tuple

import torch

from . import spec
from .outcome import Outcome
from .trace import Tracer

#: top-level module names that may not be loaded in a run's process: JAX
#: and the JAX package the program is a port of
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is in
    `FORBIDDEN` (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def driver_of(cell: spec.Cell):
    """The module that runs, judges and controls `cell`: the driver its
    traffic names, under the checkout it was loaded from."""
    return spec.load_driver(cell.traffic["driver"], cell.root)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, started: float) -> Tuple[dict, Dict[str, dict]]:
    """Measure `cell`, judge what its timed path produced, and return
    (result line, {compared number: {"value", "limit"}})."""
    drv = driver_of(cell)
    out: Outcome = drv.run(cell, seed, seconds, Tracer(trace), device,
                           started)
    rec, ms = out.record, sorted(out.record.unit_ms)
    print(f"portbench: set-up ends at {rec.setup_s!r} s; stages end at "
          f"{rec.setup_marks}", file=sys.stderr)
    print(f"portbench: {cell.name} seed {seed}: {len(ms)} windows or "
          f"passes in {rec.window_s!r} s, ms min {ms[0]!r} median "
          f"{ms[len(ms) // 2]!r} max {ms[-1]!r}; counters {rec.counters}",
          file=sys.stderr)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.judge(out.outputs, out.inputs, cell.traffic, device)
    return result_line(cell, out, numbers, trace, device)


def result_line(cell: spec.Cell, out: Outcome, numbers: Dict[str, float],
                trace: bool, device) -> Tuple[dict, Dict[str, dict]]:
    from .compare import verdict

    correct, compared = verdict(numbers, cell.traffic["limits"])
    rec = out.record
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                rec, cell.root)
    dev = dict(platform="gpu" if torch.device(device).type == "cuda"
               else torch.device(device).type,
               kind=rec.device_kind, count=cell.chips,
               memory_peak_bytes=out.memory_peak_bytes)
    # a window or pass that raises ends the run with no result line, so a
    # run that prints one failed nothing
    line = dict(correct=bool(correct), attempted=out.attempted, failed=0,
                metrics=metrics, device=dev)
    if trace:
        t = rec.trace
        dev.update(busy_s=t.busy_seconds(), window_s=t.window_s)
        line["breakdown"] = dict(device_ops=t.top_device_ops(),
                                 idle_gaps=t.top_idle())
    line["compared"] = compared
    for v in metrics.values():
        if not math.isfinite(v["value"]):
            raise ValueError(f"a metric is not finite: {metrics}")
    return line, compared
