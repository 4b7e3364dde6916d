#!/usr/bin/env python3
"""Where the time of the port's DS1 paths goes, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 tools/profile_main_path.py

Builds the DS1 graph and update stream exactly as chip_smoke.py does
(`snap_like("DS1", 1.0, seed=7)`, 8 BFS blocks, 200 mixed updates, R=8),
then for each path — "main" (static coreness plus `run_stream`) and
"analytics" (chip_smoke.py's `analytics_path`: the BlockProgram workloads
and the CC-maintaining stream) — and each backend ("ell": the ELL CUDA
kernels, "torch": the plain versions; for the main path also "dense": the
dense kernels over DS1's 5.01 GB bfloat16 adjacency) runs the path once
to warm up, once timed on the host clock, and once under
`torch.profiler`.  Prints one
JSON line per path and backend: the wall seconds without and with the
profiler, the device time summed over every kernel, memcpy and memset of
the profiled run, the device's busy share of that same run's wall time,
the number of device operations, and the top kernels by device time.
"""
from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core import coreness_with_stats
    from repro_torch.kernels import _build
    from repro_torch.runtime import run_stream

    card = cs.card_line()
    _build.build_all()
    dev = torch.device("cuda", 0)
    g, core = cs.ds1_graph(dev)
    ups = cs.sample_stream(g, cs.DS1_UPDATES // 4, seed0=2)

    def main_path(backend):
        gc = g.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, _ = coreness_with_stats(gc, backend=backend)
        run_stream(gc, c, ups, R=cs.R, backend=backend)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def analytics(backend):
        return cs.analytics_path(g.clone(), backend, core, ups)["seconds"]

    runs = [("main", main_path, b) for b in ("ell", "torch", "dense")]
    runs += [("analytics", analytics, b) for b in ("ell", "torch")]
    for path, run, backend in runs:
        run(backend)  # warm-up: allocator, kernel loads
        wall = run(backend)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof = run(backend)
        by_name = collections.Counter()
        count = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] += e.time_range.elapsed_us()
                count += 1
        device_s = sum(by_name.values()) / 1e6
        if count == 0:
            raise RuntimeError("the profiler recorded no device operation")
        print(json.dumps({
            "path": path, "backend": backend, "card": card, "wall_s": wall,
            "wall_profiled_s": wall_prof, "device_s": device_s,
            "device_busy_share": device_s / wall_prof, "device_ops": count,
            "top_kernels_ms": {k[:80]: v / 1e3
                               for k, v in by_name.most_common(8)},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
