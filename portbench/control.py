"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        --seconds <s> [--out readings.jsonl]

For each seed, in one process: the cell's run as the benchmark makes it
(a measured window of `--seconds`, long enough to apply or pass as much
as a run does), the numbers compared on what its timed path produced
(the program's reading), then the same numbers on the control put in the
program's place (the control's reading): the plain reference with the
configuration's guarantee broken (a stream window acknowledged and left
unapplied) or in the precision below the one the program states
(PageRank in bfloat16).  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import runner, spec
    from portbench.harness.trace import Tracer

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    drv = runner.driver_of(cell)
    for seed in args.seeds:
        out = drv.run(cell, seed, args.seconds, Tracer(False), "cuda:0",
                      time.perf_counter())
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        program = drv.judge(out.outputs, out.inputs, cell.traffic, "cuda:0")
        ref_s = time.perf_counter() - t0
        del out.outputs
        torch.cuda.empty_cache()
        ctl = drv.control(out.inputs, cell.traffic, "cuda:0")
        control = drv.judge(ctl, out.inputs, cell.traffic, "cuda:0")
        rec = dict(workload=cell.name, seed=seed, units=out.record.units,
                   reference_s=ref_s, program=program, control=control,
                   limits=cell.traffic["limits"])
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        del ctl, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
