"""Run one cell several times, one process after another, and give each
end-to-end metric's spread: how the benchmark's bounds are set.

    python3 portbench/sets.py --workload <cell> --seeds 11 12 13 \
        --seconds <s> [--trace 0|1] [--out runs.jsonl]

Each run is ``portbench/run.py`` as the benchmark's command runs it.
Every run's result line (with its seed, exit code, wall seconds and the
end of its standard error when it failed) goes to `--out`, one JSON
object a line; a summary of each metric goes to standard output: median,
quartiles (Python's ``statistics.quantiles(values, n=4)``) and the spread,
the distance between the quartiles as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    """(median, q1, q3, (q3 - q1) / median) of at least two values."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, q1, q3, (q3 - q1) / med


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "portbench" / "run.py"),
           "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    rec = dict(seed=seed, rc=p.returncode,
               wall_s=time.perf_counter() - t0, trace=trace)
    rec["diag"] = [ln for ln in p.stderr.splitlines()
                   if ln.startswith("portbench:")]
    lines = p.stdout.strip().splitlines()
    try:
        rec["result"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        rec["stderr"] = p.stderr[-4000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for seed in args.seeds:
        rec = one_run(args.workload, seed, args.seconds, args.trace)
        runs.append(rec)
        res = rec.get("result", {})
        brief = {k: round(v["value"], 6)
                 for k, v in res.get("metrics", {}).items()}
        for ln in rec["diag"]:
            print(ln, flush=True)
        print(f"seed {seed} rc {rec['rc']} wall {rec['wall_s']:.1f} s "
              f"correct {res.get('correct')} {brief} "
              f"compared {res.get('compared')}", flush=True)
        if "stderr" in rec:
            print(rec["stderr"], flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    ok = [r["result"] for r in runs if "result" in r]
    names = sorted({k for r in ok for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in ok
                if name in r["metrics"]]
        if len(vals) >= 2:
            med, q1, q3, s = spread(vals)
            print(f"{name}: n {len(vals)} median {med!r} q1 {q1!r} "
                  f"q3 {q3!r} spread {s!r}")
    return 0 if len(ok) == len(runs) and all(r["correct"] for r in ok) else 1


if __name__ == "__main__":
    sys.exit(main())
