"""The benchmark of `repro_torch`, the PyTorch and CUDA port of BLADYG.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout, on a machine with as many CUDA devices
as the cell of `BENCHMARK.json` asks for.  Set-up makes the cell's graph
on the device (its configuration's one graph, relabelled and dealt into
blocks by the seed) and its traffic from the seed, builds and warms up the
program, then measures for `--seconds` seconds; the plain reference in
`portbench/reference/` judges what the timed path produced once the
window has closed.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``compared``: each number
compared beside its limit); the last lines of standard error repeat the
compared numbers.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
`torch.profiler` trace of the window and the program's own counters.

Exits non-zero, printing no result, when the machine lacks the devices,
when the program is not in the checkout, or when JAX or the JAX package
was loaded in the process.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import runner, spec

    try:
        cell = spec.load_cell(args.workload, ROOT)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot load workload {args.workload!r}: {e}")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: this benchmark measures the port on "
                    "NVIDIA GPUs only")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} CUDA devices, found "
                    f"{torch.cuda.device_count()}")
    try:
        import repro_torch
    except ImportError as e:
        return fail(f"the program (src/repro_torch) is not in the "
                    f"checkout: {e}")
    if ROOT not in Path(repro_torch.__file__).resolve().parents:
        return fail(f"repro_torch was loaded from {repro_torch.__file__}, "
                    "outside the checkout")
    line, compared = runner.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), "cuda:0", STARTED)
    found = runner.forbidden_modules()
    if found:
        return fail(f"JAX or the JAX package was loaded: {found}")
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
