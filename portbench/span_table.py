"""A traced run of one cell, with the program's spans of its window.

    python3 portbench/span_table.py --workload <cell> --seed <n> \
        --seconds <s>

runs ``portbench/run.py ... --trace 1`` and, before its result line,
prints to standard error one line ``spans {...}``: for each program span
name (`harness/spans.py`) its count, wall seconds, the kernel and
device-idle seconds inside it (and the window's self seconds), beside the
window's seconds, the device's busy seconds, the units and the counters.
"""
import json
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import runner, spans

    result_line = runner.result_line

    def with_spans(cell, out, numbers, trace, device):
        rec = out.record
        if rec.trace is not None:
            print("spans " + json.dumps(dict(
                cell=cell.name, spans=spans.table(rec.trace),
                window_s=rec.trace.window_s,
                busy_s=rec.trace.busy_seconds(), units=rec.units,
                counters=rec.counters)), file=sys.stderr)
        return result_line(cell, out, numbers, trace, device)

    runner.result_line = with_spans
    sys.argv = [str(ROOT / "portbench" / "run.py")] + sys.argv[1:] + [
        "--trace", "1"]
    runpy.run_path(sys.argv[0], run_name="__main__")


if __name__ == "__main__":
    main()
