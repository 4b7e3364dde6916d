"""Time the union-find label recompute at a stream cell's shapes.

    python3 tools/cc_union_timing.py [--workload rgg23.stream-cc]
        [--seed N] [--reps 20]

Builds the cell's graph on the first CUDA device as the benchmark's
`stream_cc` driver builds it (`portbench/`: the configuration's graph,
laid out in blocks by position, rows permuted inside each block by
`--seed`, the generator's first point kept at id 0), then:

* labels it `--reps` times by `union_find_labels` (`csrc/cc_union.cu`),
  each launch's labels bit-equal to `connected_components`' (min-label
  propagation, run once: its seconds and supersteps) and to the plain
  version's (`union_find_labels_plain`, run on the card);
* gives the median device ms of a call by CUDA events, and of each of the
  kernel's three launches (init, hook, label) by `torch.profiler`;
* sets them beside a superstep's least bytes (the benchmark's
  `ell_superstep_bytes`: the valid slots, `deg` and the field read, a label
  written a row) at the card's peak bandwidth.

Prints one JSON line: the card, the sizes, the times and the counts.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

#: HBM bytes a second of one H100 SXM (the benchmark's `peaks.json`)
PEAK_BYTES_S = 3.35e12


def cell_graph(workload: str, seed: int, device):
    """The cell's graph as the stream_cc driver opens its session on it."""
    from portbench.harness import graphs, spec
    from repro_torch.core.graph import GraphBlocks

    cell = spec.load_cell(workload, ROOT)
    conf = cell.config
    drv = spec.load_driver("stream_cc", ROOT)
    gen = torch.Generator(device=device).manual_seed(seed)
    graph_gen = torch.Generator(device=device).manual_seed(
        int(conf["graph_seed"]))
    n = int(conf["vertices"])
    lay = drv.least_id_kept(drv._local.lay_out_by_id(
        graphs.make_edges(conf, graph_gen, cell.root), n,
        int(conf["blocks"]), int(conf["degree_capacity"]), gen))
    nbr, deg = graphs.ell_rows(lay.keys, lay.N, lay.Cd)
    return GraphBlocks(nbr=nbr, deg=deg, node_mask=lay.node_mask.clone(),
                       orig_id=lay.orig_id.to(torch.int32), P=lay.P,
                       Cn=lay.Cn, Cd=lay.Cd)


def timed(fn, reps: int):
    """(fn's results, median device ms of `reps` calls)."""
    outs, ms = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        outs.append(fn())
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return outs, statistics.median(ms)


def launch_ms(fn, reps: int) -> dict:
    """Median device ms of each kernel `fn` launches, by name, over `reps`
    calls under `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.count:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            out[e.key[:64]] = total / e.count / 1e3
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="rgg23.stream-cc")
    p.add_argument("--seed", type=int, default=2147500001)
    p.add_argument("--reps", type=int, default=20)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from portbench.harness.record import ell_superstep_bytes
    from repro_torch.core import connected_components
    from repro_torch.kernels.cc_union import (
        union_find_labels, union_find_labels_plain)

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    g = cell_graph(a.workload, a.seed, dev)
    args = (g.nbr, g.deg, g.node_mask)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want, steps = connected_components(g, with_steps=True)
    torch.cuda.synchronize()
    cc_s = time.perf_counter() - t
    union_find_labels(*args)  # the build and the first launch
    before = union_find_labels.launches
    outs, ms = timed(lambda: union_find_labels(*args), a.reps)
    launches = union_find_labels.launches - before
    equal = sum(torch.equal(o, want) for o in outs)
    del outs
    plain, plain_ms = timed(lambda: union_find_labels_plain(*args), 2)
    plain_equal = all(torch.equal(o, want) for o in plain)
    del plain
    per_launch = launch_ms(lambda: union_find_labels(*args), 5)
    sum_deg = int(g.deg.sum())
    nbytes = ell_superstep_bytes(sum_deg, g.N)
    line = dict(
        card=card.strip(), workload=a.workload, seed=a.seed, N=g.N, Cd=g.Cd,
        sum_deg=sum_deg, max_deg=int(g.deg.max()),
        components=int(torch.unique(want[g.node_mask]).numel()),
        connected_components_s=cc_s, connected_components_steps=steps,
        union_find_ms=ms, reps=a.reps, launches=launches,
        bit_equal_launches=equal, plain_ms=plain_ms,
        plain_bit_equal=plain_equal, kernels_ms=per_launch,
        superstep_bytes=nbytes, superstep_bound_ms=nbytes / PEAK_BYTES_S * 1e3,
        share_of_bound_pct=100.0 * nbytes / PEAK_BYTES_S * 1e3 / ms)
    print(json.dumps(line), flush=True)
    return 0 if equal == a.reps and plain_equal else 1


if __name__ == "__main__":
    sys.exit(main())
