"""pass_kernels_roofline: the analytics passes' least device time at the
card's memory bandwidth over the device time of every kernel they
launched (`torch.profiler`), in %.

The least bytes are counted from the graph and the step counts, so the
share reads the same work whatever kernels implement it: each superstep
of coreness, connected components and PageRank reads the valid slots of
`nbr`, `deg` and the field once and writes one value a row; the triangle
pass reads the valid slots and `deg` and writes the counts
(`record.ell_superstep_bytes`, `record.ell_triangle_bytes`).  Nothing is
read where the card has no entry in `peaks.json`."""
import json
from pathlib import Path

from portbench.harness.record import ell_superstep_bytes, ell_triangle_bytes

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def read(run):
    peak = json.loads(PEAKS.read_text()).get(run.device_kind)
    if run.trace is None or peak is None:
        return None
    kernel_s = run.trace.kernel_seconds()
    if kernel_s <= 0:
        return None
    s, N, c = run.sizes["sum_deg"], run.sizes["N"], run.counters
    steps = (c["steps.coreness"] + c["steps.connected_components"]
             + c["steps.pagerank"])
    nbytes = (steps * ell_superstep_bytes(s, N)
              + c["steps.triangle_counts"] * ell_triangle_bytes(s, N))
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / kernel_s
