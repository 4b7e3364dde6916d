"""cc_roofline: the connected-component recomputes' least device time at
the card's memory bandwidth over the kernel time inside the program's
`bladyg.cc` spans (`torch.profiler`), in %.

The least bytes of one superstep of min-label propagation are those of a
neighbour combine over the graph's ELL rows (`record.ell_superstep_bytes`
of the graph's degree sum at set-up: the valid slots of `nbr`, `deg` and
the labels read once, one label written a row), times the supersteps the
session counted (`cc_steps`).  The recompute reads its loop's flag on the
host inside its span, so its device work falls inside it.  Nothing is
read where the card has no entry in `peaks.json`."""
import json
from pathlib import Path

from portbench.harness import spans
from portbench.harness.record import ell_superstep_bytes

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"
CC = "bladyg.cc"


def read(run):
    peak = json.loads(PEAKS.read_text()).get(run.device_kind)
    steps = run.counters.get("cc_steps")
    if run.trace is None or peak is None or not steps \
            or "sum_deg" not in run.sizes:
        return None
    kernel_s = spans.kernel_ns(run.trace, CC) * 1e-9
    if kernel_s <= 0:
        return None
    nbytes = steps * ell_superstep_bytes(run.sizes["sum_deg"], run.sizes["N"])
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / kernel_s
