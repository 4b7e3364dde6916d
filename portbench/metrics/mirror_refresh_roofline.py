"""mirror_refresh_roofline: the mirror-aware coreness's least device time
at the card's memory bandwidth over the kernel time inside the program's
`bladyg.mirror_refresh` spans (`torch.profiler`), in %.

The least bytes of one superstep are the function's, counted once from
the split graph's sizes (`drivers/mirror_stream.group_sizes`): the valid
slots of `nbr`, `deg` and the field read once and one value written a row
(`record.ell_superstep_bytes`; the group rows' slots are among those
slots), plus one merged value written a group.  Scratch memory of any
one implementation of the merge is not counted.  The refresh reads its
loop's flag on the host inside its span, so its device work falls inside
it.  Nothing is read where the card has no entry in `peaks.json`."""
import json
from pathlib import Path

from portbench.harness import spans
from portbench.harness.record import ell_superstep_bytes

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"
REFRESH = "bladyg.mirror_refresh"


def superstep_bytes(sizes: dict) -> int:
    """Least bytes of one superstep of the mirror-aware coreness."""
    return ell_superstep_bytes(sizes["sum_deg"], sizes["N"]) \
        + 4 * sizes["groups"]


def read(run):
    peak = json.loads(PEAKS.read_text()).get(run.device_kind)
    steps = run.counters.get("refresh_steps")
    if run.trace is None or peak is None or not steps \
            or "groups" not in run.sizes:
        return None
    kernel_s = spans.kernel_ns(run.trace, REFRESH) * 1e-9
    if kernel_s <= 0:
        return None
    return (100.0 * steps * superstep_bytes(run.sizes)
            / peak["hbm_bytes_per_s"] / kernel_s)
