"""recompute_ms_per_update: wall ms of the program's `bladyg.recompute`
spans in the traced window (`kcore_dynamic._restricted_recompute`: a
window's joint block-local recompute and each escalated update's own),
per update."""
from portbench.harness import spans


def read(run):
    return spans.per(run, lambda t: 1e-6 * spans.wall_ns(t, spans.RECOMPUTE),
                     "updates")
