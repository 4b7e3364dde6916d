"""search_ms_per_update: wall ms of the program's `bladyg.search` spans
in the traced window (`kcore_dynamic.k_reachable_batch`: a window's
batched search and each escalated update's own), per update."""
from portbench.harness import spans


def read(run):
    return spans.per(run, lambda t: 1e-6 * spans.wall_ns(t, spans.SEARCH),
                     "updates")
