"""local_ms_per_window: wall ms of the program's `bladyg.local` spans in
the traced window (`StreamSession.apply_window`'s block-local batch: the
accepted updates' edits and their one joint recompute), per stream
window."""
from portbench.harness import spans

LOCAL = "bladyg.local"


def read(run):
    if run.trace is None or not spans.count(run.trace, LOCAL):
        return None
    return spans.per(run, lambda t: 1e-6 * spans.wall_ns(t, LOCAL),
                     "windows")
