"""cc_ms_per_window: wall ms of the program's `bladyg.cc` spans in the
traced window (`StreamSession.apply_window`'s upkeep of the
connected-component labels: the merge of an insert-only window, the
recompute of any other), per stream window."""
from portbench.harness import spans

CC = "bladyg.cc"


def read(run):
    if run.trace is None or not spans.count(run.trace, CC):
        return None
    return spans.per(run, lambda t: 1e-6 * spans.wall_ns(t, CC), "windows")
