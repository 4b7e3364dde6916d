"""mirror_edits_ms_per_window: wall ms of the program's
`bladyg.mirror_edits` spans in the traced window
(`hub_split.apply_mirrored_edits`: the edit path of a split graph, the
touched rows spliced on the host, the graph copied on its device), per
window."""
from portbench.harness import spans

EDITS = "bladyg.mirror_edits"


def read(run):
    if run.trace is None or not spans.count(run.trace, EDITS):
        return None
    return spans.per(run, lambda t: 1e-6 * spans.wall_ns(t, EDITS),
                     "windows")
