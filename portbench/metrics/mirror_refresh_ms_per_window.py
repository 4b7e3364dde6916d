"""mirror_refresh_ms_per_window: wall ms of the program's
`bladyg.mirror_refresh` spans in the traced window
(`MirrorStream._refresh`: the mirror-aware coreness after each window),
per window."""
from portbench.harness import spans

REFRESH = "bladyg.mirror_refresh"


def read(run):
    if run.trace is None or not spans.count(run.trace, REFRESH):
        return None
    return spans.per(run, lambda t: 1e-6 * spans.wall_ns(t, REFRESH),
                     "windows")
