"""session_self_ms_per_window: self ms of the program's `bladyg.window`
spans in the traced window (`StreamSession.apply_window`, less the part
its `bladyg.validate`, `bladyg.search` and `bladyg.recompute` spans
cover), per window: id resolution, packing, routing, edge edits and the
verdict read."""
from portbench.harness import spans


def read(run):
    return spans.per(run, lambda t: 1e-6 * spans.self_ns(
        t, spans.WINDOW, spans.WINDOW_CHILDREN), "windows")
