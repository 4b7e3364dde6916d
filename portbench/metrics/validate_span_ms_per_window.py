"""validate_span_ms_per_window: wall ms of the program's `bladyg.validate`
spans in the traced window (`core.updates.validate_updates`: the host
replay of a window, the read of its endpoint rows included), per
window."""
from portbench.harness import spans


def read(run):
    return spans.per(run, lambda t: 1e-6 * spans.wall_ns(t, spans.VALIDATE),
                     "windows")
