"""validate_span_ms_per_window: wall ms of the program's `bladyg.validate`
spans in the traced window (`core.updates.validate_updates`: the host
replay of a window, both copies of the rows included), per window.  The
program's own measure of what `validate_ms_per_window` times from the
benchmark, without that timer's two device syncs."""
from portbench.harness import spans


def read(run):
    return spans.per(run, lambda t: 1e-6 * spans.wall_ns(t, spans.VALIDATE),
                     "windows")
