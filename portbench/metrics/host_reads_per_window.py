"""host_reads_per_window: the program's `bladyg.sync` spans in the traced
window, one around each host read of a device value, per stream
window."""
from portbench.harness import spans


def read(run):
    return spans.per(run, lambda t: spans.count(t, spans.SYNC), "windows")
