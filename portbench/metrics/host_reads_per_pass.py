"""host_reads_per_pass: the program's `bladyg.sync` spans in the traced
window, one around each host read of a device value, per analytics
pass."""
from portbench.harness import spans


def read(run):
    return spans.per(run, lambda t: spans.count(t, spans.SYNC))
