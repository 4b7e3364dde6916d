"""device_idle_pct.stream: the share of the traced window in which no
operation ran on the device: 1 - the union of kernel, copy and set
intervals over the window's wall time."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * run.trace.idle_share()
