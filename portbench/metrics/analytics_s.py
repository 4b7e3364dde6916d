"""analytics_s: the measured window's seconds over the analytics passes
completed in it (host clock)."""


def read(run):
    return run.window_s / run.units
