"""updates_per_s: every update applied in the measured window over the
window's seconds (host clock, from the first window's call to the sync
after the last)."""


def read(run):
    return run.units / run.window_s
