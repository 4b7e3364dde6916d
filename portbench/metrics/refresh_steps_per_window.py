"""refresh_steps_per_window: supersteps of the mirror-aware coreness
that `MirrorStream` runs after each window (its `refresh_steps` counter)
per window of the measured window."""


def read(run):
    n = run.counters.get("windows", 0)
    steps = run.counters.get("refresh_steps")
    if not n or steps is None:
        return None
    return steps / n
