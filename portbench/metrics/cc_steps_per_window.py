"""cc_steps_per_window: supersteps of the stream session's
connected-component recomputes (its `cc_steps` counter) per window of the
measured window."""


def read(run):
    n = run.counters.get("windows", 0)
    steps = run.counters.get("cc_steps")
    if not n or steps is None:
        return None
    return steps / n
