"""supersteps_per_update: k-core maintenance supersteps (frontier hops
of the candidate searches and clamped min-H recompute steps, from
`StreamStats`) per update of the window."""


def read(run):
    n = run.counters.get("updates", 0)
    if not n:
        return None
    return (run.counters["bfs_steps"] + run.counters["recompute_steps"]) / n
