"""escalated_pct: the share of the window's updates that the stream
session escalated to the coordinator path (`StreamStats.escalated` over
`StreamStats.updates`, counted over the window)."""


def read(run):
    n = run.counters.get("updates", 0)
    return 100.0 * run.counters["escalated"] / n if n else None
