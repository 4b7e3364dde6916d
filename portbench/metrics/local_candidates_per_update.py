"""local_candidates_per_update: candidates of the stream session's joint
block-local recomputes (its `local_candidates` count, each window's union
of its accepted updates' candidate sets) over the window, per update
applied on the block-local path (`StreamStats.block_local`)."""


def read(run):
    n = run.counters.get("block_local", 0)
    cand = run.counters.get("local_candidates")
    if not n or cand is None:
        return None
    return cand / n
