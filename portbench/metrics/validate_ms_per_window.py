"""validate_ms_per_window: host ms of `validate_updates`, as
`StreamSession.apply_window` calls it (the benchmark's timer around the
name in `repro_torch.runtime.stream`, between two device syncs), per
window of the traced run."""


def read(run):
    calls = run.spans.get("validate_updates")
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
