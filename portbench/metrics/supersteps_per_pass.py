"""supersteps_per_pass: the supersteps of the four entry points of an
analytics pass (each call's ``with_steps`` count), per pass."""

from portbench.harness.analytics import ENTRY_POINTS


def read(run):
    if not run.units:
        return None
    return sum(run.counters[f"steps.{e}"] for e in ENTRY_POINTS) / run.units
