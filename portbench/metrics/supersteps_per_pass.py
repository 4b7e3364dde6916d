"""supersteps_per_pass: the supersteps of the entry points of an analytics
pass (each call's ``with_steps`` count, a counter ``steps.<entry point>``),
per pass."""


def read(run):
    if not run.units:
        return None
    return sum(v for k, v in run.counters.items()
               if k.startswith("steps.")) / run.units
