"""The program's own spans in a traced window, and the arithmetic that the
span metrics share.

The port marks its work with spans named ``bladyg.*`` (the names of
`repro_torch.tracing.SPANS`, repeated here so that the benchmark runs
against a program that has none).  The profiler records them as host
events on the clock of the device's operations, so `Trace.host` holds
those of the window's thread with the rest.  A traced run profiles one
unit of warm-up before the window opens: spans that start outside
`Trace.window` are not counted.

A reader returns None where `has_spans` is false, as on a program
without spans.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from .trace import Interval, Trace, merged

PREFIX = "bladyg."
WINDOW = PREFIX + "window"        # one `StreamSession.apply_window`
VALIDATE = PREFIX + "validate"    # the host replay of a window
SEARCH = PREFIX + "search"        # a k-reachability search
RECOMPUTE = PREFIX + "recompute"  # a clamped min-H recompute
SYNC = PREFIX + "sync"            # one host read of a device value
NAMES = (WINDOW, VALIDATE, SEARCH, RECOMPUTE, SYNC)

#: the spans a window's self time leaves out
WINDOW_CHILDREN = (VALIDATE, SEARCH, RECOMPUTE)


def has_spans(trace: Optional[Trace]) -> bool:
    """Whether `trace` holds any program span."""
    return trace is not None and any(h[2].startswith(PREFIX)
                                     for h in trace.host)


def intervals(trace: Trace, name: str) -> List[Interval]:
    """The spans named `name` that start inside the window, clipped to
    its end, in order."""
    lo, hi = trace.window
    return sorted((s, min(e, hi)) for s, e, n, _ in trace.host
                  if n == name and lo <= s < hi)


def count(trace: Trace, name: str) -> int:
    return len(intervals(trace, name))


def wall_ns(trace: Trace, name: str) -> int:
    return sum(e - s for s, e in intervals(trace, name))


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_ns(trace: Trace, name: str, children: Sequence[str]) -> int:
    """The wall of the spans named `name`, less the part of it that spans
    of the names `children` cover."""
    own = intervals(trace, name)
    kids = merged([iv for c in children for iv in intervals(trace, c)],
                  trace.window)
    return (sum(e - s for s, e in own)
            - overlap_ns(merged(own, trace.window), kids))


def kernel_ns(trace: Trace, name: str) -> int:
    """Kernel time on the device inside the spans named `name` (the
    union of kernel intervals, clipped to the spans)."""
    kernels = merged([(s, e) for s, e, _, k in trace.device
                      if k == "kernel"], trace.window)
    return overlap_ns(merged(intervals(trace, name), trace.window), kernels)


def idle_ns(trace: Trace, name: str) -> int:
    """Time inside the spans named `name` in which no operation ran on
    the device."""
    own = merged(intervals(trace, name), trace.window)
    return sum(e - s for s, e in own) - overlap_ns(own, trace.busy)


def table(trace: Trace) -> Dict[str, Dict[str, float]]:
    """For each program span name found in the window: its count, wall
    seconds, the kernel and device-idle seconds inside it, and its self
    seconds (the window's less its validate, search and recompute)."""
    out = {}
    for name in NAMES:
        n = count(trace, name)
        if not n:
            continue
        row = dict(count=n, wall_s=wall_ns(trace, name) * 1e-9,
                   kernel_s=kernel_ns(trace, name) * 1e-9,
                   idle_s=idle_ns(trace, name) * 1e-9)
        if name == WINDOW:
            row["self_s"] = self_ns(trace, name, WINDOW_CHILDREN) * 1e-9
        out[name] = row
    return out


def per(run, of: Callable[[Trace], float], key: Optional[str] = None
        ) -> Optional[float]:
    """``of(run.trace)`` over the counter `key` of the run (its units
    where None); None where the trace holds no program span or the count
    is 0."""
    n = run.units if key is None else run.counters.get(key, 0)
    if not n or not has_spans(run.trace):
        return None
    return of(run.trace) / n
