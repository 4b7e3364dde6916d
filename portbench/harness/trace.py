"""The device trace of a measured window, and the arithmetic read from it.

`Tracer` wraps the window in `torch.profiler` (CPU and CUDA activity) and
keeps, from the profiler's raw events, the device operations (kernels,
copies, sets) and the host events of the thread that ran the window.  The
window itself is the benchmark's span ``portbench.window``.

Busy time is the union of device intervals inside the window, not their
sum.  An idle gap is a stretch of the window with no device operation;
it is named by what the host was doing at its midpoint: the benchmark's
innermost span there and the innermost host event.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import sys
import time
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

WINDOW_SPAN = "portbench.window"

Interval = Tuple[int, int]   # (start_ns, end_ns)


@dataclasses.dataclass
class Trace:
    window: Interval
    #: device operations: (start_ns, end_ns, name, kind), kind one of
    #: "kernel", "memcpy", "memset"
    device: List[Tuple[int, int, str, str]]
    #: host events of the window's thread: (start_ns, end_ns, name, span?)
    #: where span? marks the benchmark's own spans (user annotations)
    host: List[Tuple[int, int, str, bool]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernel_seconds(self) -> float:
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for s, e, _, k in self.device
                   if k == "kernel" and e > lo and s < hi) * 1e-9

    @functools.cached_property
    def busy(self) -> List[Interval]:
        """The device's busy intervals inside the window, merged."""
        return merged([(s, e) for s, e, _, _ in self.device], self.window)

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def idle_share(self) -> float:
        return 1.0 - self.busy_seconds() / self.window_s

    def top_device_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(int)
        lo, hi = self.window
        for s, e, name, _ in self.device:
            if e > lo and s < hi:
                by[name] += min(e, hi) - max(s, lo)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns * 1e-9] for name, ns in top]

    def top_idle(self, k: int = 10) -> List[list]:
        gaps = complement(self.busy, self.window)
        by = defaultdict(int)
        for (s, e), label in zip(gaps, label_gaps(gaps, self.host)):
            by[label] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns * 1e-9] for name, ns in top]


def merged(intervals: Sequence[Interval], window: Interval) -> List[Interval]:
    """`intervals` clipped to `window`, sorted and merged."""
    lo, hi = window
    out: List[List[int]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_ns(intervals: Sequence[Interval], window: Interval) -> int:
    """Length of the union of `intervals` inside `window`."""
    return sum(e - s for s, e in merged(intervals, window))


def idle_gaps(intervals: Sequence[Interval], window: Interval
              ) -> List[Interval]:
    """The stretches of `window` that no interval covers."""
    return complement(merged(intervals, window), window)


def complement(busy: Sequence[Interval], window: Interval
               ) -> List[Interval]:
    """The stretches of `window` outside the merged intervals `busy`."""
    gaps, at = [], window[0]
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = e
    if at < window[1]:
        gaps.append((at, window[1]))
    return gaps


def label_gaps(gaps: Sequence[Interval],
               host: Sequence[Tuple[int, int, str, bool]]) -> List[str]:
    """For each gap, ``"<innermost span>/<innermost host event>"`` at its
    midpoint ("idle" where nothing of the host covers it).  Host events of
    one thread nest, so the open events at a point form a stack."""
    events = sorted(host, key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in events]
    stack, i = [], 0
    order = sorted(range(len(gaps)), key=lambda j: gaps[j][0] + gaps[j][1])
    out = [""] * len(gaps)
    for j in order:
        mid = (gaps[j][0] + gaps[j][1]) // 2
        hi = bisect.bisect_right(starts, mid)
        while i < hi:
            stack.append(events[i])
            i += 1
        stack = [h for h in stack if h[1] >= mid]
        spans = [h[2] for h in stack if h[3] and h[2] != WINDOW_SPAN]
        inner = [h[2] for h in stack if not h[3]]
        out[j] = "/".join(x for x in (spans[-1] if spans else "",
                                       inner[-1] if inner else "") if x) \
            or "idle"
    return out


def _kind(name: str) -> str:
    """"kernel", "memcpy" or "memset" for a device operation, by its name
    (the profiler names copies "Memcpy ..." and sets "Memset ...")."""
    for k in ("Memcpy", "Memset"):
        if name.startswith(k):
            return k.lower()
    return "kernel"


class Tracer:
    """Profile the measured window when `enabled`; `trace` is then filled
    when the window closes."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        self.trace: Optional[Trace] = None
        self._spans = {WINDOW_SPAN}

    @contextlib.contextmanager
    def window(self, warm=None):
        """Wrap the measured window: a span, profiled when enabled.  When
        profiling, `warm` (one unit of the window's work) runs first under
        the profiler, outside the span, so that the profiler's own start-up
        on the first launches falls outside the window.  The drivers sync
        the device before the window's span closes."""
        from torch.profiler import ProfilerActivity, profile, record_function

        if not self.enabled:
            yield
            return
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        try:
            if warm is not None:
                warm()
            with record_function(WINDOW_SPAN):
                yield
        finally:
            t0 = time.perf_counter()
            prof.stop()
        t1 = time.perf_counter()
        events = prof.profiler.kineto_results.events()
        self.trace = from_events(events, self._spans)
        print(f"portbench: profiler stop {t1 - t0:.1f} s, {len(events)} "
              f"events read in {time.perf_counter() - t1:.1f} s",
              file=sys.stderr)

    def span(self, name: str):
        """A benchmark span around a call into a layer (traced runs)."""
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        self._spans.add(name)
        return record_function(name)


def from_events(events, spans) -> Trace:
    """A `Trace` from the profiler's raw (kineto) events; `spans` are the
    names of the benchmark's own spans (the window's among them), whose
    copies on the device timeline are no device work."""
    from torch.autograd import DeviceType

    raw = [(e.start_ns(), e.duration_ns(), e.name(),
            e.device_type() == DeviceType.CUDA, e.start_thread_id())
           for e in events]
    found = [(s, s + d, tid) for s, d, name, dev, tid in raw
             if name == WINDOW_SPAN and not dev]
    if not found:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    *window, tid = found[-1]
    device = [(s, s + d, name, _kind(name)) for s, d, name, dev, _ in raw
              if dev and name not in spans]
    host = [(s, s + d, name, name in spans) for s, d, name, dev, t in raw
            if not dev and t == tid and name != WINDOW_SPAN]
    return Trace(window=tuple(window), device=device, host=host)
