"""Program spans on the profiler's timeline.

`span(name)` marks a stretch of the program as a host event of
`torch.profiler`, on the clock the profiler gives the device's kernels and
copies, so a trace of a profiled run shows each span beside the device
work it issued and waited for.  With no profiler running it is one shared
null context: the gate costs a flag read, where an ungated range would
cost a record call each time.  There is no switch and no exporter: a
profiled run gets spans and any other run does not.

A span is a function-scope record (`_RecordFunctionFast`), not the
user-scope range of `torch.profiler.record_function`: the profiler copies
a user-scope range onto the device timeline as an annotation, where a
reader of device time would count it as a kernel.

`SYNC` wraps every host read on the stream and analytics paths, so the
count of its spans over a call equals the host reads
`analysis.entrypoints.count_host_reads` counts there, and each read's wait
lies on the same clock.
"""
from __future__ import annotations

import contextlib

import torch

#: one stream window (`StreamSession.apply_window`), the other spans of
#: the window nested inside it on one thread
WINDOW = "bladyg.window"
#: the host replay of a window (`core.updates.validate_updates`)
VALIDATE = "bladyg.validate"
#: a k-reachability search (`kcore_dynamic.k_reachable_batch`)
SEARCH = "bladyg.search"
#: a clamped min-H recompute (`kcore_dynamic._restricted_recompute`)
RECOMPUTE = "bladyg.recompute"
#: one host read of a device value
SYNC = "bladyg.sync"

#: every span name, with the layer of the port it belongs to
SPANS = (
    (WINDOW, "stream session"),
    (VALIDATE, "stream session"),
    (SEARCH, "k-core maintenance"),
    (RECOMPUTE, "k-core maintenance"),
    (SYNC, "programs and engine"),
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A span named `name` while a profiler runs, else a null context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
