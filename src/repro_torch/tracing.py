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
#: one window of a hub-split stream (`MirrorStream.apply_window`), its
#: edits and its refresh nested inside it
MIRROR_WINDOW = "bladyg.mirror_window"
#: the edit path of a split graph (`hub_split.apply_mirrored_edits`): the
#: touched rows' splices on the host and the graph's copy on its device
MIRROR_EDITS = "bladyg.mirror_edits"
#: the mirror-aware coreness after a window (`MirrorStream._refresh`)
MIRROR_REFRESH = "bladyg.mirror_refresh"
#: a window's block-local batch (`StreamSession.apply_window`): the
#: accepted updates' edits and their one joint recompute, whose
#: `RECOMPUTE` span nests inside it; kept out of `SPANS`, and the
#: benchmark's `local_ms_per_window` reads it by name
LOCAL = "bladyg.local"
#: the connected-component labels' upkeep after a window of a session
#: that keeps them (`StreamSession.apply_window`: the label merge of an
#: insert-only window or the recompute of any other;
#: `MirrorStream._refresh`: the recompute); kept out of `SPANS`, and the
#: benchmark's `cc_ms_per_window` reads it by name.  The session's upkeep
#: reads nothing back, so under a profiler the span waits for its kernels
#: before it closes (`settle`)
CC = "bladyg.cc"

#: the span names of the stream session and the analytics, with the layer
#: of the port each belongs to (the benchmark's harness repeats these one
#: for one; it reads the mirror spans above by name: the hub-split stream's
#: window and edits are in the stream session, its refresh in k-core
#: maintenance)
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


def settle(device) -> None:
    """While a profiler runs, wait for the work queued on `device`'s
    current stream, so that the span this is called in closes after that
    work on the device's timeline.  For a span whose work reads nothing
    back to the host: it would close while its kernels still wait in the
    queue, and the kernel time inside it would miss them.  With no
    profiler running, or on the CPU, it does nothing."""
    device = torch.device(device)
    if torch.autograd._profiler_enabled() and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
