"""The port's program spans (`repro_torch.tracing`).

With no profiler running a span is one shared null context, and the
program makes no record call.  Under `torch.profiler` one stream window is
one `bladyg.window` holding its validation, searches and recomputes, and
the `bladyg.sync` spans of a call number exactly the host reads that
`analysis.entrypoints.count_host_reads` counts in it.  Outputs and
`StreamStats` are the same with the profiler on and off.  The tests
marked `cuda` hold the same on the card and check that no span is copied
onto the device's timeline.  This file does not import JAX.
"""
from __future__ import annotations

import collections
import contextlib

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.analysis import entrypoints as E
from repro_torch.core import algorithms, graph, kcore, updates

WINDOWS = ("clean", "escalated")

#: the four entry points of an analytics pass, as the benchmark calls them
PASS = {
    "coreness": lambda g: kcore.coreness_with_stats(g),
    "connected_components":
        lambda g: algorithms.connected_components(g, with_steps=True),
    "pagerank": lambda g: algorithms.pagerank(g, tol=None, max_steps=30,
                                              with_steps=True),
    "triangle_counts":
        lambda g: algorithms.triangle_counts(g, with_steps=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


def _window_call(world, which: str):
    """A fresh session's `apply_window` on the world's clean or escalated
    window, as the audit's manifest prepares it: (fn, args)."""
    ep = {e.name: e for e in E.MANIFEST}[
        f"StreamSession.apply_window[{which}]"]
    return ep.prepare(world)


def _profiled(fn, cuda: bool = False):
    """(fn's output, [(name, start_ns, end_ns, on_device)] of its program
    spans) under `torch.profiler`."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.device_type() == torch.autograd.DeviceType.CUDA)
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("bladyg.")]
    return out, events


def _counts(events):
    return collections.Counter(n for n, _, _, dev in events if not dev)


def _host_reads(fn, device) -> int:
    with E.count_host_reads(device) as box:
        fn()
    return box.count


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.fixture(scope="module")
def world():
    return E.tiny_world("cpu")


# ---- off: one null context, no record call ------------------------------


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    for name, _ in tracing.SPANS:
        assert tracing.span(name) is tracing.span(tracing.SYNC)
        assert isinstance(tracing.span(name), contextlib.nullcontext)


def test_no_record_call_without_a_profiler(world, monkeypatch):
    calls = []

    def spy(*args, **kwargs):
        calls.append(args)
        raise AssertionError("a record call with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spy)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    fn, args = _window_call(world, "escalated")
    fn(*args)
    for run in PASS.values():
        run(world.g)
    assert calls == []


def test_span_names_and_layers():
    names = [n for n, _ in tracing.SPANS]
    assert names == [tracing.WINDOW, tracing.VALIDATE, tracing.SEARCH,
                     tracing.RECOMPUTE, tracing.SYNC]
    assert all(n.startswith("bladyg.") for n in names)
    assert {layer for _, layer in tracing.SPANS} == {
        "stream session", "k-core maintenance", "programs and engine"}


def test_spans_are_not_user_scope_ranges(world):
    """The profiler copies a user-scope range (`record_function`) onto the
    device timeline as an annotation; the program's spans are recorded in
    another scope, which it does not copy."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("user.range"):
            PASS["coreness"](world.g)
    scopes = collections.defaultdict(set)
    for e in prof.profiler.kineto_results.events():
        scopes[e.name()].add(e.scope())
    assert scopes[tracing.SYNC] and not (
        scopes[tracing.SYNC] & scopes["user.range"])


# ---- on: one window's spans ---------------------------------------------


@pytest.mark.parametrize("which", WINDOWS)
def test_window_span_holds_its_children(world, which):
    fn, args = _window_call(world, which)
    res, events = _profiled(lambda: fn(*args))
    st = res.stats
    escalated = (st.escalated_cross_block + st.escalated_spill
                 + st.escalated_conflict)
    assert escalated == (1 if which == "escalated" else 0)
    counts = _counts(events)
    assert counts[tracing.WINDOW] == 1
    assert counts[tracing.VALIDATE] == 1
    assert counts[tracing.SEARCH] == 1 + escalated
    assert counts[tracing.RECOMPUTE] == int(st.block_local > 0) + escalated
    (_, w0, w1, _), = [e for e in events if e[0] == tracing.WINDOW]
    for name, s, e, dev in events:
        assert not dev
        assert w0 <= s <= e <= w1, name


# ---- on: one sync span a host read --------------------------------------


@pytest.mark.parametrize("which", WINDOWS)
def test_window_sync_spans_count_host_reads(world, which):
    fn, args = _window_call(world, which)
    reads = _host_reads(lambda: fn(*args), world.device)
    fn, args = _window_call(world, which)
    _, events = _profiled(lambda: fn(*args))
    assert _counts(events)[tracing.SYNC] == reads > 0


@pytest.mark.parametrize("entry", sorted(PASS))
def test_pass_sync_spans_count_host_reads(world, entry):
    run = PASS[entry]
    reads = _host_reads(lambda: run(world.g), world.device)
    _, events = _profiled(lambda: run(world.g))
    assert _counts(events) == {tracing.SYNC: reads}
    assert reads > 0


class _ReadSizes(TorchFunctionMode):
    """Records the element count of every tensor a host-read call takes
    (`entrypoints.HOST_READS`), its host copies included."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", "") in E.HOST_READS and args
                and isinstance(args[0], torch.Tensor)):
            self.sizes.append(args[0].numel())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_validate_reads_only_the_window_rows(device, request):
    """`validate_updates` on a graph of 4,096 rows reads the host once,
    inside its one sync span, and no more than the window's endpoint rows
    of `nbr` and `deg`, 2 * len(window) * (Cd + 1) values; the graph is
    left as it was."""
    if device == "cuda":
        request.getfixturevalue("require_cuda")
    g = graph.build_ell_random(4096, Cd=8, seed=3, device=device)
    window = (updates.sample_insertions(g, 4, "intra", seed=5)
              + updates.sample_deletions(g, 4, "intra", seed=6))
    nbr, deg = g.nbr.clone(), g.deg.clone()
    with _ReadSizes() as seen:
        reads = _host_reads(lambda: updates.validate_updates(g, window),
                            g.device)
    assert reads == 1
    assert 0 < max(seen.sizes) <= 2 * len(window) * (g.Cd + 1)
    _, events = _profiled(lambda: updates.validate_updates(g, window),
                          cuda=device == "cuda")
    assert _counts(events) == {tracing.VALIDATE: 1, tracing.SYNC: 1}
    assert torch.equal(g.nbr, nbr) and torch.equal(g.deg, deg)


# ---- on and off: the same results ---------------------------------------


@pytest.mark.parametrize("which", WINDOWS)
def test_window_results_equal_with_profiler_on_and_off(world, which):
    fn, args = _window_call(world, which)
    off = fn(*args)
    fn, args = _window_call(world, which)
    on, _ = _profiled(lambda: fn(*args))
    assert on.stats == off.stats
    assert torch.equal(on.core, off.core)
    for f in ("nbr", "deg", "node_mask", "orig_id"):
        assert torch.equal(getattr(on.g, f), getattr(off.g, f)), f
    assert on.labels is off.labels is None


@pytest.mark.parametrize("entry", sorted(PASS))
def test_pass_results_equal_with_profiler_on_and_off(world, entry):
    off = PASS[entry](world.g)
    on, _ = _profiled(lambda: PASS[entry](world.g))
    _assert_same(on, off)


# ---- on the card ---------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.usefixtures("require_cuda")
@pytest.mark.parametrize("call", ("window",) + tuple(sorted(PASS)))
def test_card_sync_spans_count_host_reads_and_stay_off_the_device(call):
    """On the card (the ELL kernels): the sync spans of the escalated
    window and of each entry point equal its host reads, and no span has
    a copy among the device's events."""
    w = E.tiny_world(torch.device("cuda", torch.cuda.current_device()))
    if call == "window":
        def make():
            fn, args = _window_call(w, "escalated")
            return lambda: fn(*args)
    else:
        def make():
            return lambda: PASS[call](w.g)
    make()()  # warm-up: kernels built and loaded
    reads = _host_reads(make(), w.device)
    _, events = _profiled(make(), cuda=True)
    assert [e for e in events if e[3]] == []
    assert _counts(events)[tracing.SYNC] == reads > 0
