"""The program-span metrics: the arithmetic of `harness/spans.py` and the
six readers on a hand-made trace with nested spans, spans of the warm-up
unit outside the window, and idle gaps on the device."""
import pytest
from torch.autograd import DeviceType

from portbench.harness import spans, spec, trace
from portbench.harness.record import RunRecord

WINDOW = (100, 1100)

#: the warm-up unit's spans, before the window opens: never counted
WARM = [(0, 90, "bladyg.window"), (10, 30, "bladyg.validate"),
        (10, 15, "bladyg.sync"), (40, 60, "bladyg.search"),
        (60, 70, "bladyg.sync")]

#: two stream windows: the first with a block-local batch and one
#: escalated update, the second with its batch escalated
PROGRAM = [
    (105, 495, "bladyg.window"),
    (110, 210, "bladyg.validate"), (110, 150, "bladyg.sync"),
    (150, 160, "bladyg.sync"),
    (220, 300, "bladyg.search"), (290, 295, "bladyg.sync"),
    (300, 305, "bladyg.sync"),
    (310, 400, "bladyg.recompute"), (390, 398, "bladyg.sync"),
    (410, 450, "bladyg.search"), (445, 450, "bladyg.sync"),
    (455, 490, "bladyg.recompute"), (480, 489, "bladyg.sync"),
    (600, 1000, "bladyg.window"),
    (610, 700, "bladyg.validate"), (610, 640, "bladyg.sync"),
    (640, 650, "bladyg.sync"),
    (700, 800, "bladyg.search"), (795, 800, "bladyg.sync"),
    (800, 802, "bladyg.sync"),
    (810, 990, "bladyg.recompute"), (985, 990, "bladyg.sync"),
]

#: the benchmark's own spans and the ops under them
OTHER = [(100, 500, "apply_window", True), (600, 1000, "apply_window", True),
         (620, 630, "aten::copy_", False), (820, 830, "aten::where", False)]

DEVICE = [(230, 280, "frontier", "kernel"), (320, 380, "hindex", "kernel"),
          (620, 630, "Memcpy DtoH", "memcpy"),
          (820, 980, "hindex", "kernel")]


def _trace(program=True):
    host = list(OTHER)
    if program:
        host += [(s, e, n, False) for s, e, n in WARM + PROGRAM]
    return trace.Trace(window=WINDOW, device=list(DEVICE), host=host)


def _run(t, units, **counters):
    return RunRecord(cell="c", device_kind="cpu", setup_s=1.0,
                     window_s=1e-6, units=units, unit_ms=[], counters=counters,
                     sizes={}, trace=t)


def _stream(t):
    return _run(t, 3, updates=3, windows=2)


def _analytics(t):
    return _run(t, 4, passes=4)


def test_names_are_the_programs():
    from repro_torch import tracing

    assert spans.NAMES == tuple(n for n, _ in tracing.SPANS)
    assert spans.WINDOW_CHILDREN == (tracing.VALIDATE, tracing.SEARCH,
                                     tracing.RECOMPUTE)


def test_intervals_count_only_what_starts_in_the_window():
    t = _trace()
    assert spans.intervals(t, "bladyg.search") == [(220, 300), (410, 450),
                                                   (700, 800)]
    assert spans.count(t, "bladyg.sync") == 12
    assert spans.count(t, "bladyg.window") == 2
    late = trace.Trace(window=(0, 50), device=[],
                       host=[(40, 90, "bladyg.window", False)])
    assert spans.intervals(late, "bladyg.window") == [(40, 50)]


def test_overlap_of_sorted_interval_lists():
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_ns([], [(0, 5)]) == 0
    assert spans.overlap_ns([(0, 100)], [(10, 20), (30, 40), (90, 200)]) \
        == 30


def test_wall_self_kernel_and_idle_inside_spans():
    t = _trace()
    assert spans.wall_ns(t, "bladyg.window") == 390 + 400
    # children: 100 + 80 + 90 + 40 + 35 in the first, 90 + 100 + 180 in
    # the second
    assert spans.self_ns(t, "bladyg.window", spans.WINDOW_CHILDREN) == 75
    assert spans.kernel_ns(t, "bladyg.search") == 50
    assert spans.idle_ns(t, "bladyg.search") == 220 - 50
    assert spans.kernel_ns(t, "bladyg.validate") == 0
    assert spans.idle_ns(t, "bladyg.validate") == 190 - 10   # the copy
    assert spans.kernel_ns(t, "bladyg.recompute") == 60 + 160
    assert spans.idle_ns(t, "bladyg.recompute") == 305 - 220
    table = spans.table(t)
    assert set(table) == set(spans.NAMES)
    assert table["bladyg.window"]["self_s"] == pytest.approx(75e-9)
    assert table["bladyg.sync"]["count"] == 12
    assert table["bladyg.recompute"]["idle_s"] == pytest.approx(85e-9)


READERS = {
    "validate_span_ms_per_window": (_stream, 1e-6 * 190 / 2),
    "session_self_ms_per_window": (_stream, 1e-6 * 75 / 2),
    "search_ms_per_update": (_stream, 1e-6 * 220 / 3),
    "recompute_ms_per_update": (_stream, 1e-6 * 305 / 3),
    "host_reads_per_window": (_stream, 12 / 2),
    "host_reads_per_pass": (_analytics, 12 / 4),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_the_hand_computed_value(name):
    make, want = READERS[name]
    assert spec.load_reader(name)(make(_trace())) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_program_spans(name):
    make, _ = READERS[name]
    read = spec.load_reader(name)
    assert read(make(_trace(program=False))) is None
    assert read(make(None)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_units(name):
    make, _ = READERS[name]
    run = make(_trace())
    run.units = 0
    run.counters = {k: 0 for k in run.counters}
    assert spec.load_reader(name)(run) is None


class _Event:
    def __init__(self, s, e, name, dev, tid=1):
        self.s, self.e, self.n, self.dev, self.tid = s, e, name, dev, tid

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def name(self):
        return self.n

    def device_type(self):
        return DeviceType.CUDA if self.dev else DeviceType.CPU

    def start_thread_id(self):
        return self.tid


def test_program_spans_reach_the_trace_as_host_events():
    """`from_events` keeps the program's spans among the window thread's
    host events, so the readers find them with no change to the
    drivers."""
    events = [_Event(100, 1100, trace.WINDOW_SPAN, False),
              _Event(105, 495, "bladyg.window", False),
              _Event(110, 150, "bladyg.sync", False),
              _Event(110, 150, "bladyg.sync", False, tid=2),
              _Event(230, 280, "frontier", True)]
    t = trace.from_events(events, {trace.WINDOW_SPAN})
    assert t.window == (100, 1100)
    assert t.device == [(230, 280, "frontier", "kernel")]
    assert t.host == [(105, 495, "bladyg.window", False),
                      (110, 150, "bladyg.sync", False)]
    assert spans.has_spans(t) and spans.count(t, "bladyg.sync") == 1
