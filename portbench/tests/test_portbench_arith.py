"""The metric arithmetic: window rates, the p95 rule, the union of device
intervals and the idle share, the labels of idle gaps, the roofline's
byte count, and the spread the bounds are set from."""
import statistics

import pytest

from portbench import sets
from portbench.harness import spec, trace
from portbench.harness.record import (
    P95_MIN_SAMPLES, RunRecord, ell_superstep_bytes, ell_triangle_bytes, p95,
    percentile_nearest_rank)


def _run(**kw):
    base = dict(cell="c", device_kind="cpu", setup_s=1.0, window_s=10.0,
                units=0, unit_ms=[], counters={}, sizes={})
    base.update(kw)
    return RunRecord(**base)


def test_union_merges_overlaps_and_clips_to_the_window():
    iv = [(0, 10), (5, 15), (20, 30), (28, 40), (50, 60), (-5, 2)]
    assert trace.merged(iv, (1, 55)) == [(1, 15), (20, 40), (50, 55)]
    assert trace.union_ns(iv, (1, 55)) == 14 + 20 + 5
    assert trace.idle_gaps(iv, (1, 70)) == [(15, 20), (40, 50), (60, 70)]
    assert trace.union_ns([], (0, 10)) == 0
    assert trace.idle_gaps([], (0, 10)) == [(0, 10)]


def test_busy_is_the_union_not_the_sum():
    t = trace.Trace(window=(0, 100),
                    device=[(0, 50, "k1", "kernel"), (10, 40, "c", "memcpy"),
                            (60, 70, "k2", "kernel")],
                    host=[])
    assert t.busy_seconds() == pytest.approx(60e-9)
    assert t.idle_share() == pytest.approx(0.4)
    assert t.kernel_seconds() == pytest.approx(60e-9)
    top = t.top_device_ops(2)
    assert [n for n, _ in top] == ["k1", "c"]
    assert [s for _, s in top] == pytest.approx([50e-9, 30e-9])


def test_idle_gaps_are_named_by_the_host_at_their_midpoint():
    host = [(0, 100, "apply_window", True),
            (0, 45, "validate_updates", True),
            (5, 40, "aten::copy_", False),
            (50, 100, "aten::where", False)]
    gaps = [(10, 30), (60, 80), (200, 210)]
    assert trace.label_gaps(gaps, host) == [
        "validate_updates/aten::copy_", "apply_window/aten::where", "idle"]
    t = trace.Trace(window=(0, 210), device=[(30, 60, "k", "kernel"),
                                            (80, 200, "k", "kernel")],
                    host=host)
    assert dict(map(tuple, t.top_idle())) == {
        "validate_updates/aten::copy_": pytest.approx(30e-9),
        "apply_window/aten::where": pytest.approx(20e-9),
        "idle": pytest.approx(10e-9)}


def test_p95_needs_ten_samples_beyond_it():
    assert P95_MIN_SAMPLES == 200
    assert p95(list(range(199))) is None
    vals = list(range(1, 201))
    assert p95(vals) == 190
    assert sum(v > p95(vals) for v in vals) == 10
    assert percentile_nearest_rank([3.0, 1.0, 2.0], 0.5) == 2.0


def test_window_rates():
    run = _run(window_s=12.5, units=400, unit_ms=[31.25] * 50,
               counters=dict(updates=400, escalated=100, bfs_steps=900,
                             recompute_steps=300))
    read = lambda n: spec.load_reader(n)(run)  # noqa: E731
    assert read("updates_per_s") == 32.0
    assert read("escalated_pct") == 25.0
    assert read("supersteps_per_update") == 3.0
    run = _run(window_s=10.5, units=7, counters={
        f"steps.{e}": 7 * s for e, s in zip(
            ("coreness", "connected_components", "pagerank",
             "triangle_counts"), (20, 3000, 1, 1))})
    assert spec.load_reader("analytics_s")(run) == 1.5
    assert spec.load_reader("supersteps_per_pass")(run) == 3022


def test_roofline_byte_count():
    # roadNet-CA's sizes: 45.8 MB, 13.7 us a superstep at 3.35 TB/s
    s, N = 2 * 2_766_607, 1_965_248
    assert ell_superstep_bytes(s, N) == 4 * s + 12 * N
    assert ell_superstep_bytes(s, N) / 3.35e12 == pytest.approx(13.6e-6,
                                                                rel=0.01)
    assert ell_triangle_bytes(s, N) == 4 * s + 8 * N
    counters = {"steps.coreness": 10, "steps.connected_components": 80,
                "steps.pagerank": 10, "steps.triangle_counts": 1}
    nbytes = 100 * ell_superstep_bytes(s, N) + ell_triangle_bytes(s, N)
    kernel_s = 4 * nbytes / 3.35e12   # a quarter of the roofline
    t = trace.Trace(window=(0, 10**12),
                    device=[(0, int(round(kernel_s * 1e9)), "k", "kernel"),
                            (0, 10**9, "copy", "memcpy")], host=[])
    run = _run(device_kind="NVIDIA H100 80GB HBM3", counters=counters,
               sizes=dict(sum_deg=s, N=N), trace=t)
    assert spec.load_reader("pass_kernels_roofline")(run) == pytest.approx(
        25.0, rel=1e-6)
    run.device_kind = "a card without a peak"
    assert spec.load_reader("pass_kernels_roofline")(run) is None


def test_spread_uses_pythons_quartiles():
    vals = [10.0, 10.2, 9.9, 10.4, 10.1, 9.8]
    med, q1, q3, s = sets.spread(vals)
    assert (q1, med, q3) == tuple(statistics.quantiles(vals, n=4))
    assert s == pytest.approx((q3 - q1) / med)


class _Event:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, start, dur, device, tid=1):
        from torch.autograd import DeviceType
        self._v = (name, start, dur, DeviceType.CUDA if device
                   else DeviceType.CPU, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]


def test_trace_from_raw_events():
    ev = [_Event(trace.WINDOW_SPAN, 100, 900, False),
          _Event(trace.WINDOW_SPAN, 100, 900, True),      # its device copy
          _Event("apply_window", 150, 800, False),
          _Event("apply_window", 150, 800, True),
          _Event("aten::copy_", 200, 50, False),
          _Event("aten::where", 300, 10, False, tid=2),   # another thread
          _Event("ell_hindex_kernel", 400, 100, True),
          _Event("Memcpy DtoH (Device -> Pageable)", 600, 200, True),
          _Event("Memset (Device)", 850, 10, True)]
    t = trace.from_events(ev, {trace.WINDOW_SPAN, "apply_window"})
    assert t.window == (100, 1000)
    assert [(n, k) for _, _, n, k in t.device] == [
        ("ell_hindex_kernel", "kernel"),
        ("Memcpy DtoH (Device -> Pageable)", "memcpy"),
        ("Memset (Device)", "memset")]
    assert [(n, span) for _, _, n, span in t.host] == [
        ("apply_window", True), ("aten::copy_", False)]
    assert t.busy_seconds() == pytest.approx(310e-9)
    assert t.kernel_seconds() == pytest.approx(100e-9)
    with pytest.raises(RuntimeError):
        trace.from_events(ev[2:], {trace.WINDOW_SPAN})
