"""`correct` at a size a CPU test holds: the program's run is correct, the
control (the reference put in the program's place with the guarantee
broken, or in the precision below) is not, and a run whose timed path is
broken underneath comes out not correct for each fault the cell can have.

These drive a whole run but the look for a chip (`run.py`), on the CPU,
where the program runs its plain versions.
"""
import time

import pytest
import torch

from _tiny import tiny_cell
from portbench.harness import compare, runner, spec
from portbench.harness.trace import Tracer

SEED = 2**31 + 77

WORKLOADS = spec.load_benchmark()["workloads"]
CELLS = [w["name"] for w in WORKLOADS]


def cells_of(driver):
    """The cells whose traffic the driver `driver` runs."""
    return [w["name"] for w in WORKLOADS
            if spec.load_traffic(w["traffic"])["driver"] == driver]


def run(cell, seconds=0.3):
    line, compared = runner.run_cell(cell, SEED, seconds, False, "cpu",
                                     time.perf_counter())
    return line


@pytest.mark.parametrize("name", CELLS)
def test_program_correct_control_not(name):
    cell = tiny_cell(name)
    drv = runner.driver_of(cell)
    out = drv.run(cell, SEED, 0.3, Tracer(False), "cpu", time.perf_counter())
    ok, table = compare.verdict(
        drv.judge(out.outputs, out.inputs, cell.traffic, "cpu"),
        cell.traffic["limits"])
    assert ok, table
    ok, table = compare.verdict(
        drv.judge(drv.control(out.inputs, cell.traffic, "cpu"), out.inputs,
                  cell.traffic, "cpu"), cell.traffic["limits"])
    assert not ok, table


# ---- faults planted in the stream's timed path --------------------------


def _unchanged(sess, window):
    """A window that returns the session's state unchanged."""


def _half(orig):
    def apply(sess, window):   # half of each window left out
        return orig(sess, window[:len(window) // 2])
    return apply


def _altered(orig):
    def apply(sess, window):   # one node's coreness altered where produced
        orig(sess, window)
        sess.core = sess.core.clone()
        sess.core[int(torch.nonzero(sess.g.node_mask)[0])] += 1
    return apply


@pytest.mark.parametrize("name", cells_of("stream"))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_stream_faults_come_out_not_correct(fault, name, monkeypatch):
    from repro_torch.runtime.stream import StreamSession

    orig = StreamSession.apply_window
    patch = dict(unchanged=_unchanged, half=_half(orig),
                 altered=_altered(orig))[fault]
    monkeypatch.setattr(StreamSession, "apply_window", patch)
    line = run(tiny_cell(name))
    assert line["correct"] is False, line["compared"]


# ---- faults planted in the analytics pass -------------------------------


@pytest.mark.parametrize("name", cells_of("analytics"))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_analytics_faults_come_out_not_correct(fault, name, monkeypatch):
    from repro_torch.core import algorithms
    from repro_torch.kernels import ops

    if fault == "unchanged":   # every superstep returns its state unchanged
        monkeypatch.setattr(ops, "live_loop",
                            lambda step, state, *a, **k: (state, 1))
        orig_fix = ops.minh_fixpoint
        monkeypatch.setattr(ops, "minh_fixpoint",
                            lambda est, h_of, active, ms: (est, 1))
        assert orig_fix is not ops.minh_fixpoint
    elif fault == "half":      # the combine over half of the rows only
        orig = ops.neighbor_combine_blocks

        def half(g, field, combine, *a, **k):
            red = orig(g, field, combine, *a, **k)
            red = red.clone()
            red[g.N // 2:] = 0
            return red
        monkeypatch.setattr(ops, "neighbor_combine_blocks", half)
    else:                      # one triangle count altered where produced
        orig = algorithms.triangle_counts

        def altered(*a, **k):
            counts, steps = orig(*a, **k)
            counts = counts.clone()
            counts[0] += 1
            return counts, steps
        monkeypatch.setattr(algorithms, "triangle_counts", altered)
    line = run(tiny_cell(name))
    assert line["correct"] is False, line["compared"]
