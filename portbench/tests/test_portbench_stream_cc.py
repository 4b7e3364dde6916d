"""The stream_cc driver at small n on the CPU: the tiny `rgg23.stream-cc`
cell runs correct with its labels judged, the judged windows after the
timed ones split a component and join two, faults planted in the labels
the session keeps come out not correct on the cell's own traffic, the
control fails, and the three readers of CC upkeep give hand-computed
values and read nothing from a program without the `bladyg.cc` span and
the `cc_steps` count."""
import time

import pytest
import torch

from _tiny import tiny_cell
from portbench import reference
from portbench.harness import compare, runner, spec, trace
from portbench.harness.record import RunRecord, ell_superstep_bytes

SEED = 2**31 + 303
CELL = "rgg23.stream-cc"
drv = spec.load_driver("stream_cc")
READERS = ("cc_ms_per_window", "cc_steps_per_window", "cc_roofline")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cell_is_the_local_stream_with_labels():
    cc, local = spec.load_cell(CELL), spec.load_cell("rgg23.local_stream")
    assert cc.chips == 1 and cc.config_name != local.config_name
    # the same graph, layout and sizes; its own source and guarantee
    own = ("source", "guarantees")
    assert ({k: v for k, v in cc.config.items() if k not in own}
            == {k: v for k, v in local.config.items() if k not in own})
    assert "component label exact" in cc.config["guarantees"]
    entries = {c["name"]: c for c in spec.load_benchmark()["configs"]}
    mine, graph = entries[cc.config_name], entries[local.config_name]
    assert mine["source"] != graph["source"] and mine["reduced"] == []
    assert cc.traffic["driver"] == "stream_cc"
    assert cc.traffic["limits"] == dict(local.traffic["limits"],
                                        label_diff=0)
    same = {k: v for k, v in cc.traffic.items()
            if k not in ("driver", "why", "limits")}
    assert same == {k: v for k, v in local.traffic.items()
                    if k not in ("driver", "why", "limits")}


def test_least_id_stays_with_the_generators_first_point():
    """The layout is local_stream's with the rows of id 0 and of original
    id 0 swapped: the same edges, blocks and permutation otherwise."""
    n = 1 << 11
    keys = spec.load_generator("rgg").edges(
        dict(generator="rgg", scale=11, vertices=n, radius_factor=0.55,
             blocks=8), torch.Generator().manual_seed(4))
    for seed in (9, 2**31 + 9):
        lay = drv._local.lay_out_by_id(keys, n, 8, 48,
                                       torch.Generator().manual_seed(seed))
        kept = drv.least_id_kept(lay)
        assert int(kept.orig_id[0]) == 0
        j = int(torch.nonzero(lay.orig_id == 0)[0, 0])
        assert j < lay.Cn and int(kept.orig_id[j]) == int(lay.orig_id[0])
        others = torch.ones(n, dtype=torch.bool)
        others[[0, j]] = False
        assert torch.equal(kept.orig_id[others], lay.orig_id[others])
        for got in (lay, kept):
            a, b = got.orig_id[got.keys // n], got.orig_id[got.keys % n]
            back = torch.minimum(a, b) * n + torch.maximum(a, b)
            assert torch.equal(torch.sort(back).values, keys)
            assert torch.equal(got.keys, torch.sort(got.keys).values)


def test_tiny_cell_runs_correct_and_counts_its_recomputes():
    cell = tiny_cell(CELL)
    out = drv.run(cell, SEED, 0.3, trace.Tracer(False), "cpu",
                  time.perf_counter())
    c = out.record.counters
    assert c["cc_recomputes"] + c["cc_merges"] > 0 and c["cc_steps"] > 0
    assert c["cc_recomputes"] <= c["windows"]
    assert out.record.sizes["sum_deg"] == 2 * out.record.sizes["m"]
    assert "labels" in out.record.setup_marks
    numbers = drv.judge(out.outputs, out.inputs, cell.traffic, "cpu")
    assert numbers == dict(edge_diff=0, degree_diff=0, core_diff=0,
                           label_diff=0)
    ctl = drv.judge(drv.control(out.inputs, cell.traffic, "cpu"),
                    out.inputs, cell.traffic, "cpu")
    ok, table = compare.verdict(ctl, cell.traffic["limits"])
    assert not ok and set(table) == set(numbers), table


def _stale(orig):
    def apply(sess, window):   # labels kept from before a delete window
        labels = sess.labels
        orig(sess, window)
        if any(op < 0 for _, _, op in window):
            sess.labels = labels
    return apply


def _frozen(orig):
    def apply(sess, window):   # labels never touched after open
        labels = sess.labels
        orig(sess, window)
        sess.labels = labels
    return apply


def _altered(orig):
    def apply(sess, window):   # one node's label altered where produced
        orig(sess, window)
        sess.labels = sess.labels.clone()
        sess.labels[int(torch.nonzero(sess.g.node_mask)[0])] += 1
    return apply


@pytest.mark.parametrize("fault", ["none", "stale", "frozen", "altered"])
def test_faults_in_the_labels_come_out_not_correct(fault, monkeypatch):
    """On the cell's own traffic: labels kept from before each delete
    window, labels never touched after open, and one label altered."""
    from repro_torch.runtime.stream import StreamSession

    orig = StreamSession.apply_window
    if fault != "none":
        patch = dict(stale=_stale, frozen=_frozen,
                     altered=_altered)[fault](orig)
        monkeypatch.setattr(StreamSession, "apply_window", patch)
    line, compared = runner.run_cell(tiny_cell(CELL), SEED, 0.3, False,
                                     "cpu", time.perf_counter())
    assert line["correct"] is (fault == "none"), compared
    assert compared["edge_diff"]["value"] == 0
    assert (compared["label_diff"]["value"] > 0) is (fault != "none")


def test_probe_windows_split_a_component_then_join_two():
    """The judged windows after the timed ones: every edge of an
    untouched node of least degree deleted (its labels change), then an
    insert from it to a node more than two hops away (a merge)."""
    cell = tiny_cell(CELL)
    out = drv.run(cell, SEED, 0.3, trace.Tracer(False), "cpu",
                  time.perf_counter())
    inputs, R = out.inputs, int(cell.traffic["window"])
    bounds = inputs["probe_bounds"]
    timed, probe = (inputs["pool"][:bounds[0]],
                    inputs["pool"][bounds[0]:].tolist())
    x = probe[0][0]
    assert bounds[-1] == inputs["applied"] == inputs["pool"].shape[0]
    assert not bool((timed[:, :2] == x).any())
    deletes, (insert,) = probe[:-1], probe[-1:]
    assert deletes and all(u == x and op == -1 for u, _, op in deletes)
    assert len(bounds) == 2 + (len(deletes) + R - 1) // R
    N = inputs["N"]
    keys = reference.replay(inputs["keys"], timed, N)
    a, b = keys // N, keys % N
    before = set(b[a == x].tolist()) | set(a[b == x].tolist())
    assert {v for _, v, _ in deletes} == before
    y = insert[1]
    assert insert[0] == x and insert[2] == 1 and y not in before
    assert not (set(b[a == y].tolist()) | set(a[b == y].tolist())) & before
    # labels after the delete windows and after the insert all differ
    labels = out.outputs["labels_at"] + [out.outputs["labels"]]
    assert len(labels) == len(bounds) - 1
    ref = drv.reference_outputs(inputs, "cpu")
    assert not torch.equal(ref["labels_at"][-1], ref["labels"])
    assert not torch.equal(drv._labels(inputs, bounds[0], "cpu"),
                           ref["labels_at"][0])


def test_program_without_the_count_or_span_still_runs(monkeypatch):
    """On a program whose session has no `cc_steps` and no `bladyg.cc`
    span (the parent of the change that added them) the run records no
    such counter, is correct, and the readers read nothing."""
    from repro_torch import tracing
    from repro_torch.runtime import stream as stream_mod

    monkeypatch.delattr(stream_mod.StreamSession, "cc_steps")
    monkeypatch.setattr(stream_mod, "CC", tracing.WINDOW + ".parent")
    cell = tiny_cell(CELL)
    out = drv.run(cell, SEED, 0.3, trace.Tracer(True), "cpu",
                  time.perf_counter())
    assert "cc_steps" not in out.record.counters
    assert out.record.counters["cc_recomputes"] > 0
    for name in READERS:
        assert spec.load_reader(name)(out.record) is None, name
    line, _ = runner.result_line(
        cell, out, drv.judge(out.outputs, out.inputs, cell.traffic, "cpu"),
        True, "cpu")
    assert line["correct"] is True
    assert not set(READERS) & set(line["metrics"])


WINDOW = (100, 1100)
H100 = "NVIDIA H100 80GB HBM3"
HOST = [(0, 90, "bladyg.cc"),                     # warm-up: not counted
        (105, 495, "bladyg.window"), (300, 480, "bladyg.cc"),
        (600, 1000, "bladyg.window"), (700, 760, "bladyg.cc")]
DEVICE = [(310, 410, "ell_cc", "kernel"), (420, 470, "where", "kernel"),
          (500, 590, "ell_hindex", "kernel"), (710, 750, "ell_cc", "kernel")]


def _run(host, device_kind=H100, **counters):
    t = trace.Trace(window=WINDOW, device=list(DEVICE),
                    host=[(s, e, n, False) for s, e, n in host])
    return RunRecord(cell="c", device_kind=device_kind, setup_s=1.0,
                     window_s=1e-6, units=16, unit_ms=[],
                     counters=dict(dict(updates=16, windows=2), **counters),
                     sizes=dict(N=4096, sum_deg=31980), trace=t)


def test_readers_give_the_hand_computed_values():
    read = {name: spec.load_reader(name) for name in READERS}
    run = _run(HOST, cc_steps=142)
    assert read["cc_ms_per_window"](run) == pytest.approx(
        1e-6 * (180 + 60) / 2)
    assert read["cc_steps_per_window"](run) == pytest.approx(71.0)
    kernel_s = (100 + 50 + 40) * 1e-9
    assert read["cc_roofline"](run) == pytest.approx(
        100 * 142 * ell_superstep_bytes(31980, 4096) / 3.35e12 / kernel_s)


def test_readers_read_nothing_from_a_program_without_them():
    read = {name: spec.load_reader(name) for name in READERS}
    bare = _run([h for h in HOST if h[2] != "bladyg.cc"])
    assert all(r(bare) is None for r in read.values())
    # no count: no steps and no roofline, whatever the trace holds
    spans_only = _run(HOST)
    assert read["cc_steps_per_window"](spans_only) is None
    assert read["cc_roofline"](spans_only) is None
    # no card in peaks.json, or no trace: no roofline
    assert read["cc_roofline"](_run(HOST, device_kind="cpu",
                                    cc_steps=142)) is None
    untraced = _run(HOST, cc_steps=142)
    untraced.trace = None
    assert read["cc_ms_per_window"](untraced) is None
    assert read["cc_roofline"](untraced) is None
    assert read["cc_steps_per_window"](untraced) == pytest.approx(71.0)
