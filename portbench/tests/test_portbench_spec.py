"""BENCHMARK.json against the benchmark's contract, and the harness
finding every configuration, traffic mix and metric by name."""
import json
import re

import pytest

from portbench.harness import spec
from portbench.harness.record import RunRecord

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    every = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in every]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in every)
    assert "setup_s" in names


def test_every_config_is_used_and_its_file_holds_reduced_keys():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        with open(spec.ROOT / c["file"]) as f:
            conf = json.load(f)
        assert set(c["reduced"]) <= set(conf)
        assert set(c["reduced"]) == set(conf["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name_and_reports_what_the_contract_asks(cell):
    c = spec.load_cell(cell)
    assert spec.plugin_path("drivers", c.traffic["driver"]).is_file()
    drv = spec.load_driver(c.traffic["driver"])
    assert all(callable(getattr(drv, f)) for f in ("run", "judge", "control"))
    if "generator" in c.config:
        assert callable(spec.load_generator(c.config["generator"]).edges)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)
    for m in c.end_to_end + c.per_layer:
        assert spec.plugin_path("metrics", m["name"]).is_file(), m["name"]
        assert callable(spec.load_reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")


@pytest.mark.parametrize("kind", ["drivers", "generators", "metrics"])
def test_unknown_plugin_names_the_file_it_looked_for(kind):
    with pytest.raises(ValueError, match=f"portbench/{kind}/no-such.py"):
        spec.load_plugin(kind, "no-such")


def test_per_layer_metrics_without_workloads_follow_what_they_move():
    bench = dict(end_to_end=[{"name": "a"}, {"name": "b",
                                              "workloads": ["y"]}],
                 per_layer=[{"name": "x1", "moves": "a"},
                            {"name": "x2", "moves": "b"},
                            {"name": "x3", "moves": "b", "workloads": ["z"]}])
    e2e, layer = spec.cell_metrics(bench, "y")
    assert [m["name"] for m in e2e] == ["a", "b"]
    assert [m["name"] for m in layer] == ["x1", "x2"]
    e2e, layer = spec.cell_metrics(bench, "z")
    assert [m["name"] for m in e2e] == ["a"]
    assert [m["name"] for m in layer] == ["x1", "x3"]


def test_read_metrics_leaves_out_what_a_reader_cannot_read():
    run = RunRecord(cell="c", device_kind="cpu", setup_s=3.5, window_s=2.0,
                    units=40, unit_ms=[50.0] * 40,
                    counters=dict(updates=40), sizes={})
    got = spec.read_metrics(
        [{"name": "setup_s", "unit": "s"},
         {"name": "updates_per_s", "unit": "updates/s"},
         {"name": "kernel_ms_per_update", "unit": "ms"},
         {"name": "validate_span_ms_per_window", "unit": "ms"}], run)
    assert got == {"setup_s": {"value": 3.5, "unit": "s"},
                   "updates_per_s": {"value": 20.0, "unit": "updates/s"}}
