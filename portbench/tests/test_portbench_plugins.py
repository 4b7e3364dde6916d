"""A cell that brings its own generator, driver, configuration and traffic
mix comes in by new files alone.

The test copies `portbench/` and `BENCHMARK.json` into a temporary root,
adds a toy generator (a ring with random chords), a toy driver (a fixed
number of analytics passes, reusing the analytics driver's pass, judge
and control), their configuration and traffic files and the two entries,
and drives a whole tiny run of that cell on the CPU with every lookup
pointed at the copy.  No file that was there before is edited.
"""
import filecmp
import json
import shutil
import time
from pathlib import Path

import pytest

from portbench.harness import runner, spec

BENCH = Path(__file__).resolve().parents[1]

GENERATOR = '''"""ring: a ring over `vertices` nodes with `chords` random chords."""
import torch


def edges(config, gen):
    n, k = int(config["vertices"]), int(config["chords"])
    ring = torch.arange(n, device=gen.device)
    u = torch.cat([ring, torch.randint(0, n, (k,), generator=gen,
                                       device=gen.device)])
    v = torch.cat([(ring + 1) % n, torch.randint(0, n, (k,), generator=gen,
                                                 device=gen.device)])
    keep = u != v
    lo, hi = torch.minimum(u, v)[keep], torch.maximum(u, v)[keep]
    return torch.unique(lo * n + hi)
'''

DRIVER = '''"""passes: a fixed number of analytics passes on a graph whose rows are
as wide as its largest degree, not the configuration's capacity."""
import time
from pathlib import Path

import torch

from portbench.harness import graphs, outcome, spec
from portbench.harness.outcome import Outcome
from portbench.harness.record import RunRecord

analytics = spec.load_driver("analytics", Path(__file__).resolve().parents[2])
judge, control = analytics.judge, analytics.control


def run(cell, seed, seconds, tracer, device, started):
    from repro_torch.core.graph import GraphBlocks

    gen = torch.Generator(device=device).manual_seed(seed)
    lay = graphs.make_layout(cell.config, gen, cell.root)
    ends = torch.cat([lay.keys // lay.N, lay.keys % lay.N])
    width = int(torch.bincount(ends, minlength=lay.N).max())
    nbr, deg = graphs.ell_rows(lay.keys, lay.N, width)
    g = GraphBlocks(nbr=nbr, deg=deg, node_mask=lay.node_mask.clone(),
                    orig_id=lay.orig_id.to(torch.int32), P=lay.P,
                    Cn=lay.Cn, Cd=width)
    t0 = time.perf_counter()
    passes = [analytics._pass(g, cell.traffic, tracer)[0]
              for _ in range(int(cell.traffic["passes"]))]
    outcome.sync(device)
    window_s = time.perf_counter() - t0
    record = RunRecord(cell=cell.name, device_kind=outcome.device_kind(device),
                       setup_s=t0 - started, window_s=window_s,
                       units=len(passes),
                       unit_ms=[1e3 * window_s / len(passes)] * len(passes),
                       counters=dict(passes=len(passes)),
                       sizes=dict(n=lay.n, N=lay.N, Cd=width))
    return Outcome(record=record, attempted=len(passes),
                   memory_peak_bytes=outcome.peak_bytes(device),
                   outputs=dict(passes=passes),
                   inputs=dict(keys=lay.keys.cpu(), N=lay.N,
                               node_mask=lay.node_mask.cpu()))
'''

CONFIG = dict(generator="ring", vertices=300, chords=200, graph_seed=5,
              blocks=4, degree_capacity=16,
              tiny=dict(vertices=300, chords=200))

TRAFFIC = dict(driver="passes", passes=2,
               pagerank=dict(alpha=0.85, tol=None, max_steps=10),
               limits=dict(core_diff=0, label_diff=0, triangle_diff=0,
                           pagerank_rel_err=1e-4))


def _write(path: Path, text: str) -> None:
    assert not path.exists(), f"{path} is not a new file"
    path.write_text(text)


@pytest.fixture
def root(tmp_path):
    """A checkout's copy of the benchmark with the toy cell added as new
    files and two new entries."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    _write(pb / "generators" / "ring.py", GENERATOR)
    _write(pb / "drivers" / "passes.py", DRIVER)
    _write(pb / "configs" / "ring.json", json.dumps(CONFIG))
    _write(pb / "traffic" / "passes.json", json.dumps(TRAFFIC))
    bench = spec.load_benchmark()
    bench["configs"].append(dict(
        name="ring", source="a ring with random chords, made in the test",
        file="portbench/configs/ring.json", reduced=[],
        why="a graph no generator of the benchmark makes"))
    bench["workloads"].append(dict(
        name="ring.passes", config="ring", traffic="passes", chips=1,
        why="two analytics passes through a driver of its own"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def _edited(c: filecmp.dircmp):
    """Files of the benchmark that the copy changed or lacks."""
    return list(c.diff_files) + list(c.left_only) + [
        f for sub in c.subdirs.values() for f in _edited(sub)]


def test_a_cell_added_by_files_runs_and_is_correct(root):
    with pytest.raises(KeyError):
        spec.load_cell("ring.passes")   # not in the benchmark itself
    cell = spec.load_cell("ring.passes", root)
    drv = runner.driver_of(cell)
    assert Path(drv.__file__) == root / "portbench" / "drivers" / "passes.py"
    line, compared = runner.run_cell(cell, 2**31 + 101, 0.1, False, "cpu",
                                     time.perf_counter())
    assert line["correct"] is True, compared
    assert line["attempted"] == 2 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s"}
    assert set(compared) == set(TRAFFIC["limits"])
    # the graph is the toy generator's: every node of the ring has two
    # neighbours at least
    out = drv.run(cell, 7, 0.1, runner.Tracer(False), "cpu",
                  time.perf_counter())
    assert out.record.sizes["n"] == 300
    assert 2 < out.record.sizes["Cd"] < CONFIG["degree_capacity"]
    # nothing that was there before was edited, and the entries were only
    # appended
    assert _edited(filecmp.dircmp(BENCH, root / "portbench",
                                  ignore=["__pycache__"])) == []
    bench, mine = spec.load_benchmark(), spec.load_benchmark(root)
    for key, value in bench.items():
        got = mine[key][:len(value)] if isinstance(value, list) else mine[key]
        assert got == value, key
