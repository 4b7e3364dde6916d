"""Find a cell's configuration, traffic mix, generator, driver and metric
readers by name.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found from the names in `BENCHMARK.json` under the
checkout's root:

- a configuration: the `file` its entry names (a JSON object of sizes;
  its ``"generator"`` names the graph's generator, its ``"tiny"`` the
  sizes a CPU test runs it at);
- a graph generator: ``portbench/generators/<generator>.py``, a module
  with ``edges(config, gen) -> keys``;
- a traffic mix: ``portbench/traffic/<traffic>.json``; its ``"driver"``
  names ``portbench/drivers/<driver>.py``, a module with ``run``,
  ``judge`` and ``control``;
- a metric (end-to-end or per-layer): ``portbench/metrics/<name>.py``,
  a module with ``read(run) -> float | None``.

A later configuration, generator, traffic mix, driver or metric is added
by adding files and entries, not by editing these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

#: the benchmark's own folder and the checkout's root
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One entry of `workloads`, with what it names loaded."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]   # the end-to-end metrics this cell reports
    per_layer: List[dict]    # the per-layer metrics this cell reports
    root: Path               # the checkout whose files it was loaded from


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reported(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell_metrics(bench: dict, cell: str):
    """(end_to_end, per_layer) metric entries that `cell` reports.

    An end-to-end metric without a `workloads` key is reported in every
    cell; a per-layer one without it in every cell that reports the
    end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if _reported(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `BENCHMARK.json` under `root`; KeyError if the
    benchmark has no such cell."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    e2e, layer = cell_metrics(bench, name)
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"],
                traffic=load_traffic(w["traffic"], root),
                end_to_end=e2e, per_layer=layer, root=root)


def load_traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "portbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def plugin_path(kind: str, name: str, root: Path = ROOT) -> Path:
    """``portbench/<kind>/<name>.py`` under `root`."""
    return root / "portbench" / kind / f"{name}.py"


def load_plugin(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``portbench/<kind>/<name>.py`` under `root`, loaded by
    path (names may hold dots); ValueError naming the file if there is
    none."""
    path = plugin_path(kind, name, root)
    if not path.is_file():
        raise ValueError(f"no {kind} {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, root: Path = ROOT
                ) -> Callable[[object], Optional[float]]:
    """The `read` function of ``portbench/metrics/<name>.py``."""
    return load_plugin("metrics", name, root).read


def load_generator(name: str, root: Path = ROOT) -> ModuleType:
    """``portbench/generators/<name>.py``: ``edges(config, gen)`` gives
    the configuration's graph as sorted undirected keys ``lo * n + hi``
    over original ids, drawn with `gen`."""
    return load_plugin("generators", name, root)


def load_driver(name: str, root: Path = ROOT) -> ModuleType:
    """``portbench/drivers/<name>.py``: ``run(cell, seed, seconds, tracer,
    device, started) -> Outcome``, ``judge(outputs, inputs, traffic,
    device) -> {number: value}`` and ``control(inputs, traffic, device)
    -> outputs``."""
    return load_plugin("drivers", name, root)


def read_metrics(entries: List[dict], run, root: Path = ROOT
                 ) -> Dict[str, dict]:
    """{name: {"value", "unit"}} for every entry whose reader finds
    something to read; a reader that returns None is left out."""
    out = {}
    for m in entries:
        value = load_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
