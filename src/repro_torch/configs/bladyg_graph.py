"""Graph-task configs — the paper's own workloads (Table 1 + §5 protocol).

Selectable via `examples/kcore_dynamic.py` / `benchmarks` the same way LM
archs are selected via --arch: one named config per dataset with the
paper's experimental protocol parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class GraphTaskConfig:
    name: str
    dataset: str            # key into repro.graphgen.snap_like DATASETS
    blocks: int = 8         # paper: 8 partitions (+1 master on EC2)
    partitioner: str = "random"   # paper §5.2.1 uses random node partitioning
    updates: int = 1000     # paper: 1000 insertions/deletions per scenario
    scenarios: Tuple[str, ...] = ("inter", "intra")
    deg_slack: int = 64     # ELL headroom for insertions
    scale_ci: float = 0.04  # CI-size fraction of the paper-scale graph


GRAPH_TASKS = {
    c.name: c
    for c in (
        GraphTaskConfig("ds1", "DS1", scale_ci=0.04),
        GraphTaskConfig("ds2", "DS2", scale_ci=0.02),
        GraphTaskConfig("ego-facebook", "ego-Facebook", scale_ci=0.40),
        GraphTaskConfig("roadnet-ca", "roadNet-CA", scale_ci=0.0012),
        GraphTaskConfig("com-livejournal", "com-LiveJournal", scale_ci=0.0005),
    )
}
