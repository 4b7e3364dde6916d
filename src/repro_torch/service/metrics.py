"""Serving observability: latency percentiles, throughput, staleness, sheds.

Pure host-side accounting — nothing here touches the device.  The server
records one `observe_batch` per answered query batch (per-query latencies
measured submit -> answer, the batch's busy time, and the snapshot
staleness its answers were served at) and one `observe_shed` per request
rejected by admission control.  `summary()` flattens everything into a
JSON-able dict with the JAX package's keys and nesting.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np


class ServiceMetrics:
    """Per-query-kind counters + latency reservoirs for one server.

    Latencies are kept raw (seconds, one float per answered query) so
    percentiles are exact, not sketched — serving runs here are thousands
    of queries, where a reservoir of everything is cheaper than being
    wrong about p99.
    """

    def __init__(self) -> None:
        self.answered: Dict[str, int] = {}   # kind -> queries answered
        self.shed: Dict[str, int] = {}       # kind -> queries rejected
        self.batches = 0                     # answered batches
        self.busy_s = 0.0                    # time spent answering batches
        self._lat: Dict[str, List[float]] = {}
        self._staleness: List[int] = []      # windows behind head, per batch

    # -- recording ---------------------------------------------------------

    def observe_batch(self, kind: str, latencies_s: Iterable[float],
                      staleness: int, busy_s: float) -> None:
        lats = list(latencies_s)
        self.answered[kind] = self.answered.get(kind, 0) + len(lats)
        self._lat.setdefault(kind, []).extend(lats)
        self._staleness.append(int(staleness))
        self.busy_s += float(busy_s)
        self.batches += 1

    def observe_shed(self, kind: str) -> None:
        self.shed[kind] = self.shed.get(kind, 0) + 1

    # -- reading -----------------------------------------------------------

    @property
    def total_answered(self) -> int:
        return sum(self.answered.values())

    @property
    def total_shed(self) -> int:
        return sum(self.shed.values())

    def qps(self) -> float:
        """Answered queries per second of batch-answering busy time."""
        return self.total_answered / self.busy_s if self.busy_s > 0 else 0.0

    def latency_percentile(self, p: float,
                           kind: Optional[str] = None) -> float:
        """p-th percentile answer latency in seconds (NaN if unobserved).

        `kind=None` pools every kind — the whole-service view.
        """
        if kind is None:
            lats = [x for xs in self._lat.values() for x in xs]
        else:
            lats = self._lat.get(kind, [])
        return float(np.percentile(lats, p)) if lats else float("nan")

    def staleness_max(self) -> int:
        return max(self._staleness) if self._staleness else 0

    def staleness_mean(self) -> float:
        return float(np.mean(self._staleness)) if self._staleness else 0.0

    def summary(self) -> dict:
        """JSON-able rollup: totals, qps, staleness, per-kind p50/p99."""
        kinds = sorted(set(self.answered) | set(self.shed))
        return {
            "answered": self.total_answered,
            "shed": self.total_shed,
            "batches": self.batches,
            "qps": self.qps(),
            "staleness_max": self.staleness_max(),
            "staleness_mean": self.staleness_mean(),
            "p50_ms": self.latency_percentile(50) * 1e3,
            "p99_ms": self.latency_percentile(99) * 1e3,
            "per_kind": {
                k: {
                    "answered": self.answered.get(k, 0),
                    "shed": self.shed.get(k, 0),
                    "p50_ms": self.latency_percentile(50, k) * 1e3,
                    "p99_ms": self.latency_percentile(99, k) * 1e3,
                }
                for k in kinds
            },
        }
