"""Serving-loop knobs for the graph query service (`repro_torch.service`).

One frozen dataclass, consumed by `service.server.QueryServer` and the
serving phase of `chip_smoke.py` — every knob that shapes the interleave
of query batches with stream windows lives here, so a deployment is one
hashable value instead of a kwargs spray.  Fields, defaults, order and
validation are the JAX package's.

The batching-relevant fields are pow2-bucketed downstream (batch sizes
in `service.queries`, top-k widths via `kernels.ops._pow2_bucket`).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ServiceConfig:
    """Admission, batching, and refresh policy for one `QueryServer`.

    max_queue      — admission bound: total requests allowed in the
                     server's buckets at once; `submit` beyond it SHEDS
                     (rejects, counted per kind in the metrics) rather
                     than growing latency unboundedly — the classic
                     bounded-queue load-shedding policy.
    max_batch      — per-bucket batch ceiling; a drained bucket is
                     answered in slices of at most this many queries,
                     each padded to the pow2 bucket above its fill.
    refresh_every  — snapshot refresh cadence in stream windows: the
                     epoch snapshot is rebuilt after every
                     `refresh_every`-th window, so queries observe at
                     most that many windows of staleness (tracked as
                     `ServiceMetrics` staleness).
    pr_steps       — fixed PageRank iteration count per refresh (the
                     `fused_analytics(steps=)` budget; also the parity
                     oracle's `max_steps`).
    alpha          — PageRank damping factor.
    """

    max_queue: int = 1024
    max_batch: int = 64
    refresh_every: int = 1
    pr_steps: int = 30
    alpha: float = 0.85

    def __post_init__(self) -> None:
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.refresh_every < 1:
            raise ValueError(
                f"refresh_every must be >= 1, got {self.refresh_every}")
        if self.pr_steps < 1:
            raise ValueError(f"pr_steps must be >= 1, got {self.pr_steps}")
