"""Graph query service: serve reads from device-resident analytics while
the stream writes.

BLADYG's premise is a graph that is *queried while it changes*; this
package is the querying half.  It layers on the streaming runtime
without forking it — one `StreamSession` (runtime/stream.py) applies
update windows, and between windows the server answers typed query
batches against versioned epoch snapshots of the maintained analytics:

  state.py    — `AnalyticsState` / `EpochSnapshot`: consistent,
                immutable (coreness, CC labels, PageRank, topology)
                records cut by a warm-started `fused_analytics` pass and
                published by reference swap (double buffering).
  queries.py  — the typed query set (`core_of`, `degree_of`,
                `nbr_max_core_of`, `same_component`, `topk_pagerank`):
                batched gathers, pow2-padded; ONE device->host copy per
                answered batch.
  server.py   — `QueryServer`: bounded-queue admission with a reject-new
                shed policy, bucket-by-kind batching, and the scheduling
                loop interleaving query batches between stream windows.
  metrics.py  — `ServiceMetrics`: per-kind latency percentiles,
                queries/sec, snapshot staleness, shed counts.

The JAX package also exports `query_trace_count`, a count of jit traces;
eager PyTorch traces nothing, so the port has no counterpart.
"""
from ..configs import ServiceConfig
from .metrics import ServiceMetrics
from .queries import (
    KINDS,
    Query,
    core_of,
    degree_of,
    nbr_max_core_of,
    same_component,
    topk_pagerank,
)
from .server import QueryServer, Request
from .state import AnalyticsState, EpochSnapshot

__all__ = [
    "ServiceConfig", "ServiceMetrics",
    "KINDS", "Query", "core_of", "degree_of", "nbr_max_core_of",
    "same_component", "topk_pagerank",
    "QueryServer", "Request",
    "AnalyticsState", "EpochSnapshot",
]
