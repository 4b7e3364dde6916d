"""What a run measured, as the metric readers see it, and the arithmetic
shared by the readers."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from .trace import Trace

#: least samples for a 95th percentile: ten beyond it
P95_MIN_SAMPLES = 200


@dataclasses.dataclass
class RunRecord:
    """One run of one cell.

    `units` counts what the window completed (updates of a stream, passes
    of analytics), `unit_ms` the wall time of each window of updates or
    each pass, `counters` the program's own counts over the window,
    `sizes` the graph's sizes, `trace` the device trace
    (traced runs), `setup_marks` the seconds from the process's start at
    which each stage of set-up ended."""

    cell: str
    device_kind: str
    setup_s: float
    window_s: float
    units: int
    unit_ms: List[float]
    counters: Dict[str, float]
    sizes: Dict[str, int]
    trace: Optional[Trace] = None
    setup_marks: Dict[str, float] = dataclasses.field(default_factory=dict)


def percentile_nearest_rank(values: Sequence[float], q: float) -> float:
    """The smallest value with at least a share `q` of the values at or
    below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def p95(values: Sequence[float]) -> Optional[float]:
    """The 95th percentile, or None below `P95_MIN_SAMPLES` samples."""
    if len(values) < P95_MIN_SAMPLES:
        return None
    return percentile_nearest_rank(values, 0.95)


def ell_superstep_bytes(sum_deg: int, N: int) -> int:
    """Least bytes of one superstep of a neighbour combine over sorted
    ELL rows: the valid slots of `nbr` (4 B each), `deg` and the field
    once (4 B a row each), one 4 B value written a row."""
    return 4 * sum_deg + 3 * 4 * N


def ell_triangle_bytes(sum_deg: int, N: int) -> int:
    """Least bytes of the triangle pass: the valid slots and `deg` read,
    one 4 B count written a row."""
    return 4 * sum_deg + 2 * 4 * N
