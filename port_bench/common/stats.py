"""The arithmetic of the end-to-end metrics and of the device's busy time,
kept apart from any clock so that tests can drive it on made-up timelines."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def whole_window_rate(work: Sequence[float], spans: Sequence[Tuple[float, float]]) -> float:
    """Work per second over whole units: the sum of ``work`` divided by the
    time from the first unit's start to the last unit's end."""
    if not spans:
        raise ValueError("no completed unit in the window")
    start = min(s for s, _ in spans)
    end = max(e for _, e in spans)
    return float(sum(work)) / (end - start)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q ≤ 100) by nearest rank: the smallest
    value with at least q% of the values at or below it. ``inf`` entries
    (failed or unfinished requests) sort last, so a tail that reaches them
    reads ``inf``."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return float(ordered[rank - 1])


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out
