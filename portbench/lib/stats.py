"""Statistics the harness reports."""
from __future__ import annotations

import math


def quantile(values, q: float) -> float:
    """The ``q`` quantile by the nearest rank over all ``values`` (the
    smallest value with at least a ``q`` share of the values at or below
    it): a p95 of 100 requests is the 95th smallest."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(q * len(s)) - 1)]


def rate(work: float, seconds: float) -> float:
    """All the work over all the time."""
    if seconds <= 0:
        raise ValueError(f"an empty window: {seconds} s")
    return work / seconds
