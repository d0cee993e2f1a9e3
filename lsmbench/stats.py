"""The arithmetic of the end-to-end metrics: rates over a window, a
percentile over all requests, and the spread of a metric over runs."""
from __future__ import annotations

import statistics
from typing import Sequence


def rate(units: float, window_s: float) -> float:
    """Units completed over the whole window, per second."""
    if window_s <= 0:
        raise ValueError("an empty window has no rate")
    return units / window_s


def percentile(values: Sequence[float], pct: int) -> float:
    """The ``pct``-th percentile of every value, interpolated between the
    two nearest ranks (Python's ``statistics.quantiles``, inclusive)."""
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median
    (``statistics.quantiles(values, n=4)``): the spread a bound is set
    from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
