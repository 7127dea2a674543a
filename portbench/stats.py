"""The statistics the end-to-end metrics take over a window."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of ALL values: the smallest
    value with at least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)), 1) - 1]


__all__ = ["percentile"]
