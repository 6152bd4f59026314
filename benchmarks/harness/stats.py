"""Percentiles over all samples."""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (q in 0..100) of all values; a missing
    sample is math.inf and counts as the largest."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]

