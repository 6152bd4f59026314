"""90th percentile, over every commit made in the window, of the time from
its ``commit()`` to the first reply ranking one of its passages first (its
probe's). A commit never seen is missing and counts as the longest."""

import math

from benchmarks.harness.stats import percentile


def read(ctx):
    if not ctx.probes:
        return None
    ms = [(v - c) * 1e3 if v is not None else math.inf for c, v in ctx.probes]
    p = percentile(ms, 90)
    return p if math.isfinite(p) else None
