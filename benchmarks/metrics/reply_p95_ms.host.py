"""95th percentile, over every query sent in the window, of the time from
its ``next()`` to its reply's ``pw.io.subscribe`` callback, on the host's
clock. A query with no reply is missing and counts as the longest; if the
percentile falls on one, there is no value (and the run is not correct).
A per-layer metric: its spread from run to run is too wide for an
end-to-end bound (PERF.md section 2)."""

import math

from benchmarks.harness.stats import percentile


def read(ctx):
    if not ctx.requests:
        return None
    ms = [(r - s) * 1e3 if r is not None else math.inf for s, r in ctx.requests]
    p = percentile(ms, 95)
    return p if math.isfinite(p) else None
