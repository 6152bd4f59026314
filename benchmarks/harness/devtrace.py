"""The traced run's device readings.

* ``torch.profiler`` traces the card's activity (kernels, copies, memsets;
  no host operators, which would cost more than the window to record) over
  the window. The union of those intervals is the busy time; they also
  give the device operations that took most time, the idle gaps, and the
  ``block_topk`` kernel's device time, which its roofline reads beside the
  launch shapes the program counts. A marker kernel launched at a known
  host time, on an idle card, puts the trace on the harness's clock.
* An idle gap is named by what the host was doing at its middle: the
  innermost span of the program (``op.<node>``, ``embed.batch``,
  ``knn.search``, ``knn.corpus_upload``) or of the harness (its feeder,
  Python's garbage collector) covering it.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps_of(busy: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def idle_by_host(gaps: list[tuple[int, int]], spans: list[tuple[str, int, int]]) -> dict[str, float]:
    """Seconds of the idle gaps by what the host was doing at each gap's
    middle: the innermost (shortest) span (name, start ns, end ns) covering
    it. One sweep over the gaps and spans in time order."""
    out: dict[str, float] = defaultdict(float)
    spans = sorted(spans, key=lambda s: s[1])
    active: list[tuple[str, int, int]] = []
    j = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        while j < len(spans) and spans[j][1] <= mid:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[2] >= mid]
        best = min(active, key=lambda s: s[2] - s[1], default=None)
        out[best[0] if best else "no span: the engine waits for input"] += (b - a) / 1e9
    return out


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.align_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self.align_ns = time.perf_counter_ns()
        torch.cuda._sleep(1000)  # the marker: ATen's spin_kernel
        torch.cuda.synchronize()

    def stop(self, rec) -> None:
        torch.cuda.synchronize()
        # stop the trace without the profiler's own event parsing, which
        # takes minutes for a window's worth of kernels; the trace is read
        # from the file kineto writes
        result = torch.autograd._disable_profiler()
        self._prof = None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            result.save(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        rec.trace = {"events": [e for e in events if e.get("cat") in DEVICE_CATS]}

    def readings(self, rec) -> dict:
        """busy_s, window_s, device ops by time, idle gaps by host activity
        and the block_topk kernel's device seconds."""
        events = sorted(rec.trace["events"], key=lambda e: float(e["ts"]))
        marker = next((e for e in events if "spin_kernel" in e["name"]), events[0])
        offset = self.align_ns - int(float(marker["ts"]) * 1000)
        lo, hi = int(rec.t0 * 1e9), int(rec.t1 * 1e9)
        ops: dict[str, float] = defaultdict(float)
        intervals, topk_ns = [], 0
        for e in events:
            if e is marker:
                continue
            a = int(float(e["ts"]) * 1000) + offset
            b = a + int(float(e.get("dur", 0)) * 1000)
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            intervals.append((a, b))
            ops[e["name"]] += (b - a) / 1e9
            if "block_topk" in e["name"]:
                topk_ns += b - a
        busy = merge(intervals)
        spans = [(n, s, s + d) for n, s, d, _a in rec.spans]
        spans += [(n, int(a * 1e9), int(b * 1e9)) for n, a, b in rec.host_spans]
        idle = idle_by_host(gaps_of(busy, lo, hi), spans)
        top = lambda m: [[k, v] for k, v in sorted(m.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": rec.t1 - rec.t0,
            "device_ops": top(ops),
            "idle_gaps": top(idle),
            "block_topk_s": topk_ns / 1e9,
        }
