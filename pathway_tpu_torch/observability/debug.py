"""On-demand debugging surfaces: thread dumps, graph tables, profiling —
counterpart of ``pathway_tpu/observability/debug.py``.

``thread_stack_dump`` answers "where is every thread" for a live process in
one request (GET /debug/threads). ``graph_table`` is the JSON operator table
of /debug/graph, with the compiled-tick segment of each node.
``take_profile`` captures a ``torch.profiler`` trace (CPU and CUDA
activity) for a few seconds and writes it as a Chrome trace into a
directory: it stands where the reference captures a ``jax.profiler`` trace,
with the same contract (a bad duration is a ``ValueError`` → 400, a second
concurrent capture a ``RuntimeError`` → 409, no profiler for the asked
device ``ProfilerUnavailable`` → 501). It profiles the card unless the
caller asks for ``device="cpu"``, and never hands back a CPU-only trace in
place of a device trace: without a card, ``device="cuda"`` raises.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

from pathway_tpu_torch.observability.journal import thread_stack_dump

# the Chrome trace inside take_profile's directory, and the capture's facts
TRACE_FILE = "trace.json"
SUMMARY_FILE = "profile.json"


def graph_table(runtime: Any) -> list[dict]:
    """Per-node rows/ns/backlog rows for /debug/graph — the JSON twin of
    the TUI operator table (internals/monitoring.py)."""
    if runtime is None:
        return []
    from pathway_tpu_torch.engine.nodes import InputNode
    from pathway_tpu_torch.engine.runtime import StreamingSource

    stats = runtime.stats
    plan = getattr(runtime, "compiled_plan", None)
    seg_of: dict[int, object] = {}
    if plan is not None:
        for seg in plan.segments:
            for n in seg.nodes:
                seg_of[n.id] = seg
    rows = []
    for node in runtime.order:
        backlog = 0
        if isinstance(node, InputNode) and isinstance(
            getattr(node, "source", None), StreamingSource
        ):
            session = node.source.session
            with session._lock:
                backlog = len(session._rows) + len(session._upserts)
        row = {
            "id": node.id,
            "name": f"{node.name}_{node.id}",
            "type": type(node).__name__,
            "rows": stats.node_rows.get(node.id, 0),
            "ns": stats.node_ns.get(node.id, 0),
            "rows_in": stats.rows_in.get(node.id, 0),
            "rows_out": stats.rows_out.get(node.id, 0),
            "backlog": backlog,
        }
        # compiled ticks: which segment (if any) this node rides, and how
        # often the segment ran compiled vs fell back to the interpreter
        # (the tail carries the counters; member rows/ns are attributed to
        # the tail). The port's segments never turn "broken": a device
        # error fails the tick instead.
        seg = seg_of.get(node.id)
        row["compiled"] = seg is not None
        if seg is not None:
            row["segment"] = seg.seg_id
            if node.id == seg.tail.id:
                row["segment_tail"] = True
                row["compiled_ticks"] = seg.compiled_ticks
                row["fallback_ticks"] = seg.fallback_ticks
        rows.append(row)
    return rows


class ProfilerUnavailable(RuntimeError):
    """torch.profiler cannot trace the asked device in this process."""


def _activities(device: str) -> list:
    """The profiler activities for ``device``: CPU, plus CUDA for a card.
    Raises ProfilerUnavailable when the asked device cannot be traced —
    never narrows a device request down to CPU activity."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, supported_activities
    except Exception as exc:  # pragma: no cover - torch is a requirement
        raise ProfilerUnavailable(f"torch.profiler is unavailable: {exc}") from exc
    if device == "cpu":
        return [ProfilerActivity.CPU]
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise ProfilerUnavailable(
            "no CUDA device in this process: torch.profiler cannot trace the "
            "card (pass device='cpu' for a host-only trace)"
        )
    if ProfilerActivity.CUDA not in supported_activities():
        raise ProfilerUnavailable(
            "this torch build's profiler has no CUDA activity (CUPTI)"
        )
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _device_events(trace_path: str) -> int:
    """Events the card ran in the trace: kernels, copies and memsets."""
    with open(trace_path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return sum(
        1
        for ev in doc.get("traceEvents", [])
        if isinstance(ev, dict)
        and str(ev.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset")
    )


_profile_lock = threading.Lock()
# set while a capture's trace is on, from prof.start() to prof.stop(): work
# meant to land in the trace starts once this is set, not at the lock
_profile_tracing = threading.Event()


def take_profile(
    seconds: float, logdir: str | None = None, device: str = "cuda"
) -> str:
    """Capture a torch.profiler trace for `seconds`; returns the trace
    directory, which holds the Chrome trace (``trace.json``, loadable in
    Perfetto) and the capture's facts (``profile.json``: device,
    activities, seconds, device events). Raises ValueError on a bad
    duration, ProfilerUnavailable when the asked device cannot be traced
    and RuntimeError while another capture runs. Serialized — concurrent
    requests would fight over the one process-wide profiler session."""
    seconds = float(seconds)
    if not 0.0 < seconds <= 120.0:
        raise ValueError("seconds must be in (0, 120]")
    activities = _activities(device)
    if logdir is None:
        import tempfile

        logdir = tempfile.mkdtemp(prefix="pathway_profile_")
    if not _profile_lock.acquire(blocking=False):
        raise RuntimeError("a profile capture is already in progress")
    try:
        import torch.profiler

        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _profile_tracing.set()
        try:
            time.sleep(seconds)
        finally:
            _profile_tracing.clear()
            prof.stop()
        trace_path = os.path.join(logdir, TRACE_FILE)
        prof.export_chrome_trace(trace_path)
    finally:
        _profile_lock.release()
    summary = {
        "device": device,
        "activities": [a.name for a in activities],
        "seconds": seconds,
        "device_events": _device_events(trace_path),
    }
    with open(os.path.join(logdir, SUMMARY_FILE), "w", encoding="utf-8") as fh:
        json.dump(summary, fh)
    return logdir


__all__ = [
    "ProfilerUnavailable",
    "graph_table",
    "take_profile",
    "thread_stack_dump",
]
