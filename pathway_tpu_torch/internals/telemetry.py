"""Telemetry — spans around graph build and execution + OTLP metrics; the
port's own copy of ``pathway_tpu/internals/telemetry.py``.

Counterpart of the reference's tracing stack
(reference: src/engine/telemetry.rs — OTLP traces/metrics;
internals/graph_runner/telemetry.py — python build spans share one trace
with engine spans via trace_parent). The span path is the Trace Weaver
(observability/tracing.py): every ``Telemetry.span`` records
into the built-in ring buffer with no external SDK, and dual-emits
through OpenTelemetry when the host application configures a real SDK
TracerProvider. Metrics still go OTLP-only (the Flight Recorder registry
is the in-repo metrics surface).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator

from pathway_tpu_torch.observability.tracing import (
    current_traceparent,
    get_tracer,
    otel_sdk_provider_active,
)


class Telemetry:
    """Span factory + lightweight local timings (always collected).

    Spans delegate to the Trace Weaver tracer; ``timings`` accumulation
    is lock-guarded — spans close concurrently on the engine's topo-level
    worker pool (engine/runtime.py), and the bare dict read-modify-write
    dropped updates under that concurrency."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.timings: dict[str, float] = {}
        self._timings_lock = threading.Lock()

    def _add_timing(self, name: str, dt: float) -> None:
        with self._timings_lock:
            self.timings[name] = self.timings.get(name, 0.0) + dt

    @contextlib.contextmanager
    def span(self, name: str, **attributes: Any) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            if self.enabled:
                with get_tracer().span(name, **attributes):
                    yield
            else:
                yield
        finally:
            self._add_timing(name, time.perf_counter() - t0)

    def trace_parent(self) -> str | None:
        """W3C traceparent of the current span — the reference forwards
        this across the Python/engine boundary (python_api.rs:3343).
        Prefers the built-in tracer's ambient context; falls back to an
        ambient OTel span when only the host application's SDK is
        tracing."""
        tp = current_traceparent()
        if tp is not None:
            return tp
        try:
            from opentelemetry import trace as _trace

            ctx = _trace.get_current_span().get_span_context()
            if not ctx.is_valid:
                return None
            return (
                f"00-{ctx.trace_id:032x}-{ctx.span_id:016x}-"
                f"{ctx.trace_flags:02x}"
            )
        except Exception:
            return None


def process_gauges() -> dict[str, float]:
    """Process CPU/memory gauges (reference: sysinfo-backed gauges,
    src/engine/telemetry.rs:359-416). Stdlib-only: os.times for CPU,
    /proc/self/status (linux) or ru_maxrss for resident memory."""
    import os

    t = os.times()
    gauges = {"process_cpu_seconds_total": float(t.user + t.system)}
    rss = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = float(line.split()[1]) * 1024.0
                    break
    except OSError:
        pass
    if rss is None:
        # fallback is PEAK rss (and on macOS ru_maxrss is bytes, not KiB)
        try:
            import resource
            import sys

            raw = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            rss = float(raw if sys.platform == "darwin" else raw * 1024)
        except Exception:
            rss = 0.0
    gauges["process_memory_rss_bytes"] = rss
    return gauges


class _OtelMetrics:
    """OTLP metrics when an OTel metrics SDK is configured by the host
    application (reference: telemetry.rs:327-357 operator latency +
    process gauges exported over OTLP); free no-ops otherwise."""

    def __init__(self):
        self._hist = None
        self.enabled = False
        try:
            # a bare OTel API (no SDK) hands out proxy instruments that
            # accept-and-drop every record — skip the per-tick cost unless
            # a real SDK provider is configured at Runtime build time
            # (shared gate with the tracer's dual-emit: tracing.py)
            if not _sdk_provider_active():
                return
            from opentelemetry import metrics as _metrics

            meter = _metrics.get_meter("pathway_tpu")
            self._hist = meter.create_histogram(
                "pathway.operator.latency",
                unit="ns",
                description="per-operator batch processing time",
            )
            # CPU time is monotonic cumulative -> counter semantics
            meter.create_observable_counter(
                "pathway.process.cpu_seconds",
                callbacks=[self._observe_cpu],
            )
            meter.create_observable_gauge(
                "pathway.process.memory_rss_bytes",
                callbacks=[self._observe_rss],
            )
            self.enabled = True
        except Exception:  # pragma: no cover - no OTel metrics API
            self._hist = None
            self.enabled = False

    @staticmethod
    def _observe_cpu(_options):
        from opentelemetry.metrics import Observation

        yield Observation(process_gauges()["process_cpu_seconds_total"])

    @staticmethod
    def _observe_rss(_options):
        from opentelemetry.metrics import Observation

        yield Observation(process_gauges()["process_memory_rss_bytes"])

    def record_operator_latency(self, operator: str, ns: int) -> None:
        if self._hist is not None:
            try:
                self._hist.record(ns, {"operator": operator})
            except Exception:
                pass


_GLOBAL = Telemetry()
_METRICS: _OtelMetrics | None = None
_METRICS_LOCK = __import__("threading").Lock()


def get_telemetry() -> Telemetry:
    return _GLOBAL


def _sdk_provider_active() -> bool:
    return otel_sdk_provider_active("metrics")


def get_metrics() -> _OtelMetrics:
    """Metrics singleton. A disabled instance is re-evaluated on each call
    (cheap: one provider type check) so an SDK MeterProvider configured
    AFTER the first Runtime still turns metrics on for later runtimes."""
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None or (
            not _METRICS.enabled and _sdk_provider_active()
        ):
            _METRICS = _OtelMetrics()
    return _METRICS
