"""Own copy of ``pathway_tpu/observability/tracing.py`` (standard library
only; OpenTelemetry is used when installed). The port's spans carry the
reference's names (``generate.decode_step``, ``generate.prefill``,
``embed.batch``).

Trace Weaver — end-to-end request tracing with a built-in recorder.

A self-contained tracer: spans land in a bounded in-memory ring buffer
with W3C ``traceparent`` generate/parse, monotonic-clock timestamps, and
parent/child links — no external SDK required (the reference forwards a
W3C trace_parent across the Python/engine boundary so build and engine
spans share one trace, src/engine/telemetry.rs + python_api.rs:3343; we
do the same across REST → embed → KNN → tick → host-mesh). When the host
application configures a real OpenTelemetry SDK TracerProvider, every
span is dual-emitted through it as well, so OTLP pipelines see the same
tree.

Surfaces: ``/debug/trace?seconds=N`` on the monitoring server returns
Chrome trace-event JSON (loadable in Perfetto), ``pw.debug.trace()`` /
``pw.debug.trace_tree()`` for notebooks, and a slow-query log (root
spans over ``PATHWAY_TRACE_SLOW_MS`` dumped with their full child
breakdown). Disable with ``PATHWAY_TRACING=0`` — a disabled tracer hands
out a shared no-op span, so the per-hop cost is one attribute check.

Cross-request attribution: the REST server registers each in-flight
request's span context keyed by its row key (``register_pending``); the
engine tick adopts the oldest pending context as its parent, so operator
/ embed / KNN spans that serve the request share its trace id. Across
processes the host mesh stamps every frame with the sender's
propagation traceparent, and the lockstep tick barrier agrees on one
group-wide tick trace (parallel/host_exchange.py).
"""

from __future__ import annotations

import contextvars
import logging
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

logger = logging.getLogger("pathway_tpu_torch")

# wall-clock anchor for the monotonic clock: span timestamps are
# perf_counter_ns offsets from one anchor, so they are strictly ordered
# within the process and immune to wall-clock steps.
#
# CLOCK CONTRACT (PR-18 audit): every DURATION in this module is a
# difference of two perf_counter_ns reads; wall time appears only as
# this one anchor, captured once at import, used for display/export
# epochs (start_unix_ns, chrome_trace ts, trailing-window cutoffs
# computed as anchored-monotonic). Freezing or stepping time.time()
# after import must not change any measured duration — enforced by the
# frozen-wall-clock regression test in tests/test_tickscope.py.
_ANCHOR_NS = time.time_ns() - time.perf_counter_ns()

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def otel_sdk_provider_active(signal: str = "metrics") -> bool:
    """True when the host application configured a REAL OpenTelemetry SDK
    provider for `signal` ("metrics" or "trace"). The bare OTel API (all
    this image ships) hands out proxy providers that accept-and-drop
    every record — not worth the per-call overhead. One helper shared by
    the metrics exporter (internals/telemetry.py) and the tracer's
    dual-emit gate."""
    try:
        if signal == "trace":
            from opentelemetry import trace as _api

            provider = _api.get_tracer_provider()
        else:
            from opentelemetry import metrics as _api

            provider = _api.get_meter_provider()
        return type(provider).__module__.startswith("opentelemetry.sdk")
    except Exception:
        return False


@dataclass(frozen=True)
class SpanContext:
    """The propagated identity of a span: what crosses process/host
    boundaries inside a ``traceparent`` header or mesh frame."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars
    flags: int = 1

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"


def parse_traceparent(header: Any) -> SpanContext | None:
    """Parse a W3C traceparent header; None on anything malformed (the
    contract: a bad header mints a fresh root rather than erroring)."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":  # forbidden version value
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, int(flags, 16))


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


@dataclass
class SpanRecord:
    """One finished span in the ring buffer."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start_unix_ns: int  # anchored monotonic, ns since epoch
    duration_ns: int
    thread: int
    attributes: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix_ns": self.start_unix_ns,
            "duration_ns": self.duration_ns,
            "thread": self.thread,
            "attributes": dict(self.attributes),
        }


# ambient span context of the current thread/task (contextvars follow
# asyncio tasks natively; the engine thread pool copies contexts
# explicitly — runtime.py)
_current: contextvars.ContextVar[SpanContext | None] = contextvars.ContextVar(
    "pathway_trace_ctx", default=None
)


class _NoopSpan:
    """Shared do-nothing span — what a disabled tracer hands out."""

    __slots__ = ()
    context: SpanContext | None = None
    trace_id: str | None = None

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """A live span: context manager that records into the tracer's ring
    on exit (and mirrors into an OTel SDK span when one is configured)."""

    __slots__ = (
        "_tracer",
        "name",
        "context",
        "parent_id",
        "ingress",
        "attributes",
        "_start_perf",
        "start_unix_ns",
        "_token",
        "_otel_cm",
        "_otel_span",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        context: SpanContext,
        parent_id: str | None,
        attributes: dict[str, Any],
        ingress: bool = False,
    ):
        self._tracer = tracer
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.ingress = ingress
        self.attributes = attributes
        self._token: Any = None
        self._otel_cm: Any = None
        self._otel_span: Any = None

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value
        if self._otel_span is not None:
            # keep the dual-emitted OTel span's view identical to ours
            try:
                self._otel_span.set_attribute(key, value)
            except Exception:
                pass

    def __enter__(self) -> "Span":
        self._start_perf = time.perf_counter_ns()
        self.start_unix_ns = _ANCHOR_NS + self._start_perf
        self._token = _current.set(self.context)
        otel = self._tracer._otel_tracer_if_active()
        if otel is not None:
            try:
                self._otel_cm = otel.start_as_current_span(self.name)
                sp = self._otel_cm.__enter__()
                for k, v in self.attributes.items():
                    try:
                        sp.set_attribute(k, v)
                    except Exception:
                        pass
                # surface OUR ids on the mirrored span so OTLP backends
                # can join against /debug/trace output
                sp.set_attribute("pathway.trace_id", self.context.trace_id)
                sp.set_attribute("pathway.span_id", self.context.span_id)
                self._otel_span = sp
            except Exception:
                self._otel_cm = None
                self._otel_span = None
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        duration_ns = time.perf_counter_ns() - self._start_perf
        if exc_type is not None:
            self.attributes["error"] = exc_type.__name__
        if self._otel_cm is not None:
            try:
                self._otel_cm.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        _current.reset(self._token)
        self._tracer._record(self, duration_ns)
        return False


class Tracer:
    """Bounded-ring span recorder + W3C context propagation."""

    def __init__(
        self, capacity: int | None = None, enabled: bool | None = None
    ):
        if enabled is None:
            enabled = os.environ.get("PATHWAY_TRACING", "1") != "0"
        self.enabled = bool(enabled)
        if capacity is None:
            try:
                capacity = int(os.environ.get("PATHWAY_TRACE_BUFFER", "8192"))
            except ValueError:
                capacity = 8192
        self._spans: deque[SpanRecord] = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        slow = os.environ.get("PATHWAY_TRACE_SLOW_MS", "")
        try:
            self.slow_ms: float | None = float(slow) if slow else None
        except ValueError:
            self.slow_ms = None
        self._otel: Any = None  # cached OTel tracer once a SDK is seen
        self._otel_next_probe = 0.0  # monotonic deadline for a re-probe

    # --- span creation ----------------------------------------------------

    def span(
        self,
        name: str,
        *,
        parent: SpanContext | None = None,
        root: bool = False,
        ingress: bool = False,
        **attributes: Any,
    ) -> Span | _NoopSpan:
        """Create a span. `parent` pins an explicit parent context (e.g.
        parsed from an incoming traceparent); `root=True` forces a fresh
        trace even when an ambient span is active; otherwise the span
        nests under the current thread/task context. ``ingress=True``
        marks a span that enters this process from outside (an HTTP
        request joining a caller's trace): it is slow-log eligible even
        though its parent lives in another service, where a plain child
        span is covered by its local root."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None and not root:
            parent = _current.get()
        if parent is not None:
            ctx = SpanContext(parent.trace_id, _new_span_id(), parent.flags)
            parent_id = parent.span_id
        else:
            ctx = SpanContext(_new_trace_id(), _new_span_id(), 1)
            parent_id = None
        return Span(
            self, name, ctx, parent_id, dict(attributes), ingress=ingress
        )

    def _otel_tracer_if_active(self) -> Any:
        """OTel dual-emit gate (mirrors internals/telemetry.get_metrics —
        an SDK configured after startup still turns emission on). The
        negative verdict is cached for a few seconds: spans open in the
        engine's per-operator hot loop, and a full provider probe (an
        import attempt when opentelemetry is absent!) per span would
        violate the near-zero-overhead contract."""
        if self._otel is not None:
            return self._otel
        now = time.monotonic()
        if now < self._otel_next_probe:
            return None
        self._otel_next_probe = now + 5.0
        if otel_sdk_provider_active("trace"):
            try:
                from opentelemetry import trace as _api

                self._otel = _api.get_tracer("pathway_tpu_torch")
            except Exception:
                self._otel = None
        return self._otel

    def _record(self, span: Span, duration_ns: int) -> None:
        rec = SpanRecord(
            name=span.name,
            trace_id=span.context.trace_id,
            span_id=span.context.span_id,
            parent_id=span.parent_id,
            start_unix_ns=span.start_unix_ns,
            duration_ns=duration_ns,
            thread=threading.get_ident(),
            attributes=span.attributes,
        )
        with self._lock:
            self._spans.append(rec)
        slow = self.slow_ms
        if (
            slow is not None
            and (rec.parent_id is None or span.ingress)
            and duration_ns >= slow * 1e6
        ):
            try:
                logger.warning(
                    "slow trace %s: %s took %.1f ms (threshold %.1f ms)\n%s",
                    rec.trace_id,
                    rec.name,
                    duration_ns / 1e6,
                    slow,
                    self.format_tree(rec.trace_id),
                )
            except Exception:
                pass

    # --- inspection -------------------------------------------------------

    def spans(self, seconds: float | None = None) -> list[SpanRecord]:
        """Snapshot of the ring, oldest first; `seconds` keeps only spans
        that ENDED within the trailing window."""
        with self._lock:
            recs = list(self._spans)
        if seconds is not None:
            cutoff = (_ANCHOR_NS + time.perf_counter_ns()) - int(
                seconds * 1e9
            )
            recs = [
                r for r in recs if r.start_unix_ns + r.duration_ns >= cutoff
            ]
        return recs

    def clear(self) -> None:
        """Test hook: drop every recorded span."""
        with self._lock:
            self._spans.clear()

    def format_tree(
        self, trace_id: str, seconds: float | None = None
    ) -> str:
        """Human-readable parent/child breakdown of one trace."""
        recs = [r for r in self.spans(seconds) if r.trace_id == trace_id]
        if not recs:
            return f"(no spans recorded for trace {trace_id})"
        by_parent: dict[str | None, list[SpanRecord]] = {}
        span_ids = {r.span_id for r in recs}
        for r in recs:
            # a parent that fell out of the ring (or lives in another
            # process) still gets its orphan rendered at the root level
            key = r.parent_id if r.parent_id in span_ids else None
            by_parent.setdefault(key, []).append(r)
        lines: list[str] = []

        def walk(parent: str | None, depth: int) -> None:
            for r in sorted(
                by_parent.get(parent, []), key=lambda r: r.start_unix_ns
            ):
                attrs = ", ".join(
                    f"{k}={v}" for k, v in sorted(r.attributes.items())
                )
                lines.append(
                    "  " * depth
                    + f"{r.name} {r.duration_ns / 1e6:.2f} ms"
                    + (f" [{attrs}]" if attrs else "")
                )
                walk(r.span_id, depth + 1)

        walk(None, 0)
        return "\n".join(lines)

    def chrome_trace(self, seconds: float | None = None) -> dict:
        """Spans as Chrome trace-event JSON (the `traceEvents` dialect
        Perfetto and chrome://tracing load). Complete ("X") events carry
        trace/span/parent ids in `args`; histogram exemplars ride along
        under `otherData` so metrics link back to traces."""
        pid = os.getpid()
        process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
        events: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": f"pathway process {process_id}"},
            }
        ]
        for r in self.spans(seconds):
            args = {k: _jsonable(v) for k, v in r.attributes.items()}
            args["trace_id"] = r.trace_id
            args["span_id"] = r.span_id
            if r.parent_id:
                args["parent_id"] = r.parent_id
            events.append(
                {
                    "name": r.name,
                    "cat": "pathway",
                    "ph": "X",
                    "ts": r.start_unix_ns / 1e3,  # microseconds
                    "dur": r.duration_ns / 1e3,
                    "pid": pid,
                    "tid": r.thread,
                    "args": args,
                }
            )
        exemplars: list[dict] = []
        try:
            from pathway_tpu_torch.observability.registry import REGISTRY

            exemplars = REGISTRY.exemplars()
        except Exception:
            pass
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "process": process_id,
                "exemplars": exemplars,
            },
        }


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# --- Chrome trace-event schema validator ----------------------------------
# (mirrors observability/exposition.py: an in-repo conformance check so
# tests can assert /debug/trace output is loadable before a human ever
# drags it into Perfetto)

_KNOWN_PHASES = frozenset("XBEiIMCbnesftPNDOvRp")


def validate_chrome_trace(data: Any) -> list[str]:
    """Conformance check of a Chrome trace-event document; returns a list
    of violations (empty = ok). Accepts both the object form
    ({"traceEvents": [...]}) and the bare array form."""
    errors: list[str] = []
    if isinstance(data, dict):
        events = data.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level 'traceEvents' must be a list"]
    elif isinstance(data, list):
        events = data
    else:
        return ["document must be an object with traceEvents or an array"]
    for i, ev in enumerate(events):
        where = f"event {i}"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in _KNOWN_PHASES:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing/empty name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errors.append(f"{where}: {key} must be an integer")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"{where}: X event needs a non-negative dur"
                )
        args = ev.get("args")
        if args is not None and not isinstance(args, dict):
            errors.append(f"{where}: args must be an object")
    return errors


# --- ambient context helpers ----------------------------------------------


def current_context() -> SpanContext | None:
    return _current.get()


def current_traceparent() -> str | None:
    ctx = _current.get()
    return ctx.traceparent() if ctx is not None else None


# --- in-flight request registry -------------------------------------------
# The REST server registers each awaiting request's span context under
# its row key; the engine tick adopts the OLDEST pending context as its
# parent so the dataflow work that serves the request lands in its
# trace. (With several concurrent requests one tick can only belong to
# one trace — the oldest waiter wins; the others still get their HTTP
# root span and response-header traceparent.)

_pending_lock = threading.Lock()
_pending: dict[int, SpanContext] = {}


def register_pending(key: int, ctx: SpanContext | None) -> None:
    if ctx is None:
        return
    with _pending_lock:
        _pending[key] = ctx


def unregister_pending(key: int) -> None:
    with _pending_lock:
        _pending.pop(key, None)


def pending_context() -> SpanContext | None:
    with _pending_lock:
        return next(iter(_pending.values()), None)


def pending_traceparent() -> str | None:
    ctx = pending_context()
    return ctx.traceparent() if ctx is not None else None


def propagation_traceparent() -> str | None:
    """What crosses a process boundary: the ambient span context when one
    is active (operator work mid-tick), else the oldest pending request
    (the tick-scheduling barrier runs outside any span)."""
    return current_traceparent() or pending_traceparent()


_GLOBAL_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL_TRACER
