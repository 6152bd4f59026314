"""Own copy of ``pathway_tpu/observability/registry.py`` (standard library
only): the port keeps its own process-wide ``REGISTRY`` under the same
metric names, help strings and label names, so a scrape of either package
reads the same.

Process-wide metrics registry — the Flight Recorder's core.

Counters, gauges, and log-linear-bucket histograms with Prometheus text
exposition (format 0.0.4, the dialect the reference engine serves from
src/engine/http_server.rs). One process-wide ``REGISTRY`` feeds the
``/metrics`` endpoint (internals/monitoring_server.py); hot paths across
engine/io/xpacks bind label children once and observe per batch, so the
per-tick cost is a lock + bisect, never string formatting.

Histograms use log-linear buckets (HdrHistogram style: linear subdivision
within each power-of-two octave), which keeps relative quantile error
bounded by 1/per_octave across the whole 0.1 ms .. 64 s serving range —
the p50/p95/p99 numbers BASELINE.md tracks are estimated from these
buckets (``Histogram.quantile``), and Prometheus re-derives them
server-side from the ``_bucket`` series.
"""

from __future__ import annotations

import math
import re
import threading
import time
from bisect import bisect_left
from typing import Any, Callable, Iterable, Mapping, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Coerce an arbitrary string into a legal metric name."""
    out = _SANITIZE_RE.sub("_", str(name))
    if not out or not _NAME_RE.match(out):
        out = "_" + out
    return out


def escape_label_value(value: Any) -> str:
    """Prometheus label-value escaping: backslash, double quote, newline.
    User-controlled strings (table/node names, routes, model ids) pass
    through here before interpolation, so a quote in a table name cannot
    corrupt the exposition output."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


def log_linear_buckets(
    lo: float = 1e-4, hi: float = 64.0, per_octave: int = 4
) -> tuple[float, ...]:
    """Bucket upper bounds: each power-of-two octave [b, 2b) split into
    ``per_octave`` linear sub-buckets (HdrHistogram layout). The default
    spans 0.1 ms .. 64 s in ~78 buckets — wide enough for a sub-ms device
    top-k and a 60 s hung backend init in the same histogram, with
    quantile interpolation error bounded by one sub-bucket (≤25%)."""
    bounds: list[float] = []
    base = lo
    while base < hi:
        for j in range(1, per_octave + 1):
            bounds.append(base * (1.0 + j / per_octave))
        base *= 2.0
    # float steps can land a hair past hi; keep one terminal bucket at hi
    out = sorted({round(b, 12) for b in bounds if b <= hi * (1 + 1e-9)})
    if not out or out[-1] < hi:
        out.append(float(hi))
    return tuple(out)


def _label_key(
    labelnames: Sequence[str], args: Sequence[Any], kwargs: Mapping[str, Any]
) -> tuple[str, ...]:
    if kwargs:
        if args:
            raise ValueError("pass label values positionally OR by name")
        try:
            args = [kwargs[n] for n in labelnames]
        except KeyError as exc:
            raise ValueError(
                f"missing label {exc.args[0]!r}; expected {labelnames}"
            ) from exc
    if len(args) != len(labelnames):
        raise ValueError(
            f"expected {len(labelnames)} label value(s) {labelnames}, "
            f"got {len(args)}"
        )
    return tuple(str(a) for a in args)


class _Metric:
    """Shared labeled-family scaffolding."""

    type_name = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}

    def labels(self, *args: Any, **kwargs: Any):
        key = _label_key(self.labelnames, args, kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child(key)
                self._children[key] = child
        return child

    def remove(self, *args: Any, **kwargs: Any) -> None:
        """Drop one label child (e.g. a placeholder series that has been
        superseded). No-op when the child does not exist."""
        key = _label_key(self.labelnames, args, kwargs)
        with self._lock:
            self._children.pop(key, None)

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self.labels()

    def _make_child(self, key: tuple[str, ...]):
        raise NotImplementedError

    def _render_label_str(self, key: tuple[str, ...], extra: str = "") -> str:
        parts = [
            f'{n}="{escape_label_value(v)}"'
            for n, v in zip(self.labelnames, key)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def samples(self) -> Iterable[str]:
        raise NotImplementedError

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} {self.type_name}",
        ]
        lines.extend(self.samples())
        return lines


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self.value += amount

    def set_total(self, value: float) -> None:
        """Bridge hook: adopt an externally-maintained monotone total
        (RuntimeStats promotion). Not part of the user-facing API."""
        with self._lock:
            self.value = float(value)


class Counter(_Metric):
    type_name = "counter"

    def _make_child(self, key):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    def samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            with child._lock:
                value = child.value
            yield (
                f"{self.name}{self._render_label_str(key)} "
                f"{format_value(value)}"
            )


class _GaugeChild:
    __slots__ = ("_lock", "value", "fn")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0
        self.fn: Callable[[], float] | None = None

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)
            self.fn = None

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self.fn = fn

    def current(self) -> float:
        fn = self.fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")
        return self.value


class Gauge(_Metric):
    type_name = "gauge"

    def _make_child(self, key):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._unlabeled().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._unlabeled().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._unlabeled().set_function(fn)

    def samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            yield (
                f"{self.name}{self._render_label_str(key)} "
                f"{format_value(child.current())}"
            )


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "counts", "sum", "count", "exemplar")

    def __init__(self, bounds: tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        # most recent (trace_id, value, unix_seconds) exemplar — links the
        # latency distribution back to a concrete trace in the Trace
        # Weaver ring (served under /debug/trace "otherData.exemplars";
        # the 0.0.4 text exposition has no exemplar syntax, so /metrics
        # output is unchanged)
        self.exemplar: tuple[str, float, float] | None = None

    def observe(self, value: float, exemplar: str | None = None) -> None:
        idx = bisect_left(self._bounds, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1
            if exemplar is not None:
                self.exemplar = (str(exemplar), float(value), time.time())

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) from bucket counts by linear
        interpolation within the target bucket."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = (
                    self._bounds[i]
                    if i < len(self._bounds)
                    else self._bounds[-1]
                )
                if hi <= lo:
                    return hi
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self._bounds[-1]


class Histogram(_Metric):
    type_name = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] | None = None,
    ):
        super().__init__(name, help, labelnames)
        if buckets is None:
            buckets = log_linear_buckets()
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("bucket bounds must be strictly increasing")
        self.bounds = bounds

    def _make_child(self, key):
        return _HistogramChild(self.bounds)

    def observe(self, value: float, exemplar: str | None = None) -> None:
        self._unlabeled().observe(value, exemplar)

    def quantile(self, q: float) -> float:
        return self._unlabeled().quantile(q)

    def samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            with child._lock:
                counts = list(child.counts)
                total = child.count
                vsum = child.sum
            cum = 0
            for bound, c in zip(self.bounds, counts):
                cum += c
                extra = f'le="{format_value(bound)}"'
                yield (
                    f"{self.name}_bucket"
                    f"{self._render_label_str(key, extra)} {cum}"
                )
            inf_extra = 'le="+Inf"'
            yield (
                f"{self.name}_bucket"
                f"{self._render_label_str(key, inf_extra)} {total}"
            )
            yield (
                f"{self.name}_sum{self._render_label_str(key)} "
                f"{format_value(vsum)}"
            )
            yield f"{self.name}_count{self._render_label_str(key)} {total}"


class MetricsRegistry:
    """Name-keyed metric store. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent across Runtime constructions in one
    process); collectors run just before each render so scrape-time
    bridges (RuntimeStats, device memory) stay pull-based."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}"
                    )
                buckets = kwargs.get("buckets")
                if buckets is not None and existing.bounds != tuple(
                    sorted(float(b) for b in buckets)
                ):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {existing.bounds}"
                    )
                return existing
            metric = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] | None = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn()`` runs at the start of every ``render()``; exceptions are
        swallowed (a broken bridge must not take down the scrape)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def exemplars(self) -> list[dict]:
        """Every histogram child's most recent exemplar: which trace id
        last contributed to which latency series (Trace Weaver's
        metrics→traces link)."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        out: list[dict] = []
        for m in metrics:
            if not isinstance(m, Histogram):
                continue
            with m._lock:
                items = sorted(m._children.items())
            for key, child in items:
                ex = child.exemplar
                if ex is None:
                    continue
                out.append(
                    {
                        "metric": m.name,
                        "labels": dict(zip(m.labelnames, key)),
                        "trace_id": ex[0],
                        "value": ex[1],
                        "time_unix": ex[2],
                    }
                )
        return out

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        """Test hook: drop every metric and collector."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
