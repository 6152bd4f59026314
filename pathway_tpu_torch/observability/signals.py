"""Own copy of ``pathway_tpu/observability/signals.py`` (standard library
over the port's registry): the same signal inventory, knobs, rings and burn
rates. The sampler only reads metrics; in the port ``pathway_last_tick_seconds``
comes from the monitoring server's runtime bridge, and ``ranks`` reads
``pathway_autoscale_ranks`` once an autoscale controller is armed
(``autoscale/controller.py``), empty before, as in the reference.

Fleet Lens SLO signals — bounded time-series rings sampled from the
process's own :class:`MetricsRegistry`, with rolling burn rates against
declared SLO targets.

The exposition endpoint (`/metrics`) answers "what is the value NOW";
the autoscaler the ROADMAP promises needs "what has it been DOING" —
shed rate climbing, WFQ backlog draining, staleness recovering after a
takeover.  This module is that feed: a per-process
sampler snapshots the key SLO series on a fixed cadence
(``PATHWAY_SIGNALS_INTERVAL_MS``, default 1000) into bounded rings
(``PATHWAY_SIGNALS_DEPTH`` points, default 600 — ten minutes at 1 Hz)
and serves them at ``/debug/signals``.

Signal inventory (sampled from metrics that already exist — the sampler
registers nothing and never mutates the registry):

===================== ======== =====================================
signal                unit     source
===================== ======== =====================================
shed_rate             fraction Δshed / (Δshed + Δadmitted)
wfq_backlog           requests pathway_serving_queue_depth (sum)
staleness_s           seconds  pathway_replica_staleness_seconds (max)
replica_occupancy     requests pathway_router_replica_inflight +
                               pathway_serving_inflight (sum)
kv_page_occupancy     fraction pathway_generate_page_pool_occupancy (max)
tok_s                 tokens/s rate(pathway_generate_tokens_total)
ttft_p50_ms, _p99_ms  ms       pathway_generate_ttft_seconds quantiles
tick_ms               ms       pathway_last_tick_seconds × 1000
tick_p99_ms           ms       pathway_operator_tick_seconds p99 × 1000
knn_p50_ms            ms       pathway_knn_query_seconds p50 × 1000
compile_hit_rate      fraction hits / (hits + misses), cumulative
ranks                 ranks    pathway_autoscale_ranks (Flux Pilot)
===================== ======== =====================================

SLO targets are declared with ``PATHWAY_SLO_*`` env knobs (see
``SLO_KNOBS``).  For a "stay below" target the burn rate is
``window_avg / target``; for a "stay above" target it is
``target / window_avg`` — either way burn > 1.0 means the SLO is being
violated over the window (``PATHWAY_SLO_WINDOW_S``, default 60).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.observability.registry import REGISTRY, MetricsRegistry

_INTERVAL_ENV = "PATHWAY_SIGNALS_INTERVAL_MS"
_DEPTH_ENV = "PATHWAY_SIGNALS_DEPTH"
_ENABLE_ENV = "PATHWAY_SIGNALS"
_WINDOW_ENV = "PATHWAY_SLO_WINDOW_S"

#: knob → (signal name, direction).  direction "max" = value must stay
#: at or below the target; "min" = must stay at or above it.
SLO_KNOBS: dict[str, tuple[str, str]] = {
    "PATHWAY_SLO_SHED_RATE": ("shed_rate", "max"),
    "PATHWAY_SLO_WFQ_BACKLOG": ("wfq_backlog", "max"),
    "PATHWAY_SLO_STALENESS_S": ("staleness_s", "max"),
    "PATHWAY_SLO_REPLICA_OCCUPANCY": ("replica_occupancy", "max"),
    "PATHWAY_SLO_KV_OCCUPANCY": ("kv_page_occupancy", "max"),
    "PATHWAY_SLO_TOK_S": ("tok_s", "min"),
    "PATHWAY_SLO_TTFT_P99_MS": ("ttft_p99_ms", "max"),
    "PATHWAY_SLO_TICK_P99_MS": ("tick_p99_ms", "max"),
    "PATHWAY_SLO_KNN_P50_MS": ("knn_p50_ms", "max"),
    "PATHWAY_SLO_COMPILE_HIT_RATE": ("compile_hit_rate", "min"),
}


def slo_targets(env: dict[str, str] | None = None) -> dict[str, tuple[float, str]]:
    """Declared SLO targets: signal name → (target, direction)."""
    env = os.environ if env is None else env
    out: dict[str, tuple[float, str]] = {}
    for knob, (signal, direction) in SLO_KNOBS.items():
        raw = env.get(knob, "")
        if not raw:
            continue
        try:
            out[signal] = (float(raw), direction)
        except ValueError:
            continue
    return out


class SignalRing:
    """Bounded ring of (wall, mono, value) samples."""

    def __init__(self, depth: int):
        self._ring: deque[tuple[float, float, float]] = deque(
            maxlen=max(int(depth), 2)
        )

    def append(self, wall: float, mono: float, value: float) -> None:
        self._ring.append((wall, mono, float(value)))

    def __len__(self) -> int:
        return len(self._ring)

    def last(self) -> float | None:
        return self._ring[-1][2] if self._ring else None

    def series(self, limit: int | None = None) -> list[tuple[float, float]]:
        """[(wall, value), ...] oldest-first, optionally the last
        ``limit`` points."""
        pts = list(self._ring)
        if limit is not None:
            pts = pts[-max(int(limit), 0):]
        return [(w, v) for (w, _m, v) in pts]

    def points(self) -> list[tuple[float, float]]:
        """[(mono, value), ...] oldest-first — the monotonic series the
        Flux Pilot forecaster seeds from (rates/windows must never ride
        the wall clock; see the CLOCK CONTRACT in sample_once)."""
        return [(m, v) for (_w, m, v) in self._ring]

    def window_avg(self, seconds: float, now_mono: float | None = None) -> float | None:
        """Mean over the trailing ``seconds`` (monotonic window)."""
        if not self._ring:
            return None
        if now_mono is None:
            now_mono = self._ring[-1][1]
        vals = [v for (_w, m, v) in self._ring if now_mono - m <= seconds]
        if not vals:
            return self._ring[-1][2]
        return sum(vals) / len(vals)

    def window_max(self, seconds: float, now_mono: float | None = None) -> float | None:
        if not self._ring:
            return None
        if now_mono is None:
            now_mono = self._ring[-1][1]
        vals = [v for (_w, m, v) in self._ring if now_mono - m <= seconds]
        return max(vals) if vals else self._ring[-1][2]


# --- registry readers -------------------------------------------------------
# The sampler only READS: it never creates metrics, so arming it on a
# plane that doesn't serve/generate costs nothing but empty rings.


def _children(registry: MetricsRegistry, name: str):
    m = registry.get(name)
    if m is None:
        return []
    with m._lock:
        children = list(m._children.values())
    return children


def _counter_total(registry: MetricsRegistry, name: str) -> float | None:
    kids = _children(registry, name)
    if not kids:
        return None
    return float(sum(c.value for c in kids))


def _gauge_agg(
    registry: MetricsRegistry, name: str, agg: Callable[[list[float]], float]
) -> float | None:
    kids = _children(registry, name)
    vals: list[float] = []
    for c in kids:
        try:
            vals.append(float(c.current()))
        except Exception:
            continue
    return agg(vals) if vals else None


def _hist_quantile(registry: MetricsRegistry, name: str, q: float) -> float | None:
    """Quantile over ALL children of a histogram, merged by bucket
    counts (per-child quantiles can't be averaged)."""
    m = registry.get(name)
    if m is None:
        return None
    with m._lock:
        kids = list(m._children.values())
    if not kids:
        return None
    bounds = m.bounds
    merged = [0] * (len(bounds) + 1)
    total = 0
    for c in kids:
        for i, n in enumerate(c.counts):
            merged[i] += n
        total += c.count
    if total == 0:
        return None
    rank = q * total
    cum = 0
    lo = 0.0
    for i, n in enumerate(merged):
        if n == 0:
            if i < len(bounds):
                lo = bounds[i]
            continue
        if cum + n >= rank:
            hi = bounds[i] if i < len(bounds) else lo
            frac = (rank - cum) / n
            return lo + (hi - lo) * frac
        cum += n
        if i < len(bounds):
            lo = bounds[i]
    return lo


@dataclass(frozen=True)
class SignalDef:
    name: str
    unit: str
    #: "gauge" signals read directly; "rate"/"ratio_rate" derive from
    #: counter deltas between consecutive samples.
    compute: Callable[["SignalSampler", float], float | None]


def _sig_shed_rate(s: "SignalSampler", dt: float) -> float | None:
    d_shed = s._counter_delta("pathway_serving_shed_total")
    d_adm = s._counter_delta("pathway_serving_admitted_total")
    if d_shed is None and d_adm is None:
        return None
    shed = d_shed or 0.0
    adm = d_adm or 0.0
    if shed + adm <= 0:
        return 0.0
    return shed / (shed + adm)


def _sig_tok_s(s: "SignalSampler", dt: float) -> float | None:
    d = s._counter_delta("pathway_generate_tokens_total")
    if d is None or dt <= 0:
        return None
    return d / dt


def _sig_compile_hit_rate(s: "SignalSampler", dt: float) -> float | None:
    hits = _counter_total(s.registry, "pathway_engine_compile_cache_hits_total")
    misses = _counter_total(s.registry, "pathway_engine_compile_cache_misses_total")
    if hits is None and misses is None:
        return None
    h = hits or 0.0
    m = misses or 0.0
    if h + m <= 0:
        return None
    return h / (h + m)


SIGNALS: tuple[SignalDef, ...] = (
    SignalDef("shed_rate", "fraction", _sig_shed_rate),
    SignalDef(
        "wfq_backlog",
        "requests",
        lambda s, dt: _gauge_agg(s.registry, "pathway_serving_queue_depth", sum),
    ),
    SignalDef(
        "staleness_s",
        "seconds",
        lambda s, dt: _gauge_agg(
            s.registry, "pathway_replica_staleness_seconds", max
        ),
    ),
    SignalDef(
        "replica_occupancy",
        "requests",
        lambda s, dt: _sum_non_none(
            _gauge_agg(s.registry, "pathway_router_replica_inflight", sum),
            _gauge_agg(s.registry, "pathway_serving_inflight", sum),
        ),
    ),
    SignalDef(
        "kv_page_occupancy",
        "fraction",
        lambda s, dt: _gauge_agg(
            s.registry, "pathway_generate_page_pool_occupancy", max
        ),
    ),
    SignalDef("tok_s", "tokens/s", _sig_tok_s),
    SignalDef(
        "ttft_p50_ms",
        "ms",
        lambda s, dt: _scale(
            _hist_quantile(s.registry, "pathway_generate_ttft_seconds", 0.5), 1e3
        ),
    ),
    SignalDef(
        "ttft_p99_ms",
        "ms",
        lambda s, dt: _scale(
            _hist_quantile(s.registry, "pathway_generate_ttft_seconds", 0.99), 1e3
        ),
    ),
    SignalDef(
        "tick_ms",
        "ms",
        lambda s, dt: _scale(
            _gauge_agg(s.registry, "pathway_last_tick_seconds", max), 1e3
        ),
    ),
    SignalDef(
        "tick_p99_ms",
        "ms",
        lambda s, dt: _scale(
            _hist_quantile(s.registry, "pathway_operator_tick_seconds", 0.99), 1e3
        ),
    ),
    SignalDef(
        "knn_p50_ms",
        "ms",
        lambda s, dt: _scale(
            _hist_quantile(s.registry, "pathway_knn_query_seconds", 0.5), 1e3
        ),
    ),
    SignalDef("compile_hit_rate", "fraction", _sig_compile_hit_rate),
    # Flux Pilot (autoscale/): the controller's own rank count, ringed
    # so scaling history rides the same /debug/signals feed the inputs
    # do — a burn spike lines up against the resize that answered it
    SignalDef(
        "ranks",
        "ranks",
        lambda s, dt: _gauge_agg(s.registry, "pathway_autoscale_ranks", max),
    ),
)


def _scale(v: float | None, k: float) -> float | None:
    return None if v is None else v * k


def _sum_non_none(*vals: float | None) -> float | None:
    present = [v for v in vals if v is not None]
    return sum(present) if present else None


_COUNTER_SOURCES = (
    "pathway_serving_shed_total",
    "pathway_serving_admitted_total",
    "pathway_generate_tokens_total",
)


class SignalSampler:
    """Samples the signal inventory from ``registry`` on a fixed cadence
    into per-signal :class:`SignalRing` rings and computes SLO burn
    rates.  ``sample_once()`` is public so tests and benches can drive
    it deterministically without the thread."""

    def __init__(
        self,
        interval_s: float | None = None,
        depth: int | None = None,
        registry: MetricsRegistry = REGISTRY,
    ):
        if interval_s is None:
            try:
                interval_s = (
                    float(os.environ.get(_INTERVAL_ENV, "1000") or 1000) / 1000.0
                )
            except ValueError:
                interval_s = 1.0
        if depth is None:
            try:
                depth = int(os.environ.get(_DEPTH_ENV, "600") or 600)
            except ValueError:
                depth = 600
        try:
            self.window_s = float(os.environ.get(_WINDOW_ENV, "60") or 60)
        except ValueError:
            self.window_s = 60.0
        self.interval_s = max(float(interval_s), 0.05)
        self.depth = max(int(depth), 2)
        self.registry = registry
        self.rings: dict[str, SignalRing] = {
            d.name: SignalRing(self.depth) for d in SIGNALS
        }
        self._units = {d.name: d.unit for d in SIGNALS}
        self._prev_counters: dict[str, float] = {}
        self._pending_deltas: dict[str, float | None] = {}
        self._samples = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- counter-delta bookkeeping (one snapshot per sample_once) ---------

    def _counter_delta(self, name: str) -> float | None:
        return self._pending_deltas.get(name)

    def _snap_counters(self) -> None:
        for name in _COUNTER_SOURCES:
            cur = _counter_total(self.registry, name)
            if cur is None:
                self._pending_deltas[name] = None
                continue
            prev = self._prev_counters.get(name)
            self._prev_counters[name] = cur
            if prev is None:
                self._pending_deltas[name] = None
            else:
                # counter reset (registry.clear in tests) → treat as fresh
                self._pending_deltas[name] = max(cur - prev, 0.0)

    # -- sampling ---------------------------------------------------------

    def sample_once(self) -> None:
        """Take one snapshot of every signal (never raises)."""
        # CLOCK CONTRACT: `wall` is display-only (the timestamp shown in
        # /debug/signals and the journal); every rate/window/burn
        # computation below uses `mono` deltas, so a stepped or frozen
        # wall clock cannot distort a signal
        wall = time.time()
        mono = time.monotonic()
        with self._lock:
            dt = self.interval_s if self._samples else 0.0
            if self._samples:
                last = next(
                    (r._ring[-1][1] for r in self.rings.values() if r._ring),
                    None,
                )
                if last is not None:
                    dt = max(mono - last, 1e-9)
            self._snap_counters()
            for d in SIGNALS:
                try:
                    v = d.compute(self, dt)
                except Exception:
                    v = None
                if v is not None:
                    self.rings[d.name].append(wall, mono, v)
            self._samples += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                pass

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pathway-signal-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # -- burn rates and snapshot -----------------------------------------

    def burn_rates(self) -> dict[str, dict[str, Any]]:
        """signal → {target, direction, window_avg, burn}.  burn > 1.0
        means the SLO is being violated over the trailing window."""
        targets = slo_targets()
        out: dict[str, dict[str, Any]] = {}
        now_mono = time.monotonic()
        for signal, (target, direction) in targets.items():
            ring = self.rings.get(signal)
            avg = ring.window_avg(self.window_s, now_mono) if ring else None
            burn: float | None = None
            if avg is not None and target > 0:
                if direction == "max":
                    burn = avg / target
                else:
                    burn = target / avg if avg > 0 else float("inf")
            out[signal] = {
                "target": target,
                "direction": direction,
                "window_avg": avg,
                "burn": burn,
            }
        return out

    def snapshot(self, series_points: int = 0) -> dict[str, Any]:
        """JSON-able state for ``/debug/signals``.  ``series_points`` > 0
        includes the trailing N ring points per signal."""
        with self._lock:
            sigs: dict[str, Any] = {}
            for name, ring in self.rings.items():
                entry: dict[str, Any] = {
                    "unit": self._units[name],
                    "last": ring.last(),
                    "n": len(ring),
                    "window_avg": ring.window_avg(self.window_s),
                }
                if series_points > 0:
                    entry["series"] = [
                        [round(w, 6), v] for (w, v) in ring.series(series_points)
                    ]
                sigs[name] = entry
            samples = self._samples
        return {
            "interval_s": self.interval_s,
            "depth": self.depth,
            "window_s": self.window_s,
            "samples": samples,
            "running": self._thread is not None and self._thread.is_alive(),
            "slo": self.burn_rates(),
            "signals": sigs,
        }


# --- process-global sampler -------------------------------------------------

_sampler: SignalSampler | None = None
_sampler_lock = threading.Lock()


def signals_enabled() -> bool:
    return os.environ.get(_ENABLE_ENV, "1") not in ("0", "false", "no", "off")


def arm_sampler(start: bool = True) -> SignalSampler | None:
    """Create (and by default start) the process-global sampler.
    Returns None when disabled via ``PATHWAY_SIGNALS=0``."""
    global _sampler
    if not signals_enabled():
        return None
    with _sampler_lock:
        if _sampler is None:
            _sampler = SignalSampler()
    if start:
        _sampler.start()
    return _sampler


def get_sampler() -> SignalSampler | None:
    """The process-global sampler, or None if never armed."""
    return _sampler


def reset_sampler() -> None:
    """Test hook: stop and forget the process-global sampler."""
    global _sampler
    with _sampler_lock:
        if _sampler is not None:
            try:
                _sampler.stop()
            except Exception:
                pass
        _sampler = None
