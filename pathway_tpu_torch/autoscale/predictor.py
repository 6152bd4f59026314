"""Own copy of ``pathway_tpu/autoscale/predictor.py``.

Flux Pilot predictor — a short-horizon forecaster over one signal
series.

Two terms, both cheap enough to run per controller step:

* **Holt level+trend**: exponentially-weighted level and slope with a
  shared time constant ``tau_s`` — the linear extrapolation fires on
  any sustained ramp within a couple of time constants, no period
  knowledge needed.
* **Diurnal phase profile** (optional, ``period_s``): a per-phase-bucket
  EWMA of the value at that point of the cycle, learned from the same
  ``observe`` stream (or seeded wholesale from a Fleet Lens ring via
  :meth:`seed`).  Once a bucket has data, the forecast also consults
  the profile at ``now + horizon`` — re-centered on the current level
  so a day-over-day amplitude shift does not stale the shape — and
  takes the max with the trend term.  Taking the max is deliberate:
  the autoscaler's failure mode is scaling up LATE (shed), not early
  (a few rank-seconds), so the forecast is conservative upward.

The forecaster is clock-free: callers pass monotonic timestamps in,
which is what makes lead-time properties unit-testable against a
synthetic diurnal generator (tests/test_autoscale.py) and lets the
bench compress a full day into seconds.
"""

from __future__ import annotations

import math


class LoadForecaster:
    def __init__(
        self,
        *,
        tau_s: float = 30.0,
        period_s: float | None = None,
        buckets: int = 48,
    ):
        self.tau_s = max(float(tau_s), 1e-6)
        self.period_s = None if period_s is None else max(float(period_s), 1e-6)
        self.buckets = max(int(buckets), 2)
        self._level: float | None = None
        self._slope = 0.0
        self._last_mono: float | None = None
        self._profile: list[float | None] = [None] * self.buckets
        self._n = 0

    # --- learning ---------------------------------------------------------

    def _bucket(self, mono: float) -> int:
        assert self.period_s is not None
        phase = (mono % self.period_s) / self.period_s
        return min(int(phase * self.buckets), self.buckets - 1)

    def observe(self, mono: float, value: float) -> None:
        value = float(value)
        if self._level is None or self._last_mono is None:
            self._level = value
            self._slope = 0.0
        else:
            dt = mono - self._last_mono
            if dt > 0.0:
                alpha = 1.0 - math.exp(-dt / self.tau_s)
                prev = self._level
                # Holt: project the old level forward, then correct
                self._level = (
                    alpha * value + (1.0 - alpha) * (prev + self._slope * dt)
                )
                inst = (self._level - prev) / dt
                self._slope = alpha * inst + (1.0 - alpha) * self._slope
        self._last_mono = mono
        self._n += 1
        if self.period_s is not None:
            b = self._bucket(mono)
            cur = self._profile[b]
            self._profile[b] = (
                value if cur is None else 0.7 * cur + 0.3 * value
            )

    def seed(self, points: list[tuple[float, float]]) -> None:
        """Warm-start from ring history — ``[(mono, value), ...]``
        oldest-first, e.g. ``SignalRing.points()``."""
        for mono, value in points:
            self.observe(mono, value)

    # --- forecasting ------------------------------------------------------

    def forecast(self, horizon_s: float, now_mono: float | None = None) -> float | None:
        """Predicted worst value over the NEXT ``horizon_s`` seconds, or
        None before any observation.  Never negative.

        The profile term is the max over every phase bucket the window
        [now, now + horizon] touches — a point estimate at exactly
        ``now + horizon`` would look PAST a surge whose peak falls
        inside the window and wave a scale-down through mid-surge."""
        if self._level is None or self._last_mono is None:
            return None
        if now_mono is None:
            now_mono = self._last_mono
        ahead = max(now_mono - self._last_mono, 0.0) + max(horizon_s, 0.0)
        trend = self._level + self._slope * ahead
        best = trend
        if self.period_s is not None:
            here = self._profile[self._bucket(now_mono)]
            # every bucket the look-ahead window touches, at bucket
            # resolution (whole cycle when the window spans it)
            span = min(ahead, self.period_s)
            step = self.period_s / self.buckets
            peak: float | None = None
            off = 0.0
            while off <= span:
                v = self._profile[self._bucket(now_mono + off)]
                if v is not None and (peak is None or v > peak):
                    peak = v
                off += step
            if peak is not None:
                # re-center the profile on the current level so the
                # learned SHAPE survives day-over-day amplitude drift
                # — but only upward: a level BELOW the profile is
                # usually the mitigation working (extra ranks soaking
                # the surge), and discounting the profile for it would
                # let a scale-down through at the surge peak.  A surge
                # that is genuinely gone decays out of the profile via
                # its own EWMA instead.
                bias = (
                    max(self._level - here, 0.0)
                    if here is not None
                    else 0.0
                )
                best = max(best, peak + bias)
        return max(best, 0.0)

    def lead_crossing(
        self,
        threshold: float,
        max_horizon_s: float,
        now_mono: float | None = None,
        resolution_s: float = 1.0,
    ) -> float | None:
        """Smallest horizon (seconds) at which the forecast crosses
        ``threshold``, scanned to ``max_horizon_s`` — None if it never
        does.  This is the lead time a scale-up gets over the raw
        signal."""
        h = 0.0
        step = max(float(resolution_s), 1e-3)
        while h <= max_horizon_s:
            v = self.forecast(h, now_mono)
            if v is not None and v > threshold:
                return h
            h += step
        return None

    def state(self) -> dict:
        return {
            "level": self._level,
            "slope": self._slope,
            "observations": self._n,
            "period_s": self.period_s,
            "profile_coverage": sum(
                1 for v in self._profile if v is not None
            )
            / self.buckets
            if self.period_s is not None
            else None,
        }
