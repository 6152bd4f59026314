"""Tenant Weave — per-tenant fair admission for the serving plane
(counterpart of ``pathway_tpu/serving/tenancy.py``, copied as is).

`serve_chaos` models a million-tenant zipf population, but every Surge
Gate decision so far was tenant-blind: one hot tenant filling the
admission queue (or draining the endpoint token bucket) starves the
zipf tail, and the shed falls on whoever arrives next — usually a tail
tenant that sent one request all day.  This module makes tenant
identity a first-class admission input:

* **Identity** rides the ``x-pathway-tenant`` request header (any
  opaque string; absent = the anonymous ``""`` tenant).  An optional
  ``x-pathway-tenant-class`` header selects a *weight class* from
  ``PATHWAY_TENANT_WEIGHTS`` (``class:weight,class:weight,...``;
  unknown/absent classes fall back to ``default``, weight 1.0).

* **Per-tenant token buckets** clamp each tenant to its *weighted fair
  share* of the endpoint capacity — but only **under pressure** (the
  endpoint bucket is out of tokens or the queue is half full), so the
  scheme stays work-conserving: a lone hot tenant on an idle endpoint
  uses everything; the moment the tail shows up, the hot tenant is
  clamped to ``capacity * w_i / W_active`` and *its* requests shed
  (429 ``tenant_rate``), leaving global tokens for everyone else.
  ``W_active`` is the exponentially-decayed activity-weighted sum
  (time constant ``ACTIVE_TAU_S`` / ``PATHWAY_TENANT_ACTIVE_TAU_S``) —
  it tracks diurnal swings smoothly, with no hard cliff when a tenant
  crosses an idle boundary; per-tenant state is LRU-bounded
  (``PATHWAY_TENANT_STATE_CAP``) so a million-tenant population costs
  a bounded dict, not a leak.

* **Weighted-fair EDF ordering**: every admitted request carries a
  WFQ virtual-finish tag (``vfinish += 1/weight`` per request, floored
  at the ledger's virtual now), and the micro-batcher orders its heap
  by ``(vfinish, deadline)`` — a hot tenant's backlog drains *behind*
  the tail's fresh requests while same-share requests keep EDF order.

* **Shed charges the hot tenant, not the queue tail**: when the
  admission queue is full, the gate asks :meth:`TenantLedger.pick_victim`
  for the queued request of the most over-share tenant; if that tenant
  is hotter than the arrival, the *victim* is evicted with 429
  (``tenant_evict``) and the arrival admitted — the tail never pays
  for the noisy neighbor's backlog.

* **Bounded per-tenant metric cardinality**: :class:`TenantLabeler`
  gives the top-``PATHWAY_TENANT_METRIC_TOPN`` (default 32) tenants by
  traffic real metric labels and folds everyone else into
  ``tenant="__other__"`` — a 1M-tenant population must not explode the
  MetricsRegistry.  Label assignment is sticky (no series churn) and
  backed by a bounded space-saving counter, so it is approximate but
  O(topn) in memory.

Escape hatch is total: with ``PATHWAY_TENANT_QOS`` unset (or 0) no
ledger is built anywhere and every admission/batching path is the
pre-Tenant-Weave code byte for byte.

Fault Forge: the ``flood=tenant:T,rps:R[,ticks:N]`` directive charges
synthetic load to tenant T through :meth:`TenantLedger.admit`'s
deterministic admission counter (see testing/faults.py), so fairness
tests need no wall-clock load generators.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any

TENANT_HEADER = "x-pathway-tenant"
TENANT_CLASS_HEADER = "x-pathway-tenant-class"
OTHER_LABEL = "__other__"

# time constant of the exponentially-decayed per-tenant activity that
# forms the fair-share denominator: a tenant's weight contribution is
# ``w * exp(-idle/τ)`` — full while it keeps sending, smoothly fading
# as it goes quiet.  This replaced the fixed 10 s ACTIVE window, whose
# hard expiry made every other tenant's fair share JUMP the instant a
# neighbor crossed the boundary (the diurnal-swing cliff: shares
# doubled at window expiry, then halved when the tenant returned).
# Override with PATHWAY_TENANT_ACTIVE_TAU_S.
ACTIVE_TAU_S = 10.0
# deprecated alias (pre-decay name); the semantics are now a time
# constant, not a cutoff
ACTIVE_WINDOW_S = ACTIVE_TAU_S
_ACTIVE_TAU_ENV = "PATHWAY_TENANT_ACTIVE_TAU_S"


def active_tau_s() -> float:
    raw = os.environ.get(_ACTIVE_TAU_ENV, "")
    if not raw:
        return ACTIVE_TAU_S
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"{_ACTIVE_TAU_ENV}={raw!r} is not a number"
        ) from None
    if not v > 0.0:
        raise ValueError(f"{_ACTIVE_TAU_ENV} must be > 0")
    return v

_ENABLED_ENV = "PATHWAY_TENANT_QOS"
_WEIGHTS_ENV = "PATHWAY_TENANT_WEIGHTS"
_TOPN_ENV = "PATHWAY_TENANT_METRIC_TOPN"
_STATE_CAP_ENV = "PATHWAY_TENANT_STATE_CAP"
_BURST_ENV = "PATHWAY_TENANT_BURST"
_RPS_ENV = "PATHWAY_TENANT_RPS"


def tenancy_enabled_via_env() -> bool:
    """``PATHWAY_TENANT_QOS=1`` arms per-tenant fair admission on every
    Surge Gate / replica admission controller.  Off (the default) keeps
    every serving path byte-identical to the tenant-blind plane."""
    return os.environ.get(_ENABLED_ENV, "0").lower() in ("1", "true", "yes")


def parse_weight_classes(raw: str | None = None) -> dict[str, float]:
    """``PATHWAY_TENANT_WEIGHTS``: ``class:weight,class:weight,...``
    (e.g. ``premium:4,default:1,batch:0.25``).  Weights must be > 0; a
    ``default`` class (weight 1.0) is added when absent — it is what
    unknown/unlabeled tenants resolve to."""
    if raw is None:
        raw = os.environ.get(_WEIGHTS_ENV, "")
    weights: dict[str, float] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.rpartition(":")
        if not sep or not name.strip():
            raise ValueError(
                f"{_WEIGHTS_ENV}: bad entry {part!r} (expected "
                "class:weight)"
            )
        try:
            weight = float(w)
        except ValueError:
            raise ValueError(
                f"{_WEIGHTS_ENV}: weight {w!r} for class {name!r} is "
                "not a number"
            ) from None
        if not weight > 0.0:
            raise ValueError(
                f"{_WEIGHTS_ENV}: weight for class {name!r} must be > 0"
            )
        weights[name.strip()] = weight
    weights.setdefault("default", 1.0)
    return weights


def _env_int(name: str, default: int, floor: int = 1) -> int:
    raw = os.environ.get(name, "") or str(default)
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an int") from None
    return max(v, floor)


class TenancyConfig:
    """Parsed tenancy policy (one per process is fine — gates share)."""

    def __init__(
        self,
        weights: dict[str, float] | None = None,
        metric_topn: int | None = None,
        state_cap: int | None = None,
        burst: float | None = None,
        tenant_rps: float | None = None,
    ):
        self.weights = (
            dict(weights) if weights is not None else parse_weight_classes()
        )
        self.weights.setdefault("default", 1.0)
        self.metric_topn = (
            _env_int(_TOPN_ENV, 32) if metric_topn is None else int(metric_topn)
        )
        self.state_cap = (
            _env_int(_STATE_CAP_ENV, 65536)
            if state_cap is None
            else max(int(state_cap), 8)
        )
        if burst is None:
            raw = os.environ.get(_BURST_ENV, "") or "4"
            try:
                burst = float(raw)
            except ValueError:
                raise ValueError(
                    f"{_BURST_ENV}={raw!r} is not a number"
                ) from None
        self.burst = max(float(burst), 1.0)
        if tenant_rps is None:
            raw = os.environ.get(_RPS_ENV, "")
            tenant_rps = float(raw) if raw else None
        self.tenant_rps = tenant_rps

    def weight_of(self, tenant_class: str | None) -> float:
        if tenant_class is None:
            return self.weights["default"]
        return self.weights.get(tenant_class, self.weights["default"])


class TenantLabeler:
    """Bounded-cardinality tenant → metric-label mapping.

    The top-N tenants by (approximate, space-saving-counted) traffic
    earn real labels; everyone else folds into ``__other__``.  Labels
    are STICKY once assigned — at most ``topn`` real label series ever
    exist per family, and a demotion never orphans a series mid-scrape.
    Approximation bias matches the workload: under zipf skew the heavy
    hitters dominate the early counts and claim the slots."""

    def __init__(self, topn: int):
        self.topn = max(int(topn), 1)
        self._cap = 8 * self.topn  # space-saving summary bound
        self._counts: dict[str, int] = {}
        self._labeled: set[str] = set()
        self._lock = threading.Lock()

    def label(self, tenant: str) -> str:
        with self._lock:
            if tenant in self._labeled:
                self._counts[tenant] = self._counts.get(tenant, 0) + 1
                return tenant
            c = self._counts.get(tenant)
            if c is None:
                if len(self._counts) >= self._cap:
                    # space-saving: inherit (and evict) the current
                    # minimum so a late-arriving heavy hitter can still
                    # climb — labeled tenants are never evicted
                    victim = min(
                        (
                            t
                            for t in self._counts
                            if t not in self._labeled
                        ),
                        key=self._counts.__getitem__,
                        default=None,
                    )
                    if victim is None:
                        return OTHER_LABEL
                    c = self._counts.pop(victim)
                else:
                    c = 0
            self._counts[tenant] = c + 1
            if len(self._labeled) < self.topn:
                self._labeled.add(tenant)
                return tenant
            return OTHER_LABEL

    def peek(self, tenant: str) -> str:
        """The label this tenant currently resolves to, WITHOUT counting
        traffic (commit-time metric emission must not double the
        space-saving counts the admission path already charged)."""
        with self._lock:
            return tenant if tenant in self._labeled else OTHER_LABEL

    def labeled(self) -> set[str]:
        with self._lock:
            return set(self._labeled)


class _TenantState:
    __slots__ = ("tokens", "last_refill", "vfinish", "last_seen", "weight")

    def __init__(self, now: float, weight: float, burst: float):
        self.tokens = burst
        self.last_refill = now
        self.vfinish = 0.0
        self.last_seen = now
        self.weight = weight


class TenantLedger:
    """Per-tenant fair-admission state for ONE route (gate or replica).

    ``capacity_rps`` is the endpoint's capacity envelope (usually the
    gate's ``rate_limit_rps``); per-tenant fair share is
    ``capacity * w_i / W_active``.  With no capacity configured (and no
    ``PATHWAY_TENANT_RPS``), the bucket tier is off and fairness acts
    through ordering + queue-full eviction alone."""

    def __init__(
        self,
        config: TenancyConfig,
        route: str = "/",
        capacity_rps: float | None = None,
    ):
        self.config = config
        self.route = route
        # explicit per-tenant rate (PATHWAY_TENANT_RPS, per weight
        # unit) beats the derived fair share when set
        self.capacity_rps = capacity_rps
        self._lock = threading.Lock()
        # insertion/touch order IS the LRU order (move_to_end on every
        # admit), so the state-cap eviction is O(1) — a min() scan over
        # 65536 entries under this lock would serialize the whole
        # route's admission behind it on every tail-tenant arrival
        self._tenants: "OrderedDict[str, _TenantState]" = OrderedDict()
        # exponentially-decayed active weight: W(t) = Σ wᵢ·e^(-(t-sᵢ)/τ)
        # where sᵢ is tenant i's last-seen instant.  Every term decays
        # with the SAME τ, so the aggregate decays uniformly — one
        # multiply per admission keeps it exact, no per-tenant scan,
        # and no cliff at any window boundary.
        self._active_tau = active_tau_s()
        self._active_weight = 0.0
        self._active_at = 0.0  # instant _active_weight was last decayed to
        self._vnow = 0.0
        self._admissions = 0  # deterministic counter the Fault Forge
        # flood= directive charges against (see testing/faults.py)
        self.labeler = TenantLabeler(config.metric_topn)
        from pathway_tpu_torch.observability import REGISTRY
        from pathway_tpu_torch.serving import metrics as _serving_metrics

        # tenant sheds also count on the route-level shed family, so
        # dashboards summing pathway_serving_shed_total see gate- and
        # replica-path tenant sheds alike
        self._m_route_shed = _serving_metrics.shed_counter()

        self._m_admitted = REGISTRY.counter(
            "pathway_tenant_admitted_total",
            "requests admitted past per-tenant fair admission, by route "
            "and tenant (top-N labels; the rest fold into __other__)",
            labelnames=("route", "tenant"),
        )
        self._m_shed = REGISTRY.counter(
            "pathway_tenant_shed_total",
            "requests shed charged to a tenant, by route/tenant/reason "
            "(tenant_rate = over fair share under pressure; tenant_evict "
            "= evicted from a full queue in favor of a colder tenant)",
            labelnames=("route", "tenant", "reason"),
        )
        self._m_wait = REGISTRY.histogram(
            "pathway_tenant_queue_wait_seconds",
            "admission-to-dispatch wait per tenant (top-N labels)",
            labelnames=("route", "tenant"),
        )
        self._m_staleness = REGISTRY.histogram(
            "pathway_tenant_staleness_seconds",
            "staleness of responses served per tenant (top-N labels) — "
            "replicas and cached router answers record here",
            labelnames=("tenant",),
            buckets=(0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0),
        )

    # --- state ------------------------------------------------------------

    def _decay_to(self, now: float) -> None:
        """Uniform exponential decay of the active-weight aggregate:
        every tenant's contribution decays with the same τ, so decaying
        the SUM is exact.  Monotonic time only moves forward; a caller
        -injected older ``now`` (tests) is a no-op."""
        import math

        dt = now - self._active_at
        if dt > 0.0:
            self._active_weight *= math.exp(-dt / self._active_tau)
            self._active_at = now

    def _contribution(self, st: _TenantState, now: float) -> float:
        import math

        idle = max(now - st.last_seen, 0.0)
        return st.weight * math.exp(-idle / self._active_tau)

    def _state(self, tenant: str, weight: float, now: float) -> _TenantState:
        self._decay_to(now)
        st = self._tenants.get(tenant)
        if st is None:
            if len(self._tenants) >= self.config.state_cap:
                # LRU bound: drop the least-recently-seen tenant (a
                # million-tenant population must not grow this dict
                # without bound); its bucket restarts full on return
                _victim, dropped = self._tenants.popitem(last=False)
                self._active_weight = max(
                    0.0,
                    self._active_weight - self._contribution(dropped, now),
                )
            st = _TenantState(now, weight, self.config.burst)
            self._tenants[tenant] = st
            self._active_weight += weight
        else:
            self._tenants.move_to_end(tenant)
            # refresh: replace the tenant's decayed contribution with
            # its full (possibly re-classed) weight — smooth at every
            # idle duration, no boundary to jump at
            self._active_weight += weight - self._contribution(st, now)
            st.weight = weight
            st.last_seen = now
        return st

    def fair_rate(self, weight: float) -> float | None:
        """This tenant's admitted-rate clamp (requests/s), or None when
        no capacity is configured (bucket tier off)."""
        if self.config.tenant_rps is not None:
            return self.config.tenant_rps * weight
        if self.capacity_rps is None:
            return None
        active = max(self._active_weight, weight)
        return self.capacity_rps * weight / active

    # --- admission --------------------------------------------------------

    def admit(
        self,
        tenant: str | None,
        tenant_class: str | None = None,
        now: float | None = None,
        *,
        pressure: bool = True,
        charge_only: bool = False,
    ) -> float:
        """Charge one request to ``tenant`` and return its WFQ
        virtual-finish tag (the micro-batcher's primary order key).

        Raises ``ShedError(429, "tenant_rate")`` when the tenant is
        over its fair share while the endpoint is under pressure.
        ``charge_only`` skips the shed (Fault Forge flood charging:
        drain the bucket + advance virtual time, never raise)."""
        from pathway_tpu_torch.serving.admission import ShedError

        if now is None:
            now = time.monotonic()
        if tenant is None:
            tenant = ""
        weight = self.config.weight_of(tenant_class)
        with self._lock:
            n = 0
            if not charge_only:
                # the REAL-admission counter (synthetic flood charges
                # never advance it, or the flood would feed itself)
                self._admissions += 1
                n = self._admissions
            st = self._state(tenant, weight, now)
            rate = self.fair_rate(weight)
            shed_wait = 0.0
            if rate is not None:
                burst = max(self.config.burst, 1.0)
                st.tokens = min(
                    burst, st.tokens + (now - st.last_refill) * rate
                )
                st.last_refill = now
                if st.tokens >= 1.0:
                    st.tokens -= 1.0
                elif pressure and not charge_only:
                    shed_wait = (1.0 - st.tokens) / max(rate, 1e-9)
                else:
                    st.tokens = max(0.0, st.tokens - 1.0)
            # WFQ virtual time (start-time fair queueing): service one
            # unit costs 1/weight; the floor at vnow — which advances
            # only at DISPATCH (note_dispatched) — keeps an idle tenant
            # from banking credit while letting a fresh tenant's first
            # request order AHEAD of a hot tenant's queued backlog
            vstart = max(self._vnow, st.vfinish)
            st.vfinish = vstart + 1.0 / weight
            tag = st.vfinish
        label = self.labeler.label(tenant)
        if charge_only:
            return tag
        self._apply_flood(n, now)
        if shed_wait > 0.0:
            self._m_shed.labels(self.route, label, "tenant_rate").inc()
            self._m_route_shed.labels(self.route, "tenant_rate").inc()
            raise ShedError(429, "tenant_rate", min(shed_wait, 30.0))
        return tag

    def commit(self, tenant: str | None) -> None:
        """Count one admission AFTER the shared path accepted it — a
        request charged here and then shed as queue_full/concurrency/
        rate_limit was never admitted and must not inflate the
        per-tenant admitted series (callers pair this with
        :meth:`refund` on the shed branch)."""
        label = self.labeler.peek(tenant or "")
        self._m_admitted.labels(self.route, label).inc()

    def refund(
        self,
        tenant: str | None,
        tenant_class: str | None = None,
        tag: float | None = None,
    ) -> None:
        """Compensate an :meth:`admit` charge whose request was then
        shed on the SHARED admission path: it never entered the queue,
        so the tenant gets its fair-share token back and — when no
        later request advanced it further — its WFQ clock rolls back.
        Without this, a tenant retrying into a full queue drains its
        own bucket on requests that were never enqueued and sheds
        ``tenant_rate`` the moment capacity frees."""
        if tenant is None:
            tenant = ""
        weight = self.config.weight_of(tenant_class)
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return
            if self.fair_rate(weight) is not None:
                st.tokens = min(
                    max(self.config.burst, 1.0), st.tokens + 1.0
                )
            if tag is not None and st.vfinish == tag:
                st.vfinish = max(0.0, tag - 1.0 / weight)

    def _apply_flood(self, admission_n: int, now: float) -> None:
        """Fault Forge noisy-neighbor injection: deterministic synthetic
        charges keyed to the admission counter (no wall clock)."""
        from pathway_tpu_torch.testing import faults

        plan = faults.active()
        if plan is None:
            return
        for tenant, cls, rps in plan.flood_charges(admission_n):
            for _ in range(rps):
                self.admit(tenant, cls, now, pressure=True, charge_only=True)

    def note_dispatched(self, order: Any) -> None:
        """Advance virtual time to the newest dispatched request's
        finish tag (the gate calls this per released request).  Tags of
        later arrivals floor here, so a tenant that was idle through a
        busy period cannot claim the virtual past."""
        tag = order[0] if isinstance(order, tuple) else None
        if tag is None:
            return
        with self._lock:
            if tag > self._vnow:
                self._vnow = tag

    # --- queue-full eviction ----------------------------------------------

    def pick_victim(self, queued: list, arriving_tag: float) -> Any:
        """Given the batcher's queued requests, return the one to evict
        in favor of an arrival carrying ``arriving_tag`` — the request
        whose tenant is MOST over its fair share (max virtual-finish
        tag), but only when strictly hotter than the arrival.  None =
        the arrival itself is the hottest; shed it normally."""
        victim = None
        victim_tag = arriving_tag
        for req in queued:
            order = getattr(req, "order", None)
            tag = order[0] if isinstance(order, tuple) else None
            if tag is not None and tag > victim_tag:
                victim, victim_tag = req, tag
        return victim

    # --- metrics hooks ----------------------------------------------------

    def count_evicted(self, tenant: str | None) -> None:
        label = self.labeler.label(tenant or "")
        self._m_shed.labels(self.route, label, "tenant_evict").inc()
        self._m_route_shed.labels(self.route, "tenant_evict").inc()

    def observe_wait(self, tenant: str | None, seconds: float) -> None:
        label = self.labeler.label(tenant or "")
        self._m_wait.labels(self.route, label).observe(max(0.0, seconds))

    def observe_staleness(
        self, tenant: str | None, seconds: float | None
    ) -> None:
        if seconds is None:
            return
        label = self.labeler.label(tenant or "")
        self._m_staleness.labels(label).observe(max(0.0, seconds))

    # --- introspection (tests / debug) ------------------------------------

    @property
    def tracked_tenants(self) -> int:
        with self._lock:
            return len(self._tenants)

    def active_weight(self, now: float | None = None) -> float:
        """The decayed fair-share denominator as of ``now`` (default:
        the monotonic clock) — tests inject times to pin the no-cliff
        contract."""
        with self._lock:
            if now is None:
                now = time.monotonic()
            self._decay_to(now)
            return self._active_weight


def ledger_for(
    qos: Any, route: str = "/", config: TenancyConfig | None = None
) -> TenantLedger | None:
    """The route's tenant ledger when ``PATHWAY_TENANT_QOS=1`` (or an
    explicit config is passed), else None — the total escape hatch:
    a None ledger means not one tenancy branch executes anywhere."""
    if config is None:
        if not tenancy_enabled_via_env():
            return None
        config = TenancyConfig()
    capacity = getattr(qos, "rate_limit_rps", None) if qos is not None else None
    return TenantLedger(config, route=route, capacity_rps=capacity)
