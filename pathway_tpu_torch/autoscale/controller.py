"""Own copy of ``pathway_tpu/autoscale/controller.py``: the same journal
kinds and ``pathway_autoscale_*`` metrics.

Flux Pilot controller — the actuation loop between Fleet Lens and
Shard Flux.

``step()`` distills the signal rings into one
:class:`~pathway_tpu_torch.autoscale.policy.PlaneObservation`, asks the pure
policy for a decision, and — for an actionable one — drives exactly one
resize through the plane's actuator.  Actions are strictly serialized
(one in flight; the policy holds behind the in-flight flag), every
decision / actuation / failure lands in the incident journal
(``autoscale-decision`` / ``autoscale-applied`` /
``autoscale-rollback``, all persisted) so chaos benches assert scaling
windows FROM the journal, and the cost proxy
``pathway_autoscale_rank_seconds_total`` integrates ranks over time —
the number the autoscaler exists to beat static provisioning on.

Actuators map the decision onto the resize mechanisms:

* :class:`SupervisorActuator` — ``GroupSupervisor.resize(m, reshard=…)``
  for a supervised engine group; a reshard callback that raises rides
  the supervisor's ``resize-rollback`` path (old size respawns, budget
  untouched) and surfaces here as a failed actuation.
* :class:`ServingPlaneActuator` — ``DeltaStreamServer.reshard(m)`` then
  replica adoption (``ReplicaServer.adopt_shard_map``) then
  ``FailoverRouter.swap_shard_map`` at the commit barrier.
* :class:`CallbackActuator` — any ``fn(m)`` (tests, benches, embedders).

Resize cost is fed back: each actuation's wall time updates an EWMA
that (a) rides every observation (``actuation_cost_s``) and (b)
stretches the predictor horizon, so a plane whose transfers take 40 s
starts scaling 40 s earlier.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

from pathway_tpu_torch.autoscale.policy import (
    DOWN,
    HOLD,
    UP,
    AutoscaleConfig,
    AutoscalePolicy,
    Decision,
    PlaneObservation,
)
from pathway_tpu_torch.autoscale.predictor import LoadForecaster
from pathway_tpu_torch.observability.registry import REGISTRY, MetricsRegistry

_INTERVAL_ENV = "PATHWAY_AUTOSCALE_INTERVAL_MS"


class ActuationError(RuntimeError):
    """A resize the mechanism reported as failed/rolled back."""


# --- actuators --------------------------------------------------------------


class CallbackActuator:
    """``fn(m)`` performs the whole resize; raise to signal rollback."""

    def __init__(self, fn: Callable[[int], Any], label: str = "callback"):
        self._fn = fn
        self.label = label

    def resize(self, m: int) -> Any:
        return self._fn(m)


class SupervisorActuator:
    """Engine-group actuation via ``GroupSupervisor.resize``.

    ``reshard_for(old_n, new_n)`` returns the transfer callback for one
    resize (typically a closure over ``elastic.mesh.reshard_stores``
    with the old/new store roots), or None for log-replay resizes.  The
    supervisor applies the resize at its next poll; we block until the
    group either commits the new size or journals ``resize-rollback``,
    and surface the rollback as :class:`ActuationError` so the
    controller journals it and backs off."""

    def __init__(
        self,
        supervisor: Any,
        reshard_for: Callable[[int, int], Callable[[], Any] | None]
        | None = None,
        *,
        timeout_s: float = 120.0,
        poll_s: float = 0.05,
    ):
        self.supervisor = supervisor
        self.reshard_for = reshard_for
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self.label = "supervisor"

    def resize(self, m: int) -> Any:
        sup = self.supervisor
        old_n = int(sup.n)
        cb = self.reshard_for(old_n, int(m)) if self.reshard_for else None
        mark = len(sup.events)
        sup.resize(int(m), reshard=cb)
        deadline = time.monotonic() + self.timeout_s
        while time.monotonic() < deadline:
            for _ts, kind, detail in sup.events[mark:]:
                if kind == "resize-rollback":
                    raise ActuationError(f"supervisor rollback: {detail}")
                if kind == "group-resize":
                    return {"old": old_n, "new": int(sup.n)}
            time.sleep(self.poll_s)
        raise ActuationError(
            f"resize {old_n} -> {m} not applied within {self.timeout_s}s"
        )


class ServingPlaneActuator:
    """Serving-plane actuation: writer reshard → replica adoption →
    router shard-map swap, in commit order.  ``members_for(m)`` names
    the new shard map (one member list per shard) for the router;
    ``adopt(m)`` performs whatever replica-side adoption the embedder
    wires (spawning members, calling ``adopt_shard_map`` on survivors).
    A raise anywhere leaves the old router map in force — the writer's
    transition guard fences stale members either way."""

    def __init__(
        self,
        writer: Any,
        *,
        router: Any = None,
        members_for: Callable[[int], list] | None = None,
        adopt: Callable[[int], Any] | None = None,
    ):
        self.writer = writer
        self.router = router
        self.members_for = members_for
        self.adopt = adopt
        self.label = "serving"

    def resize(self, m: int) -> Any:
        res = self.writer.reshard(int(m))
        if self.adopt is not None:
            self.adopt(int(m))
        if self.router is not None and self.members_for is not None:
            self.router.swap_shard_map(self.members_for(int(m)))
        return res


# --- controller -------------------------------------------------------------


class AutoscaleController:
    """One plane's control loop.  Drive it with ``step()`` (benches,
    tests) or ``start()`` a thread on the configured cadence."""

    def __init__(
        self,
        actuator: Any,
        *,
        ranks: int,
        config: AutoscaleConfig | None = None,
        policy: AutoscalePolicy | None = None,
        predictor: LoadForecaster | None = None,
        sampler: Any = None,
        interval_s: float | None = None,
        registry: MetricsRegistry = REGISTRY,
    ):
        self.actuator = actuator
        self.config = config or (policy.config if policy else None) or (
            AutoscaleConfig.from_env()
        )
        self.policy = policy or AutoscalePolicy(self.config)
        self.predictor = predictor
        self._sampler = sampler
        self.ranks = int(ranks)
        if interval_s is None:
            try:
                interval_s = (
                    float(os.environ.get(_INTERVAL_ENV, "1000") or 1000)
                    / 1000.0
                )
            except ValueError:
                interval_s = 1.0
        self.interval_s = max(float(interval_s), 0.01)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._in_flight = False
        self._cooldown_until: float | None = None
        self._high_since: float | None = None
        self._drained_since: float | None = None
        self._last_step_mono: float | None = None
        self._last_action: tuple[str, float] | None = None  # (dir, mono)
        self._act_cost_s = 0.0
        self._act_costs = 0
        self.last_decision: Decision | None = None
        self.resizes = 0
        self.registry = registry
        self._m_rank_seconds = registry.counter(
            "pathway_autoscale_rank_seconds_total",
            "rank-seconds provisioned under the autoscaler — the cost "
            "proxy the SCALE bench compares against static provisioning",
        )
        self._m_decisions = registry.counter(
            "pathway_autoscale_decisions_total",
            "policy decisions, by action (hold / up / down)",
            labelnames=("action",),
        )
        self._m_flaps = registry.counter(
            "pathway_autoscale_flaps_total",
            "direction reversals within two cooldown windows of the "
            "previous action — the oscillation the hysteresis bands "
            "exist to prevent",
        )
        self._m_cooldown_holds = registry.counter(
            "pathway_autoscale_cooldown_holds_total",
            "actionable pressure held back by the cooldown lock",
        )
        self._m_rollbacks = registry.counter(
            "pathway_autoscale_rollbacks_total",
            "actuations that failed and rolled back to the old size",
        )
        self._m_ranks = registry.gauge(
            "pathway_autoscale_ranks",
            "current rank count as the controller believes it",
        )
        self._m_ranks.set_function(lambda: self.ranks)

    # --- observation ------------------------------------------------------

    def _burn_now(self) -> float | None:
        sampler = self._sampler
        if sampler is None:
            from pathway_tpu_torch.observability.signals import get_sampler

            sampler = get_sampler()
        if sampler is None:
            return None
        vals = [
            b.get("burn")
            for b in sampler.burn_rates().values()
            if b.get("burn") is not None
        ]
        return max(vals) if vals else None

    def observe(self, now_mono: float | None = None) -> PlaneObservation:
        now = time.monotonic() if now_mono is None else now_mono
        cfg = self.config
        burn = self._burn_now()
        with self._lock:
            if burn is None:
                self._high_since = None
                self._drained_since = None
            else:
                if burn > 1.0:
                    if self._high_since is None:
                        self._high_since = now
                else:
                    self._high_since = None
                if burn <= cfg.low_water:
                    if self._drained_since is None:
                        self._drained_since = now
                else:
                    self._drained_since = None
            high_for = now - self._high_since if self._high_since else 0.0
            drained_for = (
                now - self._drained_since if self._drained_since else 0.0
            )
            cooldown = (
                max(self._cooldown_until - now, 0.0)
                if self._cooldown_until is not None
                else 0.0
            )
            in_flight = self._in_flight
            act_cost = self._act_cost_s
        predicted = None
        if self.predictor is not None and burn is not None:
            self.predictor.observe(now, burn)
            # lead the surge by at least one actuation: a plane whose
            # transfers take 40 s must start scaling 40 s earlier
            horizon = max(cfg.horizon_s, act_cost)
            predicted = self.predictor.forecast(horizon, now)
        return PlaneObservation(
            mono=now,
            ranks=self.ranks,
            max_burn=burn,
            burn_high_for_s=high_for,
            drained_for_s=drained_for,
            predicted_burn=predicted,
            cooldown_remaining_s=cooldown,
            action_in_flight=in_flight,
            actuation_cost_s=act_cost,
        )

    # --- the loop body ----------------------------------------------------

    def step(self, now_mono: float | None = None) -> Decision:
        from pathway_tpu_torch.observability.journal import record as journal_record

        now = time.monotonic() if now_mono is None else now_mono
        with self._lock:
            if self._last_step_mono is not None:
                dt = max(now - self._last_step_mono, 0.0)
                if dt:
                    self._m_rank_seconds.inc(self.ranks * dt)
            self._last_step_mono = now
        obs = self.observe(now)
        decision = self.policy.decide(obs)
        self.last_decision = decision
        self._m_decisions.labels(decision.action).inc()
        if not decision.actionable:
            if "cooldown" in decision.reason and (
                (obs.max_burn or 0.0) > 1.0
                or obs.drained_for_s >= self.config.down_window_s
            ):
                self._m_cooldown_holds.inc()
            return decision

        old = self.ranks
        journal_record(
            "autoscale-decision",
            f"{decision.action} {old} -> {decision.target_ranks}: "
            f"{decision.reason}",
            persist=True,
            action=decision.action,
            from_ranks=old,
            to_ranks=decision.target_ranks,
            max_burn=obs.max_burn,
            predicted_burn=obs.predicted_burn,
        )
        with self._lock:
            self._in_flight = True
        t0 = time.monotonic()
        try:
            self.actuator.resize(decision.target_ranks)
        except Exception as e:
            self._m_rollbacks.inc()
            journal_record(
                "autoscale-rollback",
                f"{decision.action} {old} -> {decision.target_ranks} "
                f"failed ({type(e).__name__}: {e}); staying at {old}",
                persist=True,
                action=decision.action,
                from_ranks=old,
                to_ranks=decision.target_ranks,
            )
            with self._lock:
                self._in_flight = False
                # lock out retries for a cooldown: a failing transfer
                # must not be hammered.  `now` (not the wall thread
                # clock) so virtual-time drivers stay consistent
                self._cooldown_until = now + self.config.cooldown_s
            return decision
        seconds = time.monotonic() - t0
        with self._lock:
            self._in_flight = False
            self.ranks = decision.target_ranks
            self.resizes += 1
            self._act_costs += 1
            self._act_cost_s = (
                seconds
                if self._act_costs == 1
                else 0.7 * self._act_cost_s + 0.3 * seconds
            )
            self._cooldown_until = now + self.config.cooldown_s
            # the burn history predates the new topology: restart the
            # duration markers instead of acting on stale windows
            self._high_since = None
            self._drained_since = None
            if (
                self._last_action is not None
                and self._last_action[0] != decision.action
                and now - self._last_action[1]
                < 2.0 * self.config.cooldown_s + 1e-9
            ):
                self._m_flaps.inc()
            self._last_action = (decision.action, now)
        journal_record(
            "autoscale-applied",
            f"{decision.action} {old} -> {decision.target_ranks} in "
            f"{seconds:.3f}s",
            persist=True,
            action=decision.action,
            from_ranks=old,
            to_ranks=decision.target_ranks,
            seconds=seconds,
        )
        return decision

    # --- thread driver ----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:
                pass

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pathway-autoscale", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # --- introspection (/debug/autoscale, plane doctor) -------------------

    def status(self) -> dict:
        cfg = self.config
        with self._lock:
            cooldown = (
                max(self._cooldown_until - time.monotonic(), 0.0)
                if self._cooldown_until is not None
                else 0.0
            )
            d = self.last_decision
            return {
                "armed": True,
                "running": self._thread is not None
                and self._thread.is_alive(),
                "ranks": self.ranks,
                "resizes": self.resizes,
                "in_flight": self._in_flight,
                "cooldown_remaining_s": round(cooldown, 3),
                "actuation_cost_s": round(self._act_cost_s, 4),
                "actuator": getattr(self.actuator, "label", "custom"),
                "predictor": (
                    self.predictor.state()
                    if self.predictor is not None
                    else None
                ),
                "config": {
                    "min_ranks": cfg.min_ranks,
                    "max_ranks": cfg.max_ranks,
                    "up_window_s": cfg.up_window_s,
                    "down_window_s": cfg.down_window_s,
                    "cooldown_s": cfg.cooldown_s,
                    "low_water": cfg.low_water,
                    "step": cfg.step,
                    "horizon_s": cfg.horizon_s,
                },
                "last_decision": (
                    None
                    if d is None
                    else {
                        "action": d.action,
                        "target_ranks": d.target_ranks,
                        "reason": d.reason,
                    }
                ),
            }


# --- process-global controller ---------------------------------------------

_controller: AutoscaleController | None = None
_controller_lock = threading.Lock()


def arm_controller(
    actuator: Any, *, ranks: int, start: bool = False, **kw: Any
) -> AutoscaleController:
    """Create the process-global controller (the one the plane doctor's
    ``autoscale-coverage`` rule and ``/debug/autoscale`` see)."""
    global _controller
    with _controller_lock:
        if _controller is not None:
            _controller.stop()
        _controller = AutoscaleController(actuator, ranks=ranks, **kw)
    if start:
        _controller.start()
    return _controller


def get_controller() -> AutoscaleController | None:
    return _controller


def reset_controller() -> None:
    """Test hook: stop and forget the process-global controller."""
    global _controller
    with _controller_lock:
        if _controller is not None:
            try:
                _controller.stop()
            except Exception:
                pass
        _controller = None
