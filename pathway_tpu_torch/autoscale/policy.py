"""Own copy of ``pathway_tpu/autoscale/policy.py``: the same decisions on the
same observations.

Flux Pilot policy — every scaling decision is a pure function of one
:class:`PlaneObservation` snapshot.

The controller (controller.py) reads the Fleet Lens rings and distills
them into an observation; :meth:`AutoscalePolicy.decide` maps that
observation to exactly one :class:`Decision`.  Nothing here touches a
clock, the environment, a sampler, or a journal — the no-flap /
no-down-under-burn properties are checkable by brute force over
synthetic observations (tests/test_autoscale.py).

Hysteresis is asymmetric by design:

* **Scale up** when the worst SLO burn has been above 1.0 continuously
  for ``up_window_s`` — or immediately when the predictor's forecast
  burn crosses 1.0 (capacity must be ready *before* the surge the
  forecast models, which is why the controller stretches the forecast
  horizon to cover the observed actuation cost).
* **Scale down** only when the plane has been drained — worst burn at
  or below ``low_water`` (strictly inside the up threshold, so the two
  bands never touch) — continuously for the much longer
  ``down_window_s``, and no forecast predicts a surge.  A scale-down
  NEVER fires while any SLO burn exceeds 1.0.
* A ``cooldown_s`` lock after every actuation (applied or rolled back)
  bounds the decision rate regardless of how the signals oscillate.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

HOLD = "hold"
UP = "up"
DOWN = "down"

_MIN_ENV = "PATHWAY_AUTOSCALE_MIN_RANKS"
_MAX_ENV = "PATHWAY_AUTOSCALE_MAX_RANKS"
_UP_WINDOW_ENV = "PATHWAY_AUTOSCALE_UP_WINDOW_S"
_DOWN_WINDOW_ENV = "PATHWAY_AUTOSCALE_DOWN_WINDOW_S"
_COOLDOWN_ENV = "PATHWAY_AUTOSCALE_COOLDOWN_S"
_LOW_WATER_ENV = "PATHWAY_AUTOSCALE_LOW_WATER"
_STEP_ENV = "PATHWAY_AUTOSCALE_STEP"
_HORIZON_ENV = "PATHWAY_AUTOSCALE_HORIZON_S"


def _env_float(env: dict, name: str, default: float) -> float:
    raw = env.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(env: dict, name: str, default: int) -> int:
    raw = env.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


@dataclass(frozen=True)
class AutoscaleConfig:
    """The ``PATHWAY_AUTOSCALE_*`` knob family, resolved once."""

    min_ranks: int = 1
    max_ranks: int = 4
    up_window_s: float = 15.0
    down_window_s: float = 120.0
    cooldown_s: float = 60.0
    #: drain threshold as a burn fraction — strictly below the 1.0 up
    #: threshold so the hysteresis band has width
    low_water: float = 0.5
    step: int = 1
    #: minimum forecast lead; the controller stretches it to cover the
    #: observed actuation cost so capacity lands before the surge
    horizon_s: float = 30.0

    @classmethod
    def from_env(cls, env: dict | None = None) -> "AutoscaleConfig":
        env = dict(os.environ) if env is None else env
        return cls(
            min_ranks=max(_env_int(env, _MIN_ENV, 1), 1),
            max_ranks=max(_env_int(env, _MAX_ENV, 4), 1),
            up_window_s=max(_env_float(env, _UP_WINDOW_ENV, 15.0), 0.0),
            down_window_s=max(_env_float(env, _DOWN_WINDOW_ENV, 120.0), 0.0),
            cooldown_s=max(_env_float(env, _COOLDOWN_ENV, 60.0), 0.0),
            low_water=min(
                max(_env_float(env, _LOW_WATER_ENV, 0.5), 0.0), 0.99
            ),
            step=max(_env_int(env, _STEP_ENV, 1), 1),
            horizon_s=max(_env_float(env, _HORIZON_ENV, 30.0), 0.0),
        )


@dataclass(frozen=True)
class PlaneObservation:
    """One instant of the plane as the policy sees it — the controller
    assembles it from the signal rings, its own duration markers, and
    the predictor.  ``max_burn`` is the worst burn rate across every
    declared ``PATHWAY_SLO_*`` target (None = no target has data yet:
    the policy holds, it never acts blind)."""

    mono: float
    ranks: int
    max_burn: float | None
    #: continuous seconds max_burn has been > 1.0 (0 when it is not)
    burn_high_for_s: float = 0.0
    #: continuous seconds max_burn has been <= low_water (0 otherwise)
    drained_for_s: float = 0.0
    #: forecast worst burn at the controller's horizon, if a predictor
    #: is armed
    predicted_burn: float | None = None
    cooldown_remaining_s: float = 0.0
    action_in_flight: bool = False
    #: EWMA of observed resize wall time (elastic feedback) — carried in
    #: the observation so decisions can be replayed from journal data
    actuation_cost_s: float = 0.0


@dataclass(frozen=True)
class Decision:
    action: str  # HOLD | UP | DOWN
    target_ranks: int
    reason: str

    @property
    def actionable(self) -> bool:
        return self.action != HOLD


class AutoscalePolicy:
    """Pure hysteresis controller.  ``decide`` never mutates state and
    consults nothing but the observation and the frozen config."""

    def __init__(self, config: AutoscaleConfig | None = None):
        self.config = config or AutoscaleConfig.from_env()

    def decide(self, obs: PlaneObservation) -> Decision:
        cfg = self.config
        ranks = int(obs.ranks)
        if obs.action_in_flight:
            return Decision(HOLD, ranks, "actuation in flight")
        if obs.cooldown_remaining_s > 0.0:
            return Decision(
                HOLD,
                ranks,
                f"cooldown ({obs.cooldown_remaining_s:.1f}s remaining)",
            )
        if cfg.min_ranks >= cfg.max_ranks:
            return Decision(
                HOLD, ranks, "min_ranks == max_ranks (pinned by config)"
            )
        if obs.max_burn is None:
            return Decision(HOLD, ranks, "no SLO burn data")

        sustained_up = (
            obs.max_burn > 1.0 and obs.burn_high_for_s >= cfg.up_window_s
        )
        predicted_up = (
            obs.predicted_burn is not None and obs.predicted_burn > 1.0
        )
        if sustained_up or predicted_up:
            if ranks >= cfg.max_ranks:
                return Decision(HOLD, ranks, "burning but at max_ranks")
            target = min(ranks + cfg.step, cfg.max_ranks)
            why = (
                f"burn {obs.max_burn:.2f} > 1.0 for "
                f"{obs.burn_high_for_s:.1f}s"
                if sustained_up
                else f"predicted burn {obs.predicted_burn:.2f} > 1.0"
            )
            return Decision(UP, target, why)

        # the hard guard: a scale-down is structurally impossible while
        # any SLO burn exceeds 1.0, whatever the duration markers claim
        drained = (
            obs.max_burn < 1.0
            and obs.max_burn <= cfg.low_water
            and obs.drained_for_s >= cfg.down_window_s
            and (
                obs.predicted_burn is None
                or obs.predicted_burn <= cfg.low_water
            )
        )
        if drained:
            if ranks <= cfg.min_ranks:
                return Decision(HOLD, ranks, "drained but at min_ranks")
            target = max(ranks - cfg.step, cfg.min_ranks)
            return Decision(
                DOWN,
                target,
                f"burn {obs.max_burn:.2f} <= low-water {cfg.low_water:g} "
                f"for {obs.drained_for_s:.1f}s",
            )
        return Decision(HOLD, ranks, "inside hysteresis band")
