"""pathway_tpu_torch.autoscale — own copy of ``pathway_tpu/autoscale/``.

Flux Pilot — the SLO-driven autoscaler that closes the control loop
over Shard Flux.

Fleet Lens (observability/signals.py) answers "what has the plane been
doing"; Shard Flux (parallel/supervisor.py ``resize``, parallel/
replicate.py ``DeltaStreamServer.reshard``, serving/router.py
``swap_shard_map``) makes rank/shard count a live knob.  This package
is the policy plane between them:

* :mod:`~pathway_tpu_torch.autoscale.policy` — hysteresis decisions as a pure
  function of one :class:`PlaneObservation` snapshot (asymmetric
  up/down windows, low-water drain mark, cooldown lock, min/max rank
  bounds).
* :mod:`~pathway_tpu_torch.autoscale.predictor` — a short-horizon load
  forecaster (EWMA level+trend with an optional diurnal phase profile)
  so scale-up fires *ahead* of a modeled surge, not after the shed.
* :mod:`~pathway_tpu_torch.autoscale.controller` — the actuation loop:
  serialized resizes against the existing mechanisms, every decision /
  actuation / rollback journaled (``autoscale-decision`` /
  ``autoscale-applied`` / ``autoscale-rollback``), and the
  ``pathway_autoscale_rank_seconds_total`` cost proxy.
"""

from pathway_tpu_torch.autoscale.controller import (
    AutoscaleController,
    CallbackActuator,
    ServingPlaneActuator,
    SupervisorActuator,
    arm_controller,
    get_controller,
    reset_controller,
)
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

__all__ = [
    "AutoscaleConfig",
    "AutoscaleController",
    "AutoscalePolicy",
    "CallbackActuator",
    "Decision",
    "DOWN",
    "HOLD",
    "LoadForecaster",
    "PlaneObservation",
    "ServingPlaneActuator",
    "SupervisorActuator",
    "UP",
    "arm_controller",
    "get_controller",
    "reset_controller",
]
