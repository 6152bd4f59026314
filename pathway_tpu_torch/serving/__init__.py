"""Surge Gate: the serving QoS subsystem — dynamic micro-batching,
deadline-aware admission control and graceful overload/drain for the
REST serving path, and the replicated read plane's replica, failover
router and result cache (counterpart of ``pathway_tpu/serving``).

Layering: ``io/http`` (ingress) builds a ``SurgeGate`` per endpoint when
``rest_connector(..., qos=QoSConfig(...))`` is passed (or
``PATHWAY_SERVING_ENABLED=1``); the gate feeds the engine's
``InputSession`` in bucketed releases; ``engine/index_node`` consults
:mod:`pathway_tpu_torch.serving.deadline` so expired work is dropped
before it reaches the device search. The generation scheduler uses the
``MicroBatcher`` and ``QoSConfig`` too. Everything here is stdlib-only —
safe to import from the engine layer.
"""

from pathway_tpu_torch.serving.admission import (
    AdmissionController,
    DeadlineExceeded,
    ShedError,
    TokenBucket,
)
from pathway_tpu_torch.serving.batcher import MicroBatcher
from pathway_tpu_torch.serving.config import (
    QoSConfig,
    default_bucket_ladder,
    serving_enabled_via_env,
)
from pathway_tpu_torch.serving.gate import (
    PendingRequest,
    SurgeGate,
    drain_all,
    gates,
)
from pathway_tpu_torch.serving import degrade
from pathway_tpu_torch.serving.tenancy import (
    TenancyConfig,
    TenantLabeler,
    TenantLedger,
    parse_weight_classes,
    tenancy_enabled_via_env,
)

# Replica Shield (serving/replica.py, serving/router.py) is NOT eagerly
# imported: the replica/router roles pull the replication wire and the
# HTTP client, which the engine layer (which imports this package on
# every run) never needs.  They resolve lazily, as in the reference.
_LAZY = {
    "ReplicaServer": ("pathway_tpu_torch.serving.replica", "ReplicaServer"),
    "FailoverRouter": ("pathway_tpu_torch.serving.router", "FailoverRouter"),
    "ResultCache": ("pathway_tpu_torch.serving.result_cache", "ResultCache"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(target[0]), target[1])


__all__ = [
    "FailoverRouter",
    "ReplicaServer",
    "ResultCache",
    "TenancyConfig",
    "TenantLabeler",
    "TenantLedger",
    "parse_weight_classes",
    "tenancy_enabled_via_env",
    "AdmissionController",
    "DeadlineExceeded",
    "MicroBatcher",
    "PendingRequest",
    "QoSConfig",
    "ShedError",
    "SurgeGate",
    "TokenBucket",
    "default_bucket_ladder",
    "degrade",
    "drain_all",
    "gates",
    "serving_enabled_via_env",
]
