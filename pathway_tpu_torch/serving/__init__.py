"""Surge Gate: the serving QoS subsystem — dynamic micro-batching,
deadline-aware admission control and graceful overload/drain for the
REST serving path (counterpart of ``pathway_tpu/serving``).

Layering: ``io/http`` (ingress) builds a ``SurgeGate`` per endpoint when
``rest_connector(..., qos=QoSConfig(...))`` is passed (or
``PATHWAY_SERVING_ENABLED=1``); the gate feeds the engine's
``InputSession`` in bucketed releases; ``engine/index_node`` consults
:mod:`pathway_tpu_torch.serving.deadline` so expired work is dropped
before it reaches the device search. The generation scheduler uses the
``MicroBatcher`` and ``QoSConfig`` too. Everything here is stdlib-only —
safe to import from the engine layer.
"""

from pathway_tpu_torch._unported import REPLICATION, unported
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

# the reference resolves these lazily from serving/{replica,router,
# result_cache}.py; the replicated read plane is not ported, so asking
# for one raises naming its ROADMAP item
_LAZY = {
    "ReplicaServer": "serving/replica.py",
    "FailoverRouter": "serving/router.py",
    "ResultCache": "serving/result_cache.py",
}


def __getattr__(name: str):
    if name in _LAZY:
        raise unported(f"serving.{name} ({_LAZY[name]})", REPLICATION)
    raise AttributeError(name)


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
