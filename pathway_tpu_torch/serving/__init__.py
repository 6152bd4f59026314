"""pathway_tpu_torch.serving — the serving QoS pieces the generation
scheduler needs (counterpart of ``pathway_tpu/serving``): ``QoSConfig`` with
its ``PATHWAY_SERVING_*`` overrides and pad ladder, the EDF ``MicroBatcher``,
and the ``ShedError``/``DeadlineExceeded`` refusals. The REST gate, the
admission controller, tenancy, the replica and the router are not ported
yet."""

from pathway_tpu_torch.serving.admission import DeadlineExceeded, ShedError
from pathway_tpu_torch.serving.batcher import MicroBatcher
from pathway_tpu_torch.serving.config import QoSConfig, default_bucket_ladder

__all__ = [
    "DeadlineExceeded",
    "ShedError",
    "MicroBatcher",
    "QoSConfig",
    "default_bucket_ladder",
]
