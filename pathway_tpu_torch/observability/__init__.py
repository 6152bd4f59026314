"""pathway_tpu_torch.observability — counterpart of
``pathway_tpu/observability``: one process-wide ``REGISTRY`` (same metric
names, help strings and labels as the reference), the Prometheus exposition
parser/validator, the span tracer, the incident journal, Tick Scope's
memory ledger and roofline, and the torch/CUDA gauges.

Not ported yet: the monitoring server and debug surfaces
(``observability/debug.py``), the SLO signal rings, fleet federation, the
per-tick flight recorder and the JAX gauges' compile events (the port counts
its kernel builds instead).
"""

from pathway_tpu_torch.observability.exposition import (
    parse_exposition,
    validate_exposition,
)
from pathway_tpu_torch.observability.journal import journal, record, reset_journal
from pathway_tpu_torch.observability.registry import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    log_linear_buckets,
)
from pathway_tpu_torch.observability.torch_metrics import install_torch_metrics
from pathway_tpu_torch.observability.tracing import (
    SpanContext,
    Tracer,
    get_tracer,
    parse_traceparent,
    validate_chrome_trace,
)

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanContext",
    "Tracer",
    "get_registry",
    "get_tracer",
    "install_torch_metrics",
    "journal",
    "log_linear_buckets",
    "parse_exposition",
    "parse_traceparent",
    "record",
    "reset_journal",
    "validate_chrome_trace",
    "validate_exposition",
]
