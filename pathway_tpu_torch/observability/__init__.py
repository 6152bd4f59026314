"""pathway_tpu_torch.observability — counterpart of
``pathway_tpu/observability``: one process-wide ``REGISTRY`` (same metric
names, help strings and labels as the reference), the Prometheus exposition
parser/validator, the span tracer, the incident journal, Tick Scope (the
per-tick flight recorder, memory ledger and roofline), the debug surfaces
(thread dumps, graph tables, torch.profiler captures), the SLO signal rings
with their burn rates, fleet federation, and the torch/CUDA gauges. The
monitoring server that serves them is ``internals/monitoring_server.py``.

The JAX gauges' compile events have no counterpart (the port counts its
kernel builds instead; ``install_jax_metrics`` is ``install_torch_metrics``
here).
"""

from pathway_tpu_torch.observability.debug import (
    ProfilerUnavailable,
    graph_table,
    take_profile,
)
from pathway_tpu_torch.observability.exposition import (
    parse_exposition,
    validate_exposition,
)
from pathway_tpu_torch.observability.journal import (
    IncidentJournal,
    JournalEvent,
    install_crash_hooks,
    journal,
    record,
    reset_journal,
    thread_stack_dump,
)
from pathway_tpu_torch.observability.registry import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    escape_label_value,
    get_registry,
    log_linear_buckets,
    sanitize_metric_name,
)
from pathway_tpu_torch.observability.fleet import (
    federate_events,
    federate_metrics,
    federate_ticks,
    members_from_env,
    stitch_traces,
    window_from_events,
)
from pathway_tpu_torch.observability.signals import (
    SignalRing,
    SignalSampler,
    arm_sampler,
    get_sampler,
    reset_sampler,
    slo_targets,
)
from pathway_tpu_torch.observability.tickscope import (
    Roofline,
    TickScope,
    coverage_status,
    critical_path,
    estimate_program_cost,
    memory_snapshot,
    peak_flops,
    recorder,
    register_memory_provider,
    roofline,
    stitch_ranks,
    wire_snapshot,
)
from pathway_tpu_torch.observability.torch_metrics import install_torch_metrics
from pathway_tpu_torch.observability.tracing import (
    SpanContext,
    Tracer,
    current_traceparent,
    get_tracer,
    otel_sdk_provider_active,
    parse_traceparent,
    validate_chrome_trace,
)

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "IncidentJournal",
    "JournalEvent",
    "MetricsRegistry",
    "ProfilerUnavailable",
    "Roofline",
    "SignalRing",
    "SignalSampler",
    "SpanContext",
    "TickScope",
    "Tracer",
    "arm_sampler",
    "coverage_status",
    "critical_path",
    "current_traceparent",
    "escape_label_value",
    "estimate_program_cost",
    "federate_events",
    "federate_metrics",
    "federate_ticks",
    "get_registry",
    "get_sampler",
    "get_tracer",
    "graph_table",
    "install_crash_hooks",
    "install_torch_metrics",
    "journal",
    "log_linear_buckets",
    "members_from_env",
    "memory_snapshot",
    "otel_sdk_provider_active",
    "parse_exposition",
    "parse_traceparent",
    "peak_flops",
    "record",
    "recorder",
    "register_memory_provider",
    "reset_journal",
    "reset_sampler",
    "roofline",
    "sanitize_metric_name",
    "slo_targets",
    "stitch_ranks",
    "stitch_traces",
    "take_profile",
    "thread_stack_dump",
    "validate_chrome_trace",
    "validate_exposition",
    "window_from_events",
    "wire_snapshot",
]
