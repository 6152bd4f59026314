"""Shared Surge Gate metrics on the port's process-wide registry
(counterpart of ``pathway_tpu/serving/metrics.py``, the same names).
Get-or-create accessors so the gate, the embedder and the KNN index all
record into ONE family (labeled by stage/route) regardless of
construction order."""

from __future__ import annotations

from pathway_tpu_torch.observability import REGISTRY

_OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def shed_counter():
    """Requests refused admission, by route and shed reason."""
    return REGISTRY.counter(
        "pathway_serving_shed_total",
        "requests shed by the Surge Gate, by route and reason "
        "(queue_full, rate_limit, concurrency, draining, shutdown)",
        labelnames=("route", "reason"),
    )


def admitted_counter():
    return REGISTRY.counter(
        "pathway_serving_admitted_total",
        "requests admitted past the Surge Gate, by route",
        labelnames=("route",),
    )


def expired_counter():
    """Admitted work dropped because its deadline passed before the
    stage could run (stage: gate = dropped at flush, never dispatched;
    knn = dropped before the device search)."""
    return REGISTRY.counter(
        "pathway_serving_deadline_expired_total",
        "requests dropped after their deadline expired, by stage",
        labelnames=("stage",),
    )


def queue_depth_gauge():
    return REGISTRY.gauge(
        "pathway_serving_queue_depth",
        "requests admitted but not yet dispatched into the engine, "
        "by route",
        labelnames=("route",),
    )


def inflight_gauge():
    return REGISTRY.gauge(
        "pathway_serving_inflight",
        "requests in flight (admitted, response not yet sent), by route",
        labelnames=("route",),
    )


def queue_wait_histogram():
    return REGISTRY.histogram(
        "pathway_serving_queue_wait_seconds",
        "admission-to-dispatch wait inside the micro-batcher, by route",
        labelnames=("route",),
    )


def batch_rows_histogram():
    return REGISTRY.histogram(
        "pathway_serving_batch_rows",
        "requests released per micro-batch flush, by route",
        labelnames=("route",),
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
    )


def occupancy_histogram():
    """Realized rows / padded bucket rows per device batch. 1.0 = the
    batch exactly filled its bucket; low values = padding waste."""
    return REGISTRY.histogram(
        "pathway_serving_batch_occupancy_ratio",
        "realized batch rows over padded bucket rows, by stage and "
        "bucket size",
        labelnames=("stage", "bucket"),
        buckets=_OCCUPANCY_BUCKETS,
    )
