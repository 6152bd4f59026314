"""pw.io — the connectors the port carries: ``pw.io.python`` (a
``ConnectorSubject`` feeding a streaming table) and ``pw.io.subscribe``.
Counterpart of ``pathway_tpu/io/__init__.py``; the file, HTTP and service
connectors are not ported (ROADMAP [connectors]) and raise
``NotImplementedError`` when asked for."""

from __future__ import annotations

from pathway_tpu_torch._unported import CONNECTORS, unported
from pathway_tpu_torch.io import python
from pathway_tpu_torch.io._subscribe import (
    OnChangeCallback,
    OnFinishCallback,
    subscribe,
)

__all__ = ["OnChangeCallback", "OnFinishCallback", "python", "subscribe"]

_REFERENCE_CONNECTORS = {
    "airbyte", "bigquery", "csv", "debezium", "deltalake", "elasticsearch",
    "fs", "gdrive", "http", "iceberg", "jsonlines", "kafka", "logstash",
    "minio", "mongodb", "nats", "null", "plaintext", "postgres", "pubsub",
    "pyfilesystem", "redpanda", "s3", "s3_csv", "sharepoint", "slack",
    "sqlite",
}


def __getattr__(name: str):
    if name in _REFERENCE_CONNECTORS:
        raise unported(f"pw.io.{name}", CONNECTORS)
    raise AttributeError(name)
