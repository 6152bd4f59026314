"""pw.io — the connectors the port carries: ``pw.io.python`` (a
``ConnectorSubject`` feeding a streaming table), ``pw.io.http`` (the REST
connector and the HTTP client) and ``pw.io.subscribe``. Counterpart of
``pathway_tpu/io/__init__.py``; the file and service connectors are not
ported (ROADMAP [connectors]) and raise ``NotImplementedError`` when asked
for."""

from __future__ import annotations

from pathway_tpu_torch._unported import CONNECTORS, unported
from pathway_tpu_torch.io import http, python
from pathway_tpu_torch.io._subscribe import (
    OnChangeCallback,
    OnFinishCallback,
    subscribe,
)

__all__ = ["OnChangeCallback", "OnFinishCallback", "http", "python", "subscribe"]

_REFERENCE_CONNECTORS = {
    "airbyte", "bigquery", "csv", "debezium", "deltalake", "elasticsearch",
    "fs", "gdrive", "iceberg", "jsonlines", "kafka", "logstash",
    "minio", "mongodb", "nats", "null", "plaintext", "postgres", "pubsub",
    "pyfilesystem", "redpanda", "s3", "s3_csv", "sharepoint", "slack",
    "sqlite",
}


def __getattr__(name: str):
    if name in _REFERENCE_CONNECTORS:
        raise unported(f"pw.io.{name}", CONNECTORS)
    raise AttributeError(name)
