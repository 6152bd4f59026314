"""pw.io — the connectors the port carries: the file connectors ``pw.io.fs``,
``csv``, ``jsonlines``, ``plaintext`` and ``null`` (with offsets the
persistence glue seeks), ``pw.io.python`` (a ``ConnectorSubject`` feeding a
streaming table), ``pw.io.http`` (the REST connector and the HTTP client) and
``pw.io.subscribe``. Counterpart of ``pathway_tpu/io/__init__.py``; the
service connectors are not ported (ROADMAP [connectors]) and raise
``NotImplementedError`` when asked for."""

from __future__ import annotations

from pathway_tpu_torch._unported import CONNECTORS, unported
from pathway_tpu_torch.io import csv, fs, http, jsonlines, null, plaintext, python
from pathway_tpu_torch.io._subscribe import (
    OnChangeCallback,
    OnFinishCallback,
    subscribe,
)
from pathway_tpu_torch.io.csv import CsvParserSettings

__all__ = [
    "CsvParserSettings",
    "OnChangeCallback",
    "OnFinishCallback",
    "csv",
    "fs",
    "http",
    "jsonlines",
    "null",
    "plaintext",
    "python",
    "subscribe",
]

_REFERENCE_CONNECTORS = {
    "airbyte", "bigquery", "debezium", "deltalake", "elasticsearch",
    "gdrive", "iceberg", "kafka", "logstash", "minio", "mongodb", "nats",
    "postgres", "pubsub", "pyfilesystem", "redpanda", "s3", "s3_csv",
    "sharepoint", "slack", "sqlite",
}


def __getattr__(name: str):
    if name in _REFERENCE_CONNECTORS:
        raise unported(f"pw.io.{name}", CONNECTORS)
    raise AttributeError(name)
