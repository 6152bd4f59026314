"""pw.io — every connector of ``pathway_tpu/io/__init__.py``: the file
connectors ``pw.io.fs``, ``csv``, ``jsonlines``, ``plaintext`` and ``null``,
``pw.io.python`` (a ``ConnectorSubject`` feeding a streaming table),
``pw.io.http`` (the REST connector and the HTTP client), ``pw.io.subscribe``
and the service connectors (sqlite, debezium, kafka/redpanda, nats,
postgres, the sinks, s3/minio, deltalake, iceberg and the source readers).
Each service connector imports its client library, pyarrow or fsspec inside
the call that needs it, never here."""

from __future__ import annotations

from pathway_tpu_torch.io import (
    airbyte,
    bigquery,
    csv,
    debezium,
    deltalake,
    elasticsearch,
    fs,
    gdrive,
    http,
    iceberg,
    jsonlines,
    kafka,
    logstash,
    minio,
    mongodb,
    nats,
    null,
    plaintext,
    postgres,
    pubsub,
    pyfilesystem,
    python,
    redpanda,
    s3,
    s3_csv,
    sharepoint,
    slack,
    sqlite,
)
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
    "airbyte",
    "bigquery",
    "csv",
    "debezium",
    "deltalake",
    "elasticsearch",
    "fs",
    "gdrive",
    "http",
    "iceberg",
    "jsonlines",
    "kafka",
    "logstash",
    "minio",
    "mongodb",
    "nats",
    "null",
    "plaintext",
    "postgres",
    "pubsub",
    "pyfilesystem",
    "python",
    "redpanda",
    "s3",
    "s3_csv",
    "sharepoint",
    "slack",
    "sqlite",
    "subscribe",
]
