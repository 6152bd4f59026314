"""Own copy of ``pathway_tpu/io/pubsub.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.pubsub — Google Cloud Pub/Sub sink
(upstream Pathway: python/pathway/io/pubsub). Requires google-cloud-pubsub at
call time."""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.io._utils import add_writer, require, row_dicts


def write(table, publisher: Any = None, project_id: str | None = None,
          topic_id: str | None = None, **kwargs: Any) -> None:
    if publisher is None:
        pubsub = require("google.cloud.pubsub_v1", "pubsub")
        publisher = pubsub.PublisherClient()
    topic_path = publisher.topic_path(project_id, topic_id)
    column_names = table.column_names()

    def on_batch(t: int, batch: DiffBatch) -> None:
        futures = []
        for k, d, doc in row_dicts(batch, column_names, t):
            futures.append(
                publisher.publish(
                    topic_path,
                    _json.dumps(doc).encode(),
                    pathway_time=str(t),
                    pathway_diff=str(d),
                    pathway_key=f"{k:016x}",
                )
            )
        for f in futures:
            f.result(timeout=60)

    add_writer(table, on_batch)
