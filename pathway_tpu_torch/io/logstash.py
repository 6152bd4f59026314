"""Own copy of ``pathway_tpu/io/logstash.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.logstash — sink for the Logstash HTTP input plugin
(upstream Pathway: python/pathway/io/logstash — forwards rows over HTTP)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.io._utils import add_writer, row_dicts


def write(table, endpoint: str, n_retries: int = 0, **kwargs: Any) -> None:
    import time

    import requests

    column_names = table.column_names()
    session = requests.Session()

    def on_batch(t: int, batch: DiffBatch) -> None:
        for _k, d, doc in row_dicts(batch, column_names, t):
            doc["diff"] = d
            doc["time"] = t
            for attempt in range(n_retries + 1):
                try:
                    resp = session.post(endpoint, json=doc, timeout=30)
                    resp.raise_for_status()
                    break
                except requests.RequestException:
                    if attempt == n_retries:
                        raise
                    time.sleep(min(2**attempt * 0.1, 5.0))

    add_writer(table, on_batch)
