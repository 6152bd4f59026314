"""HTTP client connector: poll/stream an endpoint into a table; write rows
out as HTTP requests — the port's copy of ``pathway_tpu/io/http/_client.py``.
``requests`` is imported only when a request is sent. Each poll's rows are
committed together, so they reach the engine in one tick at once (the
reference's ``next`` has no commit to wait for)."""

from __future__ import annotations

import json as _json
import time
from typing import Any, Sequence

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import OutputNode
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read


def read(
    url: str,
    *,
    schema: Any = None,
    method: str = "GET",
    payload: Any = None,
    headers: dict[str, str] | None = None,
    format: str = "json",
    refresh_interval_ms: int = 10000,
    n_retries: int = 0,
    mode: str = "streaming",
    **kwargs: Any,
) -> Table:
    if schema is None:
        schema = schema_from_types(data=bytes)

    class HttpSubject(ConnectorSubject):
        def run(self) -> None:
            import requests

            while True:
                try:
                    resp = requests.request(
                        method, url, json=payload, headers=headers, timeout=30
                    )
                    if format == "json":
                        data = resp.json()
                        rows = data if isinstance(data, list) else [data]
                        for row in rows:
                            self.next(**row)
                    else:
                        self.next(data=resp.content)
                except Exception:
                    pass
                self.commit()
                if mode == "static":
                    break
                time.sleep(refresh_interval_ms / 1000.0)

    return python_read(HttpSubject(), schema=schema)


def write(
    table: Table,
    url: str,
    *,
    method: str = "POST",
    format: str = "json",
    request_payload_template: Any = None,
    n_retries: int = 0,
    headers: dict[str, str] | None = None,
    **kwargs: Any,
) -> None:
    col_names = table.column_names()

    def on_batch(t: int, batch: DiffBatch) -> None:
        import requests

        for k, d, vals in batch.iter_rows():
            if d <= 0:
                continue
            payload = dict(zip(col_names, vals))
            for attempt in range(n_retries + 1):
                try:
                    requests.request(
                        method, url, json=payload, headers=headers, timeout=30
                    )
                    break
                except Exception:
                    if attempt == n_retries:
                        pass

    node = OutputNode(table._node, on_batch)
    parse_graph.G.add_output(node)
