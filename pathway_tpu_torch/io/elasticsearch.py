"""Own copy of ``pathway_tpu/io/elasticsearch.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.elasticsearch — Elasticsearch sink via the REST bulk API.

Counterpart of upstream Pathway's ElasticSearchWriter
(upstream Pathway: src/connectors/data_storage.rs:1451). Speaks the `_bulk`
HTTP/JSON protocol directly with `requests`, so no elasticsearch client
package is needed: +1 diffs become `index` actions keyed by the row key,
-1 diffs become `delete` actions.
"""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.io._utils import add_writer, row_dicts


class ElasticSearchAuth:
    def __init__(self, kind: str, **kw: Any):
        self.kind = kind
        self.kw = kw

    @classmethod
    def basic(cls, username: str, password: str) -> "ElasticSearchAuth":
        return cls("basic", username=username, password=password)

    @classmethod
    def apikey(cls, api_key_id: str, api_key: str) -> "ElasticSearchAuth":
        return cls("apikey", api_key_id=api_key_id, api_key=api_key)

    def apply(self, session) -> None:
        if self.kind == "basic":
            session.auth = (self.kw["username"], self.kw["password"])
        elif self.kind == "apikey":
            import base64

            token = base64.b64encode(
                f"{self.kw['api_key_id']}:{self.kw['api_key']}".encode()
            ).decode()
            session.headers["Authorization"] = f"ApiKey {token}"


def write(
    table,
    host: str,
    auth: ElasticSearchAuth | None = None,
    index_name: str = "pathway",
    *,
    max_batch_size: int | None = None,
    **kwargs: Any,
) -> None:
    import requests

    column_names = table.column_names()
    session = requests.Session()
    if auth is not None:
        auth.apply(session)

    def on_batch(t: int, batch: DiffBatch) -> None:
        lines: list[str] = []
        for k, d, doc in row_dicts(batch, column_names, t):
            doc_id = f"{k:016x}"
            if d > 0:
                lines.append(
                    _json.dumps(
                        {"index": {"_index": index_name, "_id": doc_id}}
                    )
                )
                lines.append(_json.dumps(doc))
            else:
                lines.append(
                    _json.dumps(
                        {"delete": {"_index": index_name, "_id": doc_id}}
                    )
                )
            if max_batch_size and len(lines) >= max_batch_size * 2:
                _flush(lines)
                lines = []
        if lines:
            _flush(lines)

    def _flush(lines: list[str]) -> None:
        body = "\n".join(lines) + "\n"
        resp = session.post(
            host.rstrip("/") + "/_bulk",
            data=body.encode(),
            headers={"Content-Type": "application/x-ndjson"},
            timeout=30,
        )
        resp.raise_for_status()
        # ES reports per-item failures with HTTP 200 + errors:true
        result = resp.json()
        if result.get("errors"):
            failed = [
                item
                for item in result.get("items", [])
                for op in item.values()
                if op.get("error")
            ]
            raise RuntimeError(f"elasticsearch bulk errors: {failed[:5]}")

    add_writer(table, on_batch)
