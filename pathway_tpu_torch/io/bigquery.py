"""Own copy of ``pathway_tpu/io/bigquery.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.bigquery — BigQuery sink via the google-cloud-bigquery client
(upstream Pathway: python/pathway/io/bigquery — insert_rows_json streaming
writes). Credentials resolve through the standard ADC chain at run time."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.io._utils import add_writer, require, row_dicts


def write(
    table,
    dataset_name: str,
    table_name: str,
    *,
    service_user_credentials_file: str | None = None,
    **kwargs: Any,
) -> None:
    bigquery = require("google.cloud.bigquery", "bigquery")
    if service_user_credentials_file:
        from google.oauth2.service_account import Credentials  # type: ignore

        creds = Credentials.from_service_account_file(
            service_user_credentials_file
        )
        client = bigquery.Client(credentials=creds)
    else:
        client = bigquery.Client()
    column_names = table.column_names()
    target = f"{dataset_name}.{table_name}"

    def on_batch(t: int, batch: DiffBatch) -> None:
        rows = []
        for _k, d, doc in row_dicts(batch, column_names, t):
            doc["time"] = t
            doc["diff"] = d
            rows.append(doc)
        if rows:
            errors = client.insert_rows_json(target, rows)
            if errors:
                raise RuntimeError(f"bigquery insert errors: {errors}")

    add_writer(table, on_batch, client.close)
