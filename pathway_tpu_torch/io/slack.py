"""Own copy of ``pathway_tpu/io/slack.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.slack — alert sink posting rows to a Slack channel
(upstream Pathway: python/pathway/io/slack — send_alerts via chat.postMessage)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.io._utils import add_writer, jsonable


def send_alerts(
    alerts: Any, slack_channel_id: str, slack_token: str, **kwargs: Any
) -> None:
    """Post the first column of every inserted row as a Slack message."""
    import requests

    session = requests.Session()
    session.headers["Authorization"] = f"Bearer {slack_token}"

    def on_batch(t: int, batch: DiffBatch) -> None:
        col = batch.column_names[0] if batch.column_names else None
        for _k, d, vals in batch.iter_rows():
            if d <= 0:
                continue
            text = str(jsonable(vals[0])) if col is not None else ""
            resp = session.post(
                "https://slack.com/api/chat.postMessage",
                json={"channel": slack_channel_id, "text": text},
                timeout=30,
            )
            resp.raise_for_status()

    add_writer(alerts, on_batch)
