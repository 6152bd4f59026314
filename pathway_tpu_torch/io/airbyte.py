"""Own copy of ``pathway_tpu/io/airbyte.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.airbyte — run an Airbyte source connector and ingest its record
stream (upstream Pathway: python/pathway/io/airbyte — drives an Airbyte
connector image/venv through the Airbyte protocol: spec/check/read over
stdout JSON lines). This implementation shells out to a locally installed
connector executable (`docker run` or a venv entrypoint) and parses
RECORD/STATE messages."""

from __future__ import annotations

import json as _json
import subprocess
import threading
from typing import Any

from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import sequential_key
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


class _AirbyteSource(StreamingSource):  # pragma: no cover - needs connector
    def __init__(self, command: list[str], streams: list[str]):
        super().__init__(["data"])
        self.command = command
        self.streams = set(streams)
        self._stop = threading.Event()
        self._thread = None
        self._counter = 0

    def _loop(self):
        proc = subprocess.Popen(
            self.command, stdout=subprocess.PIPE, text=True
        )
        assert proc.stdout is not None
        for line in proc.stdout:
            if self._stop.is_set():
                proc.terminate()
                break
            line = line.strip()
            if not line:
                continue
            try:
                msg = _json.loads(line)
            except ValueError:
                continue
            if msg.get("type") == "RECORD":
                rec = msg.get("record", {})
                if self.streams and rec.get("stream") not in self.streams:
                    continue
                self._counter += 1
                self.session.insert(
                    int(sequential_key(self._counter)),
                    (Json(rec.get("data")),),
                )
        self.session.close()

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()


def read(
    config: dict | str,
    streams: list[str],
    *,
    mode: str = "streaming",
    execution_type: str = "local",
    env_vars: dict | None = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    if isinstance(config, dict):
        command = config.get("command")
        if not command:
            raise ValueError(
                "pw.io.airbyte needs {'command': [...]} pointing at a local "
                "Airbyte connector executable (docker run ... read ...)"
            )
    else:
        command = [config]
    source = _AirbyteSource(list(command), streams)
    node = InputNode(source, source.column_names)
    return Table._from_node(node, {"data": dt.JSON}, Universe())
