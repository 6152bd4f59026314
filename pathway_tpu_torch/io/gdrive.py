"""Own copy of ``pathway_tpu/io/gdrive.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.gdrive — Google Drive source
(upstream Pathway: python/pathway/io/gdrive — polls a folder for file
changes via the Drive v3 API and streams object bytes + metadata).
Requires google-api-python-client at call time."""

from __future__ import annotations

import threading
from typing import Any

from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._utils import require


class _GDriveSource(StreamingSource):  # pragma: no cover - needs API creds
    def __init__(self, object_id, credentials_file, refresh_interval, with_metadata):
        super().__init__(["data", "_metadata"] if with_metadata else ["data"])
        require("googleapiclient", "gdrive")
        self.object_id = object_id
        self.credentials_file = credentials_file
        self.refresh_interval = refresh_interval
        self.with_metadata = with_metadata
        self._stop = threading.Event()
        self._thread = None
        self._seen: dict[str, str] = {}  # file id -> modifiedTime

    def offset_state(self) -> dict:
        return {"seen": dict(self._seen)}

    def seek(self, state: dict) -> None:
        self._seen = dict(state.get("seen", {}))

    def _service(self):
        from google.oauth2.service_account import Credentials  # type: ignore
        from googleapiclient.discovery import build  # type: ignore

        creds = Credentials.from_service_account_file(
            self.credentials_file,
            scopes=["https://www.googleapis.com/auth/drive.readonly"],
        )
        return build("drive", "v3", credentials=creds)

    def _loop(self):
        service = self._service()
        while not self._stop.is_set():
            resp = (
                service.files()
                .list(
                    q=f"'{self.object_id}' in parents and trashed = false",
                    fields="files(id, name, modifiedTime, mimeType)",
                )
                .execute()
            )
            rows = []
            for f in resp.get("files", []):
                if self._seen.get(f["id"]) == f["modifiedTime"]:
                    continue
                data = service.files().get_media(fileId=f["id"]).execute()
                self._seen[f["id"]] = f["modifiedTime"]
                key = int(ref_scalar(f["id"]))
                if self.with_metadata:
                    rows.append((key, 1, (data, Json(f))))
                else:
                    rows.append((key, 1, (data,)))
            if rows:
                self.session.insert_batch(rows, self.offset_state())
            self._stop.wait(self.refresh_interval)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    object_size_limit: int | None = None,
    service_user_credentials_file: str,
    with_metadata: bool = False,
    refresh_interval: int = 30,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    source = _GDriveSource(
        object_id, service_user_credentials_file, refresh_interval, with_metadata
    )
    node = InputNode(source, source.column_names)
    dtypes: dict[str, Any] = {"data": dt.BYTES}
    if with_metadata:
        dtypes["_metadata"] = dt.JSON
    return Table._from_node(node, dtypes, Universe())
