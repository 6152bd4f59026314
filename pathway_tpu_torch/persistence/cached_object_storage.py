"""Own copy of ``pathway_tpu/persistence/cached_object_storage.py`` (same
layout under the backend).

Cached object storage — versioned, download-once blob cache over a
persistence backend (reference: src/persistence/cached_object_storage.rs:
1-377). Object-store connectors use it so (a) an unchanged object is never
downloaded twice within a run and (b) after a restart the exact bytes of
every previously-ingested object version are still available locally,
letting recovery reparse without refetching (and without the source
needing to still exist).

Layout under the backend: ``objects/meta/{version:016d}.json`` — an
append-only event log of Update/Delete per URI — and
``objects/blobs/{version:016d}.blob`` holding the object bytes for Update
events. The latest state is rebuilt from the event log at startup;
``vacuum`` drops superseded versions (the reference's background cleanup
collapsed to an explicit call in the single-process setting)."""

from __future__ import annotations

import json
from typing import Any, Iterable

from pathway_tpu_torch.persistence.backends import BackendStore, store_for_backend

_META_PREFIX = "objects/meta/"
_BLOB_PREFIX = "objects/blobs/"


class CachedObjectStorage:
    def __init__(self, store: BackendStore | Any):
        if not isinstance(store, BackendStore):
            store = store_for_backend(store)
        self.store = store
        self._version = 0
        # uri -> (version, metadata dict) of the live object
        self._live: dict[str, tuple[int, dict]] = {}
        self._rebuild()

    # --- construction -------------------------------------------------------

    def _rebuild(self) -> None:
        for key in sorted(self.store.list_keys(_META_PREFIX)):
            raw = self.store.get(key)
            if raw is None:
                continue
            try:
                event = json.loads(raw.decode())
            except ValueError:
                continue
            version = int(event["version"])
            self._version = max(self._version, version)
            uri = event["uri"]
            if event["type"] == "update":
                self._live[uri] = (version, event.get("metadata", {}))
            else:
                self._live.pop(uri, None)

    # --- write path ---------------------------------------------------------

    def _next_version(self) -> int:
        self._version += 1
        return self._version

    def upsert(self, uri: str, contents: bytes, metadata: dict | None = None) -> int:
        """Store a new version of `uri`; blob first, metadata event last so
        a crash mid-upsert leaves no dangling live entry."""
        version = self._next_version()
        metadata = dict(metadata or {})
        self.store.put(f"{_BLOB_PREFIX}{version:016d}.blob", contents)
        self.store.put(
            f"{_META_PREFIX}{version:016d}.json",
            json.dumps(
                {"uri": uri, "version": version, "type": "update",
                 "metadata": metadata}
            ).encode(),
        )
        self._live[uri] = (version, metadata)
        return version

    def remove(self, uri: str) -> int:
        version = self._next_version()
        self.store.put(
            f"{_META_PREFIX}{version:016d}.json",
            json.dumps(
                {"uri": uri, "version": version, "type": "delete"}
            ).encode(),
        )
        self._live.pop(uri, None)
        return version

    # --- lookups (latest state) --------------------------------------------

    def contains(self, uri: str) -> bool:
        return uri in self._live

    def get(self, uri: str) -> bytes | None:
        entry = self._live.get(uri)
        if entry is None:
            return None
        return self.store.get(f"{_BLOB_PREFIX}{entry[0]:016d}.blob")

    def metadata(self, uri: str) -> dict | None:
        entry = self._live.get(uri)
        return dict(entry[1]) if entry else None

    def version_of(self, uri: str) -> int | None:
        entry = self._live.get(uri)
        return entry[0] if entry else None

    def actual_version(self) -> int:
        return self._version

    def uris(self) -> Iterable[str]:
        return list(self._live.keys())

    # --- maintenance --------------------------------------------------------

    def vacuum(self) -> int:
        """Delete blobs and events superseded by newer versions (or by a
        delete). Returns the number of removed versions."""
        keep = {v for v, _m in self._live.values()}
        removed = 0
        for key in self.store.list_keys(_META_PREFIX):
            version = int(key[len(_META_PREFIX) :].split(".")[0])
            if version in keep:
                continue
            self.store.remove(key)
            self.store.remove(f"{_BLOB_PREFIX}{version:016d}.blob")
            removed += 1
        return removed
