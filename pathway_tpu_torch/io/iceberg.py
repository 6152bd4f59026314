"""Own copy of ``pathway_tpu/io/iceberg.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.iceberg — Iceberg-style table source/sink
(upstream Pathway: src/connectors/data_lake/iceberg.rs). It needs no
`pyiceberg`; it speaks a compatible subset of the spec on pyarrow:
parquet data files tracked by versioned JSON snapshots under `metadata/`
with a `version-hint.text` pointer (the layout pyiceberg's filesystem
catalog reads). Snapshots carry the table schema and a snapshot-history
list; appending writers are schema-guarded (new columns require
``schema_evolution="allow_add"``, drops/type changes are refused), the
``mode="overwrite"`` writer starts a snapshot containing only its own
files, and the streaming reader RETRACTS rows of files that leave the
snapshot, so overwrites flow as incremental updates. Full-catalog
deployments should install `pyiceberg`."""

from __future__ import annotations

import json as _json
import os
import threading
import uuid
from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StaticSource, StreamingSource
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._utils import add_writer, jsonable
from pathway_tpu_torch.io.deltalake import _rows_from_parquet, create_exclusive_local


def _meta_dir(root: str) -> str:
    return os.path.join(root, "metadata")


def _current_version(root: str) -> int:
    """Latest committed snapshot version. version-hint.text is advisory
    (its write is last-writer-wins, so a slow writer can regress it);
    the truth is the densely-numbered vN.metadata.json files — probe
    upward from the hint until the next version is absent, exactly how
    pyiceberg's filesystem catalog recovers from a stale hint."""
    hint = os.path.join(_meta_dir(root), "version-hint.text")
    try:
        with open(hint) as f:
            v = int(f.read().strip())
    except (OSError, ValueError):
        v = -1
    while os.path.exists(
        os.path.join(_meta_dir(root), f"v{v + 1}.metadata.json")
    ):
        v += 1
    return v


def _snapshot_meta(root: str, version: int) -> dict:
    path = os.path.join(_meta_dir(root), f"v{version}.metadata.json")
    try:
        with open(path) as f:
            return _json.loads(f.read())
    except OSError:
        return {}


def _snapshot_files(root: str, version: int) -> list[str]:
    return [
        os.path.join(root, "data", p)
        for p in _snapshot_meta(root, version).get("files", [])
    ]


class _IcebergStaticSource(StaticSource):
    def __init__(self, root, column_names, schema):
        super().__init__(column_names)
        self.root = root
        self.schema = schema

    def events(self):
        import itertools

        counter = itertools.count()
        v = _current_version(self.root)
        rows = []
        if v >= 0:
            for f in _snapshot_files(self.root, v):
                rows.extend(
                    _rows_from_parquet(f, self.column_names, self.schema, counter)
                )
        if rows:
            yield 0, DiffBatch.from_rows(rows, self.column_names)


class _IcebergStreamingSource(StreamingSource):
    """Tail the version hint; emit only files added since the last seen
    snapshot."""

    def __init__(self, root, column_names, schema, refresh_s=0.2):
        super().__init__(column_names)
        self.root = root
        self.schema = schema
        self.refresh_s = refresh_s
        self._stop = threading.Event()
        self._thread = None
        self._seen_files: set[str] = set()
        # file -> contributed rows, for retraction when a snapshot drops it
        self._live: dict[str, list] = {}
        self._version = -1
        import itertools

        self._counter = itertools.count()

    def offset_state(self) -> dict:
        return {"version": self._version, "files": sorted(self._seen_files)}

    def seek(self, state: dict) -> None:
        self._version = int(state.get("version", -1))
        self._seen_files = set(state.get("files", []))
        # rebuild the live map WITHOUT emitting (rows were delivered
        # before the restart; the persistence input log replays them)
        for f in self._seen_files:
            try:
                self._live[f] = _rows_from_parquet(
                    f, self.column_names, self.schema, self._counter
                )
            except OSError:
                pass

    def _scan(self):
        v = _current_version(self.root)
        if v < 0 or v == self._version:
            return
        current = set(_snapshot_files(self.root, v))
        rows = []
        # files dropped by the new snapshot (overwrite): retract their rows
        for f in sorted(self._seen_files - current):
            for k, d, vals in self._live.pop(f, []):
                rows.append((k, -d, vals))
            self._seen_files.discard(f)
        for f in sorted(current - self._seen_files):
            part_rows = _rows_from_parquet(
                f, self.column_names, self.schema, self._counter
            )
            self._live[f] = part_rows
            rows.extend(part_rows)
            self._seen_files.add(f)
        self._version = v
        if rows:
            self.session.insert_batch(rows, self.offset_state())

    def _loop(self):
        while not self._stop.is_set():
            self._scan()
            self._stop.wait(self.refresh_s)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


def read(
    catalog_uri: str,
    *,
    namespace: list[str] | None = None,
    table_name: str | None = None,
    schema: Any,
    mode: str = "streaming",
    name: str | None = None,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    root = catalog_uri
    if namespace or table_name:
        parts = list(namespace or []) + ([table_name] if table_name else [])
        root = os.path.join(catalog_uri, *parts)
    column_names = list(schema.column_names())
    if mode == "static":
        source: Any = _IcebergStaticSource(root, column_names, schema)
    else:
        source = _IcebergStreamingSource(root, column_names, schema)
    source.persistent_id = persistent_id or name
    node = InputNode(source, column_names)
    return Table._from_node(node, dict(schema.dtypes()), Universe())


class _IcebergWriter:
    def __init__(
        self,
        root,
        column_names,
        schema_desc: list[dict] | None = None,
        *,
        mode: str = "append",
        schema_evolution: str = "strict",
    ):
        self.root = root
        self.column_names = list(column_names)
        self.mode = mode
        self.schema_desc = schema_desc or [
            {"name": n, "type": "any"} for n in column_names
        ]
        os.makedirs(_meta_dir(root), exist_ok=True)
        os.makedirs(os.path.join(root, "data"), exist_ok=True)
        self.version = _current_version(root)
        if self.version >= 0:
            self._check_schema(schema_evolution)
        # overwrite: the fresh (files-of-this-writer-only) snapshot is
        # committed WITH the first data batch, not at construction — an
        # aborted pipeline must not have emptied the table
        # files written since the last successful commit — the rebase unit
        # on commit races (files already in one of our committed snapshots
        # must NOT be re-added: a concurrent overwrite may have dropped them)
        self.pending_files: list[str] = []
        self.files: list[str] = (
            [
                os.path.relpath(f, os.path.join(root, "data"))
                for f in _snapshot_files(root, self.version)
            ]
            if self.version >= 0 and mode != "overwrite"
            else []
        )

    def _check_schema(self, evolution: str) -> None:
        """Evolution guard (mirrors pw.io.deltalake): identical schemas
        append; new columns need schema_evolution='allow_add'; dropped or
        type-changed columns are refused."""
        meta = _snapshot_meta(self.root, self.version)
        fields = meta.get("schema", {}).get("fields")
        if not fields:
            return
        existing = {f["name"]: f.get("type", "any") for f in fields}
        mine = {f["name"]: f["type"] for f in self.schema_desc}
        dropped = set(existing) - set(mine)
        if dropped:
            raise ValueError(
                f"iceberg: writer schema drops existing column(s) "
                f"{sorted(dropped)}; refusing to append"
            )
        changed = {
            n
            for n in existing
            if existing[n] not in ("any", mine[n]) and mine[n] != "any"
        }
        if changed:
            raise ValueError(
                f"iceberg: writer changes type of column(s) "
                f"{sorted(changed)}; refusing to append"
            )
        added = set(mine) - set(existing)
        if added and evolution != "allow_add":
            raise ValueError(
                f"iceberg: writer adds new column(s) {sorted(added)}; "
                "pass schema_evolution='allow_add' to evolve the table"
            )

    def _commit_snapshot(self) -> None:
        import time as _time

        while True:
            prev = _snapshot_meta(self.root, self.version)
            snapshots = list(prev.get("snapshots", []))
            next_version = self.version + 1
            snapshot = {
                "snapshot-id": next_version,
                "timestamp-ms": int(_time.time() * 1000),
                "files": list(self.files),
            }
            meta = {
                "files": list(self.files),
                "schema": {"fields": self.schema_desc},
                "snapshots": (snapshots + [snapshot])[-64:],  # bounded history
            }
            meta_path = os.path.join(
                _meta_dir(self.root), f"v{next_version}.metadata.json"
            )
            if create_exclusive_local(meta_path, _json.dumps(meta).encode()):
                self.version = next_version
                self.pending_files = []
                break
            # a concurrent writer won version next_version: rebase this
            # writer's OWN files onto the winner's list (append mode —
            # unioning our stale base snapshot would resurrect files a
            # concurrent overwrite just dropped) and retry one version up.
            # An overwrite snapshot stays authoritative: only its own files.
            if self.mode != "overwrite":
                theirs = _snapshot_meta(self.root, next_version).get("files", [])
                self.files = list(
                    dict.fromkeys([*theirs, *self.pending_files])
                )
            self.version = next_version
        # the hint is advisory (readers probe upward from it, see
        # _current_version), so a racing last-writer-wins replace here can
        # at worst cost readers a few extra stat calls, never data
        hint = os.path.join(_meta_dir(self.root), "version-hint.text")
        tmp = hint + f".tmp-{uuid.uuid4().hex}"
        with open(tmp, "w") as f:
            f.write(str(self.version))
        os.replace(tmp, hint)

    def write_batch(self, t: int, batch: DiffBatch) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        cols: dict[str, list] = {n: [] for n in self.column_names}
        times, diffs = [], []
        for _k, d, vals in batch.iter_rows():
            for n, v in zip(self.column_names, vals):
                cols[n].append(jsonable(v))
            times.append(t)
            diffs.append(d)
        cols["time"] = times
        cols["diff"] = diffs
        fname = f"{uuid.uuid4().hex}.parquet"
        pq.write_table(pa.table(cols), os.path.join(self.root, "data", fname))
        self.files.append(fname)
        self.pending_files.append(fname)
        self._commit_snapshot()


def write(
    table: Table,
    catalog_uri: str,
    *,
    namespace: list[str] | None = None,
    table_name: str | None = None,
    mode: str = "append",
    schema_evolution: str = "strict",
    **kwargs: Any,
) -> None:
    from pathway_tpu_torch.io.deltalake import _schema_desc

    root = catalog_uri
    if namespace or table_name:
        parts = list(namespace or []) + ([table_name] if table_name else [])
        root = os.path.join(catalog_uri, *parts)
    writer = _IcebergWriter(
        root,
        table.column_names(),
        _schema_desc(table),
        mode=mode,
        schema_evolution=schema_evolution,
    )
    add_writer(table, writer.write_batch)
