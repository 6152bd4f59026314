"""Own copy of ``pathway_tpu/io/deltalake.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.deltalake — Delta Lake source/sink on pyarrow.

Counterpart of upstream Pathway's DeltaLake connector
(upstream Pathway: src/connectors/data_lake/{mod,delta,writer}.rs — arrow-based
batch/streaming readers and transactional writers, 2k LoC of rust). It needs
pyarrow but no `deltalake` package: it implements the core of the Delta
protocol directly:

- parquet part files + an ordered `_delta_log/` of JSON commits holding
  `add` / `remove` actions; readers REPLAY the log, so overwrites and
  compactions are honored (removed files drop out of the active set);
- transactional commits: parquet written first, then the commit file is
  created EXCLUSIVELY (optimistic concurrency — a concurrent writer's
  version collision is detected and retried at the next version, the
  delta commit protocol, reference writer.rs). The exclusive-create
  guarantee holds on LOCAL filesystems (hard-link atomicity); plain
  object stores lack conditional puts, so concurrent multi-writer use
  over s3:// needs external coordination (same caveat as delta-rs
  without a locking provider);
- schema tracked in `metaData` actions with evolution guards: appending
  writers must match the table schema; adding new columns is allowed
  with ``schema_evolution="allow_add"`` (a new metaData action is
  committed), type changes/drops are rejected;
- object storage: any fsspec URI (s3://bucket/table, memory://...)
  works through the same code path as local directories (reference:
  data_lake S3 object store over rust-s3);
- maintenance: ``compact_every=N`` merges the active part files into one
  parquet every N commits (remove+add in a single commit — the
  reference's table maintenance/optimize pass);
- streaming reads tail the log and emit RETRACTIONS for rows of removed
  files, so a downstream incremental pipeline tracks overwrites.

Output rows carry `time`/`diff` columns like the reference writer.
"""

from __future__ import annotations

import json as _json
import os
import threading
import uuid
from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StaticSource, StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._utils import add_writer, jsonable

_LOG_DIR = "_delta_log"


def create_exclusive_local(path: str, data: bytes) -> bool:
    """Atomically create `path` iff it does not exist (hard-link trick) —
    the optimistic-commit primitive shared by the delta and iceberg
    writers. Returns False on collision."""
    tmp = path + f".tmp-{uuid.uuid4().hex}"
    with open(tmp, "wb") as f:
        f.write(data)
    try:
        os.link(tmp, path)
        return True
    except FileExistsError:
        return False
    finally:
        os.remove(tmp)


class _Store:
    """Filesystem facade: plain os for local paths, fsspec for URIs with a
    scheme (s3://, memory://, ...). Only the handful of operations the
    Delta log needs."""

    def __init__(self, root: str, storage_options: dict | None = None):
        self.root = root.rstrip("/")
        if "://" in root:
            import fsspec

            self.protocol = root.split("://", 1)[0]
            self.fs = fsspec.filesystem(
                self.protocol, **(storage_options or {})
            )
            self._local = False
        else:
            self.fs = None
            self._local = True

    def join(self, *parts: str) -> str:
        if self._local:
            return os.path.join(self.root, *parts)
        return "/".join([self.root, *parts])

    def makedirs(self, path: str) -> None:
        if self._local:
            os.makedirs(path, exist_ok=True)
        else:
            self.fs.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> list[str]:
        try:
            if self._local:
                return os.listdir(path)
            return [p.rsplit("/", 1)[-1] for p in self.fs.ls(path, detail=False)]
        except (OSError, FileNotFoundError):
            return []

    def read_text(self, path: str) -> str:
        if self._local:
            with open(path) as f:
                return f.read()
        with self.fs.open(path, "r") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        if self._local:
            with open(path, "wb") as f:
                f.write(data)
        else:
            with self.fs.open(path, "wb") as f:
                f.write(data)

    def open_read(self, path: str):
        if self._local:
            return open(path, "rb")
        return self.fs.open(path, "rb")

    def size(self, path: str) -> int:
        if self._local:
            return os.path.getsize(path)
        return self.fs.size(path)

    def remove(self, path: str) -> None:
        try:
            if self._local:
                os.remove(path)
            else:
                self.fs.rm(path)
        except (OSError, FileNotFoundError):
            pass

    def create_exclusive(self, path: str, data: bytes) -> bool:
        """Atomically create `path` iff it does not exist — the delta
        optimistic-commit primitive. Returns False on collision."""
        if self._local:
            return create_exclusive_local(path, data)
        if self.fs.exists(path):
            return False
        with self.fs.open(path, "wb") as f:  # best-effort on object stores
            f.write(data)
        return True


def _log_path(store: _Store, version: int) -> str:
    return store.join(_LOG_DIR, f"{version:020d}.json")


def _list_versions(store: _Store) -> list[int]:
    out = []
    for f in store.listdir(store.join(_LOG_DIR)):
        if f.endswith(".json"):
            try:
                out.append(int(f[:-5]))
            except ValueError:
                pass
    return sorted(out)


def _version_actions(store: _Store, version: int) -> list[dict]:
    actions = []
    for line in store.read_text(_log_path(store, version)).splitlines():
        line = line.strip()
        if line:
            actions.append(_json.loads(line))
    return actions


def _replay_log(
    store: _Store, upto: int | None = None
) -> tuple[list[str], dict | None]:
    """(active part files in add order, latest schema) after replaying the
    log — `remove` actions drop files from the active set."""
    active: dict[str, None] = {}
    schema = None
    for v in _list_versions(store):
        if upto is not None and v > upto:
            break
        for action in _version_actions(store, v):
            if "add" in action:
                active[action["add"]["path"]] = None
            elif "remove" in action:
                active.pop(action["remove"]["path"], None)
            elif "metaData" in action:
                try:
                    schema = _json.loads(
                        action["metaData"].get("schemaString", "null")
                    )
                except (ValueError, TypeError):
                    schema = None
    return list(active.keys()), schema


def _rows_from_parquet(
    source, column_names, schema, counter
) -> list[tuple[int, int, tuple]]:
    """`source` is a filesystem path or an open binary file — pyarrow
    accepts both (iceberg passes local paths; delta passes _Store file
    handles so object stores work)."""
    import pyarrow.parquet as pq

    tbl = pq.read_table(source)
    data = tbl.to_pylist()
    dtypes = schema.dtypes() if schema else {}
    pk = schema.primary_key_columns() if schema else None
    rows = []
    for obj in data:
        vals = []
        for c in column_names:
            v = obj.get(c)
            d = dtypes.get(c, dt.ANY).strip_optional()
            if d == dt.FLOAT and isinstance(v, int):
                v = float(v)
            vals.append(v)
        vals = tuple(vals)
        diff = int(obj.get("diff", 1))
        if pk:
            key = int(ref_scalar(*[vals[column_names.index(c)] for c in pk]))
        else:
            # key by value content so a -1 row cancels its earlier +1 even
            # without a declared primary key (sequential keys would orphan
            # retractions); identical duplicates coexist via multiplicity
            key = int(ref_scalar(*vals))
        rows.append((key, diff, vals))
    return rows


class _DeltaStaticSource(StaticSource):
    def __init__(self, store: _Store, column_names, schema):
        super().__init__(column_names)
        self.store = store
        self.schema = schema

    def events(self):
        import itertools

        counter = itertools.count()
        rows = []
        files, _meta = _replay_log(self.store)
        for part in files:
            with self.store.open_read(self.store.join(part)) as f:
                rows.extend(
                    _rows_from_parquet(
                        f, self.column_names, self.schema, counter
                    )
                )
        if rows:
            yield 0, DiffBatch.from_rows(rows, self.column_names)


class _DeltaStreamingSource(StreamingSource):
    """Tail the log; `add` emits the file's rows, `remove` (overwrite /
    compaction) retracts them — downstream pipelines see overwrites as
    incremental updates."""

    def __init__(self, store: _Store, column_names, schema, refresh_s=0.2):
        super().__init__(column_names)
        self.store = store
        self.schema = schema
        self.refresh_s = refresh_s
        self._stop = threading.Event()
        self._thread = None
        self._next_version = 0
        # part path -> rows it contributed (for retraction on remove)
        self._live: dict[str, list] = {}
        import itertools

        self._counter = itertools.count()

    def offset_state(self) -> dict:
        return {"next_version": self._next_version}

    def seek(self, state: dict) -> None:
        self._next_version = int(state.get("next_version", 0))
        # rebuild the live map WITHOUT emitting (those rows were already
        # delivered before the restart; the input log replays them)
        files, _meta = _replay_log(self.store, upto=self._next_version - 1)
        for part in files:
            try:
                with self.store.open_read(self.store.join(part)) as f:
                    self._live[part] = _rows_from_parquet(
                        f, self.column_names, self.schema, self._counter
                    )
            except OSError:
                pass

    def _scan(self):
        for v in _list_versions(self.store):
            if v < self._next_version:
                continue
            rows = []
            for action in _version_actions(self.store, v):
                if "add" in action:
                    part = action["add"]["path"]
                    with self.store.open_read(self.store.join(part)) as f:
                        part_rows = _rows_from_parquet(
                            f, self.column_names, self.schema, self._counter
                        )
                    self._live[part] = part_rows
                    # dataChange=false (compaction): rows merely moved
                    # files — track them, emit nothing
                    if action["add"].get("dataChange", True):
                        rows.extend(part_rows)
                elif "remove" in action:
                    part = action["remove"]["path"]
                    dropped = self._live.pop(part, [])
                    if action["remove"].get("dataChange", True):
                        for k, d, vals in dropped:
                            rows.append((k, -d, vals))
            self._next_version = v + 1
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
    uri: str,
    *,
    schema: Any,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    persistent_id: str | None = None,
    storage_options: dict | None = None,
    **kwargs: Any,
) -> Table:
    column_names = list(schema.column_names())
    store = _Store(uri, storage_options)
    if mode == "static":
        source: Any = _DeltaStaticSource(store, column_names, schema)
    else:
        source = _DeltaStreamingSource(store, column_names, schema)
    source.persistent_id = persistent_id or name
    node = InputNode(source, column_names)
    return Table._from_node(node, dict(schema.dtypes()), Universe())


def _schema_desc(table: Table) -> list[dict]:
    return [
        {"name": n, "type": str(d)}
        for n, d in table._schema.dtypes().items()
    ]


class _DeltaWriter:
    def __init__(
        self,
        store: _Store,
        column_names,
        schema_desc: list[dict] | None = None,
        *,
        mode: str = "append",
        schema_evolution: str = "strict",
        compact_every: int | None = None,
    ):
        self.store = store
        self.column_names = list(column_names)
        self.schema_desc = schema_desc or [
            {"name": n, "type": "any"} for n in column_names
        ]
        self.compact_every = compact_every
        self._commits_since_compact = 0
        if not store._local:
            import warnings

            warnings.warn(
                f"deltalake writer over {store.protocol}://: fsspec has no "
                "atomic create-if-absent, so the optimistic commit degrades "
                "to exists-check-then-write (TOCTOU). Concurrent writers on "
                "this store need external coordination (e.g. a DynamoDB-style "
                "lock) to avoid last-writer-wins on the Delta log.",
                stacklevel=3,
            )
        store.makedirs(store.join(_LOG_DIR))
        versions = _list_versions(store)
        self.version = (versions[-1] + 1) if versions else 0
        if self.version == 0:
            self._commit(
                [
                    {
                        "protocol": {
                            "minReaderVersion": 1,
                            "minWriterVersion": 2,
                        }
                    },
                    self._metadata_action(),
                ]
            )
        else:
            self._check_schema(schema_evolution)
        # overwrite: removes are DEFERRED into the same commit as the
        # first data batch — delta overwrite semantics are one atomic
        # remove+add commit, and a pipeline that aborts before producing
        # data must not have emptied the table
        self._pending_removes: list[dict] = []
        if self.version > 0 and mode == "overwrite":
            files, _m = _replay_log(store)
            self._pending_removes = [
                {"remove": {"path": p, "dataChange": True}} for p in files
            ]

    def _metadata_action(self) -> dict:
        return {
            "metaData": {
                "id": str(uuid.uuid4()),
                "format": {"provider": "parquet"},
                "schemaString": _json.dumps(
                    {
                        "columns": self.column_names,
                        "fields": self.schema_desc,
                    }
                ),
            }
        }

    def _check_schema(self, evolution: str) -> None:
        """Evolution guard (upstream Pathway: data_lake writer schema checks):
        identical schemas append; NEW columns are allowed only with
        schema_evolution='allow_add' (commits a fresh metaData action);
        dropped or type-changed columns are refused."""
        _files, meta = _replay_log(self.store)
        if not meta:
            return
        existing = {
            f["name"]: f.get("type", "any")
            for f in meta.get("fields", [])
        } or {c: "any" for c in meta.get("columns", [])}
        mine = {f["name"]: f["type"] for f in self.schema_desc}
        dropped = set(existing) - set(mine)
        if dropped:
            raise ValueError(
                f"deltalake: writer schema drops existing column(s) "
                f"{sorted(dropped)}; refusing to append"
            )
        changed = {
            n
            for n in existing
            if existing[n] not in ("any", mine[n]) and mine[n] != "any"
        }
        if changed:
            raise ValueError(
                f"deltalake: writer changes type of column(s) "
                f"{sorted(changed)}; refusing to append"
            )
        added = set(mine) - set(existing)
        if added:
            if evolution != "allow_add":
                raise ValueError(
                    f"deltalake: writer adds new column(s) {sorted(added)}; "
                    "pass schema_evolution='allow_add' to evolve the table"
                )
            self._commit([self._metadata_action()])

    def _commit(self, actions: list[dict]) -> None:
        """Optimistic transactional commit: the version file is created
        exclusively; a collision (concurrent writer won the version) bumps
        the version and retries. Atomic on local filesystems; on plain
        object stores the exists-check is best-effort (see module
        docstring)."""
        data = (
            "\n".join(_json.dumps(a) for a in actions) + "\n"
        ).encode()
        while True:
            path = _log_path(self.store, self.version)
            if self.store.create_exclusive(path, data):
                self.version += 1
                return
            self.version += 1  # lost the race: retry at the next version

    def write_batch(self, t: int, batch: DiffBatch) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq
        import io

        cols: dict[str, list] = {n: [] for n in self.column_names}
        times: list[int] = []
        diffs: list[int] = []
        for _k, d, vals in batch.iter_rows():
            for n, v in zip(self.column_names, vals):
                cols[n].append(jsonable(v))
            times.append(t)
            diffs.append(d)
        cols["time"] = times
        cols["diff"] = diffs
        part = f"part-{self.version:05d}-{uuid.uuid4().hex}.parquet"
        buf = io.BytesIO()
        pq.write_table(pa.table(cols), buf)
        fpath = self.store.join(part)
        self.store.write_bytes(fpath, buf.getvalue())
        actions = self._pending_removes + [
            {
                "add": {
                    "path": part,
                    "size": self.store.size(fpath),
                    "dataChange": True,
                }
            }
        ]
        self._pending_removes = []
        self._commit(actions)
        self._commits_since_compact += 1
        if (
            self.compact_every
            and self._commits_since_compact >= self.compact_every
        ):
            self.compact()

    def compact(self) -> None:
        """Merge every active part into one parquet (remove+add in a
        single commit — the reference's maintenance/optimize pass). Old
        parts stay on disk for readers of older versions (vacuum is a
        separate concern)."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        import io

        self._commits_since_compact = 0
        files, _meta = _replay_log(self.store)
        if len(files) <= 1:
            return
        tables = []
        for part in files:
            with self.store.open_read(self.store.join(part)) as f:
                tables.append(pq.read_table(f))
        merged = pa.concat_tables(tables, promote_options="default")
        part = f"part-{self.version:05d}-{uuid.uuid4().hex}.parquet"
        buf = io.BytesIO()
        pq.write_table(merged, buf)
        self.store.write_bytes(self.store.join(part), buf.getvalue())
        actions = [
            {"remove": {"path": p, "dataChange": False}} for p in files
        ]
        actions.append(
            {
                "add": {
                    "path": part,
                    "size": self.store.size(self.store.join(part)),
                    "dataChange": False,
                }
            }
        )
        self._commit(actions)


def write(
    table: Table,
    uri: str,
    *,
    mode: str = "append",
    schema_evolution: str = "strict",
    compact_every: int | None = None,
    storage_options: dict | None = None,
    **kwargs: Any,
) -> None:
    store = _Store(uri, storage_options)
    writer = _DeltaWriter(
        store,
        table.column_names(),
        _schema_desc(table),
        mode=mode,
        schema_evolution=schema_evolution,
        compact_every=compact_every,
    )
    add_writer(table, writer.write_batch)
