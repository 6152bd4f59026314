"""Own copy of ``pathway_tpu/io/s3.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.s3 — object-store reader over fsspec.

Counterpart of upstream Pathway's S3 scanner
(upstream Pathway: src/connectors/scanner/s3.rs:275 + posix_like.rs framework).
Uses fsspec's protocol registry: `s3://` paths need `s3fs` installed;
`file://`/`memory://` work out of the box (and are how tests exercise the
scanner). Polls the prefix for new/changed objects and streams diffs like
the fs connector.
"""

from __future__ import annotations

import threading
from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StaticSource, StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._utils import require
from pathway_tpu_torch.io.fs import _coerce_json_one, _coerce_one, _make_coercers


class AwsS3Settings:
    """(upstream Pathway: python/pathway/io/s3 AwsS3Settings)"""

    def __init__(
        self,
        bucket_name: str | None = None,
        access_key: str | None = None,
        secret_access_key: str | None = None,
        region: str | None = None,
        endpoint: str | None = None,
        with_path_style: bool = False,
        **kwargs: Any,
    ):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.region = region
        self.endpoint = endpoint
        self.with_path_style = with_path_style

    def storage_options(self) -> dict:
        opts: dict[str, Any] = {}
        if self.access_key:
            opts["key"] = self.access_key
        if self.secret_access_key:
            opts["secret"] = self.secret_access_key
        client_kwargs: dict[str, Any] = {}
        if self.region:
            client_kwargs["region_name"] = self.region
        if self.endpoint:
            client_kwargs["endpoint_url"] = self.endpoint
        if client_kwargs:
            opts["client_kwargs"] = client_kwargs
        if self.with_path_style:
            opts["config_kwargs"] = {"s3": {"addressing_style": "path"}}
        return opts


def _open_fs(path: str, settings: AwsS3Settings | None):
    fsspec = require("fsspec", "s3")
    protocol = path.split("://", 1)[0] if "://" in path else "file"
    opts = settings.storage_options() if settings else {}
    return fsspec.filesystem(protocol, **opts), protocol


def _parse_object(data: bytes, opath: str, format: str, schema, column_names):
    """bytes -> [(pk_tuple, values)] — same formats as the fs connector."""
    import csv as _csv
    import io
    import json as _json

    if format in ("plaintext", "plaintext_by_file"):
        text = data.decode("utf-8", errors="replace")
        if format == "plaintext_by_file":
            return [((opath,), (text,))]
        return [
            ((opath, i), (line,))
            for i, line in enumerate(text.splitlines())
        ]
    if format == "binary":
        return [((opath,), (data,))]
    out = []
    if format == "csv":
        coercers = _make_coercers(schema, list(column_names), _coerce_one)
        reader = _csv.DictReader(io.StringIO(data.decode("utf-8", errors="replace")))
        for i, row in enumerate(reader):
            if coercers is not None:
                vals = tuple(fn(row.get(n)) for n, fn in coercers)
            else:
                vals = tuple(row.get(n) for n in column_names)
            out.append(((opath, i), vals))
        return out
    if format in ("json", "jsonlines"):
        coercers = _make_coercers(schema, list(column_names), _coerce_json_one)
        for i, line in enumerate(data.decode("utf-8", errors="replace").splitlines()):
            line = line.strip()
            if not line:
                continue
            obj = _json.loads(line)
            if coercers is not None:
                vals = tuple(fn(obj.get(n)) for n, fn in coercers)
            else:
                vals = tuple(obj.get(n) for n in column_names)
            out.append(((opath, i), vals))
        return out
    raise ValueError(f"unknown format {format!r}")


def _rows_for_object(fs, opath, format, schema, column_names, pk_cols,
                     cache=None, sig=None):
    data = None
    if cache is not None and sig is not None:
        # download-once: an object whose (mtime, size) signature matches
        # the cached version is served from the local blob cache
        # (upstream Pathway: cached_object_storage.rs download-once semantics)
        meta = cache.metadata(opath)
        if meta is not None and meta.get("sig") == list(sig):
            data = cache.get(opath)
    if data is None:
        with fs.open(opath, "rb") as f:
            data = f.read()
        if cache is not None:
            cache.upsert(opath, data, {"sig": list(sig) if sig else None})
    rows = []
    for pk, vals in _parse_object(data, opath, format, schema, column_names):
        if pk_cols:
            key = int(
                ref_scalar(*[vals[column_names.index(c)] for c in pk_cols])
            )
        else:
            key = int(ref_scalar(*pk))
        rows.append((key, vals))
    return rows


class _S3StaticSource(StaticSource):
    def __init__(self, path, settings, format, schema, column_names, pk_cols,
                 object_cache=None):
        super().__init__(column_names)
        self.path = path
        self.settings = settings
        self.format = format
        self.schema = schema
        self.pk_cols = pk_cols
        self.object_cache = object_cache

    def events(self):
        fs, _ = _open_fs(self.path, self.settings)
        rows = []
        for opath in sorted(fs.find(self.path)):
            sig = None
            if self.object_cache is not None:
                try:
                    info = fs.info(opath)
                    sig = (
                        str(info.get("mtime", info.get("LastModified", ""))),
                        info.get("size"),
                    )
                except OSError:
                    pass
            rows.extend(
                (k, 1, v)
                for k, v in _rows_for_object(
                    fs, opath, self.format, self.schema, self.column_names,
                    self.pk_cols, cache=self.object_cache, sig=sig,
                )
            )
        if rows:
            yield 0, DiffBatch.from_rows(rows, self.column_names)


class _S3StreamingSource(StreamingSource):
    def __init__(
        self, path, settings, format, schema, column_names, pk_cols,
        refresh_s=1.0, object_cache=None,
    ):
        super().__init__(column_names)
        self.path = path
        self.settings = settings
        self.format = format
        self.schema = schema
        self.pk_cols = pk_cols
        self.refresh_s = refresh_s
        self.object_cache = object_cache
        self._stop = threading.Event()
        self._thread = None
        self._seen: dict[str, Any] = {}
        self._emitted: dict[str, list] = {}

    def offset_state(self) -> dict:
        return {"seen": dict(self._seen), "emitted": dict(self._emitted)}

    def seek(self, state: dict) -> None:
        self._seen = dict(state.get("seen", {}))
        self._emitted = dict(state.get("emitted", {}))

    def _scan(self, fs):
        for opath in sorted(fs.find(self.path)):
            try:
                info = fs.info(opath)
            except OSError:
                continue
            sig = (str(info.get("mtime", info.get("LastModified", ""))), info.get("size"))
            if self._seen.get(opath) == sig:
                continue
            rows = [
                (k, -1, v) for k, v in self._emitted.get(opath, [])
            ]
            try:
                new = _rows_for_object(
                    fs, opath, self.format, self.schema, self.column_names,
                    self.pk_cols, cache=self.object_cache, sig=sig,
                )
            except OSError:
                continue
            rows.extend((k, 1, v) for k, v in new)
            self._seen[opath] = sig
            self._emitted[opath] = new
            self.session.insert_batch(rows, self.offset_state())

    def _loop(self):
        fs, _ = _open_fs(self.path, self.settings)
        scans = 0
        while not self._stop.is_set():
            try:
                self._scan(fs)
            except OSError:
                pass
            scans += 1
            if self.object_cache is not None and scans % 60 == 0:
                # bound cache growth: superseded object versions pile up
                # one per change otherwise
                try:
                    self.object_cache.vacuum()
                except OSError:
                    pass
            self._stop.wait(self.refresh_s)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "csv",
    schema: Any = None,
    mode: str = "streaming",
    name: str | None = None,
    persistent_id: str | None = None,
    object_cache: Any = None,
    **kwargs: Any,
) -> Table:
    """``object_cache`` — a persistence Backend or CachedObjectStorage:
    unchanged objects are served from the local versioned blob cache
    instead of being re-downloaded (upstream Pathway: cached_object_storage.rs)."""
    if object_cache is not None:
        from pathway_tpu_torch.persistence.cached_object_storage import (
            CachedObjectStorage,
        )

        if not isinstance(object_cache, CachedObjectStorage):
            object_cache = CachedObjectStorage(object_cache)
    if format in ("plaintext", "plaintext_by_file"):
        column_names = ["data"]
        dtypes = {"data": dt.STR}
        schema_ = None
    elif format == "binary":
        column_names = ["data"]
        dtypes = {"data": dt.BYTES}
        schema_ = None
    else:
        assert schema is not None, f"schema required for format {format!r}"
        column_names = list(schema.column_names())
        dtypes = dict(schema.dtypes())
        schema_ = schema
    pk_cols = schema_.primary_key_columns() if schema_ else None
    if mode == "static":
        source: Any = _S3StaticSource(
            path, aws_s3_settings, format, schema_, column_names, pk_cols,
            object_cache=object_cache,
        )
    else:
        source = _S3StreamingSource(
            path, aws_s3_settings, format, schema_, column_names, pk_cols,
            object_cache=object_cache,
        )
    source.persistent_id = persistent_id or name
    node = InputNode(source, column_names)
    return Table._from_node(node, dtypes, Universe())
