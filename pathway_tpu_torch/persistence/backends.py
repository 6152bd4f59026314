"""Own copy of ``pathway_tpu/persistence/backends.py``: the same store
layout, so a store written by either package opens in the other. fsspec is
imported only when an ``FsspecStore`` is built.

Persistence backend stores — blob KV abstraction, the equivalent of
upstream Pathway's `PersistenceBackend` family
(src/persistence/backends/{file,s3,memory,mock}.rs): a tiny
key->bytes store with atomic writes, used by the input event log, offset
snapshots and metadata commits. The filesystem store is the production
backend; the memory store keeps a process-global registry so tests can
"restart" an engine in-process and find their snapshot again.
"""

from __future__ import annotations

import os
import threading


class BackendStore:
    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def get_buffer(self, key: str) -> memoryview | None:
        """Read-only buffer view of a blob — stores that can, serve it
        zero-copy (the filesystem store mmaps, so segment recovery is
        O(page faults), not O(read+copy)); the default materializes."""
        data = self.get(key)
        return None if data is None else memoryview(data)

    def remove(self, key: str) -> None:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> list[str]:
        raise NotImplementedError


class FilesystemStore(BackendStore):
    """Atomic blob store on a local (or NFS/GCS-fuse) directory.

    Writes go to a temp file + rename so a crash mid-write never leaves a
    torn blob (the reference gets the same guarantee from its file backend,
    src/persistence/backends/file.rs)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)

    def get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def get_buffer(self, key: str) -> memoryview | None:
        """mmap the blob read-only: arrays built over this view fault
        pages in lazily, which is what makes segment recovery
        O(mmap + manifest) instead of O(state bytes)."""
        import mmap as _mmap

        try:
            with open(self._path(key), "rb") as f:
                try:
                    mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
                except ValueError:  # empty file cannot be mapped
                    return memoryview(f.read())
        except OSError:
            return None
        return memoryview(mm)

    def list_keys(self, prefix: str = "") -> list[str]:
        out = []
        for root, _dirs, files in os.walk(self.root):
            for f in files:
                if f.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(root, f), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def remove(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass


_MEMORY_REGISTRY: dict[str, dict[str, bytes]] = {}
_MEMORY_LOCK = threading.Lock()


class MemoryStore(BackendStore):
    """Process-global in-memory store (reference: backends/memory.rs).
    Two engines constructed with the same `name` share the blobs — this is
    the test harness for kill/restart cycles without touching disk."""

    def __init__(self, name: str = "default"):
        with _MEMORY_LOCK:
            self._blobs = _MEMORY_REGISTRY.setdefault(name, {})

    def put(self, key: str, data: bytes) -> None:
        with _MEMORY_LOCK:
            self._blobs[key] = data

    def get(self, key: str) -> bytes | None:
        with _MEMORY_LOCK:
            return self._blobs.get(key)

    def list_keys(self, prefix: str = "") -> list[str]:
        with _MEMORY_LOCK:
            return sorted(k for k in self._blobs if k.startswith(prefix))

    def remove(self, key: str) -> None:
        with _MEMORY_LOCK:
            self._blobs.pop(key, None)


class FsspecStore(BackendStore):
    """Object-store backend over a real client (reference:
    src/persistence/backends/s3.rs:150 over rust-s3). Any fsspec protocol
    works — ``s3://`` (s3fs), ``gs://`` (gcsfs), ``memory://`` (in-process
    fake object store, how tests exercise this path without credentials).
    Object-store PUTs are atomic per object, giving the same torn-write
    guarantee the filesystem store gets from rename."""

    def __init__(self, url: str, storage_options: dict | None = None):
        import fsspec

        assert "://" in url, f"expected a protocol URL, got {url!r}"
        self.protocol, rest = url.split("://", 1)
        self.fs = fsspec.filesystem(self.protocol, **(storage_options or {}))
        self.root = rest.rstrip("/")

    def _path(self, key: str) -> str:
        return f"{self.root}/{key}"

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        if "/" in key:
            # directory-backed protocols (file://) need parents; a no-op
            # on true object stores
            try:
                self.fs.makedirs(path.rsplit("/", 1)[0], exist_ok=True)
            except OSError:
                pass
        self.fs.pipe_file(path, data)

    def get(self, key: str) -> bytes | None:
        try:
            return self.fs.cat_file(self._path(key))
        except OSError:
            return None

    def list_keys(self, prefix: str = "") -> list[str]:
        # narrow the listing to the deepest directory of the prefix
        base = f"{self.root}/{prefix}"
        directory = base.rsplit("/", 1)[0]
        try:
            found = self.fs.find(directory)
        except OSError:
            return []
        out = []
        lead = f"{self.root}/"
        for p in found:
            p = p.lstrip("/")
            if not p.startswith(lead.lstrip("/")):
                continue
            rel = p[len(lead.lstrip("/")) :]
            if rel.startswith(prefix):
                out.append(rel)
        return sorted(out)

    def remove(self, key: str) -> None:
        try:
            self.fs.rm_file(self._path(key))
        except OSError:
            pass


def store_for_backend(backend) -> BackendStore:
    """Map a user-facing `pw.persistence.Backend` config onto a store."""
    kind = getattr(backend, "kind", "filesystem")
    if kind == "filesystem":
        return FilesystemStore(backend.path)
    if kind == "memory" or kind == "mock":
        return MemoryStore(getattr(backend, "name", "default"))
    if kind == "s3":
        root = getattr(backend, "root_path", ".")
        if "://" in root:
            settings = getattr(backend, "bucket_settings", None)
            if settings is None:
                opts = None
            elif hasattr(settings, "storage_options"):
                opts = settings.storage_options()
            elif isinstance(settings, dict):
                opts = settings
            else:
                # silently dropping explicit credentials would connect
                # with ambient identity and fail far from the cause
                raise TypeError(
                    "bucket_settings must be an AwsS3Settings-like object "
                    "with .storage_options() or a dict of fsspec storage "
                    f"options, got {type(settings).__name__}"
                )
            return FsspecStore(root, opts)
        # bare path: a mounted object store (gcsfuse/s3fs mount)
        return FilesystemStore(root)
    raise ValueError(f"unknown persistence backend kind {kind!r}")
