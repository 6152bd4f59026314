"""pw.persistence — checkpoint/resume configuration. Own copy of
``pathway_tpu/persistence/__init__.py`` (upstream Pathway:
python/pathway/persistence/__init__.py + src/persistence/).

The engine glue (input event logs + state snapshots + resume) lives in
``_runtime_glue.py``; blob stores in ``backends.py``; the segment codec, the
on-disk form of an arrangement shared with ``pathway_tpu/persistence``, in
``segments.py``; the pickles both packages read in ``_pickle.py``."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any


class Backend:
    kind: str = "none"

    @classmethod
    def filesystem(cls, path: str | os.PathLike) -> "FilesystemBackend":
        return FilesystemBackend(str(path))

    @classmethod
    def s3(cls, root_path: str, bucket_settings: Any = None) -> "S3Backend":
        return S3Backend(root_path, bucket_settings)

    @classmethod
    def azure(cls, root_path: str, account: Any = None, **kw) -> "S3Backend":
        return S3Backend(root_path, account)

    @classmethod
    def mock(cls, events: Any = None, name: str = "default") -> "MockBackend":
        return MockBackend(name=name)

    @classmethod
    def memory(cls, name: str = "default") -> "MockBackend":
        return MockBackend(name=name)


@dataclass
class FilesystemBackend(Backend):
    path: str
    kind: str = "filesystem"


@dataclass
class S3Backend(Backend):
    root_path: str
    bucket_settings: Any = None
    kind: str = "s3"


@dataclass
class MockBackend(Backend):
    kind: str = "mock"
    store: dict = field(default_factory=dict)
    name: str = "default"


class PersistenceMode:
    """(reference: src/connectors/mod.rs:108 PersistenceMode)"""

    BATCH = "batch"
    SPEEDRUN = "speedrun"
    PERSISTING = "persisting"
    OPERATOR_PERSISTING = "operator_persisting"
    # only operators with an explicit name persist; inputs are not logged
    # (reference: SELECTIVE_PERSISTING in src/connectors/mod.rs:108)
    SELECTIVE_PERSISTING = "selective_persisting"


class SnapshotAccess:
    """(reference: src/connectors/mod.rs:154 SnapshotAccess) — `record`
    writes the input log without replaying (record/replay debugging),
    `replay` reads it without recording, `full` does both."""

    RECORD = "record"
    REPLAY = "replay"
    FULL = "full"


@dataclass
class Config:
    backend: Backend | None = None
    snapshot_interval_ms: int = 0
    snapshot_access: Any = None
    persistence_mode: Any = None
    continue_after_replay: bool = True
    # operator-state snapshots (reference: operator_snapshot.rs + the
    # OPERATOR_PERSISTING mode): every `snapshot_every`-th data commit dumps
    # all exec states and truncates the covered input log, bounding both
    # restart replay and log growth. False = input-log-only persistence.
    snapshot_operators: bool = True
    snapshot_every: int = 8

    @classmethod
    def simple_config(
        cls,
        backend: Backend,
        snapshot_interval_ms: int = 0,
        **kwargs: Any,
    ) -> "Config":
        return cls(
            backend=backend, snapshot_interval_ms=snapshot_interval_ms, **kwargs
        )


def simple_config(backend: Backend, **kwargs: Any) -> Config:
    return Config.simple_config(backend, **kwargs)
