"""The port's own copy of ``pathway_tpu/internals/config.py``. Runtime configuration from env vars
(reference: python/pathway/internals/config.py:58-97 +
src/engine/dataflow/config.rs:88-121)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


@dataclass
class PathwayConfig:
    ignore_asserts: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_IGNORE_ASSERTS")
    )
    runtime_typechecking: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_RUNTIME_TYPECHECKING")
    )
    terminate_on_error: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_TERMINATE_ON_ERROR", True)
    )
    monitoring_server: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_MONITORING_SERVER")
    )
    replay_storage: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_REPLAY_STORAGE")
    )
    snapshot_access: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_SNAPSHOT_ACCESS")
    )
    persistence_mode: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_PERSISTENCE_MODE")
    )
    license_key: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_LICENSE_KEY")
    )
    process_id: int = field(
        default_factory=lambda: int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    )
    processes: int = field(
        default_factory=lambda: int(os.environ.get("PATHWAY_PROCESSES", "1"))
    )
    threads: int = field(
        default_factory=lambda: int(os.environ.get("PATHWAY_THREADS", "1"))
    )
    first_port: int = field(
        default_factory=lambda: int(os.environ.get("PATHWAY_FIRST_PORT", "10000"))
    )


pathway_config = PathwayConfig()


def get_pathway_config() -> PathwayConfig:
    return pathway_config


def serving_bulk_chunk() -> int:
    """Max bulk-session rows drained per tick while an interactive
    (Surge Gate) session is hot — bounds how long a serving tick can
    stall behind ingest/backfill. Re-read per run like engine_threads."""
    raw = os.environ.get("PATHWAY_SERVING_BULK_CHUNK", "")
    try:
        return max(1, int(raw)) if raw else 128
    except ValueError:
        return 128


def engine_threads() -> int:
    """Worker-thread count at RUN start. The reference re-reads the env
    per run (Config::from_env, src/engine/dataflow/config.rs:88), unlike
    the import-time PathwayConfig snapshot; the env wins when set."""
    raw = os.environ.get("PATHWAY_THREADS", "")
    try:
        return max(1, int(raw)) if raw else max(1, pathway_config.threads)
    except ValueError:
        return max(1, pathway_config.threads)
