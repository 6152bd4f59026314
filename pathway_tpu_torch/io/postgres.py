"""Own copy of ``pathway_tpu/io/postgres.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.postgres — PostgreSQL sink.

Counterpart of upstream Pathway's PsqlWriter + formatters
(upstream Pathway: src/connectors/data_storage.rs:1059 PsqlWriter;
data_format.rs:1712 PsqlUpdatesFormatter — INSERT with time/diff columns;
:1771 PsqlSnapshotFormatter — exactly-once upserts on primary key).
Requires `psycopg2` (or psycopg) at call time.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.io._utils import add_writer, jsonable


def _connect(postgres_settings: dict):
    try:
        import psycopg2 as pg  # type: ignore[import-not-found]
    except ImportError:
        from pathway_tpu_torch.io._utils import require

        pg = require("psycopg", "postgres")
    return pg.connect(**postgres_settings)


def write(
    table,
    postgres_settings: dict,
    table_name: str,
    *,
    max_batch_size: int | None = None,
    init_mode: str = "default",
    **kwargs: Any,
) -> None:
    """Stream-of-updates mode: append rows with time/diff columns
    (upstream Pathway: PsqlUpdatesFormatter)."""
    column_names = table.column_names()
    state: dict[str, Any] = {"conn": None}

    def conn():
        if state["conn"] is None:
            state["conn"] = _connect(postgres_settings)
            if init_mode in ("create", "create_if_not_exists", "replace"):
                with state["conn"].cursor() as cur:
                    if init_mode == "replace":
                        cur.execute(f'DROP TABLE IF EXISTS "{table_name}"')
                    cols = ", ".join(f'"{c}" TEXT' for c in column_names)
                    cur.execute(
                        f'CREATE TABLE IF NOT EXISTS "{table_name}" '
                        f"({cols}, time BIGINT, diff BIGINT)"
                    )
                state["conn"].commit()
        return state["conn"]

    def on_batch(t: int, batch: DiffBatch) -> None:
        c = conn()
        cols = ", ".join(f'"{n}"' for n in column_names)
        ph = ", ".join(["%s"] * (len(column_names) + 2))
        with c.cursor() as cur:
            for _k, d, vals in batch.iter_rows():
                cur.execute(
                    f'INSERT INTO "{table_name}" ({cols}, time, diff) '  # noqa: S608
                    f"VALUES ({ph})",
                    tuple(jsonable(v) for v in vals) + (t, d),
                )
        c.commit()

    def on_end():
        if state["conn"] is not None:
            state["conn"].close()

    add_writer(table, on_batch, on_end)


def write_snapshot(
    table,
    postgres_settings: dict,
    table_name: str,
    primary_key: list[str],
    *,
    max_batch_size: int | None = None,
    **kwargs: Any,
) -> None:
    """Snapshot mode: upsert on primary key, delete on retraction
    (upstream Pathway: PsqlSnapshotFormatter, data_format.rs:1771)."""
    column_names = table.column_names()
    state: dict[str, Any] = {"conn": None}

    def conn():
        if state["conn"] is None:
            state["conn"] = _connect(postgres_settings)
        return state["conn"]

    def on_batch(t: int, batch: DiffBatch) -> None:
        c = conn()
        cols = ", ".join(f'"{n}"' for n in column_names)
        ph = ", ".join(["%s"] * len(column_names))
        pk_cols = ", ".join(f'"{c_}"' for c_ in primary_key)
        updates = ", ".join(
            f'"{n}" = EXCLUDED."{n}"'
            for n in column_names
            if n not in primary_key
        )
        with c.cursor() as cur:
            for _k, d, vals in batch.iter_rows():
                row = {n: jsonable(v) for n, v in zip(column_names, vals)}
                if d > 0:
                    sql = (
                        f'INSERT INTO "{table_name}" ({cols}) VALUES ({ph}) '  # noqa: S608
                        f"ON CONFLICT ({pk_cols}) DO UPDATE SET {updates}"
                        if updates
                        else f'INSERT INTO "{table_name}" ({cols}) VALUES ({ph}) '  # noqa: S608
                        f"ON CONFLICT ({pk_cols}) DO NOTHING"
                    )
                    cur.execute(sql, tuple(row[n] for n in column_names))
                else:
                    cond = " AND ".join(f'"{c_}" = %s' for c_ in primary_key)
                    cur.execute(
                        f'DELETE FROM "{table_name}" WHERE {cond}',  # noqa: S608
                        tuple(row[c_] for c_ in primary_key),
                    )
        c.commit()

    def on_end():
        if state["conn"] is not None:
            state["conn"].close()

    add_writer(table, on_batch, on_end)
