"""pw.demo — synthetic demo streams: the port's own copy of
``pathway_tpu/demo/__init__.py`` (reference: python/pathway/demo/
__init__.py:28-164), over the port's ``pw.io.python``.

As in the JAX package, ``generate_custom_stream`` accepts
``autocommit_duration_ms`` and does not pass it on, so rows reach the
engine at the python connector's default autocommit (1500 ms) or when the
stream ends; ``replay_csv`` sleeps ``1 / input_rate`` per row unless
``input_rate <= 0``; ``replay_csv_with_time`` replays without its time
column's pacing. Nothing is left out."""

from __future__ import annotations

import csv as _csv
import time
from typing import Any, Callable, Mapping

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read


def generate_custom_stream(
    value_generators: Mapping[str, Callable[[int], Any]],
    *,
    schema: Any,
    nb_rows: int | None = None,
    autocommit_duration_ms: int = 1000,
    input_rate: float = 1.0,
    persistent_id: str | None = None,
    name: str | None = None,
) -> Table:
    class StreamSubject(ConnectorSubject):
        def run(self) -> None:
            i = 0
            while nb_rows is None or i < nb_rows:
                values = {
                    name: gen(i) for name, gen in value_generators.items()
                }
                self.next(**values)
                i += 1
                if input_rate > 0:
                    time.sleep(1.0 / input_rate)

    return python_read(StreamSubject(), schema=schema, name=name)


def noisy_linear_stream(nb_rows: int = 10, input_rate: float = 1.0) -> Table:
    import random

    return generate_custom_stream(
        {
            "x": lambda i: float(i),
            "y": lambda i: float(i) + random.uniform(-1, 1),
        },
        schema=schema_from_types(x=float, y=float),
        nb_rows=nb_rows,
        input_rate=input_rate,
    )


def range_stream(
    nb_rows: int = 30,
    offset: int = 0,
    input_rate: float = 1.0,
    autocommit_duration_ms: int = 1000,
) -> Table:
    return generate_custom_stream(
        {"value": lambda i: float(i + offset)},
        schema=schema_from_types(value=float),
        nb_rows=nb_rows,
        input_rate=input_rate,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def replay_csv(
    path: str,
    *,
    schema: Any,
    input_rate: float = 1.0,
) -> Table:
    class ReplaySubject(ConnectorSubject):
        def run(self) -> None:
            with open(path, newline="") as f:
                for row in _csv.DictReader(f):
                    coerced = {}
                    for name, d in schema.dtypes().items():
                        v = row.get(name)
                        sd = d.strip_optional()
                        if sd == dt.INT:
                            coerced[name] = int(v)
                        elif sd == dt.FLOAT:
                            coerced[name] = float(v)
                        elif sd == dt.BOOL:
                            coerced[name] = str(v).lower() in ("true", "1")
                        else:
                            coerced[name] = v
                    self.next(**coerced)
                    if input_rate > 0:
                        time.sleep(1.0 / input_rate)

    return python_read(ReplaySubject(), schema=schema)


def replay_csv_with_time(path: str, *, schema: Any, time_column: str, unit: str = "s", **kw) -> Table:
    return replay_csv(path, schema=schema)
