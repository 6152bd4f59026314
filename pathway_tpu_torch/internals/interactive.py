"""LiveTable — live results on a separately running graph: the port's own
copy of ``pathway_tpu/internals/interactive.py`` (reference:
python/pathway/internals/interactive.py:130 — LiveTable runs a background
GraphRunner thread over an export datasink and mirrors the table back into
the session through an import datasource). Here, as in the JAX package, a
background Runtime streams diffs into an in-memory snapshot with:

- ``snapshot()`` and a ``frontier()`` (the last completed logical time,
  END_OF_TIME when the run finished);
- ``subscribe(on_change)`` — push notifications per diff, with the
  current state replayed first so late subscribers see full history;
- ``table()`` — the import half of the reference's export/import pair: a
  fresh Table in the CURRENT parse graph fed live from this mirror, so
  interactive results compose into new dataflows.

The run's thread is the one that first builds and launches a kernel on
the card: a failure there lands in ``error`` and ``wait()`` raises it. No
CPU runtime is swapped in. ``to_pandas`` imports pandas when called.
Nothing is left out.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from pathway_tpu_torch.engine.batch import END_OF_TIME, DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode, OutputNode
from pathway_tpu_torch.engine.runtime import Runtime, StreamingSource
from pathway_tpu_torch.internals import parse_graph


class LiveTable:
    def __init__(self, table: Any):
        self._table = table
        self._column_names = table.column_names()
        self._rows: dict[int, tuple] = {}
        self._lock = threading.Lock()  # state: rows/frontier/subscribers
        # callbacks run OUTSIDE _lock (so they may call frontier()/
        # snapshot()/len() without deadlocking) but UNDER _deliver_lock,
        # which serializes replay-then-follow ordering per subscriber
        self._deliver_lock = threading.Lock()
        self._frontier = 0
        self._done = threading.Event()
        self.error: BaseException | None = None
        self._subscribers: list[Callable] = []
        self._runtime: Runtime | None = None
        self._thread: threading.Thread | None = None
        self._start()

    def _on_batch(self, t: int, batch: DiffBatch) -> None:
        with self._deliver_lock:
            with self._lock:
                self._frontier = max(self._frontier, t)
                subs = list(self._subscribers)
                deliveries = []
                for k, d, vals in batch.iter_rows():
                    if d > 0:
                        self._rows[k] = vals
                    else:
                        self._rows.pop(k, None)
                    if subs:
                        deliveries.append(
                            (k, dict(zip(self._column_names, vals)), d > 0)
                        )
            for k, row, add in deliveries:
                for cb in subs:
                    try:
                        cb(k, row, t, add)
                    except Exception:
                        pass

    def _start(self) -> None:
        # only this table's mirror output — globally declared sinks must
        # not run as a side effect of peeking at a table
        node = OutputNode(self._table._node, self._on_batch)
        G = parse_graph.G
        self._runtime = Runtime([node], autocommit_ms=50, distributed=False)
        G.last_runtime = self._runtime

        def run():
            try:
                self._runtime.run()
            except Exception as exc:  # keep the notebook alive, keep the
                self.error = exc  # failure observable (reference: failed())
            finally:
                with self._lock:
                    self._frontier = END_OF_TIME
                self._done.set()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    # --- reference-parity surface --------------------------------------------

    def frontier(self) -> int:
        with self._lock:
            return self._frontier

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def failed(self) -> bool:
        return self.error is not None

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the background run finishes. Raises if the run
        failed — a crashed run must not read as clean completion."""
        finished = self._done.wait(timeout)
        if finished and self.error is not None:
            raise RuntimeError(
                f"live table's background run failed: {self.error!r}"
            ) from self.error
        return finished

    def subscribe(self, on_change: Callable) -> Callable:
        """Register on_change(key, row, time, is_addition); the current
        state is replayed first (as insertions at the current frontier),
        then every subsequent diff is delivered in order. Returns the
        callback as an unsubscribe handle."""
        with self._deliver_lock:
            with self._lock:
                replay = [
                    (k, dict(zip(self._column_names, vals)), self._frontier)
                    for k, vals in self._rows.items()
                ]
                self._subscribers.append(on_change)
            for k, row, t in replay:
                try:
                    on_change(k, row, t, True)
                except Exception:
                    pass
        return on_change

    def unsubscribe(self, handle: Callable) -> None:
        with self._lock:
            if handle in self._subscribers:
                self._subscribers.remove(handle)

    def snapshot(self) -> tuple[int, dict[int, tuple]]:
        """(frontier, rows) — the reference's LiveTableSnapshot."""
        with self._lock:
            return self._frontier, dict(self._rows)

    def table(self) -> Any:
        """Import this live mirror into the CURRENT parse graph as a new
        streaming source (reference: import_table/ImportDataSource) so
        interactive results can feed further dataflows."""
        from pathway_tpu_torch.internals.table import Table
        from pathway_tpu_torch.internals.universe import Universe

        source = _LiveImportSource(self)
        node = InputNode(source, self._column_names)
        dtypes = {
            n: self._table._schema[n].dtype for n in self._column_names
        }
        return Table._from_node(node, dtypes, Universe())

    # --- views ---------------------------------------------------------------

    def to_pandas(self):
        import pandas as pd

        with self._lock:
            keys = list(self._rows.keys())
            data = {
                n: [self._rows[k][i] for k in keys]
                for i, n in enumerate(self._column_names)
            }
        return pd.DataFrame(data, index=keys)

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def _repr_html_(self) -> str:
        return self.to_pandas()._repr_html_()

    def __repr__(self) -> str:
        return repr(self.to_pandas())

    def stop(self) -> None:
        if self._runtime is not None:
            self._runtime.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)


class _LiveImportSource(StreamingSource):
    """Feeds a LiveTable's snapshot + subsequent diffs into a session of a
    NEW graph; closes when the live run finishes."""

    def __init__(self, live_table: LiveTable):
        super().__init__(live_table._column_names)
        self._live = live_table
        self._watcher: threading.Thread | None = None
        self._handle: Callable | None = None

    def start(self) -> None:
        cols = self.column_names

        def on_change(k, row, t, is_addition):
            vals = tuple(row[n] for n in cols)
            rows = [(k, 1 if is_addition else -1, vals)]
            self.session.insert_batch(rows)

        self._handle = self._live.subscribe(on_change)

        def watch():
            self._live._done.wait()
            self.session.close()

        self._watcher = threading.Thread(target=watch, daemon=True)
        self._watcher.start()

    def stop(self) -> None:
        # detach so a stopped downstream graph doesn't keep accumulating
        # rows in a session nobody drains
        if self._handle is not None:
            self._live.unsubscribe(self._handle)
            self._handle = None


def live(table: Any) -> LiveTable:
    """Start the declared dataflow in the background and return a live view
    of `table` (Jupyter-friendly)."""
    return LiveTable(table)
