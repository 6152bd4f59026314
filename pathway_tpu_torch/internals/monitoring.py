"""In-terminal monitoring dashboard — counterpart of
``pathway_tpu/internals/monitoring.py``.

The rich TUI of upstream Pathway (python/pathway/internals/monitoring.py:165
StatsMonitor — a `rich` live dashboard with a connectors table and an
operator-latency table, fed by engine prober callbacks). Here it renders
RuntimeStats on a timer while the tick loop runs. ``rich`` is imported when
the dashboard renders, never at import: without it (the card's machine has
none) ``start`` logs that the dashboard is off and the run goes on.
"""

from __future__ import annotations

import logging
import threading
from typing import Any


def _has_rich() -> bool:
    try:
        import rich  # noqa: F401
    except ImportError:
        return False
    return True


class StatsMonitor:
    def __init__(self, runtime: Any, refresh_s: float = 0.5):
        self.runtime = runtime
        self.refresh_s = refresh_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _render(self):
        from rich.console import Group
        from rich.table import Table as RichTable

        s = self.runtime.stats
        names = {n.id: f"{n.name}#{n.id}" for n in self.runtime.order}
        conn = RichTable(title="connectors")
        conn.add_column("input")
        conn.add_column("rows ingested", justify="right")
        for nid, v in sorted(s.rows_in.items()):
            conn.add_row(names.get(nid, str(nid)), str(v))
        ops = RichTable(title="operators")
        ops.add_column("operator")
        ops.add_column("rows", justify="right")
        ops.add_column("cumulative s", justify="right")
        for nid, ns in sorted(
            s.node_ns.items(), key=lambda kv: -kv[1]
        )[:20]:
            ops.add_row(
                names.get(nid, str(nid)),
                str(s.node_rows.get(nid, 0)),
                f"{ns / 1e9:.3f}",
            )
        header = (
            f"logical time: {s.current_time}   ticks: {s.ticks}   "
            f"rows in: {sum(s.rows_in.values())}   "
            f"rows out: {sum(s.rows_out.values())}"
        )
        return Group(header, conn, ops)

    def _loop(self):  # pragma: no cover - interactive path
        from rich.console import Console
        from rich.live import Live

        with Live(
            self._render(), console=Console(), refresh_per_second=4
        ) as live:
            while not self._stop.wait(self.refresh_s):
                live.update(self._render())

    def start(self) -> None:
        if not _has_rich():
            logging.getLogger("pathway_tpu_torch").warning(
                "monitoring dashboard off: the rich package is not installed"
            )
            return
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
