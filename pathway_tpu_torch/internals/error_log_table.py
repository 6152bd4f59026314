"""The port's own copy of ``pathway_tpu/internals/error_log_table.py``. Error log exposed as a table (reference: global_error_log,
python/pathway/internals/errors.py).

The log node DRAINS newly-recorded errors every tick (and at the final
tick), so errors produced during the same run appear in the table —
matching the reference, where the error log is itself a streaming table
fed by the engine. Scoped logs (pw.local_error_log) see only entries
tagged with their scope id; the global log sees untagged entries.
"""

from __future__ import annotations

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import Node, NodeExec
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import sequential_key
from pathway_tpu_torch.internals.errors import peek_errors
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe

_COLS = ["message", "operator_id", "trace"]


class ErrorLogNode(Node):
    def __init__(self, scope: int | None):
        super().__init__([], _COLS)
        self.scope = scope

    def make_exec(self):
        return ErrorLogExec(self)


class ErrorLogExec(NodeExec):
    def __init__(self, node: ErrorLogNode):
        super().__init__(node)
        self._pos = 0  # position in the FULL log (all scopes)

    def _drain(self) -> list[DiffBatch]:
        errs = peek_errors()
        rows = []
        for i in range(self._pos, len(errs)):
            e = errs[i]
            if e.get("log_id") != self.node.scope:
                continue
            rows.append(
                (
                    int(sequential_key(i)),
                    1,
                    (e["message"], e["operator_id"], e["trace"]),
                )
            )
        self._pos = len(errs)
        if not rows:
            return []
        return [DiffBatch.from_rows(rows, _COLS)]

    def process(self, t, inputs):
        return self._drain()

    def on_end(self):
        return self._drain()

    def state_dict(self):
        return None  # the log is process-transient, never snapshotted


def error_log_table(scope: int | None = None) -> Table:
    node = ErrorLogNode(scope)
    return Table._from_node(
        node,
        {"message": dt.STR, "operator_id": dt.STR, "trace": dt.STR},
        Universe(),
    )
