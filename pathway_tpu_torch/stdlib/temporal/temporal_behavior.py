"""The port's own copy of ``pathway_tpu/stdlib/temporal/temporal_behavior.py``. Temporal behaviors: delay / cutoff / memory-release for windows and joins
(reference: python/pathway/stdlib/temporal/temporal_behavior.py; engine side
postpone/forget/freeze, src/engine/dataflow/operators/time_column.rs:248,426,509).

On this engine the three mechanisms are the BufferNode / FreezeNode /
ForgetNode microbatch operators (pathway_tpu_torch/engine/nodes.py): each tracks the
maximum time seen on its time column (the operator's own watermark, like the
reference's `current time`) and respectively postpones, drops-late, or
retracts-stale rows against a per-row threshold column.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.engine import nodes
from pathway_tpu_torch.internals.common import apply_with_type
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.universe import Universe


class Behavior:
    """Base class of all temporal behaviors."""


@dataclass
class CommonBehavior(Behavior):
    """delay / cutoff / keep_results configuration of a temporal operator."""

    delay: Any | None
    cutoff: Any | None
    keep_results: bool


def common_behavior(
    delay: Any | None = None,
    cutoff: Any | None = None,
    keep_results: bool = True,
) -> CommonBehavior:
    """For windows: ``delay`` postpones a window's first output until the
    operator time passes window_start + delay; ``cutoff`` stops updating (and
    drops late data for) windows ending before max_time - cutoff;
    ``keep_results=False`` additionally retracts results of such closed
    windows. For interval/asof joins the same thresholds apply to each input
    record's own time."""
    assert not (cutoff is None and not keep_results)
    return CommonBehavior(delay, cutoff, keep_results)


@dataclass
class ExactlyOnceBehavior(Behavior):
    shift: Any | None


def exactly_once_behavior(shift: Any | None = None) -> ExactlyOnceBehavior:
    """Each window produces exactly one output, `shift` after the window
    closes; late data is dropped."""
    return ExactlyOnceBehavior(shift)


# ---------------------------------------------------------------------------
# Engine glue: wrap a table in buffer/freeze/forget nodes.


def _temporal_table(table, node_cls, threshold_expr, time_expr, **kw):
    """Build `node_cls(prep, _pw_thr, _pw_cur)` over `table` and return a
    Table with the original columns."""
    from pathway_tpu_torch.internals.table import Table

    cols = {n: table[n] for n in table.column_names()}
    prep = table._build_rowwise(
        {**cols, "_pw_thr": threshold_expr, "_pw_cur": time_expr}
    )
    node = node_cls(prep._node, "_pw_thr", "_pw_cur", **kw)
    out = Table._from_node(
        node,
        {n: prep._schema[n].dtype for n in prep.column_names()},
        Universe(),
    )
    return out.without("_pw_thr", "_pw_cur")


def _shifted(time_ref, delta):
    """time + delta as an expression; delta may be an int/float/timedelta."""
    if delta is None:
        return time_ref
    return apply_with_type(lambda t: None if t is None else t + delta, dt.ANY, time_ref)


def apply_behavior(
    table,
    time_col: str,
    start_col: str,
    end_col: str,
    behavior: Behavior | None,
):
    """Apply a window behavior to the flattened (row, window) table.

    time_col/start_col/end_col name columns of `table` holding each row's
    event time and its window's [start, end). Column references are re-taken
    from the current table at every wrapping step so chained behavior nodes
    stay single-input."""
    if behavior is None:
        return table
    if isinstance(behavior, ExactlyOnceBehavior):
        shift = behavior.shift
        # drop anything arriving after the window already fired, then hold
        # everything until the window closes -> single emission per window
        table = _temporal_table(
            table, nodes.FreezeNode, _shifted(table[end_col], shift),
            table[time_col],
        )
        table = _temporal_table(
            table, nodes.BufferNode, _shifted(table[end_col], shift),
            table[time_col],
        )
        return table
    assert isinstance(behavior, CommonBehavior)
    if behavior.cutoff is not None:
        table = _temporal_table(
            table, nodes.FreezeNode,
            _shifted(table[end_col], behavior.cutoff), table[time_col],
        )
        if not behavior.keep_results:
            table = _temporal_table(
                table, nodes.ForgetNode,
                _shifted(table[end_col], behavior.cutoff), table[time_col],
            )
    if behavior.delay is not None:
        table = _temporal_table(
            table, nodes.BufferNode,
            _shifted(table[start_col], behavior.delay), table[time_col],
        )
    return table


def apply_behavior_to_side(table, time_col: str, behavior: Behavior | None):
    """Behavior on one input of an interval/asof join: thresholds are keyed to
    each record's own time (reference semantics: delay the record, ignore
    too-old records)."""
    if behavior is None:
        return table
    if isinstance(behavior, ExactlyOnceBehavior):
        raise TypeError(
            "exactly_once_behavior applies to windows, not temporal joins"
        )
    assert isinstance(behavior, CommonBehavior)
    if behavior.cutoff is not None:
        table = _temporal_table(
            table, nodes.FreezeNode,
            _shifted(table[time_col], behavior.cutoff), table[time_col],
        )
        if not behavior.keep_results:
            table = _temporal_table(
                table, nodes.ForgetNode,
                _shifted(table[time_col], behavior.cutoff), table[time_col],
            )
    if behavior.delay is not None:
        table = _temporal_table(
            table, nodes.BufferNode,
            _shifted(table[time_col], behavior.delay), table[time_col],
        )
    return table
