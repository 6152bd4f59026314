"""The port's own copy of ``pathway_tpu/stdlib/temporal/_interval_join.py``. Interval joins (reference: python/pathway/stdlib/temporal/_interval_join.py
— there desugared into bucketed equijoins over differential collections; here
a dedicated incremental IntervalJoinNode on the microbatch engine)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.engine.temporal_nodes import IntervalJoinNode
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult
from pathway_tpu_torch.internals.table import desugar
from pathway_tpu_torch.internals.thisclass import (
    left as left_ph,
    right as right_ph,
    this as this_ph,
)
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    Behavior,
    apply_behavior_to_side,
)


@dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound, upper_bound) -> Interval:
    """The allowed difference `other_time - self_time` of matching rows.
    Validation happens at the JOIN, not here: mixed bound kinds get the
    reference's Arguments-have-to-be-of-types message, and lower > upper
    the ValueError — both only once the join is built."""
    return Interval(lower_bound, upper_bound)


def _validate_interval_join_types(
    left, right, left_time, right_time, interval, left_on, right_on
) -> None:
    """Build-time validation (reference: interval_join check_joint_types
    over eval_type + join-condition typing)."""
    from pathway_tpu_torch.stdlib.temporal.utils import (
        check_joint_kinds,
        expr_kind,
        validate_join_condition_types,
        value_kind,
    )

    check_joint_kinds(
        {
            "self_time_expression": (expr_kind(left, left_time), "time"),
            "other_time_expression": (expr_kind(right, right_time), "time"),
            "lower_bound": (value_kind(interval.lower_bound), "interval"),
            "upper_bound": (value_kind(interval.upper_bound), "interval"),
        }
    )
    try:
        bad = interval.lower_bound > interval.upper_bound
    except TypeError:  # unreachable: check_joint_kinds already raised
        bad = False
    if bad:
        raise ValueError(
            "interval lower_bound has to be less than or equal to upper_bound"
        )
    validate_join_condition_types(left, right, left_on, right_on)


class IntervalJoinResult(JoinResult):
    """Lazy interval join; `.select(...)` with pw.left / pw.right / pw.this
    materializes, like a regular join."""

    def __init__(
        self,
        left,
        right,
        left_time,
        right_time,
        interval: Interval,
        on,
        mode: JoinMode,
        behavior: Behavior | None = None,
    ):
        super().__init__(left, right, on, mode)
        self._left_time = desugar(left_time, {left_ph: left, this_ph: left})
        self._right_time = desugar(
            right_time, {right_ph: right, this_ph: right}
        )
        self._interval = interval
        self._behavior = behavior
        _validate_interval_join_types(
            left, right, self._left_time, self._right_time, interval,
            self._left_on, self._right_on,
        )

    def _build(self):
        lnames = [f"_on{i}" for i in range(len(self._left_on))]
        left_cols = {n: self._left[n] for n in self._left.column_names()}
        left_prep = self._left._build_rowwise(
            {
                **left_cols,
                **dict(zip(lnames, self._left_on)),
                "_pw_t": self._left_time,
            }
        )
        right_cols = {n: self._right[n] for n in self._right.column_names()}
        right_prep = self._right._build_rowwise(
            {
                **right_cols,
                **dict(zip(lnames, self._right_on)),
                "_pw_t": self._right_time,
            }
        )
        left_prep = apply_behavior_to_side(left_prep, "_pw_t", self._behavior)
        right_prep = apply_behavior_to_side(
            right_prep, "_pw_t", self._behavior
        )
        node = IntervalJoinNode(
            left_prep._node,
            right_prep._node,
            lnames,
            lnames,
            "_pw_t",
            "_pw_t",
            self._interval.lower_bound,
            self._interval.upper_bound,
            self._mode.value,
        )
        return node, left_prep, right_prep


def interval_join(
    self,
    other,
    self_time,
    other_time,
    interval: Interval,
    *on,
    behavior: Behavior | None = None,
    how: JoinMode = JoinMode.INNER,
) -> IntervalJoinResult:
    """Join rows whose time difference `other_time - self_time` lies within
    `interval`, subject to equality conditions `on`."""
    return IntervalJoinResult(
        self, other, self_time, other_time, interval, on, how, behavior
    )


def interval_join_inner(
    self, other, self_time, other_time, interval, *on, behavior=None
):
    return IntervalJoinResult(
        self, other, self_time, other_time, interval, on, JoinMode.INNER,
        behavior,
    )


def interval_join_left(
    self, other, self_time, other_time, interval, *on, behavior=None
):
    return IntervalJoinResult(
        self, other, self_time, other_time, interval, on, JoinMode.LEFT,
        behavior,
    )


def interval_join_right(
    self, other, self_time, other_time, interval, *on, behavior=None
):
    return IntervalJoinResult(
        self, other, self_time, other_time, interval, on, JoinMode.RIGHT,
        behavior,
    )


def interval_join_outer(
    self, other, self_time, other_time, interval, *on, behavior=None
):
    return IntervalJoinResult(
        self, other, self_time, other_time, interval, on, JoinMode.OUTER,
        behavior,
    )
