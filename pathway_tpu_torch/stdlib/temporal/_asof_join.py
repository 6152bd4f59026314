"""The port's own copy of ``pathway_tpu/stdlib/temporal/_asof_join.py``. As-of joins (reference: python/pathway/stdlib/temporal/_asof_join.py —
there built on sorted prev/next pointer groups; here a dedicated incremental
AsofJoinNode that restates touched equality-groups per tick)."""

from __future__ import annotations

import enum
from typing import Any

from pathway_tpu_torch.engine.temporal_nodes import AsofJoinNode
from pathway_tpu_torch.internals.expression import (
    CoalesceExpression,
    ColumnReference,
)
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult
from pathway_tpu_torch.internals.table import desugar
from pathway_tpu_torch.internals.thisclass import (
    ThisPlaceholder,
    left as left_ph,
    right as right_ph,
    this as this_ph,
)
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    Behavior,
    apply_behavior_to_side,
)


class Direction(enum.Enum):
    BACKWARD = "backward"
    FORWARD = "forward"
    NEAREST = "nearest"


class AsofJoinResult(JoinResult):
    """Lazy asof join result; select() like a regular join. `defaults` maps a
    source column reference to the value used when the row has no match."""

    def __init__(
        self,
        left,
        right,
        left_time,
        right_time,
        on,
        mode: JoinMode,
        defaults: dict[ColumnReference, Any],
        direction: Direction,
        behavior: Behavior | None = None,
    ):
        super().__init__(left, right, on, mode)
        self._left_time = desugar(left_time, {left_ph: left, this_ph: left})
        self._right_time = desugar(
            right_time, {right_ph: right, this_ph: right}
        )
        self._defaults = {
            (ref.table, ref.name): v for ref, v in (defaults or {}).items()
        }
        self._direction = direction
        self._behavior = behavior

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
        node = AsofJoinNode(
            left_prep._node,
            right_prep._node,
            lnames,
            lnames,
            "_pw_t",
            "_pw_t",
            self._direction.value,
            self._mode.value,
        )
        return node, left_prep, right_prep

    def _make_sub(self, joined):
        base = super()._make_sub(joined)
        defaults = self._defaults
        n_on = len(self._left_on)

        def sub(ref: ColumnReference):
            tbl = ref.table
            # synthetic result columns (reference: the asof merge result
            # exposes `t` — the perspective row's own time — and
            # `instance` — the equated join-key value — via pw.this,
            # SHADOWING same-named source columns). pw.left / pw.right are
            # ThisPlaceholders too: only bare pw.this gets the synthetics.
            if (
                isinstance(tbl, ThisPlaceholder)
                and tbl is not left_ph
                and tbl is not right_ph
            ):
                if ref.name == "t":
                    return ColumnReference(joined, "_pw_self_t")
                if ref.name == "side":
                    return ColumnReference(joined, "_pw_side")
                if ref.name == "instance":
                    conds = [
                        CoalesceExpression(
                            ColumnReference(joined, f"l._on{i}"),
                            ColumnReference(joined, f"r._on{i}"),
                        )
                        for i in range(n_on)
                    ]
                    if not conds:
                        from pathway_tpu_torch.internals.expression import (
                            ColumnConstExpression,
                        )

                        return ColumnConstExpression(None)
                    if len(conds) == 1:
                        return conds[0]
                    from pathway_tpu_torch.internals.common import make_tuple

                    return make_tuple(*conds)
            out = base(ref)
            if tbl is left_ph:
                tbl = self._left
            elif tbl is right_ph:
                tbl = self._right
            key = (tbl, ref.name)
            if key in defaults and out is not None:
                return CoalesceExpression(out, defaults[key])
            return out

        return sub


def asof_join(
    self,
    other,
    self_time,
    other_time,
    *on,
    how: JoinMode = JoinMode.LEFT,
    defaults: dict[ColumnReference, Any] | None = None,
    direction: Direction = Direction.BACKWARD,
    behavior: Behavior | None = None,
    left_instance: ColumnReference | None = None,
    right_instance: ColumnReference | None = None,
) -> AsofJoinResult:
    """For every row, find the single best matching row of the other side by
    time (per `direction`), within groups given by `on` equalities (and the
    optional left_instance == right_instance pair)."""
    if how not in (JoinMode.LEFT, JoinMode.RIGHT, JoinMode.OUTER):
        raise ValueError(
            "asof_join supports only LEFT, RIGHT and OUTER modes"
        )
    if (left_instance is None) != (right_instance is None):
        raise ValueError(
            "asof_join requires both left_instance and right_instance, "
            "or neither"
        )
    if left_instance is not None:
        on = (*on, left_instance == right_instance)
    _validate_asof_join_types(self, other, self_time, other_time, on)
    return AsofJoinResult(
        self, other, self_time, other_time, on, how, defaults or {},
        direction, behavior,
    )


def _validate_asof_join_types(left, right, self_time, other_time, on) -> None:
    """Build-time validation (reference: asof_join check_joint_types over
    eval_type — message names t_left / t_right)."""
    from pathway_tpu_torch.stdlib.temporal.utils import (
        check_joint_kinds,
        expr_kind,
        validate_join_condition_types,
    )

    def kind_of(table, expr):
        e = desugar(expr, {left_ph: left, right_ph: right, this_ph: table})
        return expr_kind(table, e)

    check_joint_kinds(
        {
            "t_left": (kind_of(left, self_time), "time"),
            "t_right": (kind_of(right, other_time), "time"),
        }
    )
    tmp = JoinResult(left, right, on, JoinMode.INNER)
    validate_join_condition_types(left, right, tmp._left_on, tmp._right_on)


def asof_join_left(
    self, other, self_time, other_time, *on,
    defaults=None, direction=Direction.BACKWARD, behavior=None,
    left_instance=None, right_instance=None,
):
    return asof_join(
        self, other, self_time, other_time, *on, how=JoinMode.LEFT,
        defaults=defaults, direction=direction, behavior=behavior,
        left_instance=left_instance, right_instance=right_instance,
    )


def asof_join_right(
    self, other, self_time, other_time, *on,
    defaults=None, direction=Direction.BACKWARD, behavior=None,
    left_instance=None, right_instance=None,
):
    return asof_join(
        self, other, self_time, other_time, *on, how=JoinMode.RIGHT,
        defaults=defaults, direction=direction, behavior=behavior,
        left_instance=left_instance, right_instance=right_instance,
    )


def asof_join_outer(
    self, other, self_time, other_time, *on,
    defaults=None, direction=Direction.BACKWARD, behavior=None,
    left_instance=None, right_instance=None,
):
    return asof_join(
        self, other, self_time, other_time, *on, how=JoinMode.OUTER,
        defaults=defaults, direction=direction, behavior=behavior,
        left_instance=left_instance, right_instance=right_instance,
    )
