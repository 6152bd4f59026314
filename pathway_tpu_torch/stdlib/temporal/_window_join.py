"""The port's own copy of ``pathway_tpu/stdlib/temporal/_window_join.py``. Window joins: pair rows of two tables that fall into the same window
(reference: python/pathway/stdlib/temporal/_window_join.py). Tumbling/sliding
window joins desugar to window-assignment flattens + a regular equijoin on the
window identity; session window joins compute sessions over the union of both
sides' times per join group, then equijoin on the merged window."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.temporal_nodes import SessionAssignNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.common import make_tuple
from pathway_tpu_torch.internals.expression import (
    CoalesceExpression,
    ColumnReference,
    wrap_expr,
)
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult
from pathway_tpu_torch.internals.table import desugar
from pathway_tpu_torch.internals.thisclass import (
    ThisPlaceholder,
    left as left_ph,
    right as right_ph,
    this as this_ph,
)

_WINDOW_COLS = ("_pw_window", "_pw_window_start", "_pw_window_end", "_pw_key")


class WindowJoinResult:
    """Lazy window-join result: select() with pw.left / pw.right / pw.this
    (pw.this._pw_window_start / _pw_window_end give the shared window)."""

    def __init__(
        self,
        inner: JoinResult,
        orig_left,
        orig_right,
        lflat,
        rflat,
        on_pairs=(),
    ):
        self._inner = inner
        self._orig_left = orig_left
        self._orig_right = orig_right
        self._lflat = lflat
        self._rflat = rflat
        # names equi-joined on both sides: pw.this.<name> is then the
        # coalesce of the two (reference: join condition columns are
        # unambiguous on the join result)
        self._on_names = {
            l_e.name
            for l_e, r_e in on_pairs
            if isinstance(l_e, ColumnReference)
            and isinstance(r_e, ColumnReference)
            and l_e.name == r_e.name
        }

    def _pre_sub(self, e):
        lflat, rflat = self._lflat, self._rflat

        def sub(ref: ColumnReference):
            tbl = ref.table
            if tbl is self._orig_left or tbl is left_ph:
                if ref.name == "id":
                    return ColumnReference(lflat, "id")
                return lflat[ref.name]
            if tbl is self._orig_right or tbl is right_ph:
                if ref.name == "id":
                    return ColumnReference(rflat, "id")
                return rflat[ref.name]
            if isinstance(tbl, ThisPlaceholder):
                if ref.name in _WINDOW_COLS:
                    return CoalesceExpression(
                        lflat[ref.name], rflat[ref.name]
                    )
                in_l = ref.name in self._orig_left.column_names()
                in_r = ref.name in self._orig_right.column_names()
                if in_l and in_r:
                    if ref.name in self._on_names:
                        return CoalesceExpression(
                            lflat[ref.name], rflat[ref.name]
                        )
                    raise ValueError(
                        f"column {ref.name!r} is ambiguous in window_join; "
                        "use pw.left/pw.right"
                    )
                if in_l:
                    return lflat[ref.name]
                if in_r:
                    return rflat[ref.name]
                raise ValueError(f"unknown column {ref.name!r}")
            return None

        return wrap_expr(e)._substitute(sub)

    def _expand_side(self, exprs: dict, table) -> None:
        for n in table.column_names():
            if not n.startswith(("_on", "_pw_")):
                exprs[n] = table[n]

    def select(self, *args: Any, **kwargs: Any):
        exprs: dict[str, Any] = {}
        for arg in args:
            if isinstance(arg, ColumnReference):
                exprs[arg.name] = arg
            elif isinstance(arg, ThisPlaceholder):  # `*pw.left` expansion
                if arg is left_ph or arg is this_ph:
                    self._expand_side(exprs, self._orig_left)
                if arg is right_ph or arg is this_ph:
                    self._expand_side(exprs, self._orig_right)
            else:
                raise TypeError(f"positional select argument {arg!r}")
        for name, e in kwargs.items():
            if isinstance(e, ThisPlaceholder):  # `**pw.left` expansion
                if e is left_ph or e is this_ph:
                    self._expand_side(exprs, self._orig_left)
                if e is right_ph or e is this_ph:
                    self._expand_side(exprs, self._orig_right)
                continue
            exprs[name] = e
        resolved = {n: self._pre_sub(e) for n, e in exprs.items()}
        return self._inner.select(**resolved)


def _window_join_flattened(left, right, lflat, rflat, on, mode: JoinMode):
    """Equijoin the flattened sides on window identity + user conditions."""
    conds = [lflat._pw_window == rflat._pw_window]
    # rewrite user on-conditions onto the flattened tables (same column names)
    tmp = JoinResult(left, right, on, JoinMode.INNER)
    for l_e, r_e in zip(tmp._left_on, tmp._right_on):

        def remap(flat, orig):
            def sub(ref: ColumnReference):
                if ref.table is orig:
                    return flat[ref.name]
                return None

            return sub

        conds.append(
            l_e._substitute(remap(lflat, left))
            == r_e._substitute(remap(rflat, right))
        )
    inner = JoinResult(lflat, rflat, conds, mode)
    return WindowJoinResult(
        inner, left, right, lflat, rflat,
        on_pairs=list(zip(tmp._left_on, tmp._right_on)),
    )


def _session_window_join(
    win, left, right, left_time, right_time, on, mode, behavior=None
):
    """Sessions over the union of both sides' times, per join group."""
    from pathway_tpu_torch.internals.table import Table
    from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
        apply_behavior_to_side,
    )

    tmp = JoinResult(left, right, on, JoinMode.INNER)
    ltime = desugar(left_time, {left_ph: left, this_ph: left})
    rtime = desugar(right_time, {right_ph: right, this_ph: right})

    def prep_side(table, time_e, on_exprs, side):
        cols = {n: table[n] for n in table.column_names()}
        return table._build_rowwise(
            {
                **cols,
                "_pw_key": time_e,
                "_pw_on": make_tuple(*on_exprs) if on_exprs else None,
                "_pw_orig": table.id,
                "_pw_side": side,
            }
        )

    lprep = prep_side(left, ltime, tmp._left_on, 0)
    rprep = prep_side(right, rtime, tmp._right_on, 1)
    lmin = lprep.select(
        _pw_key=lprep._pw_key, _pw_on=lprep._pw_on,
        _pw_orig=lprep._pw_orig, _pw_side=lprep._pw_side,
    )
    rmin = rprep.select(
        _pw_key=rprep._pw_key, _pw_on=rprep._pw_on,
        _pw_orig=rprep._pw_orig, _pw_side=rprep._pw_side,
    )
    # behavior (delay / cutoff / forget) filters each record by its own time
    # before sessions are formed over the union
    lmin = apply_behavior_to_side(lmin, "_pw_key", behavior)
    rmin = apply_behavior_to_side(rmin, "_pw_key", behavior)
    comb = lmin.concat_reindex(rmin)
    node = SessionAssignNode(
        comb._node, "_pw_key", "_pw_on", win.predicate, win.max_gap
    )
    sess = Table._from_node(
        node,
        {"_pw_window_start": dt.ANY, "_pw_window_end": dt.ANY},
        comb._universe,
    )
    windows = comb.select(
        _pw_orig=comb._pw_orig,
        _pw_side=comb._pw_side,
        _pw_on=comb._pw_on,
        _pw_window_start=sess._pw_window_start,
        _pw_window_end=sess._pw_window_end,
    )

    def flat_for(orig, side):
        sw = windows.filter(windows._pw_side == side)
        sw = sw.with_id(sw._pw_orig)
        # sw's keys ARE orig row ids (one window row per source row)
        sw.promise_universe_is_subset_of(orig)
        cols = {n: orig[n] for n in orig.column_names()}
        out = orig._build_rowwise(
            {
                **cols,
                "_pw_key": (ltime if side == 0 else rtime),
                "_pw_window_start": sw._pw_window_start,
                "_pw_window_end": sw._pw_window_end,
                "_pw_window": make_tuple(
                    sw._pw_on, sw._pw_window_start, sw._pw_window_end
                ),
            }
        )
        # rows removed by behavior (or not yet assigned) have no window —
        # keep them out of the join so None windows never match each other
        return out.filter(out._pw_window_start.is_not_none())

    lflat = flat_for(left, 0)
    rflat = flat_for(right, 1)
    conds = [lflat._pw_window == rflat._pw_window]
    inner = JoinResult(lflat, rflat, conds, mode)
    return WindowJoinResult(
        inner, left, right, lflat, rflat,
        on_pairs=list(zip(tmp._left_on, tmp._right_on)),
    )


def _validate_window_join_types(
    left, right, left_time, right_time, window, on
) -> None:
    """Build-time validation of both time columns against the window's
    parameters, plus join-condition typing (reference: window joins'
    check_joint_types over eval_type)."""
    from pathway_tpu_torch.stdlib.temporal._window import (
        _SessionWindow,
        _SlidingWindow,
    )
    from pathway_tpu_torch.stdlib.temporal.utils import (
        check_joint_kinds,
        expr_kind,
        validate_join_condition_types,
        value_kind,
    )

    def kind_of(table, expr):
        e = desugar(expr, {left_ph: left, right_ph: right, this_ph: table})
        return expr_kind(table, e)

    params = {
        "left_time_expression": (kind_of(left, left_time), "time"),
        "right_time_expression": (kind_of(right, right_time), "time"),
    }
    if isinstance(window, _SlidingWindow):
        params["window.hop"] = (value_kind(window.hop), "interval")
        if not getattr(window, "_tumbling", False) and window.duration is not None:
            params["window.duration"] = (
                value_kind(window.duration),
                "interval",
            )
        params["window.origin"] = (value_kind(window.origin), "time")
    elif isinstance(window, _SessionWindow):
        params["window.max_gap"] = (value_kind(window.max_gap), "interval")
    check_joint_kinds(params)
    tmp = JoinResult(left, right, on, JoinMode.INNER)
    validate_join_condition_types(left, right, tmp._left_on, tmp._right_on)


def window_join(
    self, other, self_time, other_time, window, *on,
    how: JoinMode = JoinMode.INNER, behavior=None,
) -> WindowJoinResult:
    """Pair rows of `self` and `other` that share a window over their
    respective time columns (plus `on` equality conditions)."""
    _validate_window_join_types(self, other, self_time, other_time, window, on)
    return window._join(self, other, self_time, other_time, on, how, behavior)


def window_join_inner(self, other, self_time, other_time, window, *on, **kw):
    return window_join(
        self, other, self_time, other_time, window, *on, how=JoinMode.INNER,
        **kw,
    )


def window_join_left(self, other, self_time, other_time, window, *on, **kw):
    return window_join(
        self, other, self_time, other_time, window, *on, how=JoinMode.LEFT,
        **kw,
    )


def window_join_right(self, other, self_time, other_time, window, *on, **kw):
    return window_join(
        self, other, self_time, other_time, window, *on, how=JoinMode.RIGHT,
        **kw,
    )


def window_join_outer(self, other, self_time, other_time, window, *on, **kw):
    return window_join(
        self, other, self_time, other_time, window, *on, how=JoinMode.OUTER,
        **kw,
    )
