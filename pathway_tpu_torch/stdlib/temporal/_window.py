"""The port's own copy of ``pathway_tpu/stdlib/temporal/_window.py``. Windows: tumbling / sliding / session / intervals_over + windowby
(reference: python/pathway/stdlib/temporal/_window.py — there desugared onto
differential groupbys; here onto the columnar microbatch engine:
window-assignment is a vectorized flatten, sessions are an incremental
SessionAssignNode, intervals_over rides the IntervalJoinNode, and behaviors
are Buffer/Freeze/Forget engine nodes).

Reduce over a windowed table sees the hidden columns ``_pw_window``,
``_pw_window_start``, ``_pw_window_end``, ``_pw_instance`` (and
``_pw_window_location`` for intervals_over), same as the reference.
"""

from __future__ import annotations

import datetime
import math
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.engine.temporal_nodes import IntervalJoinNode, SessionAssignNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.common import apply_with_type, make_tuple
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
)
from pathway_tpu_torch.internals.groupbys import GroupedTable
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    Behavior,
    apply_behavior,
)

_HIDDEN = (
    "_pw_window",
    "_pw_window_start",
    "_pw_window_end",
    "_pw_instance",
    "_pw_window_location",
    "_pw_key",
)


def _instance_col_name(instance, flat) -> str | None:
    """Name of the original instance column when windowby's instance= was a
    plain column still present on the flattened table."""
    if isinstance(instance, ColumnReference) and instance.name in (
        flat.column_names()
    ):
        return instance.name
    return None


def _default_origin(t: Any) -> Any:
    if isinstance(t, datetime.datetime):
        return datetime.datetime(1970, 1, 1, tzinfo=t.tzinfo)
    return 0


class _WindowedGroupedTable(GroupedTable):
    """Warns when processing-time reducers meet data-time windows
    (reference: windowby reduce latest-reducer warning,
    stdlib/temporal/_window.py)."""

    # the groupby this table builds aggregates WINDOWS, not raw groups —
    # the Graph Doctor's unbounded-state rule downgrades it (state grows
    # with open windows; a behavior bounds it fully)
    _pw_windowed = True

    def reduce(self, *args: Any, **kwargs: Any):
        import warnings

        from pathway_tpu_torch.internals.expression import ReducerExpression

        for e in list(args) + list(kwargs.values()):
            name = getattr(
                getattr(e, "_reducer", None), "name", None
            ) if isinstance(e, ReducerExpression) else None
            if name in ("latest", "earliest"):
                warnings.warn(
                    f"{name} reducer uses processing time to choose elements"
                    " while windowby uses data time to assign entries to"
                    " windows. Maybe it is not the behavior you want. To"
                    " choose elements according to their data time, you may"
                    f" use {'max' if name == 'latest' else 'min'} reducer.",
                    stacklevel=2,
                )
        return super().reduce(*args, **kwargs)


def _windowed_grouped(
    flat, *, instance: bool, sort_by: str = "_pw_key", extra_group=None
):
    """GroupedTable over the flattened (row, window) table, grouped by the
    window identity columns. `extra_group` names the ORIGINAL instance
    column when windowby was given a plain column — the reference lets
    reduce() select it directly (it is constant within a window)."""
    grouping = [
        flat._pw_window,
        flat._pw_window_start,
        flat._pw_window_end,
        flat._pw_instance,  # constant None without an instance
    ]
    if extra_group is not None:
        grouping.append(flat[extra_group])
    return _WindowedGroupedTable(flat, grouping, sort_by=flat[sort_by])


class Window(ABC):
    @abstractmethod
    def _apply(self, table, key, behavior, instance):
        ...

    @abstractmethod
    def _join(self, left, right, left_time, right_time, on, mode, behavior):
        ...


# ---------------------------------------------------------------------------
# Sliding / tumbling


@dataclass
class _SlidingWindow(Window):
    hop: Any
    duration: Any
    origin: Any | None
    ratio: int | None = None  # window length = ratio * hop (stable bounds)

    def _assign_fn(self) -> Callable[[Any], tuple]:
        hop, duration, origin0 = self.hop, self.duration, self.origin
        ratio = self.ratio

        def assign(t):
            if t is None:
                return ()
            origin = origin0 if origin0 is not None else _default_origin(t)
            # candidate k range, then STABLE bounds ((k+ratio)*hop computed
            # fresh per window — a ratio-specified window end never drifts
            # from the (k+ratio)-th window start) filtered by actual
            # membership; windows before an explicit origin are dropped —
            # reference: SlidingWindow._window_assignment_function
            last_k = int((t - origin) // hop) + 1
            if ratio is not None:
                first_k = last_k - ratio - 2
            else:
                first_k = last_k - int(duration // hop) - 2
            out = []
            for k in range(first_k, last_k + 1):
                start = k * hop + origin
                if ratio is not None:
                    end = (k + ratio) * hop + origin
                else:
                    end = k * hop + origin + duration
                if start <= t < end and (origin0 is None or start >= origin0):
                    out.append((start, end))
            return tuple(out)

        return assign

    def _flatten(self, table, key, instance):
        """(row, window) table with _pw_* columns."""
        cols = {n: table[n] for n in table.column_names() if n not in _HIDDEN}
        prep_exprs = {**cols, "_pw_key": key}
        has_instance = instance is not None
        if has_instance:
            prep_exprs["_pw_instance"] = instance
        prep = table._build_rowwise(prep_exprs)
        assigned = prep.with_columns(
            _pw_windows=apply_with_type(
                self._assign_fn(), dt.ANY, prep._pw_key
            )
        )
        flat = assigned.flatten(assigned._pw_windows)
        out_exprs = {n: flat[n] for n in cols}
        out_exprs["_pw_key"] = flat._pw_key
        inst_expr = flat._pw_instance if has_instance else None
        out_exprs["_pw_window_start"] = flat._pw_windows[0]
        out_exprs["_pw_window_end"] = flat._pw_windows[1]
        out_exprs["_pw_window"] = make_tuple(
            inst_expr, flat._pw_windows[0], flat._pw_windows[1]
        )
        # _pw_instance is ALWAYS exposed (None without an instance), as in
        # the reference's windowby output schema
        out_exprs["_pw_instance"] = (
            flat._pw_instance if has_instance else None
        )
        return flat.select(**out_exprs), has_instance

    def _apply(self, table, key, behavior, instance):
        flat, has_instance = self._flatten(table, key, instance)
        flat = apply_behavior(
            flat, "_pw_key", "_pw_window_start", "_pw_window_end", behavior
        )
        return _windowed_grouped(
            flat,
            instance=has_instance,
            extra_group=_instance_col_name(instance, flat),
        )

    def _join(self, left, right, left_time, right_time, on, mode, behavior):
        from pathway_tpu_torch.internals.table import desugar
        from pathway_tpu_torch.internals.thisclass import (
            left as left_ph,
            right as right_ph,
            this as this_ph,
        )
        from pathway_tpu_torch.stdlib.temporal._window_join import (
            _window_join_flattened,
        )

        ltime = desugar(left_time, {left_ph: left, this_ph: left})
        rtime = desugar(right_time, {right_ph: right, this_ph: right})
        lflat, _ = self._flatten(left, ltime, None)
        rflat, _ = self._flatten(right, rtime, None)
        lflat = apply_behavior(
            lflat, "_pw_key", "_pw_window_start", "_pw_window_end", behavior
        )
        rflat = apply_behavior(
            rflat, "_pw_key", "_pw_window_start", "_pw_window_end", behavior
        )
        return _window_join_flattened(left, right, lflat, rflat, on, mode)


def tumbling(duration, origin=None) -> Window:
    """Fixed-size non-overlapping windows of `duration`, aligned to
    `origin` (default: 0 / epoch)."""
    _check_window_params(duration, duration, origin)
    w = _SlidingWindow(hop=duration, duration=None, origin=origin, ratio=1)
    w._tumbling = True  # build-time validation names only window.hop
    return w


def _validate_window_types(table, key, window) -> None:
    """Build-time dtype validation of the time column against the window's
    parameters (reference: check_joint_types over eval_type in every
    window's _apply, stdlib/temporal/_window.py)."""
    from pathway_tpu_torch.stdlib.temporal.utils import (
        check_joint_kinds,
        expr_kind,
        value_kind,
    )

    kk = expr_kind(table, key)
    if isinstance(window, _SlidingWindow):
        params = {
            "time_expr": (kk, "time"),
            "window.hop": (value_kind(window.hop), "interval"),
        }
        if not getattr(window, "_tumbling", False) and window.duration is not None:
            params["window.duration"] = (
                value_kind(window.duration),
                "interval",
            )
        params["window.origin"] = (value_kind(window.origin), "time")
        check_joint_kinds(params)
    elif isinstance(window, _SessionWindow):
        check_joint_kinds(
            {
                "time_expr": (kk, "time"),
                "window.max_gap": (value_kind(window.max_gap), "interval"),
            }
        )
    elif isinstance(window, _IntervalsOverWindow):
        check_joint_kinds(
            {
                "time_expr": (kk, "time"),
                "window.lower_bound": (
                    value_kind(window.lower_bound),
                    "interval",
                ),
                "window.upper_bound": (
                    value_kind(window.upper_bound),
                    "interval",
                ),
            }
        )


def _check_window_params(hop, duration, origin):
    from pathway_tpu_torch.stdlib.temporal.utils import _kind

    numeric = {"int", "float"}
    kh, kd = _kind(hop), _kind(duration)
    if not (
        (kh in numeric and kd in numeric)
        or (kh == "duration" and kd == "duration")
    ):
        raise TypeError(
            "window hop and duration must both be numbers or both be "
            f"durations, got {type(hop).__name__} and {type(duration).__name__}"
        )
    if origin is not None:
        ko = _kind(origin)
        if (kh in numeric) != (ko in numeric):
            raise TypeError(
                "window origin must be a number for numeric windows or a "
                f"datetime for duration windows, got {type(origin).__name__}"
            )


def sliding(hop, duration=None, ratio=None, origin=None) -> Window:
    """Windows of `duration` (or hop*ratio) starting every `hop`."""
    if (duration is None) == (ratio is None):
        raise ValueError(
            "exactly one of `duration` or `ratio` should be provided"
        )
    _check_window_params(hop, duration if duration is not None else hop, origin)
    return _SlidingWindow(hop=hop, duration=duration, origin=origin, ratio=ratio)


# ---------------------------------------------------------------------------
# Session


@dataclass
class _SessionWindow(Window):
    predicate: Callable[[Any, Any], bool] | None
    max_gap: Any | None

    def _flatten(self, table, key, instance):
        from pathway_tpu_torch.internals.table import Table

        cols = {n: table[n] for n in table.column_names() if n not in _HIDDEN}
        prep_exprs = {**cols, "_pw_key": key}
        has_instance = instance is not None
        if has_instance:
            prep_exprs["_pw_instance"] = instance
        prep = table._build_rowwise(prep_exprs)
        node = SessionAssignNode(
            prep._node,
            "_pw_key",
            "_pw_instance" if has_instance else None,
            self.predicate,
            self.max_gap,
        )
        sess = Table._from_node(
            node,
            {"_pw_window_start": dt.ANY, "_pw_window_end": dt.ANY},
            prep._universe,
        )
        out_exprs = {n: prep[n] for n in cols}
        out_exprs["_pw_key"] = prep._pw_key
        out_exprs["_pw_window_start"] = sess._pw_window_start
        out_exprs["_pw_window_end"] = sess._pw_window_end
        out_exprs["_pw_window"] = make_tuple(
            prep._pw_instance if has_instance else None,
            sess._pw_window_start,
            sess._pw_window_end,
        )
        out_exprs["_pw_instance"] = (
            prep._pw_instance if has_instance else None
        )
        return prep.select(**out_exprs), has_instance

    def _apply(self, table, key, behavior, instance):
        flat, has_instance = self._flatten(table, key, instance)
        flat = apply_behavior(
            flat, "_pw_key", "_pw_window_start", "_pw_window_end", behavior
        )
        return _windowed_grouped(
            flat,
            instance=has_instance,
            extra_group=_instance_col_name(instance, flat),
        )

    def _join(self, left, right, left_time, right_time, on, mode, behavior):
        from pathway_tpu_torch.stdlib.temporal._window_join import (
            _session_window_join,
        )

        return _session_window_join(
            self, left, right, left_time, right_time, on, mode, behavior
        )


def session(*, predicate=None, max_gap=None) -> Window:
    """Merge adjacent (in time order) rows into one window when
    `predicate(a, b)` holds or `b - a < max_gap`."""
    if (predicate is None) == (max_gap is None):
        raise ValueError(
            "exactly one of [predicate, max_gap] should be provided"
        )
    return _SessionWindow(predicate=predicate, max_gap=max_gap)


# ---------------------------------------------------------------------------
# intervals_over


@dataclass
class _IntervalsOverWindow(Window):
    at: ColumnReference
    lower_bound: Any
    upper_bound: Any
    is_outer: bool

    def _apply(self, table, key, behavior, instance):
        from pathway_tpu_torch.internals.table import Table

        lower, upper = self.lower_bound, self.upper_bound
        at_table = self.at.table
        # distinct probe locations
        probes_tbl = at_table.select(_pw_at=self.at)
        probes_distinct = probes_tbl.groupby(probes_tbl._pw_at).reduce(
            probes_tbl._pw_at
        )

        cols = {n: table[n] for n in table.column_names() if n not in _HIDDEN}
        prep_exprs = {**cols, "_pw_key": key}
        has_instance = instance is not None
        if has_instance:
            prep_exprs["_pw_instance"] = instance
        prep = table._build_rowwise(prep_exprs)

        node = IntervalJoinNode(
            probes_distinct._node,
            prep._node,
            [],
            [],
            "_pw_at",
            "_pw_key",
            lower,
            upper,
            "inner",
        )
        jcols = {}
        for n in probes_distinct.column_names():
            jcols["l." + n] = dt.ANY
        for n in prep.column_names():
            jcols["r." + n] = dt.ANY
        jcols["_left_id"] = dt.Optional_(dt.POINTER)
        jcols["_right_id"] = dt.Optional_(dt.POINTER)
        joined = Table._from_node(node, jcols, Universe())

        out_exprs = {n: joined["r." + n] for n in cols}
        out_exprs["_pw_key"] = joined["r._pw_key"]
        loc = joined["l._pw_at"]
        out_exprs["_pw_window_location"] = loc
        out_exprs["_pw_window_start"] = apply_with_type(
            lambda x: None if x is None else x + lower, dt.ANY, loc
        )
        out_exprs["_pw_window_end"] = apply_with_type(
            lambda x: None if x is None else x + upper, dt.ANY, loc
        )
        inst_expr = joined["r._pw_instance"] if has_instance else None
        out_exprs["_pw_window"] = make_tuple(inst_expr, loc)
        if has_instance:
            out_exprs["_pw_instance"] = joined["r._pw_instance"]
        flat = joined.select(**out_exprs)
        grouping = [
            flat._pw_window,
            flat._pw_window_location,
            flat._pw_window_start,
            flat._pw_window_end,
        ]
        if has_instance:
            grouping.append(flat._pw_instance)
        return _IntervalsOverGrouped(
            flat,
            grouping,
            sort_by=flat._pw_key,
            window=self,
            probes_distinct=probes_distinct,
            has_instance=has_instance,
        )

    def _join(self, left, right, left_time, right_time, on, mode, behavior):
        raise NotImplementedError(
            "window_join does not support intervals_over windows"
        )


class _IntervalsOverGrouped(GroupedTable):
    """GroupedTable for intervals_over: with is_outer=True, probe locations
    with no rows in range still produce an output row with None in every
    non-grouping column (reference: _IntervalsOverWindow, is_outer)."""

    _pw_windowed = True

    def __init__(
        self, table, grouping, *, sort_by, window, probes_distinct, has_instance
    ):
        super().__init__(table, grouping, sort_by=sort_by)
        self._window = window
        self._probes = probes_distinct
        self._has_instance = has_instance

    def reduce(self, *args: Any, **kwargs: Any):
        reduced = super().reduce(*args, **kwargs)
        if not self._window.is_outer or self._has_instance:
            # with instance sharding the empty-window universe is undefined
            # (no instance value to attach) — reference behaves likewise
            return reduced

        # name -> source expr, to figure out which outputs are derivable
        # from the probe location alone
        table = self._table
        out_exprs: dict[str, Any] = {}
        for a in args:
            if isinstance(a, ColumnReference):
                out_exprs[a.name] = table[a.name] if a.table is not table else a
        for n, e in kwargs.items():
            out_exprs[n] = e

        lower, upper = self._window.lower_bound, self._window.upper_bound
        probes = self._probes
        loc = probes._pw_at

        def probe_side_expr(name: str, e: Any):
            if isinstance(e, ColumnReference):
                if e.name == "_pw_window_location":
                    return loc
                if e.name == "_pw_window_start":
                    return apply_with_type(
                        lambda x: x + lower, dt.ANY, loc
                    )
                if e.name == "_pw_window_end":
                    return apply_with_type(
                        lambda x: x + upper, dt.ANY, loc
                    )
                if e.name == "_pw_window":
                    return make_tuple(None, loc)
            return None

        def reducer_null_fill(e: Any):
            """An empty outer window behaves like an outer join's null row:
            COLLECTION reducers materialize that row ((None,) — reference:
            intervals_over is_outer with sorted_tuple), scalar aggregates
            stay None."""
            desc = e._reducer
            if desc.kind not in ("tuple", "sorted_tuple", "ndarray"):
                return None
            from pathway_tpu_torch.engine.reducers import ReducerSpec

            try:
                spec = ReducerSpec(
                    kind=desc.kind,
                    arg_cols=(0,) * max(1, len(e._args)),
                    skip_nones=desc.skip_nones,
                    fn=desc.fn,
                    extra=desc.extra,
                )
                acc = spec.make()
                acc.update((None,) * max(1, len(e._args)), 1, 0, 0)
                return acc.value()
            except Exception:
                return None

        names = list(reduced.column_names())
        empty_exprs = {}
        for n in names:
            src = out_exprs.get(n)
            # grouping-derived outputs get their probe-side value; reducers
            # aggregate over the outer join's null row; anything else
            # touching data columns becomes None
            if isinstance(src, ReducerExpression):
                empty_exprs[n] = reducer_null_fill(src)
            else:
                empty_exprs[n] = (
                    probe_side_expr(n, src) if src is not None else None
                )
        # probes that currently have no matching rows = probes minus the
        # locations present in `reduced`
        reduced_locs = None
        loc_out_name = None
        for n, src in out_exprs.items():
            if (
                isinstance(src, ColumnReference)
                and src.name == "_pw_window_location"
            ):
                loc_out_name = n
                break
        probes_keyed = probes.with_id_from(probes._pw_at)
        # re-keying by the probe value lands on the SAME ids the distinct
        # groupby assigned (both ref_scalar(_pw_at))
        probes_keyed.promise_universe_is_equal_to(probes)
        if loc_out_name is not None:
            reduced_keyed = reduced.with_id_from(reduced[loc_out_name])
        else:
            # user did not select the location — rebuild it from grouping
            with_loc = super().reduce(
                _pw_window_location=table._pw_window_location
            )
            reduced_keyed = with_loc.with_id_from(
                with_loc._pw_window_location
            )
        empty = probes_keyed.difference(reduced_keyed)
        empty_rows = empty.select(**empty_exprs)
        # empty is probes-minus-reduced: provably disjoint from reduced
        reduced.promise_universes_are_disjoint(empty_rows)
        return reduced.concat(empty_rows)


def intervals_over(
    *, at: ColumnReference, lower_bound, upper_bound, is_outer: bool = True
) -> Window:
    """One window per time t in `at`, spanning [t+lower_bound, t+upper_bound];
    `is_outer` keeps empty windows (reducers yield None)."""
    return _IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


# ---------------------------------------------------------------------------
# windowby


def windowby(
    self,
    time_expr,
    *,
    window: Window,
    behavior: Behavior | None = None,
    instance=None,
    shard=None,
) -> GroupedTable:
    """Group `self` by windows over `time_expr`; reduce() then aggregates per
    (window, instance)."""
    if instance is None:
        instance = shard
    key = self._desugar(time_expr)
    inst = self._desugar(instance) if instance is not None else None
    _validate_window_types(self, key, window)
    return window._apply(self, key, behavior, inst)
