"""`.dt` column namespace — the port's own copy of
``pathway_tpu/internals/expressions/date_time.py``. Its values are pandas
Timestamps, so pandas is imported only when a method computes on a value,
never when the module is imported (the card's machine has no pandas).

(reference surface: python/pathway/internals/expressions/date_time.py; the
reference implements these in Rust over chrono, src/engine/time.rs).

Values are pandas Timestamps/Timedeltas (nanosecond precision), so every
method here computes on the exact `.value` nanosecond integers — matching
the reference's chrono i64-nanosecond arithmetic, including the chrono
format extensions (`%f` = 9-digit nanoseconds, `%3f`/`%6f`/`%9f` widths,
`%:z` offsets) and truncation-toward-zero duration components. Methods are
dtype-gated: calling a datetime method on an int column raises
AttributeError at build time when the static dtype is known (reference:
the type_interpreter rejects mistyped namespace calls)."""

from __future__ import annotations

import datetime
import warnings

from pathway_tpu_torch.internals import datetime_types
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.datetime_types import (
    DateTimeNaive,
    DateTimeUtc,
    _pd,
)
from pathway_tpu_torch.internals.expression import ColumnExpression, MethodCallExpression


def _m(name, fn, ret, *args):
    return MethodCallExpression(name, fn, ret, *args)


_UNIT_NS = {
    "ns": 1,
    "us": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
}

# to_duration unit multipliers in ns (reference: get_unit_multiplier,
# src/engine/time.rs:124-140)
_DURATION_UNIT_NS = {}
for _aliases, _mul in (
    (("W",), 7 * 24 * 3600 * 10**9),
    (("D", "day", "days"), 24 * 3600 * 10**9),
    (("h", "hr", "hour", "hours"), 3600 * 10**9),
    (("m", "min", "minute", "minutes"), 60 * 10**9),
    (("s", "sec", "second", "seconds"), 10**9),
    (("ms", "milli", "millis", "millisecond", "milliseconds"), 10**6),
    (("us", "micro", "micros", "microsecond", "microseconds"), 10**3),
    (("ns", "nano", "nanos", "nanosecond", "nanoseconds"), 1),
):
    for _a in _aliases:
        _DURATION_UNIT_NS[_a] = _mul


def _period_ns(p) -> int:
    """Round/floor period in exact nanoseconds: Timedelta, a composite
    duration string ('2h3min'), or a bare offset alias ('D', 'min')."""
    if isinstance(p, str):
        try:
            return int(_pd().Timedelta(p).value)
        except ValueError:
            return int(_pd().tseries.frequencies.to_offset(p).nanos)
    return int(_td(p).value)

# DST policy for anchoring naive wall-clock times (matches chrono's
# LocalResult handling in the reference): nonexistent times shift forward
# past the gap, ambiguous times resolve to the second (non-DST) occurrence.
_LOCALIZE = dict(nonexistent="shift_forward", ambiguous=False)


def _ts(d) -> pd.Timestamp:
    return d if isinstance(d, _pd().Timestamp) else _pd().Timestamp(d)


def _td(x) -> pd.Timedelta:
    return x if isinstance(x, _pd().Timedelta) else _pd().Timedelta(x)


def _dt_ns(d) -> int:
    """Exact nanoseconds since epoch (UTC for aware values)."""
    return int(_ts(d).value)


def _ns_of_second(d) -> int:
    return _dt_ns(d) % 1_000_000_000


def _trunc_div(v: int, unit: int) -> int:
    """Integer division truncating toward zero (chrono num_* semantics)."""
    q = abs(v) // unit
    return -q if v < 0 else q


def _strftime_one(d, fmt: str) -> str:
    """strftime with the chrono fraction extensions: %f renders 9-digit
    nanoseconds, %3f/%6f/%9f fixed widths; %% stays an escape."""
    ts = _ts(d)
    nano = f"{_ns_of_second(ts):09d}"
    out = []
    i = 0
    n = len(fmt)
    while i < n:
        c = fmt[i]
        if c == "%" and i + 1 < n:
            nxt = fmt[i + 1]
            if nxt == "%":
                out.append("%%")
                i += 2
                continue
            if nxt == "f":
                out.append(nano)
                i += 2
                continue
            if nxt in "369" and i + 2 < n and fmt[i + 2] == "f":
                out.append(nano[: int(nxt)])
                i += 3
                continue
        out.append(c)
        i += 1
    return ts.strftime("".join(out))


def _sanitize_format(fmt: str) -> str:
    """Exact port of the reference's sanitize_format_string
    (src/engine/time.rs:107): '.%f' becomes chrono's '%.f'; any remaining
    bare '%f' (not part of a '%%f' escape) is rejected. Fixed-width
    '%3f'/'%6f'/'%9f' contain no '%f' substring and pass."""
    sanitized = fmt.replace(".%f", "%.f")
    if sanitized.count("%f") != sanitized.count("%%f"):
        raise ValueError(
            f'parse error: cannot use format "{sanitized}": using '
            '"%f" without the leading dot is not supported'
        )
    return sanitized


def _strptime_one(s: str, fmt: str):
    from pathway_tpu_torch.internals.datetime_types import _strptime

    display = _sanitize_format(fmt)
    # chrono fixed-width fractions and %:z offsets map onto python's forms
    py_fmt = (
        fmt.replace("%9f", "%f")
        .replace("%6f", "%f")
        .replace("%3f", "%f")
        .replace("%:z", "%z")
    )
    try:
        return _strptime(s, py_fmt, utc=False)
    except ValueError:
        raise ValueError(
            f'parse error: cannot parse date "{s}" using format "{display}"'
        ) from None


# --- dtype gating ----------------------------------------------------------


def _static_dtype(expr) -> dt.DType | None:
    """Best-effort dtype of an expression without an environment: direct
    column references read the table schema; typed expressions carry their
    target. None = unknown (no gating)."""
    from pathway_tpu_torch.internals.expression import (
        CastExpression,
        ColumnReference,
        ConvertExpression,
        DeclareTypeExpression,
    )

    if isinstance(expr, ColumnReference):
        try:
            return expr.table.schema.__columns__[expr.name].dtype
        except Exception:
            return None
    if isinstance(expr, MethodCallExpression):
        rt = expr._return_type
        return rt if isinstance(rt, dt.DType) else None
    if isinstance(expr, (CastExpression, ConvertExpression, DeclareTypeExpression)):
        return expr._target
    return None


_DATETIME_KINDS = (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC)
_NUMERIC_KINDS = (dt.INT, dt.FLOAT)


def _require(expr, kinds, method: str) -> None:
    d = _static_dtype(expr)
    if d is None:
        return
    if d.strip_optional() in kinds or d.strip_optional() in (dt.ANY,):
        return
    raise AttributeError(
        f"dt.{method} cannot be applied to a column of type "
        f"{d.strip_optional().name}"
    )


class DateTimeNamespace:
    def __init__(self, expression: ColumnExpression):
        self._expr = expression

    # --- field extraction ----------------------------------------------------

    def nanosecond(self):
        _require(self._expr, _DATETIME_KINDS, "nanosecond")
        return _m("dt.nanosecond", _ns_of_second, dt.INT, self._expr)

    def microsecond(self):
        _require(self._expr, _DATETIME_KINDS, "microsecond")
        return _m(
            "dt.microsecond",
            lambda d: _ns_of_second(d) // 1_000,
            dt.INT,
            self._expr,
        )

    def millisecond(self):
        _require(self._expr, _DATETIME_KINDS, "millisecond")
        return _m(
            "dt.millisecond",
            lambda d: _ns_of_second(d) // 1_000_000,
            dt.INT,
            self._expr,
        )

    def second(self):
        _require(self._expr, _DATETIME_KINDS, "second")
        return _m("dt.second", lambda d: _ts(d).second, dt.INT, self._expr)

    def minute(self):
        _require(self._expr, _DATETIME_KINDS, "minute")
        return _m("dt.minute", lambda d: _ts(d).minute, dt.INT, self._expr)

    def hour(self):
        _require(self._expr, _DATETIME_KINDS, "hour")
        return _m("dt.hour", lambda d: _ts(d).hour, dt.INT, self._expr)

    def day(self):
        _require(self._expr, _DATETIME_KINDS, "day")
        return _m("dt.day", lambda d: _ts(d).day, dt.INT, self._expr)

    def month(self):
        _require(self._expr, _DATETIME_KINDS, "month")
        return _m("dt.month", lambda d: _ts(d).month, dt.INT, self._expr)

    def year(self):
        _require(self._expr, _DATETIME_KINDS, "year")
        return _m("dt.year", lambda d: _ts(d).year, dt.INT, self._expr)

    def weekday(self):
        _require(self._expr, _DATETIME_KINDS, "weekday")
        return _m("dt.weekday", lambda d: _ts(d).weekday(), dt.INT, self._expr)

    def timestamp(self, unit: str | None = None):
        _require(self._expr, _DATETIME_KINDS, "timestamp")
        if unit is None:
            warnings.warn(
                "Not specyfying the `unit` argument of the `timestamp()` "
                "method is deprecated. Please specify its value. Without "
                "specifying, it will default to 'ns'.",
                DeprecationWarning,
                stacklevel=2,
            )
            return _m("dt.timestamp", _dt_ns, dt.INT, self._expr)
        div = _UNIT_NS[unit]
        # float-cast BEFORE dividing, matching the engine's int/int `/`
        # (int64 -> f64 conversion happens first there too)
        return _m(
            "dt.timestamp",
            lambda d: float(_dt_ns(d)) / float(div),
            dt.FLOAT,
            self._expr,
        )

    # --- formatting ----------------------------------------------------------

    def strftime(self, fmt):
        _require(self._expr, _DATETIME_KINDS, "strftime")
        return _m("dt.strftime", _strftime_one, dt.STR, self._expr, fmt)

    def strptime(self, fmt, contains_timezone: bool | None = None):
        _require(self._expr, (dt.STR,), "strptime")

        if contains_timezone is None:
            if isinstance(fmt, str):
                contains_timezone = any(
                    code in fmt for code in ["%z", "%:z", "%Z"]
                )
            else:
                raise ValueError(
                    "If fmt is not a string, you need to specify whether"
                    " objects contain a timezone using `contains_timezone`"
                    " parameter."
                )

        def fn(s, f, _aware=contains_timezone):
            parsed = _strptime_one(s, f)
            if parsed.tzinfo is not None:
                return DateTimeUtc.from_datetime(parsed)
            if _aware:
                # the declared dtype is UTC but the parse produced no
                # offset (e.g. %Z, which python parses without attaching
                # tzinfo) — erroring beats silently mis-typing the column
                raise ValueError(
                    f'parse error: cannot parse date "{s}" using format '
                    f'"{_sanitize_format(f)}"'
                )
            return DateTimeNaive.from_datetime(parsed)

        ret = dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE
        return _m("dt.strptime", fn, ret, self._expr, fmt)

    # --- timezone ------------------------------------------------------------

    def to_utc(self, from_timezone: str):
        _require(self._expr, (dt.DATE_TIME_NAIVE,), "to_utc")

        def fn(d, tz):
            return _ts(d).tz_localize(tz, **_LOCALIZE).tz_convert("UTC")

        return _m("dt.to_utc", fn, dt.DATE_TIME_UTC, self._expr, from_timezone)

    def to_naive_in_timezone(self, timezone: str):
        _require(self._expr, (dt.DATE_TIME_UTC,), "to_naive_in_timezone")

        def fn(d, tz):
            return _ts(d).tz_convert(tz).tz_localize(None)

        return _m(
            "dt.to_naive_in_timezone", fn, dt.DATE_TIME_NAIVE, self._expr, timezone
        )

    def add_duration_in_timezone(self, duration, timezone: str):
        _require(self._expr, (dt.DATE_TIME_NAIVE,), "add_duration_in_timezone")

        def fn(d, dur, tz):
            # anchor the wall-clock time in tz, shift in absolute time,
            # read the wall clock back
            anchored = _ts(d).tz_localize(tz, **_LOCALIZE)
            return (anchored + _td(dur)).tz_convert(tz).tz_localize(None)

        return _m(
            "dt.add_duration_in_timezone",
            fn,
            dt.DATE_TIME_NAIVE,
            self._expr,
            duration,
            timezone,
        )

    def subtract_duration_in_timezone(self, duration, timezone: str):
        _require(
            self._expr, (dt.DATE_TIME_NAIVE,), "subtract_duration_in_timezone"
        )

        def fn(d, dur, tz):
            anchored = _ts(d).tz_localize(tz, **_LOCALIZE)
            return (anchored - _td(dur)).tz_convert(tz).tz_localize(None)

        return _m(
            "dt.subtract_duration_in_timezone",
            fn,
            dt.DATE_TIME_NAIVE,
            self._expr,
            duration,
            timezone,
        )

    def subtract_date_time_in_timezone(self, other, timezone: str):
        _require(
            self._expr, (dt.DATE_TIME_NAIVE,), "subtract_date_time_in_timezone"
        )

        def fn(a, b, tz):
            la = _ts(a).tz_localize(tz, **_LOCALIZE)
            lb = _ts(b).tz_localize(tz, **_LOCALIZE)
            return datetime_types.Duration(la - lb)

        return _m(
            "dt.subtract_date_time_in_timezone",
            fn,
            dt.DURATION,
            self._expr,
            other,
            timezone,
        )

    # --- rounding ------------------------------------------------------------

    def round(self, period):
        _require(self._expr, _DATETIME_KINDS, "round")

        def fn(d, p):
            ts = _ts(d)
            pns = _period_ns(p)
            ns = int(ts.value)
            # chrono duration_round: nearest multiple, ties toward +inf
            # (floor division makes (ns + pns//2)//pns match for both signs)
            return _pd().Timestamp(
                ((ns + pns // 2) // pns) * pns, unit="ns", tz=ts.tzinfo
            )

        return _m("dt.round", fn, dt.ANY, self._expr, period)

    def floor(self, period):
        _require(self._expr, _DATETIME_KINDS, "floor")

        def fn(d, p):
            ts = _ts(d)
            pns = _period_ns(p)
            # chrono duration_trunc floors toward -inf (pre-epoch included,
            # fixed in chrono 0.4.25) — python floor division matches
            return _pd().Timestamp(
                (int(ts.value) // pns) * pns, unit="ns", tz=ts.tzinfo
            )

        return _m("dt.floor", fn, dt.ANY, self._expr, period)

    # --- duration fields -----------------------------------------------------

    def to_duration(self, unit):
        _require(self._expr, _NUMERIC_KINDS, "to_duration")

        def fn(x, u):
            mul = _DURATION_UNIT_NS.get(u)
            if mul is None:
                raise ValueError(
                    f'unit has to be a valid time unit but is "{u}"'
                )
            # exact i64 multiply for ints (reference get_unit_multiplier)
            if isinstance(x, float):
                return datetime_types.Duration(int(x * mul), unit="ns")
            return datetime_types.Duration(int(x) * mul, unit="ns")

        return _m("dt.to_duration", fn, dt.DURATION, self._expr, unit)

    def nanoseconds(self):
        _require(self._expr, (dt.DURATION,), "nanoseconds")
        return _m(
            "dt.nanoseconds", lambda td: int(_td(td).value), dt.INT, self._expr
        )

    def microseconds(self):
        _require(self._expr, (dt.DURATION,), "microseconds")
        return _m(
            "dt.microseconds",
            lambda td: _trunc_div(int(_td(td).value), 1_000),
            dt.INT,
            self._expr,
        )

    def milliseconds(self):
        _require(self._expr, (dt.DURATION,), "milliseconds")
        return _m(
            "dt.milliseconds",
            lambda td: _trunc_div(int(_td(td).value), 1_000_000),
            dt.INT,
            self._expr,
        )

    def seconds(self):
        _require(self._expr, (dt.DURATION,), "seconds")
        return _m(
            "dt.seconds",
            lambda td: _trunc_div(int(_td(td).value), 1_000_000_000),
            dt.INT,
            self._expr,
        )

    def minutes(self):
        _require(self._expr, (dt.DURATION,), "minutes")
        return _m(
            "dt.minutes",
            lambda td: _trunc_div(int(_td(td).value), 60 * 1_000_000_000),
            dt.INT,
            self._expr,
        )

    def hours(self):
        _require(self._expr, (dt.DURATION,), "hours")
        return _m(
            "dt.hours",
            lambda td: _trunc_div(int(_td(td).value), 3600 * 1_000_000_000),
            dt.INT,
            self._expr,
        )

    def days(self):
        _require(self._expr, (dt.DURATION,), "days")
        return _m(
            "dt.days",
            lambda td: _trunc_div(int(_td(td).value), 86400 * 1_000_000_000),
            dt.INT,
            self._expr,
        )

    def weeks(self):
        _require(self._expr, (dt.DURATION,), "weeks")
        return _m(
            "dt.weeks",
            lambda td: _trunc_div(int(_td(td).value), 7 * 86400 * 1_000_000_000),
            dt.INT,
            self._expr,
        )

    # --- from timestamp ------------------------------------------------------

    def from_timestamp(self, unit: str):
        _require(self._expr, _NUMERIC_KINDS, "from_timestamp")
        mul = _UNIT_NS[unit]
        return _m(
            "dt.from_timestamp",
            lambda x: _pd().Timestamp(int(x * mul), unit="ns"),
            dt.DATE_TIME_NAIVE,
            self._expr,
        )

    def utc_from_timestamp(self, unit: str):
        _require(self._expr, _NUMERIC_KINDS, "utc_from_timestamp")
        mul = _UNIT_NS[unit]
        return _m(
            "dt.utc_from_timestamp",
            lambda x: _pd().Timestamp(int(x * mul), unit="ns", tz="UTC"),
            dt.DATE_TIME_UTC,
            self._expr,
        )
