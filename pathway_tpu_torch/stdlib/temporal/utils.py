"""Time-type utilities for temporal operators — the port's own copy of
``pathway_tpu/stdlib/temporal/utils.py`` (reference:
python/pathway/stdlib/temporal/utils.py). ``Duration`` is a pandas type,
so it is looked up when first used, never when the module is imported."""

from __future__ import annotations

import datetime
from typing import Any, Union

from pathway_tpu_torch.internals import datetime_types
from pathway_tpu_torch.internals.datetime_types import DateTimeNaive, DateTimeUtc

TimeEventType = Union[int, float, datetime.datetime]
IntervalType = Union[int, float, datetime.timedelta]

_TIME_KINDS = {
    int: "int",
    float: "float",
}


def _kind(value: Any) -> str:
    if isinstance(value, bool):
        return "other"
    if isinstance(value, int):
        return "int"
    if isinstance(value, float):
        return "float"
    if isinstance(value, datetime.datetime):
        return "utc" if value.tzinfo is not None else "naive"
    if isinstance(value, datetime.timedelta):
        return "duration"
    return "other"


def check_joint_types(parameters: dict[str, tuple[Any, str]]) -> None:
    """Validate that time/interval values are of compatible kinds, e.g. a
    datetime time column with timedelta bounds, or int with int."""
    allowed = [
        {"time": "int", "interval": "int"},
        {"time": "float", "interval": "int"},
        {"time": "float", "interval": "float"},
        {"time": "int", "interval": "float"},
        {"time": "naive", "interval": "duration"},
        {"time": "utc", "interval": "duration"},
    ]
    kinds = {name: (_kind(v), role) for name, (v, role) in parameters.items()}
    for combo in allowed:
        if all(combo.get(role) == k for _n, (k, role) in kinds.items()):
            return
    raise TypeError(
        "incompatible time/interval types in temporal operator: "
        + ", ".join(f"{n}={k}" for n, (k, _r) in kinds.items())
    )


def zero_length_interval(time_value: Any):
    """An additive zero matching the type of `time_value`."""
    if isinstance(time_value, datetime.datetime):
        return datetime_types.Duration()
    if isinstance(time_value, float):
        return 0.0
    return 0


def __getattr__(name: str) -> Any:
    if name == "Duration":
        return datetime_types.Duration
    raise AttributeError(name)


__all__ = [
    "TimeEventType",
    "IntervalType",
    "DateTimeNaive",
    "DateTimeUtc",
    "Duration",
    "check_joint_types",
    "zero_length_interval",
]


# --- build-time dtype validation (reference: utils.check_joint_types over
# eval_type; error format "Arguments (...) have to be of types ... but are
# of types ...", tests/temporal/test_windows.py test_incorrect_args) ------

_TIME_POSSIBLE = ("int", "float", "naive", "utc")
_INTERVAL_POSSIBLE = ("int", "float", "duration", "duration")
_KIND_REPR = {
    "int": "INT",
    "float": "FLOAT",
    "naive": "DATE_TIME_NAIVE",
    "utc": "DATE_TIME_UTC",
    "duration": "DURATION",
}


def dtype_kind(dtype: Any) -> str | None:
    """Map an engine dtype to a time-kind string, or None when unknown
    (ANY columns skip validation — markdown fixtures stay permissive)."""
    from pathway_tpu_torch.internals import dtype as dt

    strip = getattr(dtype, "strip_optional", None)
    if strip is not None:  # Optional_[x] validates as its inner type
        dtype = strip()
    mapping = {
        dt.INT: "int",
        dt.FLOAT: "float",
        dt.DATE_TIME_NAIVE: "naive",
        dt.DATE_TIME_UTC: "utc",
        dt.DURATION: "duration",
    }
    if dtype in mapping:
        return mapping[dtype]
    if dtype == dt.ANY:
        return None
    return str(dtype)  # e.g. 'str' — always fails, named in the message


def check_joint_kinds(params: dict[str, tuple[str | None, str]]) -> None:
    """params: name -> (kind, role) with role in {'time', 'interval'}.
    Kinds of None (unknown/ANY) are skipped. All remaining args must fit
    one column of the (time, interval) compatibility table, with int
    acceptable where float is expected."""
    live = {n: v for n, v in params.items() if v[0] is not None}
    if not live:
        return

    def fits(kind: str, expected: str) -> bool:
        return kind == expected or (kind == "int" and expected == "float")

    def expected_of(role: str, i: int) -> str:
        return (_TIME_POSSIBLE if role == "time" else _INTERVAL_POSSIBLE)[i]

    for i in range(len(_TIME_POSSIBLE)):
        if all(fits(k, expected_of(role, i)) for k, role in live.values()):
            return
    def fmt(kinds) -> str:  # reference prints bare names, no quotes
        return "(" + ", ".join(kinds) + ")"

    expected_str = " or ".join(
        fmt(_KIND_REPR[expected_of(role, i)] for _k, role in live.values())
        for i in range(len(_TIME_POSSIBLE))
    )
    actual = fmt(
        _KIND_REPR.get(k, str(k).upper()) for k, _ in live.values()
    )
    raise TypeError(
        f"Arguments ({', '.join(live)}) have to be of types "
        f"{expected_str} but are of types {actual}."
    )


def value_kind(value: Any) -> str | None:
    """_kind for runtime window parameters, None for None."""
    return None if value is None else _kind(value)


def expr_kind(table, expr) -> str | None:
    """Time-kind of an expression over `table` (dtype probe via a throwaway
    rowwise build — the liveness pass prunes it)."""
    prep = table._build_rowwise({"_pw_probe": expr})
    return dtype_kind(prep._schema["_pw_probe"].dtype)


def validate_join_condition_types(left, right, left_on, right_on) -> None:
    """Equi-join conditions must relate compatible dtypes (reference: the
    temporal joins' join-condition typing) — shared by interval, window and
    asof joins."""
    from pathway_tpu_torch.internals import dtype as dt

    for l_e, r_e in zip(left_on, right_on):
        ld = left._build_rowwise({"_pw_probe": l_e})._schema["_pw_probe"].dtype
        rd = (
            right._build_rowwise({"_pw_probe": r_e})
            ._schema["_pw_probe"]
            .dtype
        )
        if ld != dt.ANY and rd != dt.ANY and dt.lub(ld, rd) == dt.ANY:
            raise TypeError(
                f"Cannot join on columns of incompatible types {ld} "
                f"and {rd}."
            )
