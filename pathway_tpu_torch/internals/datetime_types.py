"""The port's own copy of ``pathway_tpu/internals/datetime_types.py``. DateTimeNaive / DateTimeUtc / Duration (reference:
python/pathway/internals/datetime_types.py; engine side: src/engine/time.rs
over chrono).

The reference subclasses pandas Timestamp/Timedelta. pandas 3 ignores the
subclass in ``Timestamp.__new__`` (every construction path returns a plain
``Timestamp``), so the datetime types here are *virtual*: calling
``DateTimeNaive(...)`` validates and returns a ``pd.Timestamp``, and
``isinstance(value, DateTimeNaive)`` is metaclass-routed (naive ⇔ no tzinfo).
Values therefore interoperate with everything pandas/stdlib, carry nanosecond
precision, and still satisfy the type checks user code writes against the
reference API. ``Duration`` genuinely subclasses ``pd.Timedelta`` (which does
honor subclasses); ``.value`` is nanoseconds everywhere.

The port imports pandas only when a datetime value is built or parsed: the
virtual types need it only in ``__new__``, their ``isinstance`` check is
False while pandas is not loaded (no ``pd.Timestamp`` can exist then), and
``Duration`` — a real ``pd.Timedelta`` subclass — is created on first
access (module ``__getattr__``). A pipeline without datetimes never imports
pandas.
"""

from __future__ import annotations

import datetime
from typing import Any

import sys

import numpy as np


def _pd():
    import pandas as pd

    return pd


class _TimestampTypeMeta(type):
    """Virtual-type metaclass: instances are pd.Timestamps of the matching
    tz-awareness."""

    _tz_aware: bool

    def __instancecheck__(cls, obj: Any) -> bool:
        pd = sys.modules.get("pandas")
        return pd is not None and isinstance(obj, pd.Timestamp) and (
            obj.tzinfo is not None
        ) == cls._tz_aware


class DateTimeNaive(metaclass=_TimestampTypeMeta):
    """Timezone-unaware datetime (nanosecond precision). Constructing one
    returns a naive ``pd.Timestamp``."""

    _tz_aware = False

    def __new__(cls, *args: Any, **kwargs: Any):
        ts = _pd().Timestamp(*args, **kwargs)
        if ts.tzinfo is not None:
            raise ValueError("DateTimeNaive cannot hold an aware datetime")
        return ts

    @classmethod
    def from_datetime(cls, dt: datetime.datetime) -> "pd.Timestamp":
        if dt.tzinfo is not None:
            raise ValueError("DateTimeNaive cannot hold an aware datetime")
        return _pd().Timestamp(dt)

    @classmethod
    def strptime(cls, s: str, fmt: str) -> "pd.Timestamp":
        return cls(_strptime(s, fmt, utc=False))


class DateTimeUtc(metaclass=_TimestampTypeMeta):
    """Timezone-aware datetime (stored as UTC, nanosecond precision).
    Constructing one returns an aware ``pd.Timestamp``."""

    _tz_aware = True

    def __new__(cls, *args: Any, **kwargs: Any):
        ts = _pd().Timestamp(*args, **kwargs)
        if ts.tzinfo is None:
            raise ValueError("DateTimeUtc requires an aware datetime")
        return ts.tz_convert("UTC")

    @classmethod
    def from_datetime(cls, dt: datetime.datetime) -> "pd.Timestamp":
        if dt.tzinfo is None:
            raise ValueError("DateTimeUtc requires an aware datetime")
        return _pd().Timestamp(dt).tz_convert("UTC")

    @classmethod
    def strptime(cls, s: str, fmt: str) -> "pd.Timestamp":
        return cls(_strptime(s, fmt, utc=True))


def _make_duration() -> type:
    class Duration(_pd().Timedelta):
        """Time difference (nanosecond precision)."""

        @classmethod
        def from_timedelta(cls, td: datetime.timedelta) -> "Duration":
            return cls(td)

        def nanoseconds(self) -> int:
            return int(self.value)

    Duration.__module__ = __name__
    return Duration


def __getattr__(name: str) -> Any:
    if name == "Duration":
        cls = _make_duration()
        globals()["Duration"] = cls
        return cls
    raise AttributeError(name)


def duration_if_loaded() -> type | None:
    """``Duration`` if something already created it, else None (then no
    value or annotation can be a Duration)."""
    return globals().get("Duration")


def timestamp_ns(v: "pd.Timestamp | datetime.datetime") -> int:
    """Nanoseconds since epoch (UTC for aware values)."""
    if isinstance(v, _pd().Timestamp):
        return int(v.value)
    return int(_pd().Timestamp(v).value)


def _strptime(s: str, fmt: str, utc: bool):
    """strptime that, unlike Python's, accepts nanosecond fractions for %f
    (the reference's chrono %f parses up to 9 digits). The given format is
    always honored: on a %f overflow the fraction is truncated to
    microseconds for stdlib parsing and the sub-microsecond remainder is
    re-attached, so a non-conforming string still raises ValueError."""
    import re

    try:
        return datetime.datetime.strptime(s, fmt)
    except ValueError:
        if "%f" not in fmt:
            raise
    m = re.search(r"\.(\d{7,9})(?!\d)", s)
    if not m:
        raise ValueError(f"time data {s!r} does not match format {fmt!r}")
    digits = m.group(1)
    micro, rest = digits[:6], digits[6:]
    truncated = s[: m.start(1)] + micro + s[m.end(1):]
    parsed = datetime.datetime.strptime(truncated, fmt)
    extra_ns = int(rest) * 10 ** (3 - len(rest))
    ts = _pd().Timestamp(parsed) + _pd().Timedelta(extra_ns, unit="ns")
    if utc and ts.tzinfo is not None:
        ts = ts.tz_convert("UTC")
    return ts


def to_naive(v: Any) -> "pd.Timestamp":
    if isinstance(v, _pd().Timestamp):
        if v.tzinfo is not None:
            raise ValueError("DateTimeNaive cannot hold an aware datetime")
        return v
    if isinstance(v, datetime.datetime):
        if v.tzinfo is not None:
            raise ValueError("DateTimeNaive cannot hold an aware datetime")
        return _pd().Timestamp(v)
    if isinstance(v, np.datetime64):
        return _pd().Timestamp(v)
    raise TypeError(f"cannot convert {v!r} to DateTimeNaive")
