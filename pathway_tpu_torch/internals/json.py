"""The port's own copy of ``pathway_tpu/internals/json.py``. Json value type (reference: src/engine/value.rs Value::Json +
python/pathway/internals/json.py).

Semantics mirror the reference exactly: `__getitem__`/`__iter__`/`__len__`
delegate to the wrapped Python value (so indexing a number raises TypeError,
indexing a string slices it, iterating a dict yields its keys wrapped as
Json), while `as_*` conversions are isinstance-checked with the reference's
"Cannot convert Json ... " error text. `Json.dumps` serializes datetimes as
nanosecond-precision ISO strings and durations as nanosecond ints (the
reference's _JsonEncoder)."""

from __future__ import annotations

import datetime
import json as _json
import operator
from typing import Any, ClassVar, Iterator


class _JsonEncoder(_json.JSONEncoder):
    def default(self, obj):
        from pathway_tpu_torch.internals import datetime_types as _dtt

        if isinstance(obj, Json):
            return obj.value
        duration = _dtt.duration_if_loaded()
        if duration is not None and isinstance(obj, duration):
            return obj.value
        if isinstance(obj, datetime.timedelta):
            return _dtt.Duration(obj).value
        if isinstance(obj, (_dtt.DateTimeNaive, _dtt.DateTimeUtc)):
            return obj.isoformat(timespec="nanoseconds")
        if isinstance(obj, datetime.datetime):
            try:
                import pandas as pd

                return pd.Timestamp(obj).isoformat(timespec="nanoseconds")
            except Exception:
                return obj.isoformat()
        import numpy as np

        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, tuple):
            return list(obj)
        return super().default(obj)


class Json:
    """Immutable wrapper over a parsed JSON value."""

    __slots__ = ("_value",)

    NULL: ClassVar["Json"]

    def __init__(self, value: Any = None):
        object.__setattr__(self, "_value", value)

    @property
    def value(self) -> Any:
        v = self._value
        while isinstance(v, Json):
            v = v._value
        return v

    # --- parsing / dumping ---------------------------------------------------

    @staticmethod
    def parse(s: str | bytes | bytearray) -> "Json":
        return Json(_json.loads(s))

    @staticmethod
    def dumps(obj: Any) -> str:
        return _json.dumps(obj, cls=_JsonEncoder)

    def to_string(self) -> str:
        return Json.dumps(self.value)

    # --- access (delegate to the wrapped value, reference json.py:69-85) -----

    def __getitem__(self, key: int | str) -> "Json":
        return Json(self.value[key])

    def get(self, item: str | int, default: Any = None) -> Any:
        try:
            return self[item]
        except (KeyError, IndexError, TypeError):
            return default

    def __iter__(self) -> Iterator["Json"]:
        for item in self.value:
            yield Json(item)

    def __reversed__(self) -> Iterator["Json"]:
        for item in reversed(self.value):
            yield Json(item)

    def __len__(self) -> int:
        return len(self.value)

    def __contains__(self, item: Any) -> bool:
        return item in self.value

    def __index__(self) -> int:
        return operator.index(self.value)

    def __int__(self) -> int:
        return int(self.value)

    def __float__(self) -> float:
        return float(self.value)

    # --- conversions ----------------------------------------------------------

    def _as_type(self, type_: type) -> Any:
        if isinstance(self.value, type_):
            return self.value
        raise ValueError(f"Cannot convert Json {self.value} to {type_}")

    def as_int(self) -> int:
        return self._as_type(int)

    def as_float(self) -> float:
        if isinstance(self.value, int):
            return float(self.value)
        return self._as_type(float)

    def as_str(self) -> str:
        return self._as_type(str)

    def as_bool(self) -> bool:
        return self._as_type(bool)

    def as_list(self) -> list:
        return self._as_type(list)

    def as_dict(self) -> dict:
        return self._as_type(dict)

    # --- dunder ---------------------------------------------------------------

    def __repr__(self) -> str:
        return f"pw.Json({self.value!r})"

    def __str__(self) -> str:
        return Json.dumps(self.value)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Json):
            return self.value == other.value
        return self.value == other

    def __hash__(self) -> int:
        try:
            return hash(Json.dumps_sorted(self.value))
        except TypeError:
            return hash(repr(self.value))

    @staticmethod
    def dumps_sorted(obj: Any) -> str:
        return _json.dumps(obj, cls=_JsonEncoder, sort_keys=True)

    def __bool__(self) -> bool:
        return bool(self.value)


def _is_plain_json(v: Any) -> bool:
    if v is None or isinstance(v, (bool, int, float, str)):
        return True
    if isinstance(v, list):
        return all(_is_plain_json(x) for x in v)
    if isinstance(v, dict):
        return all(
            isinstance(k, str) and _is_plain_json(x) for k, x in v.items()
        )
    return False


def normalize_json(v: Any) -> "Json":
    """Coerce an arbitrary value into a Json holding only plain JSON types —
    the engine-boundary serialization the reference performs when a Python
    Json crosses into serde (datetimes → nanosecond ISO strings, durations
    → nanosecond ints, nested Json unwrapped). Plain values pass through
    without a dumps/loads round-trip."""
    if isinstance(v, Json):
        v = v.value
    if _is_plain_json(v):
        return Json(v)
    return Json(_json.loads(Json.dumps(v)))


JsonValue = (
    int | float | str | bool | list["JsonValue"] | dict[str, "JsonValue"] | None | Json
)

Json.NULL = Json(None)
