"""Column dtype system of the engine — the port's own copy of
``pathway_tpu/internals/dtype.py``.

Capability parity with the reference dtype lattice
(upstream Pathway: python/pathway/internals/dtype.py), re-designed for a columnar
engine: every dtype knows its columnar storage class (numpy dtype or object).
"""

from __future__ import annotations

import datetime
import typing
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np


class DType:
    """Base class for Pathway column dtypes."""

    _cache: dict[Any, "DType"] = {}

    def __init__(self, name: str, np_dtype: Any, py_type: type | None = None):
        self.name = name
        self.np_dtype = np_dtype  # numpy storage dtype ('O' for boxed values)
        self.py_type = py_type

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DType) and self.name == getattr(other, "name", None)

    def __hash__(self) -> int:
        return hash(self.name)

    def is_optional(self) -> bool:
        return isinstance(self, OptionalDType)

    def strip_optional(self) -> "DType":
        return self

    @property
    def typehint(self) -> Any:
        return self.py_type if self.py_type is not None else Any


class OptionalDType(DType):
    def __init__(self, wrapped: DType):
        self.wrapped = wrapped
        super().__init__(f"Optional[{wrapped.name}]", np.dtype(object), wrapped.py_type)

    def strip_optional(self) -> DType:
        return self.wrapped

    @property
    def typehint(self) -> Any:
        return typing.Optional[self.wrapped.typehint]


class TupleDType(DType):
    def __init__(self, args: tuple[DType, ...] | None = None):
        self.args = args

        name = (
            "Tuple[...]"
            if args is None
            else "Tuple[" + ", ".join(a.name for a in args) + "]"
        )
        super().__init__(name, np.dtype(object), tuple)

    @property
    def typehint(self) -> Any:
        if self.args is None:
            return tuple
        return tuple[tuple(a.typehint for a in self.args)]


class ListDType(DType):
    def __init__(self, wrapped: DType):
        self.wrapped = wrapped
        super().__init__(f"List[{wrapped.name}]", np.dtype(object), tuple)

    @property
    def typehint(self) -> Any:
        return list[self.wrapped.typehint]


class ArrayDType(DType):
    """N-dimensional numeric array column (boxed np.ndarray per row)."""

    def __init__(self, n_dim: int | None = None, wrapped: DType | None = None):
        self.n_dim = n_dim
        self.wrapped = wrapped
        name = f"Array[{n_dim}, {wrapped.name if wrapped else 'Any'}]"
        super().__init__(name, np.dtype(object), np.ndarray)


class PointerDType(DType):
    def __init__(self, wrapped: Any = None):
        self.wrapped = wrapped
        name = "Pointer" if wrapped is None else f"Pointer[{wrapped}]"
        super().__init__(name, np.dtype(np.uint64), None)


def Pointer(*args: Any) -> PointerDType:
    """Parametrized pointer type: dt.Pointer(dt.INT) is the id type of a
    groupby over one int column (reference: dt.Pointer)."""
    if not args:
        return POINTER
    if len(args) == 1:
        return PointerDType(args[0])
    return PointerDType(tuple(args))


class CallableDType(DType):
    def __init__(self, arg_types: Any = ..., return_type: DType | None = None):
        self.arg_types = arg_types
        self.return_type = return_type
        super().__init__("Callable", np.dtype(object), None)


# --- scalar singletons -------------------------------------------------------

NONE = DType("None", np.dtype(object), type(None))
BOOL = DType("bool", np.dtype(bool), bool)
INT = DType("int", np.dtype(np.int64), int)
FLOAT = DType("float", np.dtype(np.float64), float)
STR = DType("str", np.dtype(object), str)
BYTES = DType("bytes", np.dtype(object), bytes)
ANY = DType("Any", np.dtype(object), None)
POINTER = PointerDType()
DATE_TIME_NAIVE = DType("DateTimeNaive", np.dtype(object), datetime.datetime)
DATE_TIME_UTC = DType("DateTimeUtc", np.dtype(object), datetime.datetime)
DURATION = DType("Duration", np.dtype(object), datetime.timedelta)
JSON = DType("Json", np.dtype(object), None)
PY_OBJECT_WRAPPER = DType("PyObjectWrapper", np.dtype(object), None)
ANY_TUPLE = TupleDType(None)
ANY_ARRAY = ArrayDType(None, None)
INT_ARRAY = ArrayDType(None, INT)
FLOAT_ARRAY = ArrayDType(None, FLOAT)
FUTURE = ANY  # placeholder for async column results


def Optional_(wrapped: DType) -> DType:
    if wrapped == ANY or isinstance(wrapped, OptionalDType) or wrapped == NONE:
        return wrapped
    return OptionalDType(wrapped)


# reference-style alias: tests spell dt.Optional(dt.INT); the trailing
# underscore avoided shadowing typing.Optional inside this module
Optional = Optional_  # noqa: F811

_PY_TO_DTYPE: dict[Any, DType] = {
    int: INT,
    float: FLOAT,
    bool: BOOL,
    str: STR,
    bytes: BYTES,
    type(None): NONE,
    datetime.datetime: DATE_TIME_NAIVE,
    datetime.timedelta: DURATION,
    np.ndarray: ANY_ARRAY,
    tuple: ANY_TUPLE,
    list: ANY_TUPLE,
    dict: JSON,
    Any: ANY,
}


def wrap(x: Any) -> DType:
    """Convert a python typehint / dtype-ish object into a DType."""
    if isinstance(x, DType):
        return x
    if x is None:
        return NONE
    if x in _PY_TO_DTYPE:
        return _PY_TO_DTYPE[x]
    origin = typing.get_origin(x)
    if origin is not None:
        args = typing.get_args(x)
        import types as _types

        # typing.Optional[float] and the PEP-604 spelling float | None
        # have different origins (typing.Union vs types.UnionType)
        if origin is Union or origin is _types.UnionType:
            non_none = [a for a in args if a is not type(None)]
            has_none = len(non_none) != len(args)
            if len(non_none) == 1:
                inner = wrap(non_none[0])
                return Optional_(inner) if has_none else inner
            return ANY
        if origin in (tuple,):
            if args and args[-1] is Ellipsis:
                return ListDType(wrap(args[0]))
            return TupleDType(tuple(wrap(a) for a in args))
        if origin in (list,):
            return ListDType(wrap(args[0]) if args else ANY)
        if origin is np.ndarray:
            return ANY_ARRAY
        if origin is Callable or origin is typing.Callable:  # type: ignore[comparison-overlap]
            return CallableDType()
        return ANY
    # late imports to avoid cycles
    from pathway_tpu_torch.internals.json import Json

    if x is Json:
        return JSON
    from pathway_tpu_torch.internals.api import Pointer

    if x is Pointer or (isinstance(x, type) and issubclass(x, Pointer)):
        return POINTER
    from pathway_tpu_torch.internals.datetime_types import (
        DateTimeNaive,
        DateTimeUtc,
        duration_if_loaded,
    )

    if x is DateTimeNaive:
        return DATE_TIME_NAIVE
    if x is DateTimeUtc:
        return DATE_TIME_UTC
    duration = duration_if_loaded()  # never import pandas to compare
    if duration is not None and x is duration:
        return DURATION
    if isinstance(x, type):
        return ANY
    return ANY


def dtype_of_value(v: Any) -> DType:
    """Infer the dtype of a runtime value."""
    from pathway_tpu_torch.internals.json import Json
    from pathway_tpu_torch.internals.api import Pointer

    if v is None:
        return NONE
    if isinstance(v, Pointer):
        return POINTER
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return BOOL
    if isinstance(v, (int, np.integer)):
        return INT
    if isinstance(v, (float, np.floating)):
        return FLOAT
    if isinstance(v, str):
        return STR
    if isinstance(v, bytes):
        return BYTES
    if isinstance(v, datetime.datetime):
        return DATE_TIME_UTC if v.tzinfo is not None else DATE_TIME_NAIVE
    if isinstance(v, datetime.timedelta):
        return DURATION
    if isinstance(v, np.ndarray):
        return ANY_ARRAY
    if isinstance(v, (tuple, list)):
        return ANY_TUPLE
    if isinstance(v, Json) or isinstance(v, dict):
        return JSON
    return ANY


def lub(a: DType, b: DType) -> DType:
    """Least upper bound of two dtypes (simplified lattice)."""
    if a == b:
        return a
    if a == NONE:
        return Optional_(b)
    if b == NONE:
        return Optional_(a)
    if isinstance(a, OptionalDType) or isinstance(b, OptionalDType):
        inner = lub(a.strip_optional(), b.strip_optional())
        return Optional_(inner)
    numeric = {BOOL: 0, INT: 1, FLOAT: 2}
    if a in numeric and b in numeric:
        return a if numeric[a] >= numeric[b] else b
    if isinstance(a, (TupleDType, ListDType)) and isinstance(b, (TupleDType, ListDType)):
        return ANY_TUPLE
    if isinstance(a, ArrayDType) and isinstance(b, ArrayDType):
        return ANY_ARRAY
    if isinstance(a, PointerDType) and isinstance(b, PointerDType):
        return POINTER
    return ANY


def is_compatible(value_dtype: DType, target: DType) -> bool:
    if target == ANY or value_dtype == ANY:
        return True
    if value_dtype == target:
        return True
    if isinstance(target, OptionalDType):
        return value_dtype == NONE or is_compatible(
            value_dtype.strip_optional(), target.wrapped
        )
    if target == FLOAT and value_dtype in (INT, BOOL):
        return True
    if target == INT and value_dtype == BOOL:
        return True
    if isinstance(target, PointerDType) and isinstance(value_dtype, PointerDType):
        return True
    if isinstance(target, (TupleDType, ListDType)) and isinstance(
        value_dtype, (TupleDType, ListDType)
    ):
        return True
    if isinstance(target, ArrayDType) and isinstance(value_dtype, ArrayDType):
        return True
    return False


def np_storage_dtype(dt: DType) -> np.dtype:
    return dt.np_dtype
