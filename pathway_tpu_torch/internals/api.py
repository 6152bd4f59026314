"""Low-level value model: keys, pointers, hashing — the port's own copy of
``pathway_tpu/internals/api.py``. Keys are bit-identical to the reference's:
the port hashes with its own build of the native hasher
(``internals/native.py``) where it builds, else with the byte-identical
pure-Python blake2b path.

Analog of the reference engine value model
(upstream Pathway: src/engine/value.rs:41,207): the reference uses a 128-bit xxh3
key whose low 16 bits pick the worker shard. Here a row key is a 64-bit hash
stored in uint64 columns; the low SHARD_BITS select the shard, preserving the co-location semantics
of `with_shard_of` / instance sharding.
"""

from __future__ import annotations

import hashlib
import struct
from enum import Enum
from typing import Any, Iterable

import numpy as np

# the vectorized range expansion the equijoin probe shares with the
# arrangement gather lives next to DiffBatch in the port
from pathway_tpu_torch.engine.batch import expand_ranges  # noqa: E402,F401

SHARD_BITS = 16
SHARD_MASK = (1 << SHARD_BITS) - 1

_SALT = b"pathway-tpu-key-v1"


class Pointer(int):
    """A row id — 64-bit stable hash. Subclasses int so it packs into uint64
    columns directly (reference: src/engine/value.rs Key + python Pointer)."""

    __slots__ = ()

    def __repr__(self) -> str:
        return f"^{self:016X}"

    def __str__(self) -> str:
        return f"^{self:016X}"

    @property
    def shard(self) -> int:
        return int(self) & SHARD_MASK

    def with_shard_of(self, other: "Pointer") -> "Pointer":
        return Pointer((int(self) & ~SHARD_MASK) | (int(other) & SHARD_MASK))


def _hash_bytes(data: bytes) -> int:
    return struct.unpack(
        "<Q", hashlib.blake2b(data, digest_size=8, key=_SALT).digest()
    )[0]


def _value_bytes(v: Any) -> bytes:
    """Stable serialization of a value for key derivation."""
    if v is None:
        return b"\x00"
    if isinstance(v, Pointer):
        return b"\x07" + struct.pack("<Q", int(v))
    if isinstance(v, (bool, np.bool_)):
        return b"\x01" + (b"\x01" if v else b"\x00")
    if isinstance(v, (int, np.integer)):
        x = int(v)
        if -(2**63) <= x < 2**63:
            return b"\x02" + struct.pack("<q", x)
        return b"\x0d" + str(x).encode()
    if isinstance(v, (float, np.floating)):
        f = float(v)
        import math

        if math.isfinite(f) and f == int(f) and abs(f) < 2**53:
            # ints and equal floats hash alike so 1 and 1.0 key identically
            return b"\x02" + struct.pack("<q", int(f))
        return b"\x03" + struct.pack("<d", f)
    if isinstance(v, str):
        return b"\x04" + v.encode("utf-8")
    if isinstance(v, bytes):
        return b"\x05" + v
    if isinstance(v, (tuple, list)):
        parts = [b"\x06", struct.pack("<I", len(v))]
        for item in v:
            b = _value_bytes(item)
            parts.append(struct.pack("<I", len(b)))
            parts.append(b)
        return b"".join(parts)
    if isinstance(v, np.ndarray):
        return b"\x08" + v.tobytes() + str(v.dtype).encode() + str(v.shape).encode()
    import datetime

    if isinstance(v, datetime.datetime):
        return b"\x09" + v.isoformat().encode()
    if isinstance(v, datetime.timedelta):
        return b"\x0a" + struct.pack("<d", v.total_seconds())
    from pathway_tpu_torch.internals.json import Json

    if isinstance(v, Json):
        import json as _json

        return b"\x0b" + _json.dumps(v.value, sort_keys=True).encode()
    if isinstance(v, dict):
        import json as _json

        return b"\x0b" + _json.dumps(v, sort_keys=True).encode()
    return b"\x0c" + repr(v).encode()


_native_mod: Any = None
_native_checked = False


def _get_native():
    global _native_mod, _native_checked
    if not _native_checked:
        _native_checked = True
        from pathway_tpu_torch.internals.native import get_native

        _native_mod = get_native()
    return _native_mod


def ref_scalar(*values: Any, optional: bool = False) -> Pointer:
    """Derive a stable Pointer from a tuple of values
    (reference: Key::for_values, src/engine/value.rs:60). Uses the native
    hasher (native/pathway_native.cc) when built; byte-identical fallback."""
    nat = _get_native()
    if nat is not None:
        return Pointer(nat.hash_value(tuple(values)))
    return Pointer(_hash_bytes(_value_bytes(tuple(values))))


def ptr_column(keys: np.ndarray) -> tuple:
    """Mark a raw uint64 key array as a Pointer column for
    ref_scalars_columns — the native hasher serializes it straight from the
    buffer instead of boxing one Pointer object per row."""
    return ("__ptr__", np.ascontiguousarray(keys, dtype=np.uint64))


def ref_scalars_columns(columns: list, n: int) -> np.ndarray:
    """Batch key derivation: row i keys as ref_scalar(col0[i], col1[i], ...).
    The native path hashes all rows without re-entering the interpreter;
    int64/float64 numpy columns and ptr_column-marked key arrays serialize
    directly from their buffers."""
    nat = _get_native()
    if nat is not None:
        raw = nat.hash_columns(tuple(columns), n)
        return np.frombuffer(raw, dtype=np.uint64).copy()
    cols = [
        [Pointer(int(x)) for x in col[1]]
        if isinstance(col, tuple) and len(col) == 2 and col[0] == "__ptr__"
        else col
        for col in columns
    ]
    out = np.empty(n, dtype=np.uint64)
    for i in range(n):
        out[i] = int(ref_scalar(*(col[i] for col in cols)))
    return out


def match_keys(
    left: np.ndarray, right: np.ndarray, right_sorted: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Equijoin match step over two uint64 key arrays: every (li, ri) index
    pair with ``left[li] == right[ri]``, ordered by li (and per li, by ri in
    right order) — the probe signature the columnar delta join is built on
    (native: pathway_native.cc match_fk, a threaded GIL-free hash probe;
    fallback: sort + searchsorted).  Pass ``right_sorted=True`` when the
    right side is already ascending (arrangement segments) to skip the
    fallback's argsort."""
    nl, nr = len(left), len(right)
    if not nl or not nr:
        e = np.empty(0, dtype=np.int64)
        return e, e
    nat = _get_native()
    if nat is not None and hasattr(nat, "match_fk"):
        li_b, ri_b = nat.match_fk(
            np.ascontiguousarray(left, dtype=np.uint64),
            np.ascontiguousarray(right, dtype=np.uint64),
        )
        return (
            np.frombuffer(li_b, dtype=np.int64),
            np.frombuffer(ri_b, dtype=np.int64),
        )
    if right_sorted:
        order_r = None
        r_sorted = right
    else:
        order_r = np.argsort(right, kind="stable")
        r_sorted = right[order_r]
    lo = np.searchsorted(r_sorted, left, "left")
    hi = np.searchsorted(r_sorted, left, "right")
    counts = hi - lo
    if not counts.any():
        e = np.empty(0, dtype=np.int64)
        return e, e
    li = np.repeat(np.arange(nl, dtype=np.int64), counts)
    ri = expand_ranges(lo, counts)
    if order_r is not None:
        ri = order_r[ri]
    return li, ri


def ref_scalar_with_instance(*values: Any, instance: Any) -> Pointer:
    base = ref_scalar(*values, instance)
    inst = ref_scalar(instance)
    return base.with_shard_of(inst)


_SEQ_SALT = _hash_bytes(b"sequential")


def sequential_key(i: int) -> Pointer:
    """Key for the i-th row of an unkeyed source — hashed so rows spread
    across shards."""
    return Pointer(_hash_bytes(b"\x10" + struct.pack("<q", i)))


def keys_array(keys: Iterable[Any]) -> np.ndarray:
    return np.fromiter((int(k) for k in keys), dtype=np.uint64)


class PyObjectWrapper:
    """Opaque python object carried through the graph
    (reference: src/engine/value.rs PyObjectWrapper). Subscriptable as a
    generic in annotations: ``pw.PyObjectWrapper[dict]``."""

    __slots__ = ("value", "_serializer")

    def __init__(self, value: Any, serializer: Any = None):
        self.value = value
        self._serializer = serializer

    def __class_getitem__(cls, item: Any) -> Any:
        return cls

    def __repr__(self) -> str:
        return f"PyObjectWrapper({self.value!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PyObjectWrapper) and self.value == other.value

    def __hash__(self) -> int:
        try:
            return hash(self.value)
        except TypeError:
            return hash(id(self.value))


def wrap_py_object(value: Any, serializer: Any = None) -> PyObjectWrapper:
    return PyObjectWrapper(value, serializer)


class PathwayType(Enum):
    """Public column type enum (mirrors reference PathwayType,
    src/python_api.rs:1639)."""

    ANY = "Any"
    STRING = "String"
    INT = "Int"
    BOOL = "Bool"
    FLOAT = "Float"
    POINTER = "Pointer"
    DATE_TIME_NAIVE = "DateTimeNaive"
    DATE_TIME_UTC = "DateTimeUtc"
    DURATION = "Duration"
    ARRAY = "Array"
    JSON = "Json"
    TUPLE = "Tuple"
    LIST = "List"
    BYTES = "Bytes"
    PY_OBJECT_WRAPPER = "PyObjectWrapper"
    FUTURE = "Future"

    @staticmethod
    def optional(t: "PathwayType") -> "PathwayType":
        return t


class PersistenceMode(Enum):
    """Persistence modes (reference: src/connectors/mod.rs:108)."""

    BATCH = "batch"
    SPEEDRUN_REPLAY = "speedrun_replay"
    REALTIME_REPLAY = "realtime_replay"
    PERSISTING = "persisting"
    OPERATOR_PERSISTING = "operator_persisting"
    # only operators with an explicit name persist; inputs are not logged
    SELECTIVE_PERSISTING = "selective_persisting"
    UDF_CACHING = "udf_caching"


class SnapshotAccess(Enum):
    RECORD = "record"
    REPLAY = "replay"
    FULL = "full"
    OFFSETS_ONLY = "offsets_only"


class SessionType(Enum):
    NATIVE = "native"
    UPSERT = "upsert"


class Error:
    """Singleton poison value that flows through the graph instead of raising
    (reference: src/engine/error.rs Value::Error)."""

    _instance: "Error | None" = None

    def __new__(cls) -> "Error":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Error"


ERROR = Error()


def unsafe_make_pointer(x: int) -> Pointer:
    return Pointer(x)
