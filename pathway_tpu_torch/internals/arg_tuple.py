"""The port's own copy of ``pathway_tpu/internals/arg_tuple.py``, whole.

ArgTuple — named multi-value returns
(reference: python/pathway/internals/arg_tuple.py): functions returning
dicts/iterables get a tuple-ish wrapper with attribute, item and unpacking
access; single values unwrap to the bare value."""

from __future__ import annotations

from typing import Any, Callable


class ArgTuple:
    def __init__(self, entries: dict[str, Any]):
        self._entries = dict(entries)

    def __iter__(self):
        return iter(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, key: str) -> Any:
        return self._entries[str(key)]

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_entries"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ArgTuple):
            return self._entries == other._entries
        return tuple(self) == other

    def __hash__(self) -> int:
        try:
            return hash(tuple(self._entries.values()))
        except TypeError:
            return hash(tuple(self._entries.keys()))

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self._entries.items())
        return f"ArgTuple({inner})"


def _wrap_value(value: Any) -> Any:
    if isinstance(value, dict):
        if len(value) == 1:
            only = next(iter(value.values()))
            wrapped = ArgTuple(value)
            # single-entry dicts keep named access but also compare/unwrap
            # like the bare value
            return wrapped if not _is_plain(only) else _Single(value)
        return ArgTuple(value)
    if isinstance(value, (list, tuple)):
        if len(value) == 1:
            return value[0]
        return ArgTuple({str(i): v for i, v in enumerate(value)})
    return value


def _is_plain(v: Any) -> bool:
    return not isinstance(v, (dict, list, tuple))


class _Single(ArgTuple):
    """One named value: accessible by name AND equal to the bare value."""

    def __hash__(self) -> int:
        (v,) = list(self._entries.values())
        try:
            return hash(v)  # consistent with equality to the bare value
        except TypeError:
            return super().__hash__()

    def __eq__(self, other: object) -> bool:
        (v,) = list(self._entries.values())
        res = v == other
        # == on array-like/expression values returns non-bools; only
        # short-circuit on a genuine boolean result
        if isinstance(res, bool) and res:
            return True
        return super().__eq__(other)


def wrap_arg_tuple(fn: Callable) -> Callable:
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        return _wrap_value(fn(*args, **kwargs))

    return wrapped
