"""The port's own copy of ``pathway_tpu/internals/expressions/string.py``. `.str` and `.bin` column namespaces
(reference surface: python/pathway/internals/expressions/string.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    MethodCallExpression,
)


def _m(name, fn, ret, *args, vector_fn=None):
    return MethodCallExpression(name, fn, ret, *args, vector_fn=vector_fn)


class StringNamespace:
    def __init__(self, expression: ColumnExpression):
        self._expr = expression

    def lower(self):
        return _m("str.lower", lambda s: s.lower(), dt.STR, self._expr)

    def upper(self):
        return _m("str.upper", lambda s: s.upper(), dt.STR, self._expr)

    def reversed(self):
        return _m("str.reversed", lambda s: s[::-1], dt.STR, self._expr)

    def len(self):
        return _m("str.len", lambda s: len(s), dt.INT, self._expr)

    def replace(self, old_value, new_value, count=-1):
        return _m(
            "str.replace",
            lambda s, o, n, c: s.replace(o, n, c),
            dt.STR,
            self._expr,
            old_value,
            new_value,
            count,
        )

    def startswith(self, prefix):
        return _m(
            "str.startswith", lambda s, p: s.startswith(p), dt.BOOL, self._expr, prefix
        )

    def endswith(self, suffix):
        return _m(
            "str.endswith", lambda s, p: s.endswith(p), dt.BOOL, self._expr, suffix
        )

    def swapcase(self):
        return _m("str.swapcase", lambda s: s.swapcase(), dt.STR, self._expr)

    def strip(self, chars=None):
        return _m("str.strip", lambda s, c: s.strip(c), dt.STR, self._expr, chars)

    def title(self):
        return _m("str.title", lambda s: s.title(), dt.STR, self._expr)

    def count(self, sub, start=None, end=None):
        return _m(
            "str.count",
            lambda s, sub_, st, en: s.count(
                sub_, st if st is not None else 0, en if en is not None else len(s)
            ),
            dt.INT,
            self._expr,
            sub,
            start,
            end,
        )

    def find(self, sub, start=None, end=None):
        return _m(
            "str.find",
            lambda s, sub_, st, en: s.find(
                sub_, st if st is not None else 0, en if en is not None else len(s)
            ),
            dt.INT,
            self._expr,
            sub,
            start,
            end,
        )

    def rfind(self, sub, start=None, end=None):
        return _m(
            "str.rfind",
            lambda s, sub_, st, en: s.rfind(
                sub_, st if st is not None else 0, en if en is not None else len(s)
            ),
            dt.INT,
            self._expr,
            sub,
            start,
            end,
        )

    def removeprefix(self, prefix):
        return _m(
            "str.removeprefix",
            lambda s, p: s.removeprefix(p),
            dt.STR,
            self._expr,
            prefix,
        )

    def removesuffix(self, suffix):
        return _m(
            "str.removesuffix",
            lambda s, p: s.removesuffix(p),
            dt.STR,
            self._expr,
            suffix,
        )

    def slice(self, start, end):
        return _m(
            "str.slice", lambda s, a, b: s[a:b], dt.STR, self._expr, start, end
        )

    def split(self, sep=None, maxsplit=-1):
        return _m(
            "str.split",
            lambda s, sp, m: tuple(s.split(sp, m)),
            dt.ANY_TUPLE,
            self._expr,
            sep,
            maxsplit,
        )

    def parse_int(self, optional: bool = False):
        ret = dt.Optional_(dt.INT) if optional else dt.INT
        if optional:

            def fn(s):
                try:
                    return int(s)
                except (ValueError, TypeError):
                    return None

        else:

            def fn(s):
                try:
                    return int(s)
                except (ValueError, TypeError):
                    from pathway_tpu_torch.internals.errors import EngineError

                    # reference wording (rust i64::from_str error)
                    raise EngineError(
                        f'parse error: cannot parse "{s}" to int: '
                        "invalid digit found in string"
                    )

        return _m("str.parse_int", fn, ret, self._expr)

    def parse_float(self, optional: bool = False):
        ret = dt.Optional_(dt.FLOAT) if optional else dt.FLOAT
        if optional:

            def fn(s):
                try:
                    return float(s)
                except (ValueError, TypeError):
                    return None

        else:
            fn = float
        return _m("str.parse_float", fn, ret, self._expr)

    def parse_bool(
        self,
        true_values=("on", "true", "yes", "1"),
        false_values=("off", "false", "no", "0"),
        optional: bool = False,
    ):
        true_set = {str(v).lower() for v in true_values}
        false_set = {str(v).lower() for v in false_values}

        def fn(s):
            ls = s.lower()
            if ls in true_set:
                return True
            if ls in false_set:
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {s!r} as bool")

        ret = dt.Optional_(dt.BOOL) if optional else dt.BOOL
        return _m("str.parse_bool", fn, ret, self._expr)

    def to_bytes(self, encoding: str = "utf-8"):
        return _m(
            "str.to_bytes", lambda s, e: s.encode(e), dt.BYTES, self._expr, encoding
        )


class BytesNamespace:
    def __init__(self, expression: ColumnExpression):
        self._expr = expression

    def to_str(self, encoding: str = "utf-8"):
        return _m(
            "bin.to_str", lambda b, e: b.decode(e), dt.STR, self._expr, encoding
        )

    def len(self):
        return _m("bin.len", lambda b: len(b), dt.INT, self._expr)

    def base64_encode(self):
        import base64

        return _m(
            "bin.base64_encode", lambda b: base64.b64encode(b), dt.BYTES, self._expr
        )

    def base64_decode(self):
        import base64

        return _m(
            "bin.base64_decode", lambda b: base64.b64decode(b), dt.BYTES, self._expr
        )
