"""Columnar expression evaluation — the port's own copy of
``pathway_tpu/engine/expression_eval.py``. It imports no pandas: a value is
tested for ``pd.Timestamp`` only when pandas is already loaded (no
Timestamp exists otherwise).

Counterpart of the reference's row-at-a-time interpreter
(upstream Pathway: src/engine/expression.rs): expressions are evaluated over
whole column batches. Numeric columns run vectorized with numpy on the host;
object columns (str/json/tuple) run elementwise; batched UDFs (the
embedder) receive the whole tick.

`IfElse` evaluates branches only on the selected row subsets, matching the
reference's lazy per-row branch semantics. Runtime errors inside expressions
become `ERROR` poison values instead of crashing the graph
(reference: src/engine/error.rs Value::Error).
"""

from __future__ import annotations

import operator
import sys
from typing import Any, Callable, Sequence

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.api import ERROR, Error, Pointer, ref_scalar
from pathway_tpu_torch.internals.json import Json


class InternalColRef(expr.ColumnExpression):
    """Resolved column reference: (input index, column name). 'id' = keys."""

    def __init__(self, input_index: int, name: str):
        self._input_index = input_index
        self._name = name

    def __repr__(self):
        return f"${self._input_index}.{self._name}"


class EvalContext:
    """Aligned row-batch over one or more same-universe inputs."""

    def __init__(self, keys: np.ndarray, column_sets: Sequence[dict[str, np.ndarray]]):
        self.keys = keys
        self.column_sets = list(column_sets)
        self._id_cache: np.ndarray | None = None

    @property
    def n(self) -> int:
        return len(self.keys)

    def id_column(self) -> np.ndarray:
        if self._id_cache is None:
            out = np.empty(len(self.keys), dtype=object)
            for i, k in enumerate(self.keys):
                out[i] = Pointer(int(k))
            self._id_cache = out
        return self._id_cache

    def fetch(self, ref: InternalColRef) -> np.ndarray:
        if ref._name == "id":
            return self.id_column()
        return self.column_sets[ref._input_index][ref._name]


def _is_numeric(a: np.ndarray) -> bool:
    return a.dtype.kind in "bifu"


def _full(n: int, value: Any) -> np.ndarray:
    if isinstance(value, bool):
        return np.full(n, value, dtype=bool)
    if isinstance(value, int) and not isinstance(value, Pointer):
        if -(2**63) <= value < 2**63:
            return np.full(n, value, dtype=np.int64)
    if isinstance(value, float):
        return np.full(n, value, dtype=np.float64)
    out = np.empty(n, dtype=object)
    out[:] = [value] * n
    return out


def _unbox_rows(arrays) -> list:
    """Per-row Python boundaries (UDFs, scalar method fns, elementwise
    operators) must see plain Python scalars: with typed ingest a column
    may be int64/float64/bool, and numpy SCALAR semantics differ from
    Python's exactly where the poison contract bites (np.int64 // 0
    warns and yields 0 instead of raising ZeroDivisionError;
    isinstance(v, int) is False for np.int64).  tolist() unboxes at C
    speed; object columns pass through untouched."""
    return [
        a.tolist()
        if isinstance(a, np.ndarray) and a.dtype != object
        else a
        for a in arrays
    ]


def _elementwise(fn: Callable, *arrays: np.ndarray) -> np.ndarray:
    n = len(arrays[0])
    arrays = _unbox_rows(arrays)
    out = np.empty(n, dtype=object)
    for i in range(n):
        args = [a[i] for a in arrays]
        if any(isinstance(a, Error) for a in args):
            out[i] = ERROR
            continue
        try:
            out[i] = fn(*args)
        except Exception as exc:
            from pathway_tpu_torch.internals.errors import record_error

            record_error(exc)
            out[i] = ERROR
    return out


def _tighten(out: np.ndarray) -> np.ndarray:
    """Convert an object array to a typed one when ALL elements agree."""
    if out.dtype != object or len(out) == 0:
        return out
    all_bool = True
    all_int = True
    all_float = True
    for v in out:
        if not isinstance(v, (bool, np.bool_)):
            all_bool = False
        if (
            isinstance(v, (bool, np.bool_, Pointer))
            or not isinstance(v, (int, np.integer))
        ):
            all_int = False
        if (
            isinstance(v, (bool, np.bool_, Pointer))
            or not isinstance(v, (int, float, np.integer, np.floating))
        ):
            # Pointer subclasses int: letting it through would round-trip
            # row keys through float64 and corrupt them past 2**53
            all_float = False
        if not (all_bool or all_int or all_float):
            return out
    try:
        if all_bool:
            return out.astype(bool)
        if all_int:
            return out.astype(np.int64)
        if all_float:
            return out.astype(np.float64)
    except (ValueError, TypeError, OverflowError):
        return out
    return out


def tighten_batch(batch) -> Any:
    """Typed ingest (Tick Forge): apply the SAME strict object->typed
    conversion the expression evaluator already uses on its results to a
    batch's ingest columns, so stateless chains start from dense numeric
    arrays instead of boxed rows.  Acceptance rules are exactly
    ``_tighten``'s — a column converts only when EVERY element is a plain
    bool / int64-range int / float (Pointer, None, Error, big ints, and
    mixed bool+int columns all stay object) — so no value the interpreter
    would keep boxed ever changes representation silently."""
    from pathway_tpu_torch.engine.batch import DiffBatch

    obj = {
        name: col
        for name, col in batch.columns.items()
        if col.dtype == object and len(col)
    }
    if not obj:
        return batch
    cols = dict(batch.columns)
    changed = False
    for name, col in obj.items():
        tight = _tighten(col)
        if tight is not col:
            cols[name] = tight
            changed = True
    if not changed:
        return batch
    return DiffBatch(batch.keys, batch.diffs, cols)


_CMP_OPS = {"==", "!=", "<", "<=", ">", ">="}
_BOOL_OPS = {"&", "|", "^"}


def _binary(op: str, left: np.ndarray, right: np.ndarray) -> np.ndarray:
    lnum, rnum = _is_numeric(left), _is_numeric(right)
    if lnum and rnum:
        with np.errstate(all="ignore"):
            if op == "/":
                l = left.astype(np.float64)
                r = right.astype(np.float64)
                bad = right == 0
                if bad.any():
                    from pathway_tpu_torch.internals.errors import record_error

                    for _ in range(int(np.sum(bad))):
                        record_error(ZeroDivisionError("division by zero"))
                    res = np.where(bad, np.nan, np.divide(l, np.where(bad, 1, r)))
                    out = res.astype(object)
                    out[np.asarray(bad)] = ERROR
                    return out
                return np.divide(l, r)
            if op in ("//", "%"):
                bad = right == 0
                fn = np.floor_divide if op == "//" else np.mod
                if bad.any():
                    from pathway_tpu_torch.internals.errors import record_error

                    for _ in range(int(np.sum(bad))):
                        record_error(ZeroDivisionError("division by zero"))
                    res = fn(left, np.where(bad, 1, right))
                    out = res.astype(object)
                    out[np.asarray(bad)] = ERROR
                    return out
                return fn(left, right)
            if op == "**":
                if left.dtype.kind in "iu" and right.dtype.kind in "iu":
                    if (right < 0).any():
                        return np.power(left.astype(float), right.astype(float))
                return np.power(left, right)
            if op in _CMP_OPS:
                return _BINARY_NP[op](left, right)
            if op in _BOOL_OPS:
                if left.dtype == bool and right.dtype == bool:
                    return _BINARY_NP[op](left, right)
                return _BINARY_NP[op](left, right)
            if op == "@":
                return _elementwise(operator.matmul, left, right)
            return _BINARY_NP[op](left, right)
    # object path
    fn = _BINARY_PY[op]
    return _tighten(_elementwise(fn, left, right))


def _py_eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    return a == b


_BINARY_NP: dict[str, Callable] = {
    "<<": np.left_shift,
    ">>": np.right_shift,
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "==": np.equal,
    "!=": np.not_equal,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
    "&": np.bitwise_and,
    "|": np.bitwise_or,
    "^": np.bitwise_xor,
}

_BINARY_PY: dict[str, Callable] = {
    "<<": operator.lshift,
    ">>": operator.rshift,
    "+": operator.add,
    "-": operator.sub,
    "*": operator.mul,
    "/": operator.truediv,
    "//": operator.floordiv,
    "%": operator.mod,
    "**": operator.pow,
    "@": operator.matmul,
    "==": _py_eq,
    "!=": lambda a, b: not _py_eq(a, b),
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
    "&": operator.and_,
    "|": operator.or_,
    "^": operator.xor,
}


def eval_expr(e: expr.ColumnExpression, ctx: EvalContext) -> np.ndarray:
    n = ctx.n
    if isinstance(e, InternalColRef):
        return ctx.fetch(e)
    if isinstance(e, expr.ColumnConstExpression):
        return _full(n, e._value)
    if isinstance(e, expr.ColumnBinaryOpExpression):
        return _binary(e._op, eval_expr(e._left, ctx), eval_expr(e._right, ctx))
    if isinstance(e, expr.ColumnUnaryOpExpression):
        a = eval_expr(e._expr, ctx)
        if e._op == "-":
            return -a if _is_numeric(a) else _elementwise(operator.neg, a)
        if e._op == "~":
            if a.dtype == bool:
                return ~a
            # object columns of bools (optional bool etc.) are logical not;
            # ints are bitwise (reference: Not on Bool, Neg semantics)
            def inv(v):
                if isinstance(v, (bool, np.bool_)):
                    return not v
                return operator.inv(v)

            return _tighten(_elementwise(inv, a))
        if e._op == "abs":
            return np.abs(a) if _is_numeric(a) else _elementwise(abs, a)
        raise NotImplementedError(e._op)
    if isinstance(e, expr.IfElseExpression):
        cond = eval_expr(e._if, ctx)
        cond_b = cond.astype(bool) if cond.dtype != object else np.array(
            [bool(c) for c in cond]
        )
        idx_t = np.nonzero(cond_b)[0]
        idx_f = np.nonzero(~cond_b)[0]
        then_v = eval_expr(e._then, _subset_ctx(ctx, idx_t))
        else_v = eval_expr(e._else, _subset_ctx(ctx, idx_f))
        if (
            then_v.dtype == else_v.dtype
            and then_v.dtype != object
        ):
            out = np.empty(n, dtype=then_v.dtype)
        else:
            out = np.empty(n, dtype=object)
        out[idx_t] = then_v
        out[idx_f] = else_v
        return _tighten(out) if out.dtype == object else out
    if isinstance(e, expr.CoalesceExpression):
        out = eval_expr(e._args[0], ctx)
        if out.dtype != object:
            return out
        out = out.copy()
        for arg in e._args[1:]:
            missing = np.array([v is None for v in out])
            if not missing.any():
                break
            idx = np.nonzero(missing)[0]
            sub = eval_expr(arg, _subset_ctx(ctx, idx))
            out[idx] = sub
        return _tighten(out)
    if isinstance(e, expr.RequireExpression):
        # deps first; the value evaluates ONLY on rows where every dep is
        # non-None (lazy like IfElse — an eager evaluation would poison
        # rows whose dep is legitimately None, e.g. diff's first row)
        missing = np.zeros(n, dtype=bool)
        for arg in e._args:
            a = eval_expr(arg, ctx)
            if a.dtype == object:
                missing |= np.array([v is None for v in a])
        if not missing.any():
            return eval_expr(e._val, ctx)
        out = np.empty(n, dtype=object)
        out[:] = None
        idx = np.nonzero(~missing)[0]
        if len(idx):
            sub = eval_expr(e._val, _subset_ctx(ctx, idx))
            out[idx] = sub
        return out
    if isinstance(e, expr.FillErrorExpression):
        val = eval_expr(e._expr, ctx)
        if val.dtype != object:
            return val
        bad = np.array([isinstance(v, Error) for v in val])
        if not bad.any():
            return val
        idx = np.nonzero(bad)[0]
        repl = eval_expr(e._replacement, _subset_ctx(ctx, idx))
        out = val.copy()
        out[idx] = repl
        return _tighten(out)
    if isinstance(e, expr.IsNoneExpression):
        a = eval_expr(e._expr, ctx)
        if a.dtype != object:
            return np.zeros(n, dtype=bool)
        return np.array([v is None for v in a])
    if isinstance(e, expr.IsNotNoneExpression):
        a = eval_expr(e._expr, ctx)
        if a.dtype != object:
            return np.ones(n, dtype=bool)
        return np.array([v is not None for v in a])
    if isinstance(e, expr.UnwrapExpression):
        a = eval_expr(e._expr, ctx)
        if a.dtype == object:
            for v in a:
                if v is None:
                    raise ValueError("cannot unwrap if there is None value")
        return a
    if isinstance(e, expr.CastExpression):
        return _cast(e._target, eval_expr(e._expr, ctx))
    if isinstance(e, expr.ConvertExpression):
        return _convert(e._target, eval_expr(e._expr, ctx), e._unwrap)
    if isinstance(e, expr.DeclareTypeExpression):
        return eval_expr(e._expr, ctx)
    if isinstance(e, expr.ToStringExpression):
        a = eval_expr(e._expr, ctx)
        return _elementwise(_to_string, a)
    if isinstance(e, expr.MakeTupleExpression):
        # unbox typed columns first: tuple VALUES keep the engine-wide
        # python-scalar representation (the sharded exchange packers and
        # value hashing key off exact element types)
        arrays = _unbox_rows([eval_expr(a, ctx) for a in e._args])
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = tuple(a[i] for a in arrays)
        return out
    if isinstance(e, expr.GetExpression):
        a = eval_expr(e._expr, ctx)
        idx = eval_expr(e._index, ctx)
        default = eval_expr(e._default, ctx)
        if e._check_if_exists:
            return _elementwise(_get_with_default, a, idx, default)
        return _elementwise(_get_strict, a, idx)
    if isinstance(e, expr.PointerExpression):
        arrays = [eval_expr(a, ctx) for a in e._args]
        inst = eval_expr(e._instance, ctx) if e._instance is not None else None
        out = np.empty(n, dtype=object)
        if not e._optional and inst is None and arrays:
            # hot path: batch key derivation in the native kernel
            from pathway_tpu_torch.internals.api import ref_scalars_columns

            hashed = ref_scalars_columns(list(arrays), n)
            for i in range(n):
                out[i] = Pointer(int(hashed[i]))
            return out
        for i in range(n):
            vals = tuple(a[i] for a in arrays)
            if e._optional and any(v is None for v in vals):
                out[i] = None
                continue
            if inst is not None:
                # reference Key::for_values_with_instance: the instance is
                # part of the hashed values AND supplies the shard bits
                from pathway_tpu_torch.internals.api import ref_scalar_with_instance

                p = ref_scalar_with_instance(*vals, instance=inst[i])
            else:
                p = ref_scalar(*vals)
            out[i] = p
        return out
    if isinstance(e, expr.MethodCallExpression):
        arrays = [eval_expr(a, ctx) for a in e._args]
        if e._vector_fn is not None and all(_is_numeric(a) for a in arrays):
            try:
                return e._vector_fn(*arrays)
            except Exception:
                pass
        fn = e._scalar_fn
        if e._propagate_none:

            def wrapped(first, *rest, _fn=fn):
                if first is None:
                    return None
                return _fn(first, *rest)

            return _tighten(_elementwise(wrapped, *arrays))
        return _tighten(_elementwise(fn, *arrays))
    if isinstance(e, (expr.AsyncApplyExpression,)):
        return _eval_async_apply(e, ctx)
    if isinstance(e, expr.BatchApplyExpression):
        from pathway_tpu_torch.internals.errors import record_error

        arrays = _unbox_rows([eval_expr(a, ctx) for a in e._args])
        kw_arrays = {
            k: _unbox_rows([eval_expr(v, ctx)])[0]
            for k, v in e._kwargs.items()
        }
        out = np.empty(n, dtype=object)
        # rows with None (propagate_none) or ERROR inputs bypass the fn,
        # matching the scalar/async apply semantics
        ok_idx = []
        for i in range(n):
            row = [a[i] for a in arrays] + [v[i] for v in kw_arrays.values()]
            if any(isinstance(v, Error) for v in row):
                out[i] = ERROR
            elif e._propagate_none and any(v is None for v in row):
                out[i] = None
            else:
                ok_idx.append(i)
        max_bs = e._max_batch_size or max(len(ok_idx), 1)
        pos = 0
        while pos < len(ok_idx):
            chunk = ok_idx[pos : pos + max_bs]
            args = [[a[i] for i in chunk] for a in arrays]
            kwargs = {
                k: [v[i] for i in chunk] for k, v in kw_arrays.items()
            }
            try:
                results = e._fn(*args, **kwargs)
                if len(results) != len(chunk):
                    raise ValueError(
                        f"batched UDF returned {len(results)} results for "
                        f"{len(chunk)} inputs"
                    )
                for i, r in zip(chunk, results):
                    out[i] = r
            except Exception as exc:
                record_error(exc, user=True)
                for i in chunk:
                    out[i] = ERROR
            pos += max_bs
        return _coerce_to_dtype(out, e._return_type)
    if isinstance(e, expr.ApplyExpression):
        arrays = _unbox_rows([eval_expr(a, ctx) for a in e._args])
        kw_arrays = {
            k: _unbox_rows([eval_expr(v, ctx)])[0]
            for k, v in e._kwargs.items()
        }
        out = np.empty(n, dtype=object)
        for i in range(n):
            args = [a[i] for a in arrays]
            kwargs = {k: v[i] for k, v in kw_arrays.items()}
            if e._propagate_none and any(a is None for a in args):
                out[i] = None
                continue
            if any(isinstance(a, Error) for a in args) or any(
                isinstance(v, Error) for v in kwargs.values()
            ):
                out[i] = ERROR
                continue
            try:
                out[i] = e._fn(*args, **kwargs)
            except Exception as exc:
                from pathway_tpu_torch.internals.errors import record_error

                record_error(exc, user=True)
                out[i] = ERROR
        return _coerce_to_dtype(out, e._return_type)
    if isinstance(e, expr.ReducerExpression):
        raise RuntimeError(
            "reducers can only be used inside groupby(...).reduce(...)"
        )
    if isinstance(e, expr.ColumnReference):
        raise RuntimeError(
            f"unresolved column reference {e!r} — expression used outside "
            "of its table context"
        )
    raise NotImplementedError(f"cannot evaluate {type(e).__name__}")


def _eval_async_apply(e: expr.AsyncApplyExpression, ctx: EvalContext) -> np.ndarray:
    import asyncio

    # the coroutines may run on a helper thread (run_async_blocking when a
    # loop already runs here); capture the error-log scope so their errors
    # still land in the right local log
    from pathway_tpu_torch.internals import errors as _err

    _scope = _err._active_scope()
    n = ctx.n
    arrays = _unbox_rows([eval_expr(a, ctx) for a in e._args])
    kw_arrays = {
        k: _unbox_rows([eval_expr(v, ctx)])[0]
        for k, v in e._kwargs.items()
    }

    async def run_all():
        async def one(i):
            args = [a[i] for a in arrays]
            kwargs = {k: v[i] for k, v in kw_arrays.items()}
            if e._propagate_none and any(a is None for a in args):
                return None
            if any(isinstance(a, Error) for a in args) or any(
                isinstance(v, Error) for v in kwargs.values()
            ):
                return ERROR
            try:
                return await e._fn(*args, **kwargs)
            except Exception as exc:
                from pathway_tpu_torch.internals.errors import record_error

                record_error(exc, user=True, scope=_scope)
                return ERROR

        return await asyncio.gather(*[one(i) for i in range(n)])

    from pathway_tpu_torch.internals.udfs import run_async_blocking

    results = run_async_blocking(run_all)
    out = np.empty(n, dtype=object)
    for i, r in enumerate(results):
        out[i] = r
    return _coerce_to_dtype(out, e._return_type)


def _coerce_to_dtype(out: np.ndarray, target: dt.DType) -> np.ndarray:
    if target.strip_optional() == dt.JSON:
        # engine-boundary Json serialization (reference: python Json ->
        # serde on the PyO3 crossing): datetimes become ISO strings etc.
        from pathway_tpu_torch.internals.json import normalize_json

        def norm(v):
            if v is None or isinstance(v, Error):
                return v
            return normalize_json(v)

        return _elementwise(norm, out)
    storage = target.np_dtype
    if storage != np.dtype(object) and out.dtype == object:
        # ERROR poison and None must survive coercion: astype(bool) would
        # silently turn the (truthy) Error object into True and None into
        # False, losing the poison/optionality
        if any(v is None or isinstance(v, Error) for v in out):
            return out
        try:
            return out.astype(storage)
        except (ValueError, TypeError):
            return out
    return out


def _to_string(v: Any) -> str:
    if isinstance(v, Json):
        return v.to_string()
    if isinstance(v, bool):
        return "True" if v else "False"
    pd = sys.modules.get("pandas")  # no Timestamp exists unless pandas is loaded
    if pd is not None and isinstance(v, pd.Timestamp):
        # reference rendering (src/engine/time.rs Display): T-separated,
        # 9-digit nanoseconds, colonless +0000 offset for aware values
        from pathway_tpu_torch.internals.expressions.date_time import _strftime_one

        fmt = "%Y-%m-%dT%H:%M:%S.%f"
        if v.tzinfo is not None:
            fmt += "%z"
        return _strftime_one(v, fmt)
    return str(v)


def _json_access(value: Any, index: Any):
    """(found, item) for JSON-pointer-style access: str key into an object,
    non-negative in-range int index into an array; anything else is a miss
    (reference: src/engine/expression.rs JsonGetItem — no Python negative
    indexing, no wraparound)."""
    if isinstance(value, dict):
        if isinstance(index, str) and index in value:
            return True, value[index]
        return False, None
    if isinstance(value, list):
        if (
            isinstance(index, int)
            and not isinstance(index, bool)
            and 0 <= index < len(value)
        ):
            return True, value[index]
        return False, None
    return False, None


def _get_with_default(container: Any, index: Any, default: Any) -> Any:
    if isinstance(index, np.integer):
        index = int(index)
    if isinstance(container, Json):
        found, item = _json_access(container.value, index)
        if not found:
            if default is None or isinstance(default, Json):
                return default
            return Json(default)  # raw dict/list default coerces to Json
        return Json(item)
    try:
        return container[index]
    except Exception:
        return default


def _get_strict(container: Any, index: Any) -> Any:
    if isinstance(index, np.integer):
        index = int(index)
    if isinstance(container, Json):
        # total access: a miss yields JSON null so chains like
        # data["a"]["b"] propagate (reference test_json.py get_item tests)
        found, item = _json_access(container.value, index)
        return Json(item) if found else Json.NULL
    return container[index]


def _cast(target: dt.DType, a: np.ndarray) -> np.ndarray:
    t = target.strip_optional()
    if t == dt.INT:
        if _is_numeric(a):
            return a.astype(np.int64)
        return _tighten(_elementwise(lambda v: None if v is None else int(v), a))
    if t == dt.FLOAT:
        if _is_numeric(a):
            return a.astype(np.float64)
        return _tighten(_elementwise(lambda v: None if v is None else float(v), a))
    if t == dt.BOOL:
        if _is_numeric(a):
            return a.astype(bool)
        return _tighten(_elementwise(lambda v: None if v is None else bool(v), a))
    if t == dt.STR:
        return _elementwise(lambda v: None if v is None else _to_string(v), a)
    return a


def _convert(target: dt.DType, a: np.ndarray, unwrap: bool) -> np.ndarray:
    def fn(v):
        if v is None:
            if unwrap:
                raise ValueError("cannot unwrap if there is None value")
            return None
        if isinstance(v, Json):
            # engine-strict (unlike the isinstance-based UDF-level Json.as_*):
            # bools never convert to int/float, floats never to int
            # (reference test_json.py as_int/as_float wrong-value tests)
            jv = v.value
            if jv is None:
                if unwrap:
                    raise ValueError("cannot unwrap if there is None value")
                return None
            if target == dt.INT:
                if isinstance(jv, bool) or not isinstance(jv, int):
                    raise ValueError(f"Cannot convert Json {jv!r} to int")
                return jv
            if target == dt.FLOAT:
                if isinstance(jv, bool) or not isinstance(jv, (int, float)):
                    raise ValueError(f"Cannot convert Json {jv!r} to float")
                return float(jv)
            if target == dt.STR:
                if not isinstance(jv, str):
                    raise ValueError(f"Cannot convert Json {jv!r} to str")
                return jv
            if target == dt.BOOL:
                if not isinstance(jv, bool):
                    raise ValueError(f"Cannot convert Json {jv!r} to bool")
                return jv
        if target == dt.INT:
            if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
                raise ValueError(f"{v!r} is not an int")
            return int(v)
        if target == dt.FLOAT:
            if isinstance(v, bool) or not isinstance(v, (int, float, np.number)):
                raise ValueError(f"{v!r} is not a float")
            return float(v)
        if target == dt.STR:
            if not isinstance(v, str):
                raise ValueError(f"{v!r} is not a str")
            return v
        if target == dt.BOOL:
            if not isinstance(v, (bool, np.bool_)):
                raise ValueError(f"{v!r} is not a bool")
            return bool(v)
        return v

    return _tighten(_elementwise(fn, a))


def _subset_ctx(ctx: EvalContext, idx: np.ndarray) -> EvalContext:
    return EvalContext(
        ctx.keys[idx],
        [{n: c[idx] for n, c in cols.items()} for cols in ctx.column_sets],
    )
