"""Tick Forge: run stateless operator chains as torch programs on the card —
the port's own copy of ``pathway_tpu/engine/compile.py``.

The interpreter (engine/runtime.py) walks the exec graph every tick and
dispatches one numpy kernel per operator. This module segments the node
graph into maximal chains of *stateless, fixed-schema* operators
(StreamMap/select expression eval, Filter, Reindex with numeric keys,
Concat fan-in) and lowers each chain's expression trees into ONE plain
torch function over columnar device tensors: one launch per lowered node,
one host-to-device copy of the chain's input columns and one
device-to-host copy of its outputs per tick. Filters lower to masks (the
host epilogue compresses), object/string columns pass through host-side
untouched, and anything the lowering cannot prove equivalent — UDFs,
async exprs, Pointer-producing expressions, object-dtype inputs — marks a
chain boundary or falls back to the per-node interpreter for that tick,
with identical semantics. Keys and diffs never leave the host.

Shape bucketing: programs are cached per (segment, padded row-count
bucket, input dtype tuple). Row counts pad up the same power-of-two
ladder the Surge Gate micro-batcher releases batches on; padded rows are
sliced away (map) or masked out (filter) on the host.

GroupBy's semigroup partials (count/sum/avg) can also run on the device
(``semigroup_partials``: ``index_add_`` into ``row_bucket(nu)`` groups).

Where the port differs from the reference, by design:

- compiled ticks are off unless ``PATHWAY_COMPILED_TICK=1`` (the reference
  defaults to on): segments run on ``PATHWAY_COMPILED_DEVICE`` (default
  ``cuda``), which raises without a card unless set to ``cpu``, so a
  default of "on" would either fail every CPU run or hide a CPU fallback;
- an error other than ``NotCompilable`` inside a segment propagates and
  fails the tick, as any operator's error does (the reference logs it and
  runs the interpreter for the rest of the run, which would hide a device
  fault).

Knobs:
  PATHWAY_COMPILED_TICK=1     turn compiled ticks on (default off)
  PATHWAY_COMPILED_DEVICE     the segments' device (default cuda)
  PATHWAY_COMPILED_MIN_ROWS   smallest batch worth dispatching (def 64)
  PATHWAY_COMPILED_GROUPBY    1/0 force the device semigroup partials
                              (default: on when the device is cuda)

Metrics: pathway_engine_compile_cache_{hits,misses}_total,
pathway_engine_compile_seconds, pathway_engine_compile_fallbacks_total
{reason}.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.expression_eval import InternalColRef
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr

# ---------------------------------------------------------------------------
# knobs


def compiled_tick_enabled() -> bool:
    """Default OFF in the port; ``PATHWAY_COMPILED_TICK=1`` turns it on
    (re-read per Runtime)."""
    return os.environ.get("PATHWAY_COMPILED_TICK", "0") != "0"


def compiled_device() -> torch.device:
    """The device segments and partials run on: ``PATHWAY_COMPILED_DEVICE``,
    default ``cuda``; raises without a card unless it names ``cpu``."""
    from pathway_tpu_torch._device import resolve_device

    return resolve_device(os.environ.get("PATHWAY_COMPILED_DEVICE", "cuda"))


def compiled_min_rows() -> int:
    """Batches below this size skip the device dispatch — launch and copy
    overhead beats fusion wins on tiny ticks."""
    raw = os.environ.get("PATHWAY_COMPILED_MIN_ROWS", "")
    try:
        return max(1, int(raw)) if raw else 64
    except ValueError:
        return 64


def compiled_groupby_enabled() -> bool:
    """Device semigroup partials: explicit 1/0 wins; default auto — on when
    the compiled device is CUDA."""
    raw = os.environ.get("PATHWAY_COMPILED_GROUPBY", "")
    if raw:
        return raw != "0"
    return torch.device(os.environ.get("PATHWAY_COMPILED_DEVICE", "cuda")).type == "cuda"


def row_bucket(n: int) -> int:
    """Power-of-two pad bucket — the same ladder Surge Gate's
    micro-batcher releases batches on (serving/config.py), so gated
    serving flushes land on a handful of buckets."""
    b = 8
    while b < n:
        b <<= 1
    return b


# ---------------------------------------------------------------------------
# metrics (process-wide registry; label children cached at module level)


def _metrics():
    global _HITS, _MISSES, _COMPILE_HIST, _FALLBACKS
    if _HITS is None:
        from pathway_tpu_torch.observability import REGISTRY

        _HITS = REGISTRY.counter(
            "pathway_engine_compile_cache_hits_total",
            "compiled-tick programs reused from the shape-bucketed cache",
        )
        _MISSES = REGISTRY.counter(
            "pathway_engine_compile_cache_misses_total",
            "compiled-tick cache misses (a lowering, or a negative "
            "entry recording a non-lowerable dtype tuple)",
        )
        _COMPILE_HIST = REGISTRY.histogram(
            "pathway_engine_compile_seconds",
            "wall time spent lowering one segment program",
        )
        _FALLBACKS = REGISTRY.counter(
            "pathway_engine_compile_fallbacks_total",
            "ticks a planned segment ran on the interpreter instead",
            labelnames=("reason",),
        )
    return _HITS, _MISSES, _COMPILE_HIST, _FALLBACKS


_HITS = _MISSES = _COMPILE_HIST = _FALLBACKS = None


class NotCompilable(Exception):
    """This expression/segment cannot be lowered (reason in args[0])."""

    @property
    def reason(self) -> str:
        return self.args[0]


# ---------------------------------------------------------------------------
# structural classification (build-time)

# operators with exact torch equivalents under the engine's numpy
# semantics.  /, //, %, ** are excluded: their ERROR-poison semantics
# (record_error + per-row poison on zero divisors) have no pure
# counterpart; << >> excluded (negative shift counts are UB and differ
# across backends); @ is object-valued.
_OK_BINOPS = frozenset({"+", "-", "*", "==", "!=", "<", "<=", ">", ">=",
                        "&", "|", "^"})
_CMP_OPS = frozenset({"==", "!=", "<", "<=", ">", ">="})
_BITS_OPS = frozenset({"&", "|", "^"})
_ARITH_OPS = frozenset({"+", "-", "*"})

_CAST_TARGETS = (dt.INT, dt.FLOAT, dt.BOOL)


def classify_expr(e: expr.ColumnExpression) -> str | None:
    """``None`` when the expression is *structurally* lowerable (dtype
    feasibility is still decided per tick against the concrete batch);
    otherwise a short reason used by the planner."""
    if isinstance(e, InternalColRef):
        if e._name == "id":
            return "id column (Pointer-valued)"
        if e._input_index != 0:
            return "multi-input column reference"
        return None
    if isinstance(e, expr.ColumnConstExpression):
        v = e._value
        if isinstance(v, bool):
            return None
        if isinstance(v, int):
            return None if -(2**63) <= v < 2**63 else "big-int constant"
        if isinstance(v, float):
            return None
        return f"object constant ({type(v).__name__})"
    if isinstance(e, expr.ColumnBinaryOpExpression):
        if e._op not in _OK_BINOPS:
            return f"operator {e._op!r} (interpreter-only semantics)"
        return classify_expr(e._left) or classify_expr(e._right)
    if isinstance(e, expr.ColumnUnaryOpExpression):
        if e._op not in ("-", "~", "abs"):
            return f"unary operator {e._op!r}"
        return classify_expr(e._expr)
    if isinstance(e, expr.IfElseExpression):
        return (
            classify_expr(e._if)
            or classify_expr(e._then)
            or classify_expr(e._else)
        )
    if isinstance(e, expr.CoalesceExpression):
        # numeric first arg short-circuits in the interpreter
        return classify_expr(e._args[0])
    if isinstance(e, (expr.FillErrorExpression, expr.UnwrapExpression)):
        return classify_expr(e._expr)
    if isinstance(e, expr.RequireExpression):
        r = classify_expr(e._val)
        if r:
            return r
        for a in e._args:
            r = classify_expr(a)
            if r:
                return r
        return None
    if isinstance(e, expr.CastExpression):
        if e._target.strip_optional() not in _CAST_TARGETS:
            return f"cast to {e._target}"
        return classify_expr(e._expr)
    if isinstance(e, expr.DeclareTypeExpression):
        return classify_expr(e._expr)
    if isinstance(e, (expr.IsNoneExpression, expr.IsNotNoneExpression)):
        return classify_expr(e._expr)
    if isinstance(e, expr.AsyncApplyExpression):
        return "async UDF"
    if isinstance(e, (expr.BatchApplyExpression, expr.ApplyExpression)):
        return "UDF (pw.apply)"
    if isinstance(e, expr.MethodCallExpression):
        return "method call (host-side scalar/vector fn)"
    if isinstance(e, expr.PointerExpression):
        return "pointer derivation (host-side key hash)"
    if isinstance(
        e,
        (
            expr.MakeTupleExpression,
            expr.GetExpression,
            expr.ToStringExpression,
            expr.ConvertExpression,
        ),
    ):
        return "object-valued expression"
    return f"unsupported expression ({type(e).__name__})"


def _is_bare_ref(e: expr.ColumnExpression) -> bool:
    return isinstance(e, InternalColRef) and e._name != "id"


def classify_node(node: Any) -> tuple[bool, str | None]:
    """(chain-member-eligible, reason-if-not).  Structural only; used by
    the planner.  Input/Output nodes return a non-user-actionable
    reason."""
    from pathway_tpu_torch.engine.nodes import (
        ConcatNode,
        FilterNode,
        InputNode,
        OutputNode,
        ReindexNode,
        RowwiseNode,
    )

    if isinstance(node, RowwiseNode):
        if len(node.inputs) > 1:
            return False, "stateful (multi-input aligned select)"
        if not node.deterministic:
            return False, "non-deterministic expressions (cached replay)"
        for e in node.exprs.values():
            if _is_bare_ref(e):
                continue
            r = classify_expr(e)
            if r:
                return False, r
        return True, None
    if isinstance(node, FilterNode):
        r = classify_expr(node.predicate)
        return (False, r) if r else (True, None)
    if isinstance(node, ReindexNode):
        r = classify_expr(node.key_expr)
        return (False, r) if r else (True, None)
    if isinstance(node, ConcatNode):
        return True, None
    if isinstance(node, (InputNode, OutputNode)):
        return False, "__io__"
    if getattr(node, "is_stateful", False):
        return False, f"stateful operator ({type(node).__name__})"
    return False, f"unsupported operator ({type(node).__name__})"


def _has_compute(node: Any) -> bool:
    """A node worth paying a device round-trip for: real expression work
    (not a pure projection/rename) or a filter/reindex."""
    from pathway_tpu_torch.engine.nodes import (
        FilterNode,
        ReindexNode,
        RowwiseNode,
    )

    if isinstance(node, (FilterNode, ReindexNode)):
        return True
    if isinstance(node, RowwiseNode):
        return any(not _is_bare_ref(e) for e in node.exprs.values())
    return False


# ---------------------------------------------------------------------------
# lowering: expression tree -> torch thunk (+ static result dtype)
#
# A lowered value is one of
#   ("host", src)        passthrough of external input column `src`
#   ("dev", thunk, dt)   thunk(inp, memo) -> tensor on the segment's device
#   ("const", v, dt)     scalar literal, materialized as a full column of
#                        its numpy dtype (the interpreter materializes
#                        literals via _full, so consts promote as ARRAYS —
#                        result dtypes come from np.result_type, and no
#                        Python scalar ever enters a torch op)
# Thunks are memoized by identity per run so a chain column referenced
# twice computes once.

_I64 = np.dtype(np.int64)
_F64 = np.dtype(np.float64)
_BOOL = np.dtype(bool)

# the numpy dtypes a column may have on the device (torch has no
# arithmetic for uint16/32/64)
_TORCH_DTYPES = {
    np.dtype(bool): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def _torch_dtype(d: np.dtype) -> torch.dtype:
    t = _TORCH_DTYPES.get(np.dtype(d))
    if t is None:
        raise NotCompilable(f"dtype {d} has no torch counterpart")
    return t


@functools.cache
def _int_cast_specials() -> tuple[int, int, int]:
    """What numpy's float64 -> int64 cast gives on this host for NaN, for
    values at or above 2**63 (+inf included) and for values below -2**63:
    INT64_MIN for all three on x86. A CUDA conversion saturates instead,
    so the lowered cast substitutes these."""
    with np.errstate(invalid="ignore"):
        nan, hi, lo = np.array([np.nan, np.inf, -np.inf]).astype(np.int64)
    return int(nan), int(hi), int(lo)


def _cast(x: torch.Tensor, out: np.dtype) -> torch.Tensor:
    """``x.astype(out)`` with numpy's results, also where a float is NaN,
    infinite or out of int64's range."""
    t = _torch_dtype(out)
    if out.kind != "i" or not x.dtype.is_floating_point:
        return x.to(t)
    nan, hi, lo = _int_cast_specials()
    x64 = x.to(torch.float64)
    r = x64.to(torch.int64)
    r = torch.where(x64 >= 2.0**63, torch.full_like(r, hi), r)
    r = torch.where(x64 < -(2.0**63), torch.full_like(r, lo), r)
    r = torch.where(torch.isnan(x64), torch.full_like(r, nan), r)
    return r.to(t)


def _ev(entry: tuple, inp: dict, memo: dict):
    kind = entry[0]
    if kind == "host":
        return inp[entry[1]]
    if kind == "const":
        n = inp["__n__"]
        return torch.full(
            (n,), entry[1], dtype=_torch_dtype(entry[2]), device=inp["__dev__"]
        )
    thunk = entry[1]
    key = id(thunk)
    r = memo.get(key)
    if r is None:
        r = thunk(inp, memo)
        memo[key] = r
    return r


def _entry_dtype(
    entry: tuple, dtypes: dict[str, np.dtype], where: str
) -> np.dtype:
    if entry[0] == "host":
        d = dtypes[entry[1]]
        if d.kind not in "bifu":
            raise NotCompilable(f"object column {entry[1]!r} ({where})")
        return d
    return entry[2]


def _check_mix(ld: np.dtype, rd: np.dtype) -> None:
    # numpy's uint64/int64 promotion (-> float64) is a trap neither side
    # should fall into silently
    if {ld.kind, rd.kind} == {"u", "i"}:
        raise NotCompilable("mixed signed/unsigned operands")


_T_BIN: dict[str, Callable] = {
    "+": torch.add, "-": torch.sub, "*": torch.mul,
    "==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
    ">": torch.gt, ">=": torch.ge, "&": torch.bitwise_and,
    "|": torch.bitwise_or, "^": torch.bitwise_xor,
}


def _lower(
    e: expr.ColumnExpression,
    env: dict[str, tuple],
    dtypes: dict[str, np.dtype],
    used: "dict[str, None]",
    ops: list,
) -> tuple:
    """Lower `e` against the symbolic column environment; returns an
    entry tuple. ``ops`` collects one element per lowered arithmetic,
    compare, select or cast node (the roofline's operation count). Raises
    NotCompilable — callers fall back per tick."""

    def dev(entry) -> tuple[Callable, np.dtype]:
        """(thunk, dtype) for any entry — host refs lift to device
        inputs, consts materialize against the batch length."""
        d = _entry_dtype(entry, dtypes, "referenced")
        _torch_dtype(d)
        if entry[0] == "host":
            used[entry[1]] = None
        return (lambda inp, memo, _e=entry: _ev(_e, inp, memo)), d

    def node(thunk, out: np.dtype) -> tuple:
        ops.append(None)
        return ("dev", thunk, out)

    if isinstance(e, InternalColRef):
        if e._name == "id":
            raise NotCompilable("id column (Pointer-valued)")
        entry = env.get(e._name)
        if entry is None:
            raise NotCompilable(f"unknown column {e._name!r}")
        # bare refs stay symbolic: host passthroughs never cross to the
        # device (object/string columns legally ride along untouched);
        # consumers that lift to the device run their own dtype checks
        # via dev()
        return entry
    if isinstance(e, expr.ColumnConstExpression):
        v = e._value
        if isinstance(v, bool):
            return ("const", bool(v), _BOOL)
        if isinstance(v, int):
            if not -(2**63) <= v < 2**63:
                raise NotCompilable("big-int constant")
            return ("const", int(v), _I64)
        if isinstance(v, float):
            return ("const", float(v), _F64)
        raise NotCompilable(f"object constant ({type(v).__name__})")
    if isinstance(e, expr.ColumnBinaryOpExpression):
        op = e._op
        if op not in _OK_BINOPS:
            raise NotCompilable(f"operator {op!r}")
        lf, ld = dev(_lower(e._left, env, dtypes, used, ops))
        rf, rd = dev(_lower(e._right, env, dtypes, used, ops))
        _check_mix(ld, rd)
        if op in _ARITH_OPS:
            # numpy's bool + and * are or and and, and bool - raises:
            # bool operands stay on the interpreter
            if ld.kind not in "iuf" or rd.kind not in "iuf":
                raise NotCompilable(f"arithmetic on {ld}/{rd}")
            out = np.result_type(ld, rd)
        elif op in _BITS_OPS:
            if ld.kind == "b" and rd.kind == "b":
                out = _BOOL
            elif ld.kind in "iu" and rd.kind in "iu":
                out = np.result_type(ld, rd)
            else:
                raise NotCompilable(f"bitwise op on {ld}/{rd}")
        else:  # comparison
            out = _BOOL
        common = _torch_dtype(out if op not in _CMP_OPS else np.result_type(ld, rd))
        fn = _T_BIN[op]

        def thunk(inp, memo, _lf=lf, _rf=rf, _c=common, _fn=fn):
            return _fn(_lf(inp, memo).to(_c), _rf(inp, memo).to(_c))

        return node(thunk, out)
    if isinstance(e, expr.ColumnUnaryOpExpression):
        af, ad = dev(_lower(e._expr, env, dtypes, used, ops))
        if e._op == "-":
            if ad.kind not in "if":
                raise NotCompilable(f"negation on {ad}")
            return node(lambda inp, memo: torch.neg(af(inp, memo)), ad)
        if e._op == "abs":
            if ad.kind not in "ifu":
                raise NotCompilable(f"abs on {ad}")
            return node(lambda inp, memo: torch.abs(af(inp, memo)), ad)
        if e._op == "~":
            if ad.kind == "b":
                return node(lambda inp, memo: torch.logical_not(af(inp, memo)), _BOOL)
            if ad.kind in "iu":
                return node(lambda inp, memo: torch.bitwise_not(af(inp, memo)), ad)
            raise NotCompilable(f"invert on {ad}")
        raise NotCompilable(f"unary operator {e._op!r}")
    if isinstance(e, expr.IfElseExpression):
        cf, _cd = dev(_lower(e._if, env, dtypes, used, ops))
        tf, td = dev(_lower(e._then, env, dtypes, used, ops))
        ef, ed = dev(_lower(e._else, env, dtypes, used, ops))
        if td == ed:
            out = td
        elif td.kind in "iuf" and ed.kind in "iuf":
            # interpreter: object array of mixed ints/floats tightens
            # to the numpy promotion of the two
            _check_mix(td, ed)
            out = np.result_type(td, ed)
        else:
            raise NotCompilable(f"if_else branches {td}/{ed}")
        to = _torch_dtype(out)

        def thunk(inp, memo, _cf=cf, _tf=tf, _ef=ef, _o=to):
            c = _cf(inp, memo).to(torch.bool)
            return torch.where(c, _tf(inp, memo).to(_o), _ef(inp, memo).to(_o))

        return node(thunk, out)
    if isinstance(e, expr.CoalesceExpression):
        first = _lower(e._args[0], env, dtypes, used, ops)
        # non-object dtype short-circuits in the interpreter
        _entry_dtype(first, dtypes, "coalesce")
        return first
    if isinstance(e, expr.FillErrorExpression):
        inner = _lower(e._expr, env, dtypes, used, ops)
        _entry_dtype(inner, dtypes, "fill_error")
        return inner
    if isinstance(e, expr.UnwrapExpression):
        inner = _lower(e._expr, env, dtypes, used, ops)
        _entry_dtype(inner, dtypes, "unwrap")
        return inner
    if isinstance(e, expr.RequireExpression):
        # numeric deps are never None: require == its value
        for a in e._args:
            _entry_dtype(_lower(a, env, dtypes, used, ops), dtypes, "require")
        return _lower(e._val, env, dtypes, used, ops)
    if isinstance(e, expr.CastExpression):
        t = e._target.strip_optional()
        af, ad = dev(_lower(e._expr, env, dtypes, used, ops))
        if ad.kind not in "bifu":
            raise NotCompilable(f"cast from {ad}")
        if t == dt.INT:
            out = _I64
        elif t == dt.FLOAT:
            out = _F64
        elif t == dt.BOOL:
            out = _BOOL
        else:
            raise NotCompilable(f"cast to {t}")
        return node(lambda inp, memo, _o=out: _cast(af(inp, memo), _o), out)
    if isinstance(e, expr.DeclareTypeExpression):
        return _lower(e._expr, env, dtypes, used, ops)
    if isinstance(e, (expr.IsNoneExpression, expr.IsNotNoneExpression)):
        af, _ad = dev(_lower(e._expr, env, dtypes, used, ops))
        val = isinstance(e, expr.IsNotNoneExpression)

        def thunk(inp, memo, _af=af, _v=val):
            a = _af(inp, memo)
            return torch.full(a.shape, _v, dtype=torch.bool, device=a.device)

        return node(thunk, _BOOL)
    r = classify_expr(e)
    raise NotCompilable(r or f"unsupported ({type(e).__name__})")


# ---------------------------------------------------------------------------
# segment program: one torch function per (segment, bucket, dtype tuple)


class _Program:
    """Lowered form of one segment for one input-dtype signature."""

    __slots__ = (
        "in_cols", "dev_out", "host_out", "has_mask", "has_keys", "fn",
        "out_names", "n_ops", "out_row_bytes", "out_dtypes",
    )

    def __init__(self, in_cols, dev_out, host_out, has_mask, has_keys,
                 fn, out_names, n_ops, out_row_bytes, out_dtypes):
        self.in_cols = in_cols      # ordered device input column names
        self.dev_out = dev_out      # [(name, position-in-fn-result)]
        self.host_out = host_out    # [(name, external src col)]
        self.has_mask = has_mask
        self.has_keys = has_keys
        self.fn = fn
        self.out_names = out_names  # final column order
        self.n_ops = n_ops          # lowered operations per row
        self.out_row_bytes = out_row_bytes  # device output bytes per row
        self.out_dtypes = out_dtypes  # numpy dtype of each device column


def _build_program(
    chain: Sequence[Any],
    external_cols: Sequence[str],
    dtypes: dict[str, np.dtype],
) -> _Program:
    """Lower the chain against concrete input dtypes into one torch
    function. Raises NotCompilable when this dtype signature cannot be
    proven equivalent (the caller negative-caches it)."""
    from pathway_tpu_torch.engine.nodes import (
        ConcatNode,
        FilterNode,
        ReindexNode,
        RowwiseNode,
    )

    env: dict[str, tuple] = {c: ("host", c) for c in external_cols}
    masks: list[tuple] = []
    key_entry: tuple | None = None
    used: dict[str, None] = {}
    ops: list = []

    def device_input(entry: tuple, what: str) -> np.dtype:
        d = _entry_dtype(entry, dtypes, what)
        _torch_dtype(d)
        if entry[0] == "host":
            # bare-column predicates and keys never pass through dev(),
            # so the device input must be registered here
            used[entry[1]] = None
        return d

    for node in chain:
        if isinstance(node, ConcatNode):
            continue  # concat + column select happen host-side
        if isinstance(node, RowwiseNode):
            env = {
                out_name: _lower(e, env, dtypes, used, ops)
                for out_name, e in node.exprs.items()
            }
        elif isinstance(node, FilterNode):
            entry = _lower(node.predicate, env, dtypes, used, ops)
            device_input(entry, "filter predicate")
            masks.append(entry)
        elif isinstance(node, ReindexNode):
            entry = _lower(node.key_expr, env, dtypes, used, ops)
            d = device_input(entry, "reindex keys")
            # uint64 keys have no torch arithmetic; keys are computed in
            # int64 and viewed as uint64 on the host
            if d != _I64:
                raise NotCompilable(f"reindex key dtype {d}")
            key_entry = entry
        else:  # pragma: no cover - planner never includes others
            raise NotCompilable(f"operator {type(node).__name__}")

    tail = chain[-1]
    out_names = list(tail.column_names)
    dev_out: list[tuple[str, int]] = []
    host_out: list[tuple[str, str]] = []
    dev_entries: list[tuple] = []
    for name in out_names:
        entry = env[name]
        # consts go through the device so literal columns come back with
        # _full's exact dtypes; host refs stay host
        if entry[0] == "host":
            host_out.append((name, entry[1]))
        else:
            _entry_dtype(entry, dtypes, f"output {name!r}")
            dev_out.append((name, len(dev_entries)))
            dev_entries.append(entry)

    if not dev_entries and not masks and key_entry is None:
        raise NotCompilable("no device computation (pure projection)")

    in_cols = list(used.keys())
    if not in_cols:
        # constant-only programs have no batch-length anchor
        raise NotCompilable("constant-only computation")
    mask_entries = list(masks)
    key_e = key_entry

    def fn(*tensors):
        inp = dict(zip(in_cols, tensors))
        inp["__n__"] = tensors[0].shape[0]
        inp["__dev__"] = tensors[0].device
        memo: dict = {}
        outs = [_ev(en, inp, memo) for en in dev_entries]
        if mask_entries:
            m = _ev(mask_entries[0], inp, memo).to(torch.bool)
            for en in mask_entries[1:]:
                m = m & _ev(en, inp, memo).to(torch.bool)
            outs.append(m)
        if key_e is not None:
            outs.append(_ev(key_e, inp, memo))
        return tuple(outs)

    return _Program(
        in_cols,
        dev_out,
        host_out,
        bool(mask_entries),
        key_e is not None,
        fn,
        out_names,
        len(ops) + max(len(mask_entries) - 1, 0),
        # the outputs' bytes a row: the columns, a bool mask, int64 keys
        sum(_entry_dtype(en, dtypes, "output").itemsize for en in dev_entries)
        + bool(mask_entries) + 8 * (key_e is not None),
        [_entry_dtype(en, dtypes, "output") for en in dev_entries],
    )


def _upload(cols: Sequence[np.ndarray], device: torch.device) -> list[torch.Tensor]:
    """One host-to-device copy for every column: their bytes packed into
    one buffer, viewed back per column on the device. Every column has a
    multiple of 8 rows, so each view starts 8-byte aligned."""
    raw = np.concatenate([np.ascontiguousarray(c).view(np.uint8) for c in cols])
    buf = torch.from_numpy(raw).to(device)
    out, off = [], 0
    for c in cols:
        out.append(buf[off:off + c.nbytes].view(_torch_dtype(c.dtype)))
        off += c.nbytes
    return out


_NP_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def _download(ts: Sequence[torch.Tensor]) -> list[np.ndarray]:
    """One device-to-host copy for every tensor (the inverse of _upload)."""
    raw = torch.cat([t.contiguous().view(torch.uint8) for t in ts]).cpu().numpy()
    out, off = [], 0
    for t in ts:
        nb = t.numel() * t.element_size()
        out.append(raw[off:off + nb].view(_NP_DTYPES[t.dtype]))
        off += nb
    return out


# ---------------------------------------------------------------------------
# the runtime-facing segment


class SegmentRunner:
    """One planned chain: head inputs -> lowered program -> tail output.

    Holds the per-(bucket, dtype-tuple) program cache; every tick either
    runs the program on the device (pad -> run -> slice/mask) or falls
    back to running the chain's own interpreter execs — the very same
    NodeExec objects the interpreter would use, so alternating between
    paths is always safe (members are stateless)."""

    _FALLBACK = object()  # negative cache entry

    def __init__(self, seg_id: int, nodes: Sequence[Any], execs: dict,
                 device: torch.device):
        from pathway_tpu_torch.engine.nodes import ConcatNode

        self.seg_id = seg_id
        self.nodes = list(nodes)
        self.execs = execs
        self.device = device
        self.head = nodes[0]
        self.tail = nodes[-1]
        self.concat_head = isinstance(self.head, ConcatNode)
        if self.concat_head:
            self.external_cols = list(self.head.column_names)
        else:
            self.external_cols = list(self.head.inputs[0].column_names)
        self._cache: dict[tuple, Any] = {}
        self._lock = threading.Lock()
        self._journaled_reasons: set[str] = set()
        self.compiled_ticks = 0
        self.fallback_ticks = 0
        self._min_rows = compiled_min_rows()

    # --- runtime hooks ----------------------------------------------------

    def gather(self, produced: dict) -> list[list[DiffBatch]]:
        return [produced.get(inp.id, []) for inp in self.head.inputs]

    def process(self, t: int, inputs: list[list[DiffBatch]]) -> list[DiffBatch]:
        # gate on the raw input lengths BEFORE paying the head-batch
        # concat: a chronically small-tick segment must not add a full
        # memory pass on top of the interpreter redoing the same concat
        n = sum(len(b) for batches in inputs for b in batches)
        if not n:
            return []
        if n < self._min_rows:
            return self._interpret(t, inputs)
        batch = self._head_batch(inputs)
        try:
            out = self._run_compiled(batch)
        except NotCompilable as nc:
            _metrics()[3].labels(nc.reason[:60]).inc()
            self._journal_fallback(t, nc.reason[:60])
            return self._interpret(t, inputs)
        self.compiled_ticks += 1
        return out

    def _journal_fallback(self, t: int, reason: str) -> None:
        """Incident-journal a compiled-segment fallback ONCE per
        (segment, reason) — the fallback counter ticks every tick, the
        journal records the state transition."""
        if reason in self._journaled_reasons:
            return
        self._journaled_reasons.add(reason)
        from pathway_tpu_torch.observability.journal import record as journal_record

        journal_record(
            "compile-fallback",
            f"segment {self.seg_id} fell back to the interpreter "
            f"({reason})",
            tick=t,
            segment=self.seg_id,
            reason=reason,
            permanent=False,
        )

    # --- paths ------------------------------------------------------------

    def _head_batch(self, inputs: list[list[DiffBatch]]) -> DiffBatch:
        from pathway_tpu_torch.engine.nodes import _concat_inputs

        if not self.concat_head:
            return _concat_inputs(list(inputs[0]), self.external_cols)
        parts = [
            b.select_columns(self.external_cols)
            for batches in inputs
            for b in batches
            if len(b)
        ]
        if not parts:
            return DiffBatch.empty(self.external_cols)
        return DiffBatch.concat(parts)

    def _interpret(
        self, t: int, inputs: list[list[DiffBatch]]
    ) -> list[DiffBatch]:
        """Run the chain on its own interpreter execs (identical to the
        un-segmented engine, including per-node error-log scopes)."""
        from pathway_tpu_torch.internals.errors import set_exec_scope

        self.fallback_ticks += 1
        local: dict[int, list[DiffBatch]] = {}
        for pos, inp in enumerate(self.head.inputs):
            local[inp.id] = list(inputs[pos])
        for node in self.nodes:
            ex = self.execs[node.id]
            ins = [local.get(i.id, []) for i in node.inputs]
            set_exec_scope(getattr(node, "_error_scope", None))
            try:
                local[node.id] = ex.process(t, ins)
            finally:
                set_exec_scope(None)
        return local[self.tail.id]

    def _run_compiled(self, batch: DiffBatch) -> list[DiffBatch]:
        prog, bucket_key = self._program_for(batch)
        n = len(batch)
        bucket = bucket_key[0]
        ins = []
        for name in prog.in_cols:
            col = batch.columns[name]
            if bucket > n:
                col = np.concatenate([col, np.zeros(bucket - n, dtype=col.dtype)])
            ins.append(col)
        # roofline attribution (observability/tickscope.py): measured wall
        # per program run against the count registered at lowering time;
        # the copies stay inside the window — the tick waits for them
        _rt0 = time.perf_counter()
        with torch.no_grad():
            res = prog.fn(*_upload(ins, self.device))
        outs = _download(res)
        from pathway_tpu_torch.observability import tickscope as _ts

        _ts.roofline().observe(
            "compiled_tick",
            f"seg_{'-'.join(prog.in_cols)}_rows{bucket}",
            time.perf_counter() - _rt0,
        )
        pos = len(prog.dev_out)
        mask = None
        new_keys = None
        if prog.has_mask:
            mask = outs[pos]
            pos += 1
        if prog.has_keys:
            new_keys = outs[pos]
        for _name, i in prog.dev_out:
            if outs[i].shape != (bucket,):
                raise NotCompilable("non-columnar program output")
        keys = batch.keys
        diffs = batch.diffs
        if new_keys is not None:
            nk = new_keys[:n]
            if len(nk) and (nk < 0).any():
                # the interpreter raises OverflowError assigning a
                # negative key into the uint64 key column; reproduce by
                # letting it
                raise NotCompilable("negative reindex key")
            keys = nk.view(np.uint64)
        if mask is not None:
            idx = np.flatnonzero(mask[:n])
            if len(idx) == 0:
                return []
            keys = keys[idx]
            diffs = diffs[idx]
            cols = {}
            for name, i in prog.dev_out:
                cols[name] = outs[i][idx]
            for name, src in prog.host_out:
                cols[name] = batch.columns[src][idx]
        else:
            cols = {}
            for name, i in prog.dev_out:
                cols[name] = outs[i][:n]
            for name, src in prog.host_out:
                cols[name] = batch.columns[src]
        ordered = {name: cols[name] for name in prog.out_names}
        return [DiffBatch(keys, diffs, ordered)]

    def _program_for(self, batch: DiffBatch) -> tuple[_Program, tuple]:
        hits, misses, compile_hist, _fb = _metrics()
        # the dtype signature covers every external column the chain may
        # reference; lowering decides which of them go to the device
        dkey = tuple(
            batch.columns[c].dtype.str if c in batch.columns else "?"
            for c in self.external_cols
        )
        bucket = row_bucket(len(batch))
        key = (bucket, dkey)
        with self._lock:
            entry = self._cache.get(key)
        if entry is self._FALLBACK:
            hits.inc()
            raise NotCompilable("cached non-lowerable dtype signature")
        if entry is not None:
            hits.inc()
            return entry, key
        misses.inc()
        dtypes = {c: batch.columns[c].dtype for c in batch.columns}
        for c in self.external_cols:
            if batch.columns[c].ndim != 1:
                with self._lock:
                    self._cache[key] = self._FALLBACK
                raise NotCompilable(f"multi-dim column {c!r}")
        t0 = time.perf_counter()
        try:
            prog = _build_program(self.nodes, self.external_cols, dtypes)
        except NotCompilable:
            with self._lock:
                self._cache[key] = self._FALLBACK
            raise
        compile_hist.observe(time.perf_counter() - t0)
        with self._lock:
            self._cache[key] = prog
        self._register_with_ledger(prog, bucket, dtypes)
        self._register_roofline(prog, bucket, dtypes)
        return prog, key

    def _register_with_ledger(self, prog: _Program, bucket: int, dtypes) -> None:
        """Hand the freshly-built segment program to the launch ledger
        (analysis/lowering.py): ``prove_lowering`` can then run the exact
        program this process runs on meta tensors, device-free, and check
        its outputs' shapes and numpy dtypes. The ledger never raises into
        the tick."""
        from pathway_tpu_torch.analysis import lowering as ledger

        ledger.register_program(
            f"seg_{'-'.join(prog.in_cols)}_rows{bucket}",
            prog.fn,
            tuple(((bucket,), dtypes[c]) for c in prog.in_cols),
            meta={
                "rows": bucket,
                "in_cols": list(prog.in_cols),
                "out_cols": [c for c, _ in prog.dev_out],
                "out_dtypes": [str(d) for d in prog.out_dtypes],
            },
        )

    def _register_roofline(self, prog: _Program, bucket: int, dtypes) -> None:
        """Register the program's per-call cost with the Tick Scope
        roofline, keyed like _run_compiled's observe calls: one operation
        per lowered arithmetic, compare, select or cast node per padded
        row; the device input columns read once and the output columns
        written once."""
        from pathway_tpu_torch.observability import tickscope as _ts

        in_bytes = sum(dtypes[c].itemsize for c in prog.in_cols)
        _ts.roofline().register(
            "compiled_tick",
            f"seg_{'-'.join(prog.in_cols)}_rows{bucket}",
            float(prog.n_ops * bucket),
            float((in_bytes + prog.out_row_bytes) * bucket),
            source="lowering",
        )


# ---------------------------------------------------------------------------
# planning


class CompiledPlan:
    def __init__(self, segments: list[SegmentRunner]):
        self.segments = segments
        self.by_tail: dict[int, SegmentRunner] = {
            s.tail.id: s for s in segments
        }
        self.member_ids: set[int] = {
            n.id for s in segments for n in s.nodes if n is not s.tail
        }

    def segment_of(self, node_id: int) -> SegmentRunner | None:
        for s in self.segments:
            if any(n.id == node_id for n in s.nodes):
                return s
        return None


def plan_segments(
    order: Sequence[Any], execs: dict
) -> CompiledPlan | None:
    """Greedy maximal-chain segmentation over the runtime's topo order.

    A chain starts at any structurally compilable node and extends while
    the current tail has exactly ONE consumer, that consumer's only
    input is the tail, and the consumer is itself compilable.  Chains
    with no real compute (pure projections/renames) are skipped — a
    device round-trip for a dict re-label is pure loss. Resolves the
    compiled device first, so compiled ticks without a card raise."""
    if not compiled_tick_enabled():
        return None
    device = compiled_device()
    from pathway_tpu_torch.engine.nodes import ConcatNode

    consumers: dict[int, list[Any]] = {n.id: [] for n in order}
    for node in order:
        for inp in node.inputs:
            if inp.id in consumers:
                consumers[inp.id].append(node)

    assigned: set[int] = set()
    segments: list[SegmentRunner] = []
    seg_id = 0
    for node in order:
        if node.id in assigned:
            continue
        ok, _ = classify_node(node)
        if not ok:
            continue
        chain = [node]
        cur = node
        while True:
            cons = consumers.get(cur.id, [])
            if len(cons) != 1:
                break
            nxt = cons[0]
            if nxt.id in assigned or isinstance(nxt, ConcatNode):
                break
            if len(nxt.inputs) != 1 or nxt.inputs[0] is not cur:
                break
            ok, _ = classify_node(nxt)
            if not ok:
                break
            chain.append(nxt)
            cur = nxt
        # a bare Concat head with no chain after it is just the
        # interpreter's concat; segments must contain real compute
        if not any(_has_compute(n) for n in chain):
            continue
        if isinstance(chain[0], ConcatNode) and len(chain) == 1:
            continue
        for n in chain:
            assigned.add(n.id)
        segments.append(SegmentRunner(seg_id, chain, execs, device))
        seg_id += 1
    if not segments:
        return None
    return CompiledPlan(segments)


# ---------------------------------------------------------------------------
# GroupBy semigroup partials (count/sum/avg) on the device.
#
# np.add.at-equivalent: dcounts[g] = sum(diffs | code==g) and, per
# argument column, part[g] = sum(arr * diffs | code==g). Exact for int64
# (wrap-around matches); for float64 the sum order within a group differs
# (index_add_ on CUDA adds as its atomics land), so float partials agree
# with np.add.at within rounding (the engine's float contract is allclose).

# guards the calls counter: GroupBy execs may run on the engine's pool
_SEMIGROUP_LOCK = threading.Lock()


def semigroup_partials(
    codes: np.ndarray,
    diffs: np.ndarray,
    args: Sequence[np.ndarray | None],
    nu: int,
) -> tuple[np.ndarray, list[np.ndarray | None]]:
    """Device twin of the bulk-groupby scatter pass.  ``args`` is
    positionally aligned with the reducer specs (None = count/multiset,
    no partial).  Only int64/float64 argument columns are supported —
    callers keep the numpy path otherwise. One host-to-device copy of the
    codes, diffs and arguments, ``index_add_`` into ``row_bucket(nu)``
    groups, one device-to-host copy of the partials. Nothing is built, so
    unlike the segments it counts no cache hits or misses."""
    for a in args:
        if a is not None and a.dtype not in (_I64, _F64):
            raise NotCompilable(f"semigroup arg dtype {a.dtype}")
    device = compiled_device()
    n = len(codes)
    nb = row_bucket(n)
    gb = row_bucket(nu)  # groups ride the same pad ladder as rows
    pad = nb - n
    host = [codes.astype(np.int64), np.asarray(diffs, dtype=np.int64)]
    host += [np.ascontiguousarray(a) for a in args if a is not None]
    if pad:
        host = [np.concatenate([h, np.zeros(pad, dtype=h.dtype)]) for h in host]
    with torch.no_grad():
        codes_d, diffs_d, *arg_d = _upload(host, device)
        res = [torch.zeros(gb, dtype=torch.int64, device=device).index_add_(0, codes_d, diffs_d)]
        for a in arg_d:
            w = a * diffs_d.to(a.dtype)
            res.append(torch.zeros(gb, dtype=a.dtype, device=device).index_add_(0, codes_d, w))
        res = _download(res)
    with _SEMIGROUP_LOCK:
        semigroup_partials.calls += 1
    dcounts = res[0][:nu]
    out: list[np.ndarray | None] = []
    i = 1
    for a in args:
        if a is None:
            out.append(None)
        else:
            out.append(res[i][:nu])
            i += 1
    return dcounts, out


# calls that ran on the device (read by chip_smoke.py)
semigroup_partials.calls = 0
