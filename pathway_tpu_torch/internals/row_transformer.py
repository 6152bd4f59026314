"""The port's own copy of ``pathway_tpu/internals/row_transformer.py``,
whole.

Row transformers — ``@pw.transformer`` classes with demand-driven,
possibly recursive per-row computations (reference:
python/pathway/internals/row_transformer.py:1-294 and the engine's complex
columns, src/engine/dataflow/complex_columns.rs:1-489).

A transformer class declares inner ``ClassArg`` tables whose attributes
are either inputs (``input_attribute``/``input_method``), cached
intermediates (``attribute``), or outputs (``output_attribute`` /
``method``). Compute functions receive a row reference as ``self`` and may
follow pointers into any table of the same transformer via
``self.transformer.<table>[ptr]`` — the demand-driven part.

Engine mapping: the reference compiles these to demand-subscription
dataflow (Computer/ComplexColumn); under the totally-ordered microbatch
engine each transformer output is one operator that keeps the current
state of every argument table, re-derives its rows when any input ticks,
and emits only the changed output rows. Per-tick memoization gives the
same sharing the reference's demand graph provides within one time."""

from __future__ import annotations

import inspect
import types
from typing import Any, Callable

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import Node, NodeExec
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ERROR, Pointer, ref_scalar
from pathway_tpu_torch.internals.errors import record_error


# --------------------------------------------------------------------------
# attribute descriptors


class _Attr:
    def __init__(
        self,
        kind: str,
        func: Callable | None = None,
        output_name: str | None = None,
        dtype: Any = None,
    ):
        self.kind = kind  # input | input_method | attribute | output | method
        self.func = func
        self.name: str | None = None
        self._output_name = output_name
        self._dtype = dtype
        if func is not None:
            self.__doc__ = func.__doc__

    def __set_name__(self, owner, name):
        if self.name is None:
            self.name = name

    @property
    def output_name(self) -> str:
        return self._output_name or self.name  # type: ignore[return-value]

    @property
    def is_output(self) -> bool:
        return self.kind in ("output", "method")

    def dtype(self) -> dt.DType:
        if self._dtype is not None:
            return dt.wrap(self._dtype)
        if self.func is not None:
            try:
                sig = inspect.signature(self.func)
                if sig.return_annotation is not inspect.Signature.empty:
                    return dt.wrap(sig.return_annotation)
            except (ValueError, TypeError):
                pass
        return dt.ANY


def input_attribute(dtype: Any = None) -> _Attr:
    """Reads the input column with the attribute's name."""
    return _Attr("input", dtype=dtype)


def input_method(dtype: Any = None) -> _Attr:
    """An input column holding callables (another transformer's method)."""
    return _Attr("input_method", dtype=dtype)


def _deco(kind: str):
    def factory(func: Callable | None = None, /, **params):
        if func is None:
            return lambda f: _Attr(kind, f, **params)
        return _Attr(kind, func, **params)

    return factory


attribute = _deco("attribute")
output_attribute = _deco("output")
method = _deco("method")


# --------------------------------------------------------------------------
# ClassArg


class ClassArg:
    """Base for a transformer's inner table classes (reference:
    row_transformer.py ClassArg)."""

    _attributes: dict[str, _Attr]
    _index: int
    transformer: "Transformer"
    id: Pointer

    def __init_subclass__(cls, /, input: Any = Any, output: Any = Any, **kw):
        super().__init_subclass__(**kw)
        attrs: dict[str, _Attr] = {}
        for klass in reversed(cls.__mro__):
            for name, value in vars(klass).items():
                if isinstance(value, _Attr):
                    attrs[name] = value
        cls._attributes = attrs
        cls.input_schema = input
        out_names = [a.output_name for a in attrs.values() if a.is_output]
        if output is not Any and output is not None:
            declared = set(output.column_names())
            if declared != set(out_names):
                raise RuntimeError(
                    f"output schema validation error: declared columns "
                    f"{sorted(declared)}, transformer produces "
                    f"{sorted(out_names)}"
                )
        cls.output_schema = output

    @staticmethod
    def pointer_from(*args, optional: bool = False) -> Pointer:
        return ref_scalar(*args, optional=optional)


# --------------------------------------------------------------------------
# runtime row references


class _Env:
    """One tick's evaluation context: live state of every argument table +
    per-(table,row,attr) memo so shared sub-computations run once."""

    __slots__ = ("states", "col_idx", "memo", "transformer")

    def __init__(self, transformer: "Transformer", states, col_idx):
        self.transformer = transformer
        self.states = states  # list[dict ptr -> vals tuple]
        self.col_idx = col_idx  # list[dict col name -> position]
        self.memo: dict = {}

    def row_vals(self, ca: type, ptr: int) -> tuple:
        rows = self.states[ca._index]
        vals = rows.get(ptr)
        if vals is None:
            raise KeyError(
                f"row {Pointer(ptr)} not present in transformer table "
                f"{ca.__name__!r}"
            )
        return vals


class RowRef:
    __slots__ = ("_env", "_ca", "_ptr")

    def __init__(self, env: _Env, ca: type, ptr: int):
        object.__setattr__(self, "_env", env)
        object.__setattr__(self, "_ca", ca)
        object.__setattr__(self, "_ptr", ptr)

    @property
    def id(self) -> Pointer:
        return Pointer(self._ptr)

    @property
    def transformer(self) -> "_TransformerRef":
        return _TransformerRef(self._env)

    @staticmethod
    def pointer_from(*args, optional: bool = False) -> Pointer:
        return ref_scalar(*args, optional=optional)

    def __getattr__(self, name: str):
        ca = self._ca
        a = ca._attributes.get(name)
        if a is None:
            static = inspect.getattr_static(ca, name, None)
            if static is None:
                raise AttributeError(name)
            if isinstance(static, staticmethod):
                return static.__func__
            if isinstance(static, (types.FunctionType,)):
                return types.MethodType(static, self)
            if isinstance(static, property):
                return static.fget(self)  # type: ignore[misc]
            return static
        env = self._env
        if a.kind in ("input", "input_method"):
            vals = env.row_vals(ca, self._ptr)
            return vals[env.col_idx[ca._index][name]]
        if a.kind in ("attribute", "output"):
            key = (ca._index, self._ptr, name)
            if key not in env.memo:
                env.memo[key] = a.func(self)
            return env.memo[key]
        # method: bind lazily so other rows can call it with arguments
        return types.MethodType(a.func, self)


class _TransformerRef:
    __slots__ = ("_env",)

    def __init__(self, env: _Env):
        self._env = env

    def __getattr__(self, name: str):
        ca = self._env.transformer.class_args.get(name)
        if ca is None:
            raise AttributeError(name)
        return _TableAccessor(self._env, ca)


class _TableAccessor:
    __slots__ = ("_env", "_ca")

    def __init__(self, env: _Env, ca: type):
        self._env = env
        self._ca = ca

    def __getitem__(self, ptr) -> RowRef:
        return RowRef(self._env, self._ca, int(ptr))


class _BoundMethod:
    """Emitted value of a ``method`` output column: callable against the
    operator's live state, comparable by identity of (table,row,method) so
    re-emission diffs stay quiet. Pickles by (table index, row, name) —
    ``load_state`` rebinds the live exec after a persistence resume."""

    __slots__ = ("exec_ref", "ca_index", "ptr", "attr_name")

    def __init__(self, exec_ref, ca_index, ptr, attr_name):
        self.exec_ref = exec_ref
        self.ca_index = ca_index
        self.ptr = ptr
        self.attr_name = attr_name

    def _ca(self):
        tr = self.exec_ref.node.transformer
        return list(tr.class_args.values())[self.ca_index]

    def __call__(self, *args):
        env = self.exec_ref._make_env()
        ca = self._ca()
        a = ca._attributes[self.attr_name]
        return a.func(RowRef(env, ca, self.ptr), *args)

    def __eq__(self, other):
        return (
            isinstance(other, _BoundMethod)
            and (self.ca_index, self.ptr, self.attr_name)
            == (other.ca_index, other.ptr, other.attr_name)
        )

    def __hash__(self):
        return hash((self.ca_index, self.ptr, self.attr_name))

    def __getstate__(self):
        return (self.ca_index, self.ptr, self.attr_name)

    def __setstate__(self, state):
        self.ca_index, self.ptr, self.attr_name = state
        self.exec_ref = None


# --------------------------------------------------------------------------
# engine operator


class RowTransformerNode(Node):
    def __init__(self, input_nodes, transformer: "Transformer", ca: type):
        out_cols = [
            a.output_name for a in ca._attributes.values() if a.is_output
        ]
        super().__init__(list(input_nodes), out_cols)
        self.transformer = transformer
        self.ca = ca

    def make_exec(self):
        return RowTransformerExec(self)


class RowTransformerExec(NodeExec):
    def __init__(self, node: RowTransformerNode):
        super().__init__(node)
        self.states: list[dict[int, tuple]] = [
            {} for _ in node.inputs
        ]
        self.col_idx = [
            {n: i for i, n in enumerate(inp.column_names)}
            for inp in node.inputs
        ]
        self.emitted: dict[int, tuple] = {}
        self.out_attrs = [
            a for a in node.ca._attributes.values() if a.is_output
        ]

    def state_dict(self):
        # `emitted` must persist too: without it the first tick after a
        # resume would re-emit every row as +1 and double-count downstream
        return {"states": self.states, "emitted": self.emitted}

    def load_state(self, state):
        self.states = state["states"]
        self.emitted = state.get("emitted", {})
        for vals in self.emitted.values():
            for v in vals:
                if isinstance(v, _BoundMethod):
                    v.exec_ref = self

    def _make_env(self) -> _Env:
        return _Env(self.node.transformer, self.states, self.col_idx)

    def process(self, t, inputs):
        changed = False
        for state, batches in zip(self.states, inputs):
            for b in batches:
                for k, d, vals in b.iter_rows():
                    changed = True
                    if d > 0:
                        state[k] = vals
                    else:
                        state.pop(k, None)
        if not changed:
            return []
        # demand-driven recursion can make any row's output depend on any
        # other row, so re-derive the whole table and emit only changes
        env = self._make_env()
        ca = self.node.ca
        own = self.states[ca._index]
        new_vals: dict[int, tuple] = {}
        for ptr in own:
            row = RowRef(env, ca, ptr)
            out = []
            for a in self.out_attrs:
                if a.kind == "method":
                    out.append(_BoundMethod(self, ca._index, ptr, a.name))
                    continue
                try:
                    out.append(getattr(row, a.name))
                except Exception as exc:
                    record_error(exc, str(self.node))
                    out.append(ERROR)
            new_vals[ptr] = tuple(out)
        from pathway_tpu_torch.engine.batch import _values_eq

        out_rows: list[tuple[int, int, tuple]] = []
        for k in set(self.emitted) | set(new_vals):
            old = self.emitted.get(k)
            new = new_vals.get(k)
            if old is not None and new is not None and _values_eq(old, new):
                continue
            if old is not None:
                out_rows.append((k, -1, old))
                del self.emitted[k]
            if new is not None:
                out_rows.append((k, 1, new))
                self.emitted[k] = new
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]


# --------------------------------------------------------------------------
# the decorator


class _Result:
    def __init__(self, tables: dict[str, Any]):
        self._tables = tables

    def __getattr__(self, name: str):
        try:
            return self._tables[name]
        except KeyError:
            raise AttributeError(name)


class Transformer:
    def __init__(self, name: str, class_args: dict[str, type]):
        self.name = name
        self.class_args = class_args
        for i, ca in enumerate(class_args.values()):
            ca._index = i
            ca.transformer = self

    def __call__(self, *tables, **kwargs) -> _Result:
        from pathway_tpu_torch.internals.table import Table

        if len(tables) > len(self.class_args):
            raise TypeError(
                f"transformer {self.name} takes {len(self.class_args)} "
                f"table(s) but {len(tables)} were given"
            )
        matched = dict(zip(self.class_args.keys(), tables))
        for name in kwargs:
            if name in matched:
                raise TypeError(
                    f"transformer {self.name} got multiple tables for "
                    f"argument {name!r}"
                )
        matched.update(kwargs)
        if set(matched) != set(self.class_args):
            raise TypeError(
                f"transformer {self.name} expects tables for "
                f"{list(self.class_args)}, got {list(matched)}"
            )
        input_nodes = [matched[n]._node for n in self.class_args]
        out_tables: dict[str, Table] = {}
        for name, ca in self.class_args.items():
            node = RowTransformerNode(input_nodes, self, ca)
            dtypes = {
                a.output_name: a.dtype()
                for a in ca._attributes.values()
                if a.is_output
            }
            out_tables[name] = Table._from_node(
                node, dtypes, matched[name]._universe
            )
        return _Result(out_tables)


def transformer(cls: type) -> Transformer:
    """Class decorator (reference: ``@pw.transformer``): turns a class of
    inner ``ClassArg`` tables into a callable transformer."""
    class_args = {
        name: value
        for name, value in vars(cls).items()
        if isinstance(value, type) and issubclass(value, ClassArg)
    }
    if not class_args:
        raise TypeError(
            f"@transformer class {cls.__name__} declares no ClassArg tables"
        )
    return Transformer(cls.__name__, class_args)
