"""The port's own copy of ``pathway_tpu/internals/schema.py``. Schema: static typing of tables.

Capability parity with the reference Schema metaclass
(upstream Pathway: python/pathway/internals/schema.py:955-ish): class-syntax
schemas with annotations, `column_definition` (primary keys, defaults),
`schema_from_types` / `schema_from_dict` / `schema_from_csv`, `schema_builder`,
plus schema algebra (`|`, `with_types`, `without`, ...).
"""

from __future__ import annotations

import csv as _csv
import typing
from dataclasses import dataclass
from typing import Any, Mapping

from pathway_tpu_torch.internals import dtype as dt


_NO_DEFAULT = object()


@dataclass
class ColumnDefinition:
    primary_key: bool = False
    default_value: Any = _NO_DEFAULT
    dtype: Any = None
    name: str | None = None
    append_only: bool | None = None
    description: str | None = None
    example: Any = None

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not _NO_DEFAULT


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _NO_DEFAULT,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
    description: str | None = None,
    example: Any = None,
) -> Any:
    return ColumnDefinition(
        primary_key=primary_key,
        default_value=default_value,
        dtype=dtype,
        name=name,
        append_only=append_only,
        description=description,
        example=example,
    )


@dataclass
class ColumnSchema:
    name: str
    dtype: dt.DType
    primary_key: bool = False
    default_value: Any = _NO_DEFAULT
    append_only: bool = False
    description: str | None = None

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not _NO_DEFAULT


@dataclass
class SchemaProperties:
    append_only: bool | None = None


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnSchema]
    __append_only__: bool

    def __eq__(cls, other: object) -> bool:
        # schemas are equal when their column names, dtypes and primary
        # keys agree (reference: Schema equality is structural)
        if not isinstance(other, SchemaMetaclass):
            return NotImplemented
        return [
            (n, c.dtype, c.primary_key) for n, c in cls.__columns__.items()
        ] == [
            (n, c.dtype, c.primary_key)
            for n, c in other.__columns__.items()
        ]

    def __hash__(cls) -> int:
        return hash(tuple(cls.__columns__.keys()))

    def __init__(cls, name, bases, namespace, append_only: bool | None = None):
        super().__init__(name, bases, namespace)
        columns: dict[str, ColumnSchema] = {}
        for base in bases:
            if hasattr(base, "__columns__"):
                columns.update(base.__columns__)  # type: ignore[attr-defined]
        hints = {}
        try:
            hints = typing.get_type_hints(cls)
        except Exception:
            hints = dict(namespace.get("__annotations__", {}))
        for col_name, hint in namespace.get("__annotations__", {}).items():
            if col_name.startswith("__"):
                continue
            resolved = hints.get(col_name, hint)
            definition = namespace.get(col_name, None)
            if isinstance(definition, ColumnDefinition):
                out_name = definition.name or col_name
                columns[out_name] = ColumnSchema(
                    name=out_name,
                    dtype=dt.wrap(definition.dtype or resolved),
                    primary_key=definition.primary_key,
                    default_value=definition.default_value,
                    append_only=bool(definition.append_only),
                    description=definition.description,
                )
            else:
                columns[col_name] = ColumnSchema(name=col_name, dtype=dt.wrap(resolved))
        cls.__columns__ = columns
        cls.__append_only__ = bool(append_only)

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        columns = {**cls.__columns__, **other.__columns__}
        return schema_from_columns(columns, name=f"{cls.__name__}|{other.__name__}")

    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def columns(cls) -> dict[str, ColumnSchema]:
        return dict(cls.__columns__)

    def keys(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def primary_key_columns(cls) -> list[str] | None:
        pks = [c.name for c in cls.__columns__.values() if c.primary_key]
        return pks or None

    def typehints(cls) -> dict[str, Any]:
        return {name: c.dtype.typehint for name, c in cls.__columns__.items()}

    def dtypes(cls) -> dict[str, dt.DType]:
        return {name: c.dtype for name, c in cls.__columns__.items()}

    # reference spelling used by tests (schema._dtypes())
    _dtypes = dtypes

    @property
    def id(cls) -> ColumnSchema:
        """Type of the table's id column (reference: schema.id —
        parametrized by the grouping columns for groupby outputs)."""
        id_dtype = getattr(cls, "__id_dtype__", None) or dt.POINTER
        return ColumnSchema(name="id", dtype=id_dtype)

    def __getitem__(cls, name: str) -> ColumnSchema:
        return cls.__columns__[name]

    def with_types(cls, **kwargs: Any) -> "SchemaMetaclass":
        columns = dict(cls.__columns__)
        for name, hint in kwargs.items():
            if name not in columns:
                raise ValueError(f"column {name!r} not present in schema")
            old = columns[name]
            columns[name] = ColumnSchema(
                name=name,
                dtype=dt.wrap(hint),
                primary_key=old.primary_key,
                default_value=old.default_value,
                append_only=old.append_only,
            )
        return schema_from_columns(columns, name=cls.__name__)

    def without(cls, *names: Any) -> "SchemaMetaclass":
        drop = {n if isinstance(n, str) else n.name for n in names}
        columns = {k: v for k, v in cls.__columns__.items() if k not in drop}
        return schema_from_columns(columns, name=cls.__name__)

    def update_properties(cls, **kwargs: Any) -> "SchemaMetaclass":
        return cls

    def universe_properties(cls) -> SchemaProperties:
        return SchemaProperties(append_only=cls.__append_only__)

    def __repr__(cls) -> str:
        cols = ", ".join(f"{n}: {c.dtype}" for n, c in cls.__columns__.items())
        return f"<pw.Schema {cls.__name__}({cols})>"


class Schema(metaclass=SchemaMetaclass):
    """Base class for user-declared schemas:

    >>> class InputSchema(pw.Schema):
    ...     name: str
    ...     age: int
    """

    def __init_subclass__(cls, append_only: bool | None = None, **kwargs):
        super().__init_subclass__(**kwargs)


def schema_from_columns(
    columns: Mapping[str, ColumnSchema], name: str = "Schema"
) -> SchemaMetaclass:
    namespace: dict[str, Any] = {"__annotations__": {}}
    cls = SchemaMetaclass(name, (Schema,), namespace)
    cls.__columns__ = dict(columns)
    return cls


def schema_from_types(_name: str = "Schema", **kwargs: Any) -> SchemaMetaclass:
    columns = {k: ColumnSchema(name=k, dtype=dt.wrap(v)) for k, v in kwargs.items()}
    return schema_from_columns(columns, name=_name)


def schema_from_dict(
    columns: Mapping[str, Any],
    *,
    name: str = "Schema",
    properties: SchemaProperties | None = None,
) -> SchemaMetaclass:
    out: dict[str, ColumnSchema] = {}
    for k, v in columns.items():
        if isinstance(v, ColumnDefinition):
            out[k] = ColumnSchema(
                name=k,
                dtype=dt.wrap(v.dtype),
                primary_key=v.primary_key,
                default_value=v.default_value,
            )
        elif isinstance(v, dict):
            out[k] = ColumnSchema(
                name=k,
                dtype=dt.wrap(v.get("dtype")),
                primary_key=bool(v.get("primary_key", False)),
                default_value=v.get("default_value", _NO_DEFAULT),
            )
        else:
            out[k] = ColumnSchema(name=k, dtype=dt.wrap(v))
    return schema_from_columns(out, name=name)


def schema_builder(
    columns: Mapping[str, ColumnDefinition],
    *,
    name: str = "Schema",
    properties: SchemaProperties | None = None,
) -> SchemaMetaclass:
    out = {}
    for k, v in columns.items():
        if not isinstance(v, ColumnDefinition):
            v = ColumnDefinition(dtype=v)
        out[k] = ColumnSchema(
            name=v.name or k,
            dtype=dt.wrap(v.dtype if v.dtype is not None else Any),
            primary_key=v.primary_key,
            default_value=v.default_value,
        )
    return schema_from_columns(out, name=name)


_CSV_TYPES = [int, float, bool, str]


def _infer_csv_type(values: list[str]) -> Any:
    def ok(cast):
        for v in values:
            if v == "":
                continue
            try:
                if cast is bool:
                    if v.lower() not in ("true", "false", "0", "1"):
                        return False
                else:
                    cast(v)
            except ValueError:
                return False
        return True

    if ok(int):
        return int
    if ok(float):
        return float
    if ok(bool):
        return bool
    return str


def schema_from_csv(
    path: str,
    *,
    name: str = "Schema",
    properties: SchemaProperties | None = None,
    delimiter: str = ",",
    quote: str = '"',
    comment_character: str | None = None,
    escape: str | None = None,
    double_quote_escapes: bool = True,
    num_parsed_rows: int | None = None,
) -> SchemaMetaclass:
    with open(path, newline="") as f:
        reader = _csv.reader(f, delimiter=delimiter, quotechar=quote)
        rows = []
        header: list[str] | None = None
        for row in reader:
            if comment_character and row and row[0].startswith(comment_character):
                continue
            if header is None:
                header = row
                continue
            rows.append(row)
            if num_parsed_rows is not None and len(rows) >= num_parsed_rows:
                break
    assert header is not None, "empty csv"
    columns = {}
    for i, col in enumerate(header):
        values = [r[i] for r in rows if i < len(r)]
        columns[col] = ColumnSchema(name=col, dtype=dt.wrap(_infer_csv_type(values)))
    return schema_from_columns(columns, name=name)


def assert_table_has_schema(
    table: Any,
    schema: SchemaMetaclass,
    *,
    allow_superset: bool = True,
    ignore_primary_keys: bool = True,
) -> None:
    table_dtypes = table.schema.dtypes()
    for col, cdt in schema.dtypes().items():
        if col not in table_dtypes:
            raise AssertionError(f"table is missing column {col!r}")
        if not dt.is_compatible(table_dtypes[col], cdt) and not dt.is_compatible(
            cdt, table_dtypes[col]
        ):
            raise AssertionError(
                f"column {col!r} has dtype {table_dtypes[col]}, expected {cdt}"
            )
    if not allow_superset:
        extra = set(table_dtypes) - set(schema.dtypes())
        if extra:
            raise AssertionError(f"table has extra columns: {sorted(extra)}")


def is_subschema(left: SchemaMetaclass, right: SchemaMetaclass) -> bool:
    rd = right.dtypes()
    for col, cdt in left.dtypes().items():
        if col not in rd or not dt.is_compatible(cdt, rd[col]):
            return False
    return True
