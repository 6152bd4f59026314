"""The port's own copy of ``pathway_tpu/internals/table_slice.py``. TableSlice — a reshapeable view of a table's column references
(reference: python/pathway/internals/table_slice.py). Supports the
mapping protocol so `**t.slice.with_suffix("_l")` expands in select()."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.expression import ColumnReference


class TableSlice:
    def __init__(self, mapping: dict[str, ColumnReference], table: Any):
        self._mapping = mapping
        self._table = table

    def __iter__(self):
        return iter(self._mapping.values())

    def __repr__(self) -> str:
        return f"TableSlice({self._mapping})"

    def keys(self):
        return self._mapping.keys()

    def _normalize(self, arg: str | ColumnReference) -> str:
        if isinstance(arg, ColumnReference):
            return arg.name
        return arg

    def __getitem__(self, arg):
        if isinstance(arg, (ColumnReference, str)):
            return self._mapping[self._normalize(arg)]
        return TableSlice(
            {self._normalize(k): self[k] for k in arg}, self._table
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        from pathway_tpu_torch.internals.table import Table

        if hasattr(Table, name) and name != "id":
            raise ValueError(
                f"{name!r} is a method name. It is discouraged to use it as "
                f"a column name. If you really want to use it, use "
                f"[{name!r}]."
            )
        if name not in self._mapping:
            raise AttributeError(
                f"Column name {name!r} not found in {self!r}."
            )
        return self._mapping[name]

    def without(self, *cols) -> "TableSlice":
        mapping = dict(self._mapping)
        for col in cols:
            colname = self._normalize(col)
            if colname not in mapping:
                raise KeyError(
                    f"Column name {colname!r} not found in a {self}."
                )
            mapping.pop(colname)
        return TableSlice(mapping, self._table)

    def rename(self, rename_dict: dict) -> "TableSlice":
        normalized = {
            self._normalize(old): self._normalize(new)
            for old, new in rename_dict.items()
        }
        mapping = dict(self._mapping)
        for old in normalized:
            if old not in mapping:
                raise KeyError(f"Column name {old!r} not found in a {self}.")
            mapping.pop(old)
        for old, new in normalized.items():
            mapping[new] = self._mapping[old]
        return TableSlice(mapping, self._table)

    def with_prefix(self, prefix: str) -> "TableSlice":
        return self.rename({name: prefix + name for name in self.keys()})

    def with_suffix(self, suffix: str) -> "TableSlice":
        return self.rename({name: name + suffix for name in self.keys()})

    def ix(self, expression, *, optional: bool = False, context=None):
        new_table = self._table.ix(
            expression, optional=optional, context=context
        )
        return TableSlice(
            {
                name: new_table[colref.name]
                for name, colref in self._mapping.items()
            },
            new_table,
        )

    def ix_ref(self, *args, optional: bool = False, context=None):
        new_table = self._table.ix_ref(
            *args, optional=optional, context=context
        )
        return TableSlice(
            {
                name: new_table[colref.name]
                for name, colref in self._mapping.items()
            },
            new_table,
        )

    @property
    def slice(self) -> "TableSlice":
        return self
