"""The port's own copy of ``pathway_tpu/internals/thisclass.py``. `pw.this` / `pw.left` / `pw.right` placeholders
(reference: python/pathway/internals/thisclass.py). Attribute access returns
ColumnReferences bound to the placeholder; desugaring substitutes the actual
table when the expression reaches a table operation."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.expression import ColumnReference, PointerExpression


_KEY_GUARD_COUNTER = 0


class ThisPlaceholder:
    def __init__(self, kind: str):
        self._kind = kind

    @property
    def C(self):
        from pathway_tpu_torch.internals.table import _ColumnNamespace

        return _ColumnNamespace(self)

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return ColumnReference(self, name)

    def __getitem__(self, name) -> Any:
        if isinstance(name, str):
            if name.startswith("_pw_this_expand_"):
                return self  # `**pw.left` guard key (see keys())
            return ColumnReference(self, name)
        if isinstance(name, (list, tuple)):
            return ThisSlice(self, [c if isinstance(c, str) else c.name for c in name])
        raise TypeError(name)

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    def pointer_from(self, *args, optional: bool = False, instance=None):
        return PointerExpression(self, *args, optional=optional, instance=instance)

    def ix(
        self,
        expression,
        *,
        optional: bool = False,
        context=None,
        allow_misses: bool = False,
    ):
        from pathway_tpu_torch.internals.table import _DeferredThisIxTable

        return _DeferredThisIxTable(expression, optional, context, allow_misses)

    def without(self, *columns) -> "ThisSlice":
        names = [c if isinstance(c, str) else c.name for c in columns]
        return ThisSlice(self, None, without=names)

    def rename(self, rename_dict: dict) -> "ThisSlice":
        return ThisSlice(self, None).rename(rename_dict)

    def with_prefix(self, prefix: str) -> "ThisSlice":
        return ThisSlice(self, None, prefix=prefix)

    def with_suffix(self, suffix: str) -> "ThisSlice":
        return ThisSlice(self, None, suffix=suffix)

    def __repr__(self) -> str:
        return f"pw.{self._kind}"

    def __iter__(self):
        # `*pw.this` in select(...) expands to all columns (the positional
        # ThisPlaceholder handler does the expansion; iteration just hands
        # the placeholder through)
        return iter([self])

    def keys(self):
        # `**pw.left` support: the mapping protocol hands select() a
        # single guarded kwarg whose VALUE is this placeholder; select
        # handlers detect it and expand to all columns (reference:
        # thisclass KEY_GUARD keys)
        global _KEY_GUARD_COUNTER  # unique per expansion: collisions would
        _KEY_GUARD_COUNTER += 1  # silently drop one side's columns
        return [f"_pw_this_expand_{_KEY_GUARD_COUNTER}"]


class ThisSlice:
    """`pw.this[["a","b"]]`, `pw.this.without(...)`, `pw.left.rename(...)`,
    with_prefix/with_suffix — resolved against the target table at
    desugaring time. Attribute access mints deferred ColumnReferences
    that error at resolve time when the name was sliced away (reference:
    thisclass mock slices / TableSlice)."""

    def __init__(
        self,
        parent: ThisPlaceholder,
        names: list[str] | None,
        without=None,
        renames: dict | None = None,
        prefix: str = "",
        suffix: str = "",
        pick: list[str] | None = None,
        out_renames: dict | None = None,
    ):
        self._parent = parent
        self._names = names
        self._without = list(without or [])
        self._renames = dict(renames or {})  # source name -> output name
        self._prefix = prefix
        self._suffix = suffix
        self._pick = pick  # narrow to these OUTPUT names after renaming
        self._out_renames = dict(out_renames or {})  # output -> new output

    def _derive(self, **overrides) -> "ThisSlice":
        kw = dict(
            names=self._names,
            without=self._without,
            renames=self._renames,
            prefix=self._prefix,
            suffix=self._suffix,
            pick=self._pick,
            out_renames=self._out_renames,
        )
        kw.update(overrides)
        return ThisSlice(self._parent, **kw)

    def without(self, *columns) -> "ThisSlice":
        extra = [c if isinstance(c, str) else c.name for c in columns]
        return self._derive(without=self._without + extra)

    def rename(self, rename_dict: dict) -> "ThisSlice":
        norm = {
            (k if isinstance(k, str) else k.name): (
                v if isinstance(v, str) else v.name
            )
            for k, v in rename_dict.items()
        }
        # renames address OUTPUT names (post prefix/suffix/earlier
        # renames), mirroring TableSlice.rename; unknown names error at
        # resolve time, when the column set is known
        return self._derive(out_renames={**self._out_renames, **norm})

    def with_prefix(self, prefix: str) -> "ThisSlice":
        return self._derive(prefix=prefix + self._prefix)

    def with_suffix(self, suffix: str) -> "ThisSlice":
        return self._derive(suffix=self._suffix + suffix)

    def keys(self):
        # `**pw.left.without("x")` mapping protocol: one guarded key whose
        # value is this slice; select handlers expand it (same guard trick
        # as ThisPlaceholder.keys)
        global _KEY_GUARD_COUNTER
        _KEY_GUARD_COUNTER += 1
        return [f"_pw_this_expand_{_KEY_GUARD_COUNTER}"]

    def __iter__(self):
        return iter([self])

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("_"):
            raise AttributeError(name)
        return ColumnReference(self, name)

    def __getitem__(self, name) -> Any:
        if isinstance(name, str):
            if name.startswith("_pw_this_expand_"):
                return self  # `**slice` guard key (see keys())
            return ColumnReference(self, name)
        if isinstance(name, (list, tuple)):
            picked = [c if isinstance(c, str) else c.name for c in name]
            return self._derive(pick=picked)
        raise TypeError(name)

    def _visible_names(self, table) -> list[str]:
        names = self._names
        if names is None:
            names = list(table.column_names())
        return [c for c in names if c not in self._without]

    def _out_name(self, src: str) -> str:
        return self._prefix + self._renames.get(src, src) + self._suffix

    def resolve(self, table) -> dict[str, ColumnReference]:
        out = {
            self._out_name(n): table[n] for n in self._visible_names(table)
        }
        for old, new in self._out_renames.items():
            if old not in out:
                raise KeyError(
                    f"Column name {old!r} not found in this slice."
                )
            out[new] = out.pop(old)
        if self._pick is not None:
            out = {n: out[n] for n in self._pick}
        return out

    def resolve_ref(self, table, name: str) -> ColumnReference:
        # `name` is an OUTPUT name: apply renames/prefix/suffix/pick
        resolved = self.resolve(table)
        if name not in resolved:
            raise KeyError(
                f"Column name {name!r} not found in this slice."
            )
        return resolved[name]


this = ThisPlaceholder("this")
left = ThisPlaceholder("left")
right = ThisPlaceholder("right")


def is_this_like(obj: Any) -> bool:
    return isinstance(obj, ThisPlaceholder)
