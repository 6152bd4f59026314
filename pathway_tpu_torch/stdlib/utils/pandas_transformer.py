"""The port's own copy of
``pathway_tpu/stdlib/utils/pandas_transformer.py``, whole; pandas is
imported only inside the operator's ``process``.

``@pw.pandas_transformer`` — lift a pandas.DataFrame function into a
table operator (reference: stdlib/utils/pandas_transformer.py:124).

Input universes become DataFrame indexes; the function's output index is
the output universe (must be unique integers). Under the microbatch
engine this is a whole-table operator: any input tick re-derives the
DataFrame computation and only changed output rows are emitted."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import Node, NodeExec
from pathway_tpu_torch.internals.errors import record_error
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


class _PandasTransformNode(Node):
    def __init__(self, input_nodes, func: Callable, output_schema):
        super().__init__(
            list(input_nodes), list(output_schema.column_names())
        )
        self.func = func
        self.output_schema = output_schema

    def make_exec(self):
        return _PandasTransformExec(self)


class _PandasTransformExec(NodeExec):
    def __init__(self, node: _PandasTransformNode):
        super().__init__(node)
        self.states: list[dict[int, tuple]] = [{} for _ in node.inputs]
        self.emitted: dict[int, tuple] = {}

    def process(self, t, inputs):
        import pandas as pd

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
        frames = []
        for state, inp in zip(self.states, self.node.inputs):
            keys = list(state.keys())
            data = {
                n: [state[k][i] for k in keys]
                for i, n in enumerate(inp.column_names)
            }
            frames.append(pd.DataFrame(data, index=keys))
        out_names = self.node.column_names
        new_vals: dict[int, tuple] = {}
        try:
            result = self.node.func(*frames)
        except Exception as exc:
            record_error(exc, str(self.node))
            result = None
        if result is not None:
            if not isinstance(result, pd.DataFrame):
                result = pd.DataFrame(result)
            # a shape mismatch is a programming error, not a data error:
            # fail the run instead of silently padding or staling
            if len(result.columns) != len(out_names):
                raise ValueError(
                    f"pandas_transformer returned {len(result.columns)} "
                    f"column(s) but output_schema declares "
                    f"{len(out_names)}: {list(out_names)}"
                )
            if result.index.has_duplicates:
                raise ValueError(
                    "pandas_transformer output index must be unique (it "
                    "becomes the output universe)"
                )
            result.columns = list(out_names)
            for key, row in result.iterrows():
                new_vals[int(key)] = tuple(row[n] for n in out_names)
        else:
            new_vals = dict(self.emitted)  # error in user fn: keep output
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
        return [DiffBatch.from_rows(out_rows, out_names)]


def pandas_transformer(
    output_schema: Any, output_universe: str | int | None = None
):
    """Decorator turning a pandas-DataFrame function into a table
    transformer (reference API parity)."""

    def decorator(func: Callable):
        import functools
        import inspect

        sig_params = list(inspect.signature(func).parameters.keys())

        @functools.wraps(func)
        def wrapper(*tables: Table) -> Table:
            node = _PandasTransformNode(
                [t._node for t in tables], func, output_schema
            )
            if output_universe is None:
                uni = Universe()
            else:
                idx = (
                    output_universe
                    if isinstance(output_universe, int)
                    else sig_params.index(output_universe)
                )
                uni = tables[idx]._universe
            return Table._from_node(
                node, dict(output_schema.dtypes()), uni
            )

        return wrapper

    return decorator
