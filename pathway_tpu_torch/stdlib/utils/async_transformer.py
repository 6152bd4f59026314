"""The port's own copy of ``pathway_tpu/stdlib/utils/async_transformer.py``,
whole.

AsyncTransformer (reference: stdlib/utils/async_transformer.py:281-511):
fully-async request/response operator — each input row is handed to the
user's ``invoke`` coroutine; results come back as a table with a
``_async_status`` column and ``successful`` / ``failed`` / ``finished``
views.

Design vs the reference: the reference routes results through a Python
connector back into the engine (a second input), because timely workers
cannot block on a future. The microbatch engine's totally-ordered tick can
await the whole batch, so this implementation is a single custom operator:
all rows of a tick run concurrently on one event loop (bounded by
``capacity``), and instance consistency is enforced per tick — a failure
poisons every same-instance row at the same or later logical time, exactly
the reference's "-FAILURE-" promotion rule. Consequently ``finished``
never observes "-PENDING-" rows (a timing artifact of the reference's
round-trip architecture, not part of its contract)."""

from __future__ import annotations

import asyncio
import inspect
import re
from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import Node, NodeExec
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.table import Table

_ASYNC_STATUS_COLUMN = "_async_status"
_SUCCESS = "-SUCCESS-"
_FAILURE = "-FAILURE-"


class _AsyncTransformNode(Node):
    def __init__(self, input_node: Node, transformer: "AsyncTransformer"):
        out_cols = list(transformer.output_schema.column_names()) + [
            _ASYNC_STATUS_COLUMN
        ]
        super().__init__([input_node], out_cols)
        self.transformer = transformer

    def make_exec(self):
        return _AsyncTransformExec(self)


class _AsyncTransformExec(NodeExec):
    def __init__(self, node: _AsyncTransformNode):
        super().__init__(node)
        tr = node.transformer
        in_cols = node.inputs[0].column_names
        self.in_cols = in_cols
        self.inst_idx = tr._instance_idx(in_cols)
        self.out_names = list(tr.output_schema.column_names())
        # instance value -> poisoned from some logical time onward
        self.failed_instances: set = set()
        self.emitted: dict[int, tuple] = {}
        self._opened = False

    def state_dict(self):
        return {
            "failed_instances": self.failed_instances,
            "emitted": self.emitted,
        }

    def load_state(self, state):
        self.failed_instances = state["failed_instances"]
        self.emitted = state["emitted"]

    def _run_batch(self, rows: list[tuple]) -> list[Any]:
        """Run invoke for every row concurrently; returns a result dict or
        an Exception per row."""
        tr = self.node.transformer
        invoke = tr._prepared_invoke()
        capacity = tr._capacity

        async def run_all():
            sem = asyncio.Semaphore(capacity) if capacity else None

            async def one(kwargs):
                if sem is None:
                    return await invoke(**kwargs)
                async with sem:
                    return await invoke(**kwargs)

            return await asyncio.gather(
                *[one(kw) for kw in rows], return_exceptions=True
            )

        return udfs.run_async_blocking(run_all)

    def process(self, t, inputs):
        tr = self.node.transformer
        out_rows: list[tuple[int, int, tuple]] = []
        # one pass over the WHOLE tick: instance demotion must see every
        # batch of this logical time, and an insert+retract within the
        # tick must cancel instead of leaving a ghost result
        additions: dict[int, tuple[Any, dict]] = {}
        for b in inputs[0]:
            for k, d, vals in b.iter_rows():
                inst = (
                    vals[self.inst_idx] if self.inst_idx is not None else k
                )
                if d > 0:
                    kwargs = {
                        n: v
                        for n, v in zip(self.in_cols, vals)
                        if n != "_instance"
                    }
                    additions[k] = (inst, kwargs)
                elif k in additions:
                    del additions[k]  # net-zero within the tick
                else:
                    old = self.emitted.pop(k, None)
                    if old is not None:
                        out_rows.append((k, -1, old))
        if additions:
            if not self._opened:
                tr.open()
                self._opened = True
            items = list(additions.items())
            results = self._run_batch([kw for _k, (_i, kw) in items])
            # first pass: record which instances failed at this time
            statuses = []
            for (_k, (inst, _kw)), res in zip(items, results):
                ok = not isinstance(res, BaseException)
                if ok:
                    try:
                        tr._check_result(res)
                    except Exception:
                        ok = False
                if not ok:
                    self.failed_instances.add(inst)
                statuses.append(ok)
            # second pass: a success whose instance failed at <= this time
            # is demoted to FAILURE (reference `failed` contract)
            for (k, (inst, _kw)), res, ok in zip(items, results, statuses):
                if ok and inst not in self.failed_instances:
                    vals_out = tuple(res[n] for n in self.out_names) + (
                        _SUCCESS,
                    )
                else:
                    vals_out = tuple(None for _ in self.out_names) + (
                        _FAILURE,
                    )
                old = self.emitted.get(k)
                if old is not None:
                    out_rows.append((k, -1, old))
                out_rows.append((k, 1, vals_out))
                self.emitted[k] = vals_out
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]

    def on_end(self):
        if self._opened:
            self.node.transformer.close()
        return []


class AsyncTransformer:
    """Subclass with ``output_schema`` (class kwarg or attribute) and an
    ``async def invoke(self, **kwargs) -> dict`` matching the input columns
    (reference: python/pathway/stdlib/utils/async_transformer.py:281)."""

    output_schema: Any = None

    def __init_subclass__(cls, /, output_schema: Any = None, **kwargs):
        super().__init_subclass__(**kwargs)
        if output_schema is not None:
            cls.output_schema = output_schema

    def __init__(
        self,
        input_table: Table,
        *,
        instance: Any = None,
        autocommit_duration_ms: int | None = 1500,
        **kwargs,
    ):
        assert self.output_schema is not None, "define output_schema"
        self._check_signature(input_table)
        if instance is not None:
            input_table = input_table.with_columns(_instance=instance)
        self._input_table = input_table
        self._has_instance = instance is not None
        self._capacity: int | None = None
        self._timeout: float | None = None
        self._retry_strategy: udfs.AsyncRetryStrategy | None = None
        self._cache_strategy: udfs.CacheStrategy | None = None
        self._prepared: Any = None

    # --- configuration -----------------------------------------------------

    def with_options(
        self,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
    ) -> "AsyncTransformer":
        if capacity is not None:
            self._capacity = capacity
        if timeout is not None:
            self._timeout = timeout
        if retry_strategy is not None:
            self._retry_strategy = retry_strategy
        if cache_strategy is not None:
            self._cache_strategy = cache_strategy
        self._prepared = None
        return self

    def open(self) -> None:
        """One-time setup before the first invoke (reference parity)."""

    def close(self) -> None:
        """Cleanup after the run finishes (reference parity)."""

    async def invoke(self, **kwargs) -> dict:
        raise NotImplementedError

    # --- internals ----------------------------------------------------------

    def _check_signature(self, input_table: Table) -> None:
        sig = inspect.signature(self.invoke)
        try:
            sig.bind(**{n: None for n in input_table.column_names()})
        except TypeError as e:
            msg = str(e)
            if m := re.match("got an unexpected keyword argument '(.+)'", msg):
                raise TypeError(
                    f"Input table has a column {m[1]!r} but it is not "
                    "present on the argument list of the invoke method."
                )
            if m := re.match("missing a required argument: '(.+)'", msg):
                raise TypeError(
                    f"Column {m[1]!r} is present on the argument list of "
                    "the invoke method but it is not present in the "
                    "input_table."
                )
            raise

    def _check_result(self, result: Any) -> None:
        if not isinstance(result, dict) or set(result.keys()) != set(
            self.output_schema.column_names()
        ):
            raise ValueError(
                f"invoke result {result!r} does not match output_schema "
                f"columns {list(self.output_schema.column_names())}"
            )

    def _instance_idx(self, in_cols: list[str]) -> int | None:
        return in_cols.index("_instance") if self._has_instance else None

    def _prepared_invoke(self):
        if self._prepared is None:
            fn = self.invoke
            if self._cache_strategy is not None:
                inner0 = fn
                memo: dict = {}

                async def fn_cached(**kwargs):
                    key = tuple(sorted(kwargs.items()))
                    if key in memo:
                        return memo[key]
                    result = await inner0(**kwargs)
                    memo[key] = result
                    return result

                fn = fn_cached
            if self._retry_strategy is not None:
                fn = udfs.with_retry_strategy(fn, self._retry_strategy)
            if self._timeout is not None:
                inner = fn

                async def timed(**kwargs):
                    return await asyncio.wait_for(
                        inner(**kwargs), timeout=self._timeout
                    )

                fn = timed
            self._prepared = fn
        return self._prepared

    # --- result views -------------------------------------------------------

    @property
    def output_table(self) -> Table:
        """All rows with their "-SUCCESS-"/"-FAILURE-" status column."""
        if not hasattr(self, "_output_table"):
            node = _AsyncTransformNode(self._input_table._node, self)
            dtypes = {
                n: dt.Optional_(d)
                for n, d in self.output_schema.dtypes().items()
            }
            dtypes[_ASYNC_STATUS_COLUMN] = dt.STR
            self._output_table = Table._from_node(
                node, dtypes, self._input_table._universe.subset()
            )
        return self._output_table

    @property
    def successful(self) -> Table:
        out = self.output_table
        res = out.filter(
            out[_ASYNC_STATUS_COLUMN] == _SUCCESS
        ).without(_ASYNC_STATUS_COLUMN)
        return res.update_types(**dict(self.output_schema.dtypes()))

    @property
    def failed(self) -> Table:
        out = self.output_table
        return out.filter(
            out[_ASYNC_STATUS_COLUMN] == _FAILURE
        ).without(_ASYNC_STATUS_COLUMN)

    @property
    def finished(self) -> Table:
        return self.output_table

    @property
    def result(self) -> "AsyncTransformer":
        return self
