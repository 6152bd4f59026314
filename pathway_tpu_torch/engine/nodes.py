"""Engine graph nodes and their executors — the port's own copy of
``pathway_tpu/engine/nodes.py`` (the same nodes, the same update streams).

Under an engine mesh (``parallel/mesh.py`` ``get_engine_mesh``) GroupBy,
Join, Buffer and instance Sort build their key-sharded execs
(``engine/sharded.py``), as the reference's do. Hooks of the reference
this copy does not carry: the multi-process execs (``engine/dcn.py``; the
runtime raises for them, ROADMAP [mesh]). The columnar groupby
factorizes with numpy (``factorize``) where the reference calls pandas.

This is the engine's operator vocabulary — the capability contract the
reference exposes as the ~55-method `Graph` trait
(upstream Pathway: src/engine/graph.rs:643-992). Build-time `Node` descriptors
are created by the Table API; at run time each node instantiates a `NodeExec`
that consumes/emits columnar `DiffBatch`es per logical tick.

Incremental strategy: stateless ops are vectorized streaming maps; stateful
ops (join/groupby/sort/...) keep keyed state and restate only *touched* keys
per tick — the microbatch analog of differential dataflow's arrangements
(reference: src/engine/dataflow.rs join_tables:2740, group_by_table:3404).
"""

from __future__ import annotations

import itertools
import os
import sys
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from pathway_tpu_torch.engine.arrangement import (
    Arrangement,
    Rows,
    concat_columns,
    consolidate_mixed,
    merge_rows_sorted,
    merge_sorted,
    mix_keys,
    sorted_member,
)
from pathway_tpu_torch.engine.batch import (
    END_OF_TIME,
    DiffBatch,
    MultisetState,
)
from pathway_tpu_torch.engine.expression_eval import (
    EvalContext,
    eval_expr,
)
from pathway_tpu_torch.engine.reducers import ReducerSpec
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.api import (
    ERROR,
    Pointer,
    match_keys,
    ptr_column,
    ref_scalar,
    ref_scalars_columns,
)
from pathway_tpu_torch.internals.errors import record_error
from pathway_tpu_torch.internals.json import Json

_node_counter = itertools.count()


def factorize(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``pd.factorize(arr, use_na_sentinel=False)`` in numpy: (codes [n]
    int64 numbered in first-appearance order, first index of each unique
    value). None is one value of its own (an object column mixing None
    with ints or strings sorts the other values alone). Raises TypeError
    where ``np.unique`` cannot order the values; the caller then takes the
    exact per-row hash, as the reference does on a pandas TypeError."""
    n = len(arr)
    if arr.dtype == object:
        vals = arr.tolist()
        types = set(map(type, vals))
        if types == {float}:
            # object floats sort by Python comparison, where NaN != NaN:
            # a float array groups all NaNs together, as pandas does
            arr = np.asarray(vals, dtype=np.float64)
        elif type(None) in types:
            is_none = np.fromiter((v is None for v in vals), dtype=bool, count=n)
            rest = np.flatnonzero(~is_none)
            if len(rest):
                _u, first, inv = np.unique(
                    arr[rest], return_index=True, return_inverse=True
                )
                first = rest[first]
            else:
                first = inv = np.zeros(0, dtype=np.int64)
            full = np.empty(n, dtype=np.int64)
            full[rest] = inv.reshape(-1)
            full[is_none] = len(first)
            return _first_appearance(full, np.append(first, np.flatnonzero(is_none)[0]))
    _u, first, inv = np.unique(arr, return_index=True, return_inverse=True)
    return _first_appearance(inv.reshape(-1).astype(np.int64), first)


def _first_appearance(codes: np.ndarray, first: np.ndarray):
    """Relabel sort-order codes by the rank of each value's first index."""
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(first), dtype=np.int64)
    rank[order] = np.arange(len(first), dtype=np.int64)
    return rank[codes], first[order]


ALL_NODES: list["Node"] = []  # every node built since the last G.clear()
# (run_all executes the WHOLE declared graph, outputs or not — reference:
# GraphRunner.run_all vs run_outputs, internals/graph_runner/__init__.py)


# package root used to find the user frame that declared a node (the
# first stack frame outside pathway_tpu itself)
# trailing separator: a SIBLING path that merely shares the directory
# name as a prefix (".../pathway_tpu_demo.py") is user code, not ours
_PKG_ROOT = (
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
)


def _declaration_frame() -> tuple[str, int, str] | None:
    """(filename, lineno, function) of the user code declaring a node —
    the provenance the Graph Doctor attaches to diagnostics (a cheap
    frame walk, no traceback materialization)."""
    try:
        f = sys._getframe(1)
    except ValueError:  # pragma: no cover
        return None
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_ROOT):
            return (fn, f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return None


class Node:
    """Build-time descriptor."""

    # --- static-analysis metadata (pathway_tpu/analysis) ---------------
    # Whether the exec keeps keyed state across ticks — drives the Graph
    # Doctor's unbounded-state and graph-stats rules.
    is_stateful = False

    def __init__(self, inputs: Sequence["Node"], column_names: Sequence[str]):
        self.id = next(_node_counter)
        self.inputs = list(inputs)
        self.column_names = list(column_names)
        self.name = type(self).__name__
        # declaration-site provenance for diagnostics
        self.trace = _declaration_frame()
        # error-log scope captured at build time (pw.local_error_log)
        from pathway_tpu_torch.internals.errors import current_build_scope

        self._error_scope = current_build_scope()
        ALL_NODES.append(self)

    def key_columns(self) -> tuple[str, ...]:
        """Input columns that determine keyed-state routing (grouping
        keys, join keys, dedup instances, ...) — () for stateless or
        row-key-routed nodes."""
        return ()

    def make_exec(self) -> "NodeExec":
        raise NotImplementedError

    def __repr__(self):
        return f"<{self.name}#{self.id}>"


class NodeExec:
    def __init__(self, node: Node):
        self.node = node

    def process(self, t: int, inputs: list[list[DiffBatch]]) -> list[DiffBatch]:
        raise NotImplementedError

    def on_end(self) -> list[DiffBatch]:
        return []

    # --- operator-state snapshots (reference: chunked operator snapshots,
    # src/persistence/operator_snapshot.rs:21-31 + MaybePersist wrappers,
    # src/engine/dataflow/persist.rs) -----------------------------------
    # Default: every attribute except the build-time node descriptor IS the
    # incremental state (the exec pattern keeps all state in plain dicts).
    # Execs holding unpicklables (device arrays, meshes) override.

    def state_dict(self) -> dict | None:
        """Picklable snapshot of this exec's incremental state, or None
        when the exec is stateless.  "_m_"-prefixed attributes are
        metrics-registry handles (hold locks, process-global) and are
        never part of operator state."""
        state = {
            k: v
            for k, v in self.__dict__.items()
            if k != "node" and not k.startswith("_m_")
        }
        return state or None

    def load_state(self, state: dict) -> None:
        self.__dict__.update(state)

    # --- incremental (arrangement-backed) snapshots ---------------------
    # Execs whose state lives in Arrangements (engine/arrangement.py)
    # expose it so the persistence glue can write sealed segments
    # incrementally (content-addressed by segment id, bytes ∝ churn) and
    # recover by mmap-loading them instead of unpickling a monolith.

    def arranged_state(self) -> tuple[dict, dict[str, Any]] | None:
        """(residual_state, {name: Arrangement}) when this exec's state
        should snapshot incrementally, or None to snapshot monolithically
        via state_dict().  The residual must be small (indices, flags) —
        everything that grows with state belongs in the arrangements."""
        return None

    def load_arranged_state(
        self, residual: dict, arrangements: dict[str, Any]
    ) -> None:
        """Default restore: residual attrs + each arrangement under its
        part name (parts named after plain attributes).  Execs that nest
        arrangements inside helper objects override this."""
        self.load_state(residual)
        for name, arr in arrangements.items():
            setattr(self, name, arr)

    # --- memory ledger (observability/tickscope.py) ---------------------

    def memory_ledger(self, deep: bool = False) -> dict[str, int]:
        """Resident bytes per state part.  Default: every Arrangement
        attribute reports its segment/staged bytes; ``deep`` adds the
        monolith-pickle size for execs still snapshotting via
        state_dict() (the exact number the ROADMAP's "kill the last
        monolith" item needs measured, but costs a pickle — never on
        by default).  Execs with doubled state (GroupByExec's live dict
        + pickled ledger) override to name both sides."""
        from pathway_tpu_torch.engine.arrangement import Arrangement

        parts: dict[str, int] = {}
        for k, v in self.__dict__.items():
            if isinstance(v, Arrangement):
                parts[f"arrangement:{k}"] = v.resident_bytes()
        if deep and self.arranged_state() is None:
            try:
                state = self.state_dict()
                if state:
                    import pickle

                    parts["monolith_pickle"] = len(
                        pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
                    )
            except Exception:
                pass
        return parts


def _concat_inputs(batches: list[DiffBatch], names: Sequence[str]) -> DiffBatch:
    batches = [b for b in batches if len(b)]
    if not batches:
        return DiffBatch.empty(names)
    return DiffBatch.concat(batches)


# ---------------------------------------------------------------------------
# Input


class InputNode(Node):
    """Source-fed table (reference: Graph::connector_table,
    src/engine/dataflow.rs:3672)."""

    def __init__(self, source: Any, column_names: Sequence[str]):
        super().__init__([], column_names)
        self.source = source

    def make_exec(self):
        return InputExec(self)


class InputExec(NodeExec):
    def __init__(self, node: InputNode):
        super().__init__(node)
        self.pending: list[DiffBatch] = []
        # Tick Forge typed ingest: resolved once per exec (the flag is
        # per-run like the compiled plan itself)
        self._tighten: bool | None = None

    def inject(self, batch: DiffBatch) -> None:
        if self._tighten is None:
            from pathway_tpu_torch.engine.compile import compiled_tick_enabled

            self._tighten = compiled_tick_enabled()
        if self._tighten:
            from pathway_tpu_torch.engine.expression_eval import tighten_batch

            batch = tighten_batch(batch)
        self.pending.append(batch)

    def process(self, t, inputs):
        out = self.pending
        self.pending = []
        return out


# ---------------------------------------------------------------------------
# Rowwise (select / with_columns) — stateless fast path


class RowwiseNode(Node):
    """Compute output columns from expressions over aligned inputs
    (reference: expression_table, src/engine/dataflow.rs:1735)."""

    def __init__(
        self,
        inputs: Sequence[Node],
        exprs: dict[str, expr_mod.ColumnExpression],
        deterministic: bool = True,
    ):
        super().__init__(inputs, list(exprs.keys()))
        self.exprs = exprs
        self.deterministic = deterministic

    @property
    def is_stateful(self) -> bool:  # type: ignore[override]
        # AlignedRowwiseExec keeps per-input multiset state; the
        # single-input deterministic fast path is a pure streaming map
        return len(self.inputs) > 1 or not self.deterministic

    def make_exec(self):
        if len(self.inputs) == 1 and self.deterministic:
            return StreamMapExec(self)
        return AlignedRowwiseExec(self)


class StreamMapExec(NodeExec):
    def process(self, t, inputs):
        batch = _concat_inputs(inputs[0], self.node.inputs[0].column_names)
        if not len(batch):
            return []
        ctx = EvalContext(batch.keys, [batch.columns])
        out_cols = {
            name: eval_expr(e, ctx) for name, e in self.node.exprs.items()
        }
        return [DiffBatch(batch.keys, batch.diffs, out_cols)]


class AlignedRowwiseExec(NodeExec):
    """Multi-input select: inputs share the universe of input 0; output row for
    key k combines the states of all inputs at k. Also used for
    non-deterministic expressions (cached replay on retraction)."""

    def __init__(self, node: RowwiseNode):
        super().__init__(node)
        self.states = [MultisetState(inp.column_names) for inp in node.inputs]
        self.emitted: dict[int, tuple] = {}

    def process(self, t, inputs):
        touched: dict[int, None] = {}
        for i, (inp_batches, state) in enumerate(zip(inputs, self.states)):
            for b in inp_batches:
                for k, d, vals in b.iter_rows():
                    touched[k] = None
                    state.apply_row(k, d, vals)
        if not touched:
            return []
        keys = list(touched.keys())
        primary = self.states[0]
        new_keys = [k for k in keys if primary.get(k) is not None]
        # build aligned context for recomputation
        out_rows: list[tuple[int, int, tuple]] = []
        if new_keys:
            karr = np.asarray(new_keys, dtype=np.uint64)
            col_sets = []
            for state in self.states:
                cols = {}
                for ci, cname in enumerate(state.column_names):
                    col = np.empty(len(new_keys), dtype=object)
                    for i, k in enumerate(new_keys):
                        row = state.get(k)
                        col[i] = row[ci] if row is not None else None
                    cols[cname] = col
                col_sets.append(cols)
            ctx = EvalContext(karr, col_sets)
            out_cols = [eval_expr(e, ctx) for e in self.node.exprs.values()]
            new_vals = {
                k: tuple(c[i] for c in out_cols) for i, k in enumerate(new_keys)
            }
        else:
            new_vals = {}
        from pathway_tpu_torch.engine.batch import _values_eq

        for k in keys:
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


# ---------------------------------------------------------------------------
# Filter


class FilterNode(Node):
    def __init__(self, input: Node, predicate: expr_mod.ColumnExpression):
        super().__init__([input], input.column_names)
        self.predicate = predicate

    def make_exec(self):
        return FilterExec(self)


class FilterExec(NodeExec):
    def process(self, t, inputs):
        batch = _concat_inputs(inputs[0], self.node.inputs[0].column_names)
        if not len(batch):
            return []
        ctx = EvalContext(batch.keys, [batch.columns])
        pred = eval_expr(self.node.predicate, ctx)
        if pred.dtype == object:
            from pathway_tpu_torch.internals.api import Error

            mask = np.empty(len(pred), dtype=bool)
            for i, p in enumerate(pred):
                if isinstance(p, Error):
                    mask[i] = False
                    record_error(
                        "Error value encountered in filter condition, "
                        "skipping the row",
                        str(self.node),
                    )
                else:
                    mask[i] = bool(p)
        else:
            mask = pred.astype(bool)
        out = batch.mask(mask)
        return [out] if len(out) else []


# ---------------------------------------------------------------------------
# Reindex (with_id / with_id_from)


class ReindexNode(Node):
    """Change row keys (reference: Graph::reindex / with_id_from)."""

    def __init__(self, input: Node, key_expr: expr_mod.ColumnExpression):
        super().__init__([input], input.column_names)
        self.key_expr = key_expr

    def make_exec(self):
        return ReindexExec(self)


class ReindexExec(NodeExec):
    def process(self, t, inputs):
        batch = _concat_inputs(inputs[0], self.node.inputs[0].column_names)
        if not len(batch):
            return []
        ctx = EvalContext(batch.keys, [batch.columns])
        new_keys = eval_expr(self.node.key_expr, ctx)
        karr = np.empty(len(batch), dtype=np.uint64)
        for i, k in enumerate(new_keys):
            karr[i] = int(k)
        return [DiffBatch(karr, batch.diffs, batch.columns)]


# ---------------------------------------------------------------------------
# Groupby / reduce


class GroupByNode(Node):
    """(reference: group_by_table, src/engine/dataflow.rs:3404)"""

    is_stateful = True

    def __init__(
        self,
        input: Node,
        grouping_cols: Sequence[str],
        reducer_specs: dict[str, ReducerSpec],
        instance_col: str | None = None,
        set_id: bool = False,
        sort_by: str | None = None,
    ):
        out_cols = list(grouping_cols) + list(reducer_specs.keys())
        super().__init__([input], out_cols)
        self.grouping_cols = list(grouping_cols)
        self.reducer_specs = reducer_specs
        self.instance_col = instance_col
        self.set_id = set_id
        self.sort_by = sort_by

    def key_columns(self) -> tuple[str, ...]:
        out = tuple(self.grouping_cols)
        if self.instance_col:
            out += (self.instance_col,)
        return out

    def _make_local_exec(self):
        from pathway_tpu_torch.parallel.mesh import get_engine_mesh

        em = get_engine_mesh()
        if em is not None:
            from pathway_tpu_torch.engine.sharded import ShardedGroupByExec

            return ShardedGroupByExec(self, em[0], em[1])
        return GroupByExec(self)

    def make_exec(self):
        return self._make_local_exec()


class _GroupState:
    __slots__ = ("gvals", "count", "accs", "emitted")

    def __init__(self, gvals: tuple, specs: Iterable[ReducerSpec]):
        self.gvals = gvals
        self.count = 0
        self.accs = [spec.make() for spec in specs]
        self.emitted: tuple | None = None


class GroupByExec(NodeExec):
    def __init__(self, node: GroupByNode):
        super().__init__(node)
        self.groups: dict[int, _GroupState] = {}
        in_cols = node.inputs[0].column_names
        self.g_idx = [in_cols.index(c) for c in node.grouping_cols]
        self.inst_idx = (
            in_cols.index(node.instance_col) if node.instance_col else None
        )
        self.sort_idx = (
            in_cols.index(node.sort_by) if node.sort_by else None
        )
        self.specs = list(node.reducer_specs.values())
        self.arg_idx = [
            tuple(in_cols.index(c) for c in spec.arg_cols) for spec in self.specs
        ]
        # persistence ledger: a side arrangement mirroring per-group state
        # as immutable pickled blobs, appended only for groups a tick
        # touches — so operator snapshots write O(churn) segment bytes
        # instead of re-pickling the whole groups dict. The COMPUTE path
        # is untouched (groupby stays on the dict accumulators); the
        # glue enables this only when persistence is attached.
        self.ledger = Arrangement(1)
        self._ledgered: set[int] = set()
        self._ledger_enabled = False
        self._compiled_semigroup: bool | None = None

    def enable_state_ledger(self) -> None:
        self._ledger_enabled = True

    def _ledger_append(self, touched) -> None:
        if not self._ledger_enabled or not touched:
            return
        try:
            import pickle

            from pathway_tpu_torch.persistence import _pickle

            jks: list[int] = []
            diffs: list[int] = []
            blobs: list = []
            for gk in touched:
                gs = self.groups.get(gk)
                if gk in self._ledgered:
                    jks.append(gk)
                    diffs.append(-1)
                    blobs.append(None)  # cancels by (jk, key); value unused
                    if gs is None:
                        self._ledgered.discard(gk)
                if gs is not None:
                    jks.append(gk)
                    diffs.append(1)
                    blobs.append(
                        _pickle.dumps(gs, protocol=pickle.HIGHEST_PROTOCOL)
                    )
                    self._ledgered.add(gk)
            if jks:
                jka = np.asarray(jks, dtype=np.uint64)
                col = np.empty(len(blobs), dtype=object)
                col[:] = blobs
                self.ledger.append(
                    jka, jka, np.asarray(diffs, dtype=np.int64), [col]
                )
        except Exception:
            # unpicklable accumulator (e.g. a closure-bound stateful
            # reducer): drop to the monolithic snapshot path permanently —
            # same degraded contract the whole-state pickler already has
            import logging

            logging.getLogger("pathway_tpu_torch").warning(
                "groupby state ledger disabled (unpicklable group state) "
                "for node %s; snapshots fall back to the monolithic path",
                self.node,
                exc_info=True,
            )
            self._ledger_enabled = False
            self.ledger = Arrangement(1)
            self._ledgered = set()

    def arranged_state(self):
        if not self._ledger_enabled:
            return None
        residual = {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("node", "groups", "ledger", "_ledgered")
            and not k.startswith("_m_")
        }
        return residual, {"ledger": self.ledger}

    def load_arranged_state(self, residual, arrangements) -> None:
        from pathway_tpu_torch.persistence import _pickle

        self.__dict__.update(residual)
        self.ledger = arrangements["ledger"]
        rows = self.ledger.entries()
        self.groups = {
            int(jk): _pickle.loads(blob)
            for jk, blob in zip(rows.jk.tolist(), rows.cols[0].tolist())
        }
        self._ledgered = set(self.groups)

    def load_state(self, state: dict) -> None:
        enabled = self._ledger_enabled  # set by the persistence glue
        super().load_state(state)
        if enabled and not self._ledger_enabled:
            # the snapshot was taken by a run without the ledger (legacy
            # or PATHWAY_PERSIST_MONOLITH): re-enable for THIS run
            self._ledger_enabled = True
        if self._ledger_enabled and self.groups and not self._ledgered:
            # seed the ledger with every restored group — otherwise the
            # next incremental snapshot would persist only groups touched
            # since the restore and silently drop the rest
            self._ledger_append(list(self.groups))

    def memory_ledger(self, deep: bool = False) -> dict[str, int]:
        """Groupby's residency is DOUBLED when the state ledger is on:
        the live ``groups`` dict (compute path) plus the pickled-blob
        mirror in ``self.ledger`` (persistence path).  Name both sides
        so Tick Scope's top-owners list can show the doubling the
        ROADMAP's columnar-memory refactor wants to collapse.  The dict
        side is estimated per group via sys.getsizeof on the state's
        __dict__ values (cheap; exact would re-pickle every group)."""
        import sys

        parts = {"ledger_blobs": self.ledger.resident_bytes()}
        dict_bytes = sys.getsizeof(self.groups)
        for gs in self.groups.values():
            dict_bytes += sys.getsizeof(gs)
            d = getattr(gs, "__dict__", None)
            if d:
                dict_bytes += sum(
                    sys.getsizeof(v)
                    + (v.nbytes if isinstance(v, np.ndarray) else 0)
                    for v in d.values()
                )
        parts["groups_dict"] = dict_bytes
        if deep and not self._ledger_enabled:
            base = super().memory_ledger(deep=True)
            if "monolith_pickle" in base:
                parts["monolith_pickle"] = base["monolith_pickle"]
        return parts

    def _group_key(self, vals: tuple) -> int:
        gvals = tuple(vals[i] for i in self.g_idx)
        if self.node.set_id and len(gvals) == 1 and isinstance(gvals[0], Pointer):
            # grouping by an id column: reuse it (reference groupby id behavior)
            base = gvals[0]
        else:
            base = ref_scalar(*gvals)
        if self.inst_idx is not None:
            base = base.with_shard_of(ref_scalar(vals[self.inst_idx]))
        return int(base)

    def _group_keys_batch(self, b) -> "Any":
        """Vectorized group keys for a whole batch via the native batch
        hasher (falls back to per-row ref_scalar)."""
        from pathway_tpu_torch.internals.api import ref_scalars_columns

        cols = list(b.columns.values())
        gcols = [cols[i] for i in self.g_idx]
        return ref_scalars_columns(gcols, len(b))

    _BULK_SEMIGROUP = ("count", "sum", "avg")
    _BULK_MULTISET = ("min", "max", "argmin", "argmax", "unique")

    # factorize (pandas in the reference, a numpy sort here) takes some
    # value pairs as equal that ref_scalar distinguishes (True==1==1.0;
    # None merges with NaN in float columns), so the
    # factorize fast path only fires when each grouping column's value
    # types make those collisions impossible; anything else falls back to
    # the exact per-row hash.
    _SAFE_TYPESETS = (
        {str},
        {str, type(None)},
        {int},
        {int, type(None)},
        {float},
        {bool},
        {type(None)},
    )

    def _bulk_codes(self, b):
        """Factorize the grouping columns: (codes [n] int64 dense 0..nu-1 in
        first-appearance order, nu, first_idx [nu]) or None when any column
        is factorize-unsafe. Replaces hashing every row: group keys are
        derived (via the exact hasher) for the nu distinct groups only —
        the O(n) work drops from ~1 us/row blake2b to a numpy sort."""
        cols = list(b.columns.values())
        parts: list[tuple[np.ndarray, int]] = []
        for j in self.g_idx:
            arr = cols[j]
            if arr.dtype == object:
                ts = set(map(type, arr.tolist()))
                if ts not in self._SAFE_TYPESETS:
                    return None
            elif arr.dtype.kind not in "biufUS" or arr.ndim != 1:
                return None
            try:
                codes_j, uniq_j = factorize(arr)
            except TypeError:
                return None
            parts.append((codes_j.astype(np.int64), max(1, len(uniq_j))))
        codes, nu = parts[0]
        if len(parts) > 1:
            # mixed-radix combination must fit int64 or wrapped codes could
            # collide and silently merge distinct groups — fall back to the
            # exact per-row hash beyond that
            radix = nu
            for _cj, nj in parts[1:]:
                radix *= nj
                if radix > (1 << 62):
                    return None
            for cj, nj in parts[1:]:
                codes = codes * nj + cj
            codes, uniq_c = factorize(codes)
            codes = codes.astype(np.int64)
            nu = len(uniq_c)
        n = len(codes)
        # smallest row index per group: reversed fancy assignment makes the
        # earliest row the last (winning) write for each code
        first_idx = np.empty(nu, dtype=np.int64)
        first_idx[codes[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
        return codes, nu, first_idx

    def _semigroup_partials(self, codes, diffs, arg_arrays, nu):
        """Per-group (diff counts, weighted sums) for the semigroup
        reducers.  Host scatter (np.add.at) by default; the device twin
        (``index_add_`` on the compiled device) runs when compiled ticks
        and compiled groupby are both on (PATHWAY_COMPILED_GROUPBY —
        engine/compile.py). A batch the device path refuses
        (NotCompilable) takes the host path; any other error propagates."""
        if self._compiled_semigroup is None:
            from pathway_tpu_torch.engine.compile import (
                compiled_groupby_enabled,
                compiled_tick_enabled,
            )

            self._compiled_semigroup = (
                compiled_tick_enabled() and compiled_groupby_enabled()
            )
        if self._compiled_semigroup:
            from pathway_tpu_torch.engine.compile import (
                NotCompilable,
                semigroup_partials,
            )

            sem_args = [
                a if (s.kind in ("sum", "avg")) else None
                for s, a in zip(self.specs, arg_arrays)
            ]
            try:
                return semigroup_partials(codes, diffs, sem_args, nu)
            except NotCompilable:
                pass  # unsupported dtype this batch: host path below
        dcounts = np.zeros(nu, dtype=np.int64)
        np.add.at(dcounts, codes, diffs)
        partials: list[np.ndarray | None] = []
        for spec, arr in zip(self.specs, arg_arrays):
            if arr is None:
                partials.append(None)
            else:
                part = np.zeros(
                    nu, dtype=arr.dtype if arr.dtype.kind == "i" else np.float64
                )
                np.add.at(part, codes, arr * diffs)
                partials.append(part)
        return dcounts, partials

    def _try_bulk(self, b, touched, t) -> bool:
        """Columnar groupby path (the microbatch analog of differential's
        batched reduce, reference src/engine/reduce.rs:40): factorize the
        grouping columns, hash only the distinct groups, accumulate
        semigroup reducers (count/sum/avg) with bincount-style partial sums
        and multiset reducers (min/max/argmin/argmax/unique/any) with one
        tight per-group bulk update — no per-row Python tuples."""
        if self.sort_idx is not None or len(b) < 256:
            return False
        if not self.g_idx:
            # global reduce (no grouping columns): _bulk_codes has no
            # column to factorize — use the per-row path
            return False
        for s in self.specs:
            if s.kind in self._BULK_SEMIGROUP:
                # count(col) must see its argument column (ERROR poison,
                # skip_nones) — only argument-less count is a pure semigroup
                if s.skip_nones or (s.kind == "count" and s.arg_cols):
                    return False
            elif s.kind not in self._BULK_MULTISET:
                return False
        cols = list(b.columns.values())
        diffs = b.diffs
        # pre-validate semigroup argument columns as dense numerics
        arg_arrays: list[np.ndarray | None] = []
        for spec, idx in zip(self.specs, self.arg_idx):
            if spec.kind not in self._BULK_SEMIGROUP or spec.kind == "count":
                arg_arrays.append(None)
                continue
            arr = cols[idx[0]]
            if arr.dtype == object:
                try:
                    arr = np.array(arr.tolist())
                except (TypeError, ValueError):
                    return False
            if arr.dtype.kind not in "if" or arr.ndim != 1:
                return False  # ndarray-valued sums use the per-row path
            arg_arrays.append(arr)
        fact = self._bulk_codes(b)
        if fact is None:
            return False
        codes, nu, first_idx = fact
        # exact group keys for the distinct groups only (same C hasher and
        # column layout as _group_keys_batch, so keys are byte-identical
        # across the bulk and per-row paths)
        from pathway_tpu_torch.internals.api import ref_scalars_columns

        gks_u = ref_scalars_columns(
            [cols[j][first_idx] for j in self.g_idx], nu
        )
        dcounts, partials = self._semigroup_partials(
            codes, diffs, arg_arrays, nu
        )
        # group the batch's row positions by code for multiset bulk updates
        any_multiset = any(s.kind in self._BULK_MULTISET for s in self.specs)
        if any_multiset:
            order = np.argsort(codes, kind="stable")
            bounds = np.searchsorted(codes[order], np.arange(nu + 1))
            diffs_l = diffs.tolist()
        for gi in range(nu):
            gk = int(gks_u[gi])
            gs = self.groups.get(gk)
            if gs is None:
                i0 = int(first_idx[gi])
                gs = _GroupState(
                    tuple(cols[j][i0] for j in self.g_idx), self.specs
                )
                self.groups[gk] = gs
            d = int(dcounts[gi])
            gs.count += d
            if any_multiset:
                g_rows = order[bounds[gi] : bounds[gi + 1]]
            for acc, spec, part, idx in zip(
                gs.accs, self.specs, partials, self.arg_idx
            ):
                if spec.kind == "count":
                    acc.c += d
                elif spec.kind == "sum":
                    p = part[gi]
                    acc.s = acc.s + (
                        int(p) if part.dtype.kind == "i" else float(p)
                    )
                    acc.n += d
                elif spec.kind == "avg":
                    acc.s += float(part[gi])
                    acc.c += d
                else:  # multiset bulk
                    try:
                        acc.update_bulk(
                            [cols[j][g_rows].tolist() for j in idx],
                            [diffs_l[r] for r in g_rows],
                        )
                    except Exception as exc:
                        # same degraded-but-running contract as the per-row
                        # path (e.g. unhashable ndarray args)
                        record_error(exc, str(self.node))
            touched[gk] = None
        return True

    def process(self, t, inputs):
        batches = inputs[0]
        touched: dict[int, None] = {}
        simple_keys = not self.node.set_id and self.inst_idx is None
        for b in batches:
            if simple_keys and len(b) and self._try_bulk(b, touched, t):
                continue
            gks = self._group_keys_batch(b) if simple_keys and len(b) else None
            cols = list(b.columns.values())
            keys_a, diffs_a = b.keys, b.diffs
            for i in range(len(b)):
                vals = tuple(c[i] for c in cols)
                k = int(keys_a[i])
                d = int(diffs_a[i])
                if any(vals[j] is ERROR for j in self.g_idx) or (
                    self.inst_idx is not None
                    and vals[self.inst_idx] is ERROR
                ):
                    record_error(
                        "Error value encountered in grouping columns, "
                        "skipping the row",
                        str(self.node),
                    )
                    continue
                gk = int(gks[i]) if gks is not None else self._group_key(vals)
                gs = self.groups.get(gk)
                if gs is None:
                    gs = _GroupState(
                        tuple(vals[j] for j in self.g_idx), self.specs
                    )
                    self.groups[gk] = gs
                gs.count += d
                # ordered reducers (tuple/ndarray/earliest) sort by this token
                order = (vals[self.sort_idx], k) if self.sort_idx is not None else k
                for acc, idx in zip(gs.accs, self.arg_idx):
                    args = tuple(vals[j] for j in idx)
                    if any(a is ERROR for a in args):
                        # skip_errors (the groupby default) drops ERROR
                        # args; otherwise they poison the aggregate while
                        # present and a retraction un-poisons (reference:
                        # Value::Error propagation, src/engine/error.rs).
                        # Stateful reducers are append-only and cannot
                        # retract: their poison is permanent (reference:
                        # stateful reducers do not recover from errors)
                        if not acc.spec.skip_errors:
                            acc.poisoned_count += (
                                abs(d) if acc.spec.kind == "stateful" else d
                            )
                        continue
                    try:
                        acc.update(args, d, order, t)
                    except Exception as exc:
                        # a failing STATEFUL combine poisons its aggregate
                        # permanently (append-only state cannot retract);
                        # other reducers just log, matching the bulk path
                        record_error(exc, str(self.node), user=True)
                        if acc.spec.kind == "stateful":
                            acc.poisoned_count += abs(d)
                touched[gk] = None
        out_rows: list[tuple[int, int, tuple]] = []
        from pathway_tpu_torch.engine.batch import _values_eq

        for gk, gs in [(gk, self.groups[gk]) for gk in touched]:
            if gs.count > 0:
                try:
                    new = gs.gvals + tuple(
                        ERROR if acc.poisoned_count > 0 else acc.value()
                        for acc in gs.accs
                    )
                except Exception as exc:
                    record_error(exc, str(self.node))
                    new = gs.gvals + tuple(ERROR for _ in gs.accs)
            else:
                new = None
            old = gs.emitted
            if old is not None and new is not None and _values_eq(old, new):
                continue
            if old is not None:
                out_rows.append((gk, -1, old))
            if new is not None:
                out_rows.append((gk, 1, new))
            gs.emitted = new
            if new is None and gs.count == 0:
                del self.groups[gk]
        self._ledger_append(touched)
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]


# ---------------------------------------------------------------------------
# Join


class JoinNode(Node):
    """Binary equijoin (reference: join_tables, src/engine/dataflow.rs:2740).

    Output columns: left columns as 'l.<name>', right as 'r.<name>', plus
    '_left_id'/'_right_id' pointers (None on the unmatched side)."""

    is_stateful = True

    def __init__(
        self,
        left: Node,
        right: Node,
        left_on: Sequence[str],
        right_on: Sequence[str],
        mode: str,  # inner | left | right | outer
        id_from: str | None = None,  # None | 'left' | 'right'
        exact_match: bool = False,
    ):
        cols = (
            ["l." + c for c in left.column_names]
            + ["r." + c for c in right.column_names]
            + ["_left_id", "_right_id"]
        )
        super().__init__([left, right], cols)
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.mode = mode
        self.id_from = id_from

    def key_columns(self) -> tuple[str, ...]:
        return tuple(self.left_on) + tuple(self.right_on)

    def _make_local_exec(self):
        from pathway_tpu_torch.parallel.mesh import get_engine_mesh

        em = get_engine_mesh()
        if em is not None:
            from pathway_tpu_torch.engine.sharded import ShardedJoinExec

            return ShardedJoinExec(self, em[0], em[1])
        return JoinExec(self)

    def make_exec(self):
        return self._make_local_exec()


class _SideState:
    """Rowwise dict state — jk -> {rowkey: [vals, count]}.  Only the
    oracle/fallback representation: the engine's steady-state join keeps
    its state in columnar Arrangements (engine/arrangement.py); this dict
    form survives for the differential-testing oracle
    (PATHWAY_JOIN_ROWWISE=1) and as the degraded-but-running escape hatch
    when the vectorized path hits something unexpected."""

    __slots__ = ("by_jk",)

    def __init__(self):
        self.by_jk: dict[int, dict[int, list]] = {}

    def apply(self, jk: int, k: int, d: int, vals: tuple):
        rows = self.by_jk.setdefault(jk, {})
        e = rows.get(k)
        if e is None:
            if d != 0:
                rows[k] = [vals, d]
        else:
            e[1] += d
            if d > 0:
                e[0] = vals
            if e[1] == 0:
                del rows[k]
        if not rows:
            del self.by_jk[jk]

    def rows(self, jk: int) -> dict[int, list]:
        return self.by_jk.get(jk, {})


def _none_col(n: int) -> np.ndarray:
    return np.full(n, None, dtype=object)


def _eq_scalar(x, y) -> bool:
    """Python `==` with the engine's value conventions (ndarray values
    compare elementwise, None equals only None, un-comparable objects
    fall back to identity) — the scalar twin of batch._values_eq."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return (
            isinstance(x, np.ndarray)
            and isinstance(y, np.ndarray)
            and x.shape == y.shape
            and bool(np.all(x == y))
        )
    try:
        return bool(x == y) or (x is None and y is None)
    except (ValueError, TypeError):
        return x is y


_eq_elem = np.frompyfunc(_eq_scalar, 2, 1)


def _column_eq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise value equality of two aligned columns (bool array);
    typed columns compare at C speed, object columns row by row with
    _eq_scalar semantics."""
    if a.dtype != object and b.dtype != object:
        try:
            return np.asarray(a == b, dtype=bool)
        except (TypeError, ValueError):
            pass
    return _eq_elem(a, b).astype(bool)


def _state_rowwise_env() -> bool:
    """The shared rowwise-oracle knob for every arrangement-backed
    stateful exec (dedupe / temporal joins / session assignment)."""
    return os.environ.get("PATHWAY_STATE_ROWWISE", "") not in ("", "0")


def _fallback_counter():
    """One counter for every arrangement-backed exec's degradation to the
    rowwise path — a single definition so the metric cannot fork."""
    from pathway_tpu_torch.observability import REGISTRY

    return REGISTRY.counter(
        "pathway_engine_state_fallbacks_total",
        "arrangement-backed stateful execs degraded to the rowwise "
        "path, by node class and reason",
        ("node", "reason"),
    )


# vectorized Pointer boxing for the _left_id/_right_id output columns
_box_pointers = np.frompyfunc(Pointer, 1, 1)


class _TickDelta:
    """One side's delta for one tick, pre-sorted and fingerprinted once —
    shared by the overlay, the changed-row seeds, and the arrangement
    append (which reuses the sort instead of redoing it)."""

    __slots__ = ("n", "jks", "keys", "diffs", "cols", "order",
                 "mix", "mix_sorted", "clean")

    def __init__(self, jks: np.ndarray, batch: DiffBatch):
        self.n = len(jks)
        self.jks = jks
        self.keys = batch.keys
        self.diffs = batch.diffs
        self.cols = list(batch.columns.values())
        if self.n:
            self.order = np.argsort(jks, kind="stable")
            self.mix = mix_keys(jks, batch.keys)
            self.mix_sorted = np.sort(self.mix)
            self.clean = bool((batch.diffs > 0).all()) and not bool(
                (self.mix_sorted[1:] == self.mix_sorted[:-1]).any()
            )
        else:
            self.order = np.empty(0, dtype=np.int64)
            self.mix = np.empty(0, dtype=np.uint64)
            self.mix_sorted = np.empty(0, dtype=np.uint64)
            self.clean = True


class JoinExec(NodeExec):
    """Incremental equijoin over columnar arranged state.

    Every tick applies the delta-join rule (ΔL ⋈ R ∪ L′ ⋈ ΔR): both
    sides' state lives in Arrangements (engine/arrangement.py), a tick
    probes them for the touched join keys only, overlays the delta, and
    builds the output diff with vectorized pair expansion
    (api.match_keys / searchsorted), diff-weighted retractions,
    per-jk match-count tracking for left/right/outer unmatched padding,
    and batch-hashed output keys — the general path, not a bulk special
    case.  The rowwise dict path survives solely as the differential-
    testing oracle (PATHWAY_JOIN_ROWWISE=1) and as a runtime escape hatch
    (counted in pathway_engine_join_fallbacks, labeled by reason)."""

    def __init__(self, node: JoinNode):
        super().__init__(node)
        lcols = node.inputs[0].column_names
        rcols = node.inputs[1].column_names
        self.l_on_idx = [lcols.index(c) for c in node.left_on]
        self.r_on_idx = [rcols.index(c) for c in node.right_on]
        self.n_l = len(lcols)
        self.n_r = len(rcols)
        self.arr_l = Arrangement(self.n_l)
        self.arr_r = Arrangement(self.n_r)
        # rowwise fallback state (materialized from the arrangements only
        # if the fallback ever fires)
        self.left: _SideState | None = None
        self.right: _SideState | None = None
        self._rowwise = False
        self._fallback_reason: str | None = None
        # Flight Recorder counters ("_m_" attrs are excluded from operator
        # snapshots — registry children hold locks)
        from pathway_tpu_torch.observability import REGISTRY

        self._m_hits = REGISTRY.counter(
            "pathway_engine_join_bulk_hits_total",
            "join ticks fully served by the columnar arrangement "
            "(delta-join) path",
        )
        self._m_fallbacks = REGISTRY.counter(
            "pathway_engine_join_fallbacks_total",
            "join ticks served by the rowwise fallback path, by reason",
            ("reason",),
        )
        if os.environ.get("PATHWAY_JOIN_ROWWISE", "") not in ("", "0"):
            self._to_rowwise("env")

    # --- operator snapshots ---------------------------------------------
    # state_dict (base) already skips registry handles; arranged_state
    # additionally routes the two side arrangements through the
    # incremental segment-snapshot path when the columnar path is live.

    def arranged_state(self):
        if self._rowwise or self.left is not None:
            return None  # dict fallback state: monolith snapshot
        residual = {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("node", "arr_l", "arr_r")
            and not k.startswith("_m_")
        }
        return residual, {"arr_l": self.arr_l, "arr_r": self.arr_r}

    def load_arranged_state(self, residual, arrangements) -> None:
        super().load_arranged_state(residual, arrangements)
        # the env oracle knob outlives the snapshot that was taken on the
        # columnar path — re-apply it so a restart honors the escape hatch
        if os.environ.get("PATHWAY_JOIN_ROWWISE", "") not in ("", "0"):
            self._to_rowwise("env")

    # --- fallback management --------------------------------------------

    def _to_rowwise(self, reason: str) -> None:
        """Materialize dict state from the arrangements and stay rowwise
        from here on (degraded-but-running contract)."""
        self._rowwise = True
        self._fallback_reason = reason
        if self.left is None:
            self.left = self._materialize_side(self.arr_l)
            self.right = self._materialize_side(self.arr_r)
            self.arr_l = Arrangement(self.n_l)
            self.arr_r = Arrangement(self.n_r)

    @staticmethod
    def _materialize_side(arr: Arrangement) -> _SideState:
        side = _SideState()
        rows = arr.entries()
        cols = [c.tolist() for c in rows.cols]
        vals: Any = zip(*cols) if cols else iter([()] * len(rows))
        by = side.by_jk
        for jk, k, c, v in zip(
            rows.jk.tolist(), rows.key.tolist(), rows.count.tolist(), vals
        ):
            by.setdefault(jk, {})[k] = [v, c]
        return side

    def _jk(self, vals: tuple, idx: list[int]) -> int:
        return int(ref_scalar(*(vals[i] for i in idx)))

    def _outputs_for_jk(self, jk: int) -> dict[int, tuple]:
        """Full current output rows for one join key."""
        node = self.node
        lrows = self.left.rows(jk)
        rrows = self.right.rows(jk)
        out: dict[int, tuple] = {}

        def emit(okey: int, vals: tuple):
            if okey in out:
                # duplicate output id (id_from with non-unique matches) —
                # reference raises a duplicate-id error; we poison + log
                record_error(
                    KeyError(
                        "duplicate row id in join output (id= used with "
                        "non-unique matches)"
                    ),
                    str(node),
                )
                return
            out[okey] = vals

        if lrows and rrows:
            for lk, (lvals, lc) in lrows.items():
                for rk, (rvals, rc) in rrows.items():
                    n = lc * rc
                    if n <= 0:
                        continue
                    if node.id_from == "left":
                        okey = lk
                    elif node.id_from == "right":
                        okey = rk
                    else:
                        okey = int(ref_scalar(Pointer(lk), Pointer(rk)))
                    emit(
                        okey,
                        lvals + rvals + (Pointer(lk), Pointer(rk)),
                    )
        if node.mode in ("left", "outer") and not rrows:
            for lk, (lvals, lc) in lrows.items():
                if lc <= 0:
                    continue
                okey = lk if node.id_from == "left" else int(
                    ref_scalar(Pointer(lk), None)
                )
                emit(okey, lvals + (None,) * self.n_r + (Pointer(lk), None))
        if node.mode in ("right", "outer") and not lrows:
            for rk, (rvals, rc) in rrows.items():
                if rc <= 0:
                    continue
                okey = rk if node.id_from == "right" else int(
                    ref_scalar(None, Pointer(rk))
                )
                emit(okey, (None,) * self.n_l + rvals + (None, Pointer(rk)))
        return out

    def _batch_jks(self, b, on_idx, side_tag: str = "") -> np.ndarray:
        """Join keys for a whole batch via the C batch hasher (byte-
        identical to per-row ref_scalar, same contract as the groupby
        path's _group_keys_batch). A row with None in ANY on-column gets a
        PRIVATE key (side + row id): null keys never match the other side
        but still pad as unmatched in outer modes (reference: chained
        outer joins do not equate padded Nones)."""
        from pathway_tpu_torch.internals.api import ref_scalar, ref_scalars_columns

        cols = list(b.columns.values())
        jks = ref_scalars_columns([cols[i] for i in on_idx], len(b))
        null_rows = None
        for i in on_idx:
            col = cols[i]
            if col.dtype == object:
                # per-element identity test: `col == None` would dispatch
                # elementwise __eq__, which ndarray values hijack into
                # arrays ("truth value ... is ambiguous")
                m = np.fromiter(
                    (v is None for v in col), dtype=bool, count=len(col)
                )
                if not m.any():
                    continue
                null_rows = m if null_rows is None else (null_rows | m)
        if null_rows is not None and null_rows.any():
            # batch the private-key derivation through the C columns
            # hasher: constant ("__pw_null", side) columns + the row-key
            # buffer, byte-identical to the old per-row ref_scalar loop
            idx = np.nonzero(null_rows)[0]
            n_null = len(idx)
            priv = ref_scalars_columns(
                [
                    np.full(n_null, "__pw_null", dtype=object),
                    np.full(n_null, side_tag, dtype=object),
                    ptr_column(b.keys[idx]),
                ],
                n_null,
            )
            jks = np.array(jks, copy=True)
            jks[idx] = priv
        return jks

    # --- columnar delta join --------------------------------------------

    @staticmethod
    def _overlay(
        before: Rows,
        d: "_TickDelta",
        age_base: int,
        before_seed: np.ndarray,
        before_mix: np.ndarray,
    ) -> Rows:
        """State after this tick's delta.  A clean delta (insert-only, no
        duplicate pairs) touching no existing entry merges in with two
        searchsorteds; anything else re-consolidates the before-rows with
        the delta entries appended at strictly later ages."""
        if not d.n:
            return before
        if d.clean and not before_seed.any():
            ages = (age_base + d.order).astype(np.int64)
            delta_rows = Rows(
                d.jks[d.order],
                d.keys[d.order],
                d.diffs[d.order],
                ages,
                [np.asarray(c)[d.order] for c in d.cols],
            )
            return merge_rows_sorted(before, delta_rows)
        ages = np.arange(age_base, age_base + d.n, dtype=np.int64)
        cols = [np.asarray(c) for c in d.cols]
        if not len(before):
            return consolidate_mixed(
                d.jks, d.keys, d.diffs, ages, cols, d.mix
            )
        return consolidate_mixed(
            np.concatenate([before.jk, d.jks]),
            np.concatenate([before.key, d.keys]),
            np.concatenate([before.count, d.diffs]),
            np.concatenate([before.age, ages]),
            [
                concat_columns([bc, dc])
                for bc, dc in zip(before.cols, cols)
            ],
            np.concatenate([before_mix, d.mix]),
        )

    @staticmethod
    def _jk_positions(
        rows: Rows, touched: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(per-row index into ``touched``, entries per touched jk) — the
        per-jk match-count tracking behind unmatched-padding deltas."""
        jpos = np.searchsorted(touched, rows.jk)
        return jpos, np.bincount(jpos, minlength=len(touched))

    def _drop_duplicate_ids(self, L, R, li, ri):
        """id_from output keys with non-unique matches: per jk, the first
        pair (in emission order) wins; later collisions poison + log —
        same contract as the rowwise path's per-jk emit() check."""
        node = self.node
        okeys = L.key[li] if node.id_from == "left" else R.key[ri]
        jk = L.jk[li]
        n = len(li)
        order = np.lexsort((np.arange(n), okeys, jk))
        jk_o = jk[order]
        ok_o = okeys[order]
        dup = np.zeros(n, dtype=bool)
        dup[1:] = (jk_o[1:] == jk_o[:-1]) & (ok_o[1:] == ok_o[:-1])
        if dup.any():
            for _ in range(int(dup.sum())):
                record_error(
                    KeyError(
                        "duplicate row id in join output (id= used with "
                        "non-unique matches)"
                    ),
                    str(self.node),
                )
            keep = np.ones(n, dtype=bool)
            keep[order[dup]] = False
            li, ri = li[keep], ri[keep]
        return li, ri

    def _state_output(
        self,
        L: Rows,
        R: Rows,
        seed_l,
        seed_r,
        flip_l,
        flip_r,
        jpos_l,
        jpos_r,
        l_cnt,
        r_cnt,
        full: bool,
    ) -> list[tuple]:
        """Output rows of ONE state (before or after) restricted to rows
        that can differ across the tick: pairs with at least one delta-
        touched endpoint (all pairs when ``full``) plus unmatched-padding
        rows whose row changed or whose other-side presence flipped.
        Returns chunks (kind, L, li, R, ri)."""
        node = self.node
        parts: list[tuple] = []
        if len(L) and len(R):
            if full:
                li, ri = match_keys(L.jk, R.jk, right_sorted=True)
            else:
                l_seed_idx = np.nonzero(seed_l)[0]
                a1, b1 = match_keys(
                    L.jk[l_seed_idx], R.jk, right_sorted=True
                )
                l_rest_idx = np.nonzero(~seed_l)[0]
                r_seed_idx = np.nonzero(seed_r)[0]
                a2, b2 = match_keys(
                    L.jk[l_rest_idx], R.jk[r_seed_idx], right_sorted=True
                )
                li = np.concatenate([l_seed_idx[a1], l_rest_idx[a2]])
                ri = np.concatenate([b1, r_seed_idx[b2]])
            if len(li):
                # a pair is in the output iff the product of its net
                # weights is positive (matching the dict path's lc*rc>0)
                m = (L.count[li] * R.count[ri]) > 0
                li, ri = li[m], ri[m]
            if len(li) and node.id_from is not None:
                li, ri = self._drop_duplicate_ids(L, R, li, ri)
            if len(li):
                parts.append(("pair", L, li, R, ri))
        if node.mode in ("left", "outer") and len(L):
            elig = (r_cnt[jpos_l] == 0) & (L.count > 0)
            if not full:
                elig &= seed_l | flip_r[jpos_l]
            idx = np.nonzero(elig)[0]
            if len(idx):
                parts.append(("lpad", L, idx, None, None))
        if node.mode in ("right", "outer") and len(R):
            elig = (l_cnt[jpos_r] == 0) & (R.count > 0)
            if not full:
                elig &= seed_r | flip_l[jpos_r]
            idx = np.nonzero(elig)[0]
            if len(idx):
                parts.append(("rpad", None, None, R, idx))
        return parts

    _PAIR_C1 = np.uint64(0x9E3779B97F4A7C15)
    _PAIR_C2 = np.uint64(0xC2B2AE3D27D4EB4F)
    _PAIR_C3 = np.uint64(0x165667B19E3779F9)
    _PAIR_C4 = np.uint64(0x27D4EB2F165667C5)

    @classmethod
    def _chunk_pair_ids(cls, kind: str, L, li, R, ri) -> np.ndarray:
        """64-bit identity of each output row's (pair, kind) — used to
        detect whether the before and after emit-sets can overlap at all
        (only then can retraction-vs-insert rows cancel and the value-hash
        consolidation pay for itself)."""
        if kind == "pair":
            return (L.key[li] * cls._PAIR_C1) ^ (R.key[ri] * cls._PAIR_C2)
        if kind == "lpad":
            return L.key[li] * cls._PAIR_C3
        return R.key[ri] * cls._PAIR_C4

    def _chunk_okeys(self, kind: str, L, li, R, ri) -> np.ndarray:
        """Output keys for one chunk, derived through the batch hasher
        (byte-identical to the rowwise path's per-row ref_scalar)."""
        node = self.node
        if kind == "pair":
            if node.id_from == "left":
                return L.key[li]
            if node.id_from == "right":
                return R.key[ri]
            return ref_scalars_columns(
                [ptr_column(L.key[li]), ptr_column(R.key[ri])], len(li)
            )
        if kind == "lpad":
            lk = L.key[li]
            if node.id_from == "left":
                return lk
            return ref_scalars_columns(
                [ptr_column(lk), _none_col(len(li))], len(li)
            )
        rk = R.key[ri]
        if node.id_from == "right":
            return rk
        return ref_scalars_columns(
            [_none_col(len(ri)), ptr_column(rk)], len(ri)
        )

    def _chunk_columns(self, kind: str, L, li, R, ri, n: int) -> list:
        """Output value columns for one chunk: gathered side columns,
        None-padding for the unmatched side, and the _left_id/_right_id
        pointer columns (boxed only when the liveness pass says a
        downstream expression reads them)."""
        live = getattr(self.node, "_live_cols", None)
        cols: list[np.ndarray] = []
        if L is not None:
            cols.extend(c[li] for c in L.cols)
        else:
            cols.extend(_none_col(n) for _ in range(self.n_l))
        if R is not None:
            cols.extend(c[ri] for c in R.cols)
        else:
            cols.extend(_none_col(n) for _ in range(self.n_r))
        if L is not None and (live is None or "_left_id" in live):
            cols.append(_box_pointers(L.key[li]))
        else:
            cols.append(_none_col(n))
        if R is not None and (live is None or "_right_id" in live):
            cols.append(_box_pointers(R.key[ri]))
        else:
            cols.append(_none_col(n))
        return cols

    def _bulk_first_tick(self, dl: "_TickDelta", dr: "_TickDelta") -> list[DiffBatch]:
        """Insert-only inner join into empty state (the batch-analytics
        bulk load): no before-set exists, so matches emit straight from
        the C probe over the raw delta key arrays."""
        out: list[DiffBatch] = []
        li, ri = match_keys(dl.jks, dr.jks)
        total = len(li)
        if total:
            okeys = ref_scalars_columns(
                [ptr_column(dl.keys[li]), ptr_column(dr.keys[ri])], total
            )
            live = getattr(self.node, "_live_cols", None)
            names = self.node.column_names
            columns = {}
            ncol = 0
            for c in dl.cols:
                columns[names[ncol]] = c[li]
                ncol += 1
            for c in dr.cols:
                columns[names[ncol]] = c[ri]
                ncol += 1
            columns[names[ncol]] = (
                _box_pointers(dl.keys[li])
                if live is None or "_left_id" in live
                else _none_col(total)
            )
            columns[names[ncol + 1]] = (
                _box_pointers(dr.keys[ri])
                if live is None or "_right_id" in live
                else _none_col(total)
            )
            out.append(
                DiffBatch(okeys, np.ones(total, dtype=np.int64), columns)
            )
        self._commit_deltas(dl, dr)
        return out

    def _commit_deltas(self, dl: "_TickDelta", dr: "_TickDelta") -> None:
        """Apply the tick's deltas to BOTH arrangements atomically: stage
        (all allocations, may raise) before committing either side, so
        the exception fallback can never see one side's delta applied
        without the other's."""
        staged_l = self.arr_l.stage(
            dl.jks, dl.keys, dl.diffs, dl.cols,
            jk_order=dl.order, mix_sorted=dl.mix_sorted, clean=dl.clean,
        )
        staged_r = self.arr_r.stage(
            dr.jks, dr.keys, dr.diffs, dr.cols,
            jk_order=dr.order, mix_sorted=dr.mix_sorted, clean=dr.clean,
        )
        self.arr_l.commit(staged_l)
        self.arr_r.commit(staged_r)

    def _delta_tick(self, lb, rb, jks_l, jks_r) -> list[DiffBatch]:
        """One tick on the columnar path: probe arranged state for the
        touched jks, overlay the delta, emit the (before ⊖ after) diff."""
        node = self.node
        dl = _TickDelta(jks_l, lb)
        dr = _TickDelta(jks_r, rb)
        inner_simple = node.mode == "inner" and node.id_from is None
        if (
            inner_simple
            and dl.clean
            and dr.clean
            and not len(self.arr_l)
            and not len(self.arr_r)
        ):
            # first-tick bulk load into empty state: no probe, no
            # overlay, no before-set — emit the matches directly (the
            # batch-analytics fast path, on the same machinery)
            return self._bulk_first_tick(dl, dr)
        # touched jks from the per-side sorted deltas (no extra sort)
        if dl.n and dr.n:
            tj = merge_sorted(jks_l[dl.order], jks_r[dr.order])
        elif dl.n:
            tj = jks_l[dl.order]
        else:
            tj = jks_r[dr.order]
        if len(tj) > 1:
            keep = np.empty(len(tj), dtype=bool)
            keep[0] = True
            keep[1:] = tj[1:] != tj[:-1]
            touched = tj[keep]
        else:
            touched = tj
        # inner joins with a one-sided, collision-free delta never read
        # the quiet side's existing rows: pairs with two unchanged
        # endpoints cancel, there is no padding, and the overlay adds
        # only brand-new entries — skip that probe entirely
        skip_l = (
            inner_simple
            and dr.n == 0
            and dl.clean
            and not self.arr_l.overlaps(dl.mix)
        )
        skip_r = (
            inner_simple
            and dl.n == 0
            and dr.clean
            and not self.arr_r.overlaps(dr.mix)
        )
        before_l = (
            Rows.empty(self.n_l) if skip_l else self.arr_l.probe(touched)
        )
        before_r = (
            Rows.empty(self.n_r) if skip_r else self.arr_r.probe(touched)
        )
        # changed-row seeds: state rows whose (jk, key) the delta touches
        mix_bl = mix_keys(before_l.jk, before_l.key)
        mix_br = mix_keys(before_r.jk, before_r.key)
        sl_b = sorted_member(mix_bl, dl.mix_sorted)
        sr_b = sorted_member(mix_br, dr.mix_sorted)
        after_l = self._overlay(
            before_l, dl, self.arr_l.next_age(), sl_b, mix_bl
        )
        after_r = self._overlay(
            before_r, dr, self.arr_r.next_age(), sr_b, mix_br
        )
        # empty before-state: every after-row came from this delta
        sl_a = (
            np.ones(len(after_l), dtype=bool)
            if not len(before_l)
            else sorted_member(
                mix_keys(after_l.jk, after_l.key), dl.mix_sorted
            )
        )
        sr_a = (
            np.ones(len(after_r), dtype=bool)
            if not len(before_r)
            else sorted_member(
                mix_keys(after_r.jk, after_r.key), dr.mix_sorted
            )
        )
        # id_from can alias output keys across state versions, so those
        # joins recompute the touched jks fully; otherwise only pairs with
        # a delta-touched endpoint can change — everything else cancels
        full = node.id_from is not None
        if node.mode == "inner" and not full:
            # no padding, no full recompute: the per-jk group counts and
            # presence flips are never read
            jp_lb = jp_rb = jp_la = jp_ra = None
            lc_b = rc_b = lc_a = rc_a = None
            flip_l = flip_r = None
        else:
            jp_lb, lc_b = self._jk_positions(before_l, touched)
            jp_rb, rc_b = self._jk_positions(before_r, touched)
            jp_la, lc_a = self._jk_positions(after_l, touched)
            jp_ra, rc_a = self._jk_positions(after_r, touched)
            flip_l = (lc_b > 0) != (lc_a > 0)
            flip_r = (rc_b > 0) != (rc_a > 0)
        bef_parts = self._state_output(
            before_l, before_r, sl_b, sr_b, flip_l, flip_r,
            jp_lb, jp_rb, lc_b, rc_b, full,
        )
        aft_parts = self._state_output(
            after_l, after_r, sl_a, sr_a, flip_l, flip_r,
            jp_la, jp_ra, lc_a, rc_a, full,
        )
        out: list[DiffBatch] = []
        if bef_parts or aft_parts:
            okeys_l: list[np.ndarray] = []
            diffs_l: list[np.ndarray] = []
            col_parts: list[list[np.ndarray]] = [
                [] for _ in node.column_names
            ]
            for sign, chunks in ((-1, bef_parts), (1, aft_parts)):
                for kind, L, li, R, ri in chunks:
                    n = len(li) if li is not None else len(ri)
                    okeys_l.append(self._chunk_okeys(kind, L, li, R, ri))
                    diffs_l.append(np.full(n, sign, dtype=np.int64))
                    for ci, col in enumerate(
                        self._chunk_columns(kind, L, li, R, ri, n)
                    ):
                        col_parts[ci].append(col)
            batch = DiffBatch(
                np.concatenate(okeys_l).astype(np.uint64, copy=False),
                np.concatenate(diffs_l),
                {
                    name: concat_columns(col_parts[ci])
                    for ci, name in enumerate(node.column_names)
                },
            )
            if bef_parts and aft_parts:
                # unchanged re-emissions cancel retraction-vs-insert in
                # consolidate() — but value-hashing every emitted row is
                # the dominant cost of retraction ticks, so only pay it
                # when the two emit-sets actually share a pair (disjoint
                # sets — pure insert+retract churn — cannot cancel)
                ids_b = np.sort(
                    np.concatenate(
                        [self._chunk_pair_ids(*c) for c in bef_parts]
                    )
                )
                ids_a = np.concatenate(
                    [self._chunk_pair_ids(*c) for c in aft_parts]
                )
                if sorted_member(ids_a, ids_b).any():
                    batch = batch.consolidate()
            if len(batch):
                out.append(batch)
        # commit the delta into arranged state only after the pure
        # computation succeeded (the exception fallback must see pre-tick
        # state); the append reuses this tick's sort + fingerprints
        self._commit_deltas(dl, dr)
        return out

    def _drop_error_keys(
        self, b: DiffBatch, on_idx: list[int]
    ) -> tuple[DiffBatch, DiffBatch | None]:
        """Rows whose join-key columns hold ERROR are skipped and logged
        (reference: join condition error handling, dataflow.rs join
        arrangement Error filtering)."""
        from pathway_tpu_torch.internals.api import Error

        cols = list(b.columns.values())
        bad = None
        for i in on_idx:
            col = cols[i]
            if col.dtype == object:
                m = np.fromiter(
                    (isinstance(v, Error) for v in col), bool, count=len(b)
                )
                bad = m if bad is None else (bad | m)
        if bad is None or not bad.any():
            return b, None
        for _ in range(int(bad.sum())):
            record_error(
                "Error value encountered in join condition, "
                "skipping the row",
                str(self.node),
            )
        return b.mask(~bad), b.mask(bad)

    def _outer_rows_for_dropped(
        self, dropped: DiffBatch, side: str
    ) -> list[tuple[int, int, tuple]]:
        """Error-keyed rows never match, but outer joins still surface
        them as unmatched rows of their side (reference: left join keeps
        the Error row with nulls on the other side)."""
        node = self.node
        out = []
        for k, d, vals in dropped.iter_rows():
            if side == "left":
                okey = k if node.id_from == "left" else int(
                    ref_scalar(Pointer(k), None)
                )
                out.append(
                    (okey, d, vals + (None,) * self.n_r + (Pointer(k), None))
                )
            else:
                okey = k if node.id_from == "right" else int(
                    ref_scalar(None, Pointer(k))
                )
                out.append(
                    (okey, d, (None,) * self.n_l + vals + (None, Pointer(k)))
                )
        return out

    def process(self, t, inputs):
        lb = _concat_inputs(inputs[0], self.node.inputs[0].column_names)
        rb = _concat_inputs(inputs[1], self.node.inputs[1].column_names)
        outer_rows: list[tuple[int, int, tuple]] = []
        if len(lb):
            lb, dropped = self._drop_error_keys(lb, self.l_on_idx)
            if dropped is not None and self.node.mode in ("left", "outer"):
                outer_rows.extend(self._outer_rows_for_dropped(dropped, "left"))
        if len(rb):
            rb, dropped = self._drop_error_keys(rb, self.r_on_idx)
            if dropped is not None and self.node.mode in ("right", "outer"):
                outer_rows.extend(
                    self._outer_rows_for_dropped(dropped, "right")
                )
        extra = (
            [DiffBatch.from_rows(outer_rows, self.node.column_names)]
            if outer_rows
            else []
        )
        if not len(lb) and not len(rb):
            return extra
        jks_l = (
            self._batch_jks(lb, self.l_on_idx, "l")
            if len(lb)
            else np.empty(0, np.uint64)
        )
        jks_r = (
            self._batch_jks(rb, self.r_on_idx, "r")
            if len(rb)
            else np.empty(0, np.uint64)
        )
        if not self._rowwise:
            try:
                out = self._delta_tick(lb, rb, jks_l, jks_r)
            except Exception as exc:
                # degraded-but-running: log, materialize dict state from
                # the (un-mutated) arrangements, finish the tick rowwise
                record_error(exc, str(self.node))
                self._to_rowwise("exception")
            else:
                self._m_hits.inc()
                return extra + out
        self._m_fallbacks.labels(self._fallback_reason or "unknown").inc()
        return extra + self._process_rowwise(lb, rb, jks_l, jks_r)

    def _process_rowwise(self, lb, rb, jks_l, jks_r) -> list[DiffBatch]:
        """Touched-jk dict recompute — the differential-testing oracle."""
        touched: dict[int, None] = {}
        jl = jks_l.tolist()
        l_updates = []
        for i, (k, d, vals) in enumerate(lb.iter_rows()):
            jk = jl[i]
            touched[jk] = None
            l_updates.append((jk, k, d, vals))
        jr = jks_r.tolist()
        r_updates = []
        for i, (k, d, vals) in enumerate(rb.iter_rows()):
            jk = jr[i]
            touched[jk] = None
            r_updates.append((jk, k, d, vals))
        before = {jk: self._outputs_for_jk(jk) for jk in touched}
        for jk, k, d, vals in l_updates:
            self.left.apply(jk, k, d, vals)
        for jk, k, d, vals in r_updates:
            self.right.apply(jk, k, d, vals)
        from pathway_tpu_torch.engine.batch import _values_eq

        out_rows: list[tuple[int, int, tuple]] = []
        for jk in touched:
            after = self._outputs_for_jk(jk)
            bef = before[jk]
            for okey, vals in bef.items():
                new = after.get(okey)
                if new is None or not _values_eq(vals, new):
                    out_rows.append((okey, -1, vals))
            for okey, vals in after.items():
                old = bef.get(okey)
                if old is None or not _values_eq(old, vals):
                    out_rows.append((okey, 1, vals))
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]


# ---------------------------------------------------------------------------
# Concat / union


class ConcatNode(Node):
    def __init__(self, inputs: Sequence[Node]):
        super().__init__(inputs, inputs[0].column_names)

    def make_exec(self):
        return ConcatExec(self)


class ConcatExec(NodeExec):
    def process(self, t, inputs):
        out = []
        for inp_node, batches in zip(self.node.inputs, inputs):
            for b in batches:
                if len(b):
                    out.append(b.select_columns(self.node.column_names))
        return out


# ---------------------------------------------------------------------------
# Update rows / cells (reference: Table.update_rows / update_cells)


class UpdateRowsNode(Node):
    is_stateful = True

    def __init__(self, left: Node, right: Node):
        super().__init__([left, right], left.column_names)

    def make_exec(self):
        return UpdateRowsExec(self)


class UpdateRowsExec(NodeExec):
    """Right rows override left rows on key collision; union of key sets."""

    def __init__(self, node):
        super().__init__(node)
        self.states = [
            MultisetState(node.inputs[0].column_names),
            MultisetState(node.inputs[1].column_names),
        ]
        self.emitted: dict[int, tuple] = {}
        rcols = node.inputs[1].column_names
        self.r_order = [rcols.index(c) for c in node.column_names]

    def process(self, t, inputs):
        touched: dict[int, None] = {}
        for state, batches in zip(self.states, inputs):
            for b in batches:
                for k, d, vals in b.iter_rows():
                    touched[k] = None
                    state.apply_row(k, d, vals)
        from pathway_tpu_torch.engine.batch import _values_eq

        out_rows = []
        for k in touched:
            rrow = self.states[1].get(k)
            if rrow is not None:
                new = tuple(rrow[i] for i in self.r_order)
            else:
                new = self.states[0].get(k)
            old = self.emitted.get(k)
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


# ---------------------------------------------------------------------------
# Flatten


class RemoveRetractionsNode(Node):
    """Append-only view: deletions are dropped (reference:
    Table._remove_retractions, internals/table.py)."""

    def __init__(self, input: Node):
        super().__init__([input], input.column_names)

    def make_exec(self):
        return RemoveRetractionsExec(self)


class RemoveRetractionsExec(NodeExec):
    def process(self, t, inputs):
        out = []
        for b in inputs[0]:
            m = b.diffs > 0
            if m.all():
                out.append(b)
            elif m.any():
                out.append(b.mask(m))
        return out


class FlattenNode(Node):
    """(reference: Graph::flatten_table; Table.flatten internals/table.py:2089)"""

    def __init__(
        self, input: Node, flatten_col: str, origin_id: str | None = None
    ):
        cols = list(input.column_names)
        if origin_id is not None:
            cols.append(origin_id)
        super().__init__([input], cols)
        self.flatten_col = flatten_col
        self.origin_id = origin_id

    def make_exec(self):
        return FlattenExec(self)


class FlattenExec(NodeExec):
    """Columnar flatten: expand the container column per row, then build
    all output columns by np.repeat/fancy-indexing and derive the output
    keys with ONE batch hash over (parent pointer, item index) — the
    per-output-row blake2b of the rowwise version dominated flatten-heavy
    pipelines (e.g. the fuzzy join's token-edge expansion)."""

    def process(self, t, inputs):
        node = self.node
        in_cols = node.inputs[0].column_names
        fidx = in_cols.index(node.flatten_col)
        out = []
        from pathway_tpu_torch.engine.batch import _obj_column
        from pathway_tpu_torch.internals.api import ref_scalars_columns

        for b in inputs[0]:
            n = len(b)
            if not n:
                continue
            cols = list(b.columns.values())
            items_all: list = []
            counts = np.zeros(n, dtype=np.int64)
            for i, container in enumerate(cols[fidx].tolist()):
                if container is None:
                    continue
                if isinstance(container, Json):
                    # only JSON arrays flatten (reference test_json.py
                    # test_json_flatten_wrong_values)
                    if not isinstance(container.value, list):
                        record_error(
                            ValueError(
                                f"Pathway can't flatten this Json: {container}"
                            ),
                            str(node),
                        )
                        continue
                    items = [Json(x) for x in container.value]
                else:
                    try:
                        items = list(container)
                    except TypeError:
                        record_error(
                            TypeError(f"cannot flatten {container!r}"),
                            str(node),
                        )
                        continue
                counts[i] = len(items)
                items_all.extend(items)
            total = int(counts.sum())
            if not total:
                continue
            rep = np.repeat(np.arange(n), counts)
            idx_within = np.arange(total) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            from pathway_tpu_torch.internals.api import ptr_column

            nkeys = ref_scalars_columns(
                [ptr_column(b.keys[rep]), idx_within], total
            )
            new_cols = {}
            for ci, name in enumerate(in_cols):
                if ci == fidx:
                    new_cols[name] = _obj_column(items_all)
                else:
                    new_cols[name] = cols[ci][rep]
            if node.origin_id is not None:
                new_cols[node.origin_id] = _obj_column(
                    list(map(Pointer, b.keys[rep].tolist()))
                )
            out.append(DiffBatch(nkeys, b.diffs[rep], new_cols))
        return out


# ---------------------------------------------------------------------------
# Sort (prev/next pointers)


class SortNode(Node):
    """Incremental prev/next pointers over a sorted order
    (reference: src/engine/dataflow/operators/prev_next.rs)."""

    is_stateful = True

    def __init__(self, input: Node, key_col: str, instance_col: str | None):
        super().__init__([input], ["prev", "next"])
        self.key_col = key_col
        self.instance_col = instance_col

    def key_columns(self) -> tuple[str, ...]:
        out = (self.key_col,)
        if self.instance_col:
            out += (self.instance_col,)
        return out

    def _make_local_exec(self):
        from pathway_tpu_torch.parallel.mesh import get_engine_mesh

        em = get_engine_mesh()
        # an instance-less sort is one global order: sharding would route
        # every row to shard 0 and pay the exchange for nothing
        if em is not None and self.instance_col is not None:
            from pathway_tpu_torch.engine.sharded import ShardedSortExec

            return ShardedSortExec(self, em[0], em[1])
        return SortExec(self)

    def make_exec(self):
        return self._make_local_exec()


class SortExec(NodeExec):
    """Incremental prev/next maintenance: a sorted (sortval, rowkey) list
    per instance, updated by bisect so a tick touching c rows costs
    O(c log n) comparisons and emits only the changed pointer pairs — the
    microbatch analog of the reference's pointer-maintaining prev_next
    operator (src/engine/dataflow/operators/prev_next.rs:1-891). Ticks that
    change a large fraction of an instance fall back to one full sort."""

    def __init__(self, node: SortNode):
        super().__init__(node)
        in_cols = node.inputs[0].column_names
        self.k_idx = in_cols.index(node.key_col)
        self.i_idx = (
            in_cols.index(node.instance_col) if node.instance_col else None
        )
        # instance -> {rowkey: sortval}
        self.instances: dict[Any, dict[int, Any]] = {}
        # instance -> maintained sorted list[(sortval, rowkey)]
        self.orders: dict[Any, list] = {}
        # instance -> {rowkey: (prev, next)} previously emitted
        self.emitted: dict[Any, dict[int, tuple]] = {}
        # instances that ever saw a NaN sort key: bisect cannot locate NaN
        # tuples, so those instances stay on the full-rebuild path
        self.nan_insts: set = set()

    def _emit_diff(self, out_rows, emitted, k, new):
        old = emitted.get(k)
        if old == new:
            return
        if old is not None:
            out_rows.append((k, -1, old))
        if new is not None:
            out_rows.append((k, 1, new))
            emitted[k] = new
        else:
            emitted.pop(k, None)

    def _rebuild(self, out_rows, rows, order, emitted):
        order[:] = sorted((v, k) for k, v in rows.items())
        new_vals: dict[int, tuple] = {}
        n = len(order)
        for i, (_, k) in enumerate(order):
            prev_k = Pointer(order[i - 1][1]) if i > 0 else None
            next_k = Pointer(order[i + 1][1]) if i < n - 1 else None
            new_vals[k] = (prev_k, next_k)
        for k in set(emitted) | set(new_vals):
            self._emit_diff(out_rows, emitted, k, new_vals.get(k))

    def _drop_entry(self, order, affected, v, k, bisect_left) -> None:
        idx = bisect_left(order, (v, k))
        if idx < len(order) and order[idx] == (v, k):
            order.pop(idx)
            # the two rows that now become neighbors
            if idx > 0:
                affected.add(order[idx - 1][1])
            if idx < len(order):
                affected.add(order[idx][1])

    def _incremental(self, out_rows, rows, order, emitted, chs, bisect_left):
        affected: set[int] = set()
        deleted: set[int] = set()
        for k, d, v in chs:
            if d > 0:
                if k in rows:
                    # upsert / repeated insert: drop the stale order entry
                    # first or it would linger as a ghost (the rows dict is
                    # last-write-wins, matching the full-rebuild path)
                    self._drop_entry(order, affected, rows[k], k, bisect_left)
                rows[k] = v
                idx = bisect_left(order, (v, k))
                # the two rows that will now point at k
                if idx > 0:
                    affected.add(order[idx - 1][1])
                if idx < len(order):
                    affected.add(order[idx][1])
                order.insert(idx, (v, k))
                affected.add(k)
                deleted.discard(k)
            else:
                if k not in rows:
                    continue
                v_old = rows.pop(k)
                self._drop_entry(order, affected, v_old, k, bisect_left)
                deleted.add(k)
                affected.discard(k)
        for k in deleted:
            self._emit_diff(out_rows, emitted, k, None)
        n = len(order)
        for k in affected:
            v = rows.get(k)
            if v is None and k not in rows:
                continue  # re-deleted within this tick
            idx = bisect_left(order, (v, k))
            prev_k = Pointer(order[idx - 1][1]) if idx > 0 else None
            next_k = Pointer(order[idx + 1][1]) if idx < n - 1 else None
            self._emit_diff(out_rows, emitted, k, (prev_k, next_k))

    def process(self, t, inputs):
        from bisect import bisect_left

        changes: dict[Any, list] = {}
        for b in inputs[0]:
            for k, d, vals in b.iter_rows():
                inst = vals[self.i_idx] if self.i_idx is not None else None
                changes.setdefault(inst, []).append((k, d, vals[self.k_idx]))
        out_rows: list[tuple[int, int, tuple]] = []
        for inst, chs in changes.items():
            rows = self.instances.setdefault(inst, {})
            order = self.orders.setdefault(inst, [])
            emitted = self.emitted.setdefault(inst, {})
            if inst not in self.nan_insts and any(
                isinstance(v, float) and v != v for _k, _d, v in chs
            ):
                self.nan_insts.add(inst)
            if inst in self.nan_insts or len(chs) * 8 >= len(order) + 1:
                for k, d, v in chs:
                    if d > 0:
                        rows[k] = v
                    else:
                        rows.pop(k, None)
                self._rebuild(out_rows, rows, order, emitted)
            else:
                self._incremental(
                    out_rows, rows, order, emitted, chs, bisect_left
                )
            if not rows:
                self.instances.pop(inst, None)
                self.orders.pop(inst, None)
                self.emitted.pop(inst, None)
                self.nan_insts.discard(inst)
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]


# ---------------------------------------------------------------------------
# Gradual broadcast


class GradualBroadcastNode(Node):
    """Roll out a changing scalar (model version, threshold, ...) to all
    rows without mass retraction (reference:
    src/engine/dataflow/operators/gradual_broadcast.rs:1-490, API at
    python/pathway/internals/table.py:631). The threshold table supplies a
    (lower, value, upper) triplet; each data row gets apx_value = upper if
    its key hash falls below the (value-lower)/(upper-lower) fraction of
    the key space, else lower — so as `value` sweeps lower->upper, rows
    flip individually instead of all at once."""

    is_stateful = True

    def __init__(self, data: Node, thr: Node):
        super().__init__([data, thr], ["apx_value"])

    def make_exec(self):
        return GradualBroadcastExec(self)


_KEY_SPACE = float(1 << 64)


class GradualBroadcastExec(NodeExec):
    def __init__(self, node: GradualBroadcastNode):
        super().__init__(node)
        self.counts: dict[int, int] = {}  # data rowkey -> multiplicity
        self.keys_sorted: list[int] = []
        self.thr_state: dict[int, list] = {}  # thr rowkey -> [vals, count]
        self.triplet: tuple | None = None
        self.emitted: dict[int, Any] = {}  # data rowkey -> apx value

    @staticmethod
    def _threshold(triplet) -> int:
        lower, value, upper = triplet
        if upper == lower:
            frac = 1.0
        else:
            frac = (value - lower) / (upper - lower)
        frac = min(max(frac, 0.0), 1.0)
        return int(frac * _KEY_SPACE)

    @staticmethod
    def _apx(k: int, triplet, thr: int):
        return triplet[2] if k < thr else triplet[0]

    def process(self, t, inputs):
        from bisect import bisect_left, insort

        out_rows: list[tuple[int, int, tuple]] = []
        # 1) data-side changes evaluated under the current triplet
        #    (reference: input1 batches apply with the pre-update triplet)
        thr_now = self._threshold(self.triplet) if self.triplet else None
        for b in inputs[0]:
            for k, d in zip(b.keys.tolist(), b.diffs.tolist()):
                c = self.counts.get(k, 0)
                nc = c + d
                if c <= 0 < nc:
                    insort(self.keys_sorted, k)
                    if self.triplet is not None:
                        v = self._apx(k, self.triplet, thr_now)
                        out_rows.append((k, 1, (v,)))
                        self.emitted[k] = v
                elif nc <= 0 < c:
                    idx = bisect_left(self.keys_sorted, k)
                    if idx < len(self.keys_sorted) and self.keys_sorted[idx] == k:
                        self.keys_sorted.pop(idx)
                    old = self.emitted.pop(k, None)
                    if old is not None:
                        out_rows.append((k, -1, (old,)))
                if nc == 0:
                    self.counts.pop(k, None)
                else:
                    self.counts[k] = nc
        # 2) threshold-side changes
        last_inserted = None
        thr_changed = False
        for b in inputs[1]:
            for k, d, vals in b.iter_rows():
                thr_changed = True
                e = self.thr_state.get(k)
                if e is None:
                    if d != 0:
                        self.thr_state[k] = [vals, d]
                else:
                    e[1] += d
                    if d > 0:
                        e[0] = vals
                    if e[1] == 0:
                        del self.thr_state[k]
                if d > 0:
                    last_inserted = vals
        if thr_changed:
            if last_inserted is not None:
                new_triplet = tuple(last_inserted[:3])
            elif self.thr_state:
                new_triplet = tuple(next(iter(self.thr_state.values()))[0][:3])
            else:
                new_triplet = self.triplet  # emptied: keep last (ref. keeps)
            if new_triplet is not None and new_triplet != self.triplet:
                old_triplet = self.triplet
                self.triplet = new_triplet
                thr_new = self._threshold(new_triplet)
                if old_triplet is None:
                    for k in self.keys_sorted:
                        v = self._apx(k, new_triplet, thr_new)
                        out_rows.append((k, 1, (v,)))
                        self.emitted[k] = v
                else:
                    # both apx functions are two-valued step functions with
                    # one breakpoint, so they differ on at most 3 contiguous
                    # key ranges — emit diffs only there (the "gradual"
                    # property: a value sweep touches only the swept range)
                    thr_old = self._threshold(old_triplet)
                    t1, t2 = min(thr_old, thr_new), max(thr_old, thr_new)
                    ks = self.keys_sorted
                    for seg_lo, seg_hi in ((0, t1), (t1, t2), (t2, 1 << 64)):
                        if seg_lo >= seg_hi:
                            continue
                        old_v = self._apx(seg_lo, old_triplet, thr_old)
                        new_v = self._apx(seg_lo, new_triplet, thr_new)
                        if old_v == new_v:
                            continue
                        lo_i = bisect_left(ks, seg_lo)
                        hi_i = bisect_left(ks, seg_hi)
                        for k in ks[lo_i:hi_i]:
                            out_rows.append((k, -1, (self.emitted[k],)))
                            out_rows.append((k, 1, (new_v,)))
                            self.emitted[k] = new_v
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]


# ---------------------------------------------------------------------------
# Deduplicate


class DeduplicateNode(Node):
    """(reference: deduplicate, src/engine/dataflow.rs:3514)"""

    is_stateful = True

    def __init__(
        self,
        input: Node,
        instance_cols: Sequence[str],
        acceptor: Callable[[Any, Any], bool] | None,
        value_col: str | None,
    ):
        super().__init__([input], input.column_names)
        self.instance_cols = list(instance_cols)
        self.acceptor = acceptor
        self.value_col = value_col

    def key_columns(self) -> tuple[str, ...]:
        return tuple(self.instance_cols)

    def make_exec(self):
        return DeduplicateExec(self)


class DeduplicateExec(NodeExec):
    """Deduplicate over columnar arranged state.

    The accepted row per instance lives in an Arrangement (one net entry
    per instance hash, engine/arrangement.py): a tick derives instance
    keys with the C batch hasher, probes the touched instances with one
    searchsorted pass, decides acceptance vectorized (acceptor-None
    collapses to a compare-against-predecessor scan; a user acceptor
    folds per touched group), emits the NET per-instance change, and
    appends the retract/insert delta back into the arrangement — so
    bulk loads are columnar and snapshots are incremental segments.
    The per-row dict path survives as the differential-testing oracle
    (PATHWAY_STATE_ROWWISE=1) and as the exception escape hatch."""

    # persisted under its own identity even when inputs re-feed every run
    # (reference: deduplicate keeps state via its persistent id,
    # operators/stateful_reduce.rs non-retractable accumulators)
    persist_standalone = True

    def __init__(self, node: DeduplicateNode):
        super().__init__(node)
        in_cols = node.inputs[0].column_names
        self.inst_idx = [in_cols.index(c) for c in node.instance_cols]
        self.val_idx = (
            in_cols.index(node.value_col) if node.value_col else None
        )
        self.n_cols = len(in_cols)
        # instance key -> (accepted value, emitted row vals, out key) —
        # the rowwise oracle/fallback representation only
        self.state: dict[int, tuple] = {}
        self.arr = Arrangement(self.n_cols)
        self._rowwise = False
        self._fallback_reason: str | None = None
        self._m_fallbacks = _fallback_counter()
        if _state_rowwise_env():
            self._to_rowwise("env")

    # --- fallback / oracle management -----------------------------------

    def _to_rowwise(self, reason: str) -> None:
        """Materialize dict state from the arrangement and stay rowwise
        from here on (degraded-but-running contract)."""
        self._rowwise = True
        self._fallback_reason = reason
        self._m_fallbacks.labels(type(self).__name__, reason).inc()
        rows = self.arr.entries()
        if len(rows):
            cols = [c.tolist() for c in rows.cols]
            vals_it: Any = zip(*cols) if cols else iter([()] * len(rows))
            for jk, vals in zip(rows.jk.tolist(), vals_it):
                vals = tuple(vals)
                value = (
                    vals[self.val_idx] if self.val_idx is not None else vals
                )
                self.state[int(jk)] = (value, vals, int(jk))
        self.arr = Arrangement(self.n_cols)

    # --- operator snapshots ---------------------------------------------

    def arranged_state(self):
        if self._rowwise:
            return None
        residual = {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("node", "arr", "state", "_restore_emit")
            and not k.startswith("_m_")
        }
        return residual, {"arr": self.arr}

    def load_arranged_state(self, residual, arrangements) -> None:
        self.__dict__.update(residual)
        self.arr = arrangements["arr"]
        self.state = {}
        if _state_rowwise_env():
            self._rowwise = False  # residual was snapshotted columnar
            self._to_rowwise("env")
        self._set_restore_emit()

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        if not self._rowwise and "arr" not in state and self.state:
            # legacy monolith snapshot (pre-arrangement dict state): seed
            # the arrangement so the columnar path continues with the
            # restored accepted rows instead of re-accepting duplicates
            entries = list(self.state.values())
            jks = np.asarray(
                [ik for (_v, _vals, ik) in entries], dtype=np.uint64
            )
            cols = []
            for ci in range(self.n_cols):
                col = np.empty(len(entries), dtype=object)
                col[:] = [vals[ci] for (_v, vals, _ik) in entries]
                cols.append(col)
            self.arr = Arrangement(self.n_cols)
            self.arr.append(
                jks, jks, np.ones(len(entries), dtype=np.int64), cols
            )
            self.state = {}
        self._set_restore_emit()

    def _set_restore_emit(self) -> None:
        # restored accumulator output re-emits on the first tick of the new
        # run so downstream consumers rebuild (reference: a restored
        # arrangement feeds its consolidated contents to consumers at the
        # initial time). The persistence glue clears this when the graph
        # restored downstream state too (inputs do not re-feed).
        if self.state:
            self._restore_emit = [
                (ik, 1, vals) for (_value, vals, ik) in self.state.values()
            ]
        else:
            rows = self.arr.entries()
            cols = [c.tolist() for c in rows.cols]
            vals_it: Any = zip(*cols) if cols else iter([()] * len(rows))
            self._restore_emit = [
                (int(jk), 1, tuple(vals))
                for jk, vals in zip(rows.jk.tolist(), vals_it)
            ]

    def state_dict(self) -> dict | None:
        state = super().state_dict()
        if state is not None:
            state.pop("_restore_emit", None)
        return state

    # --- columnar path ---------------------------------------------------

    def _accept_vectorized(self, cols, order, starts, prev, has_prev, prev_pos):
        """Acceptor-None acceptance: a row is accepted iff its value
        differs from its predecessor in the instance's sequence (the
        stored value for group firsts; no stored value accepts
        unconditionally).  Returns (selected original row per group,
        changed mask) — the last accepted row is the net new state."""
        n = len(order)
        cmp_idx = (
            [self.val_idx] if self.val_idx is not None else range(self.n_cols)
        )
        eq = np.ones(n, dtype=bool)
        for ci in cmp_idx:
            sc = cols[ci][order]
            e = np.empty(n, dtype=bool)
            e[0] = False
            if n > 1:
                e[1:] = _column_eq(sc[1:], sc[:-1])
            eq &= e
        first_eq = np.zeros(len(starts), dtype=bool)
        if len(prev) and has_prev.any():
            pi = prev_pos[has_prev]
            fe = np.ones(int(has_prev.sum()), dtype=bool)
            first_rows = order[starts[has_prev]]
            for ci in cmp_idx:
                fe &= _column_eq(cols[ci][first_rows], prev.cols[ci][pi])
            first_eq[has_prev] = fe
        eq[starts] = first_eq
        accept = ~eq
        posm = np.where(accept, np.arange(n, dtype=np.int64), np.int64(-1))
        last = np.maximum.reduceat(posm, starts)
        changed = last >= 0
        sel = order[np.where(changed, last, 0)]
        return sel, changed

    def _accept_acceptor(self, cols, order, starts, prev, has_prev, prev_pos):
        """User-acceptor acceptance: fold each touched instance's rows in
        arrival order.  An acceptor exception poisons ONLY that row —
        recorded, nothing emitted, stored state untouched — and the fold
        continues with the unchanged accepted value."""
        node = self.node
        n = len(order)
        g = len(starts)
        sel = np.zeros(g, dtype=np.int64)
        changed = np.zeros(g, dtype=bool)
        py_cols = [c.tolist() for c in cols]
        prev_py = [c.tolist() for c in prev.cols]
        val_idx = self.val_idx
        ends = np.empty(g, dtype=np.int64)
        ends[:-1] = starts[1:]
        ends[-1] = n
        for gi in range(g):
            have = bool(has_prev[gi])
            cur_value = None
            if have:
                pv = tuple(pc[prev_pos[gi]] for pc in prev_py)
                cur_value = pv[val_idx] if val_idx is not None else pv
            sel_i = -1
            for p in range(int(starts[gi]), int(ends[gi])):
                ri = int(order[p])
                vals = tuple(pc[ri] for pc in py_cols)
                value = vals[val_idx] if val_idx is not None else vals
                if have:
                    # the first value per instance is accepted without
                    # consulting the acceptor (reference: stateful_reduce
                    # passes None state only to the combine_fn, and the
                    # deduplicate acceptor never sees old_value=None)
                    try:
                        if not bool(node.acceptor(value, cur_value)):
                            continue
                    except Exception as exc:
                        record_error(exc, str(node))
                        continue
                have = True
                cur_value = value
                sel_i = ri
            if sel_i >= 0:
                changed[gi] = True
                sel[gi] = sel_i
        return sel, changed

    def _process_arranged(self, b: DiffBatch) -> list[DiffBatch]:
        if bool((b.diffs < 0).any()):
            b = b.mask(b.diffs >= 0)  # append-only semantics
            if not len(b):
                return []
        n = len(b)
        cols = list(b.columns.values())
        iks = ref_scalars_columns([cols[i] for i in self.inst_idx], n)
        order = np.argsort(iks, kind="stable")
        iks_s = iks[order]
        boundary = np.empty(n, dtype=bool)
        boundary[0] = True
        boundary[1:] = iks_s[1:] != iks_s[:-1]
        starts = np.nonzero(boundary)[0]
        touched = iks_s[starts]  # sorted unique instance keys
        g = len(starts)
        prev = self.arr.probe(touched)  # one net entry per stored instance
        has_prev = np.zeros(g, dtype=bool)
        prev_pos = np.zeros(g, dtype=np.int64)
        if len(prev):
            pos = np.searchsorted(touched, prev.jk)
            has_prev[pos] = True
            prev_pos[pos] = np.arange(len(prev), dtype=np.int64)
        if self.node.acceptor is None:
            sel, changed = self._accept_vectorized(
                cols, order, starts, prev, has_prev, prev_pos
            )
        else:
            sel, changed = self._accept_acceptor(
                cols, order, starts, prev, has_prev, prev_pos
            )
        if not changed.any():
            return []
        ch = np.nonzero(changed)[0]
        sel_rows = sel[changed]
        out_ik = touched[ch]
        ret_mask = has_prev[ch]
        nr = int(ret_mask.sum())
        ppos = prev_pos[ch][ret_mask]
        new_cols = [c[sel_rows] for c in cols]
        keys_parts = [out_ik[ret_mask], out_ik] if nr else [out_ik]
        diffs_parts = (
            [np.full(nr, -1, dtype=np.int64), np.ones(len(ch), np.int64)]
            if nr
            else [np.ones(len(ch), np.int64)]
        )
        col_parts = [
            ([prev.cols[i][ppos], new_cols[i]] if nr else [new_cols[i]])
            for i in range(self.n_cols)
        ]
        out = DiffBatch(
            np.concatenate(keys_parts),
            np.concatenate(diffs_parts),
            {
                name: concat_columns(col_parts[i])
                for i, name in enumerate(self.node.column_names)
            },
        )
        # commit the delta into arranged state LAST (pure computation
        # above may raise; the fallback must see pre-tick state): retract
        # entries first so consolidation picks the insert as the value
        d_jks = np.concatenate(keys_parts)
        self.arr.append(
            d_jks,
            d_jks,  # rowkey == jk: exactly one live entry per instance
            np.concatenate(diffs_parts),
            [concat_columns(col_parts[i]) for i in range(self.n_cols)],
        )
        return [out]

    # --- rowwise oracle / fallback ---------------------------------------

    def _process_rowwise(self, inputs) -> list[DiffBatch]:
        out_rows = []
        for b in inputs[0]:
            for k, d, vals in b.iter_rows():
                if d < 0:
                    continue  # append-only semantics
                ivals = tuple(vals[i] for i in self.inst_idx)
                ik = int(ref_scalar(*ivals))
                value = vals[self.val_idx] if self.val_idx is not None else vals
                prev = self.state.get(ik)
                prev_value = prev[0] if prev else None
                accept = True
                if self.node.acceptor is not None and prev is not None:
                    try:
                        accept = bool(self.node.acceptor(value, prev_value))
                    except Exception as exc:
                        record_error(exc, str(self.node))
                        accept = False
                elif prev is not None and prev_value == value:
                    accept = False
                if not accept:
                    continue
                if prev is not None:
                    out_rows.append((prev[2], -1, prev[1]))
                self.state[ik] = (value, vals, ik)
                out_rows.append((ik, 1, vals))
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]

    def process(self, t, inputs):
        pre: list[DiffBatch] = []
        pending = getattr(self, "_restore_emit", None)
        if pending:
            pre = [DiffBatch.from_rows(pending, self.node.column_names)]
            self._restore_emit = None
        if self._rowwise:
            return pre + self._process_rowwise(inputs)
        b = _concat_inputs(inputs[0], self.node.inputs[0].column_names)
        if not len(b):
            return pre
        try:
            return pre + self._process_arranged(b)
        except Exception:
            import logging

            logging.getLogger("pathway_tpu_torch").exception(
                "deduplicate columnar path failed; falling back to the "
                "rowwise path for node %s", self.node
            )
            self._to_rowwise("exception")
            return pre + self._process_rowwise(inputs)


# ---------------------------------------------------------------------------
# Ix (pointer lookup)


class IxNode(Node):
    """t2.ix(t1.ptr_col): fetch the row of `indexed` pointed to by a pointer
    column of `indexer`; result lives on the indexer's universe
    (reference: Graph::ix / Table.ix, internals/table.py:1164)."""

    is_stateful = True

    def __init__(
        self, indexer: Node, ptr_col: str, indexed: Node, optional: bool
    ):
        super().__init__([indexer, indexed], indexed.column_names)
        self.ptr_col = ptr_col
        self.optional = optional

    def make_exec(self):
        return IxExec(self)


class IxExec(NodeExec):
    def __init__(self, node: IxNode):
        super().__init__(node)
        self.indexer = MultisetState(node.inputs[0].column_names)
        self.indexed = MultisetState(node.inputs[1].column_names)
        self.reverse: dict[int, set[int]] = {}  # target key -> indexer keys
        self.emitted: dict[int, tuple] = {}
        self.ptr_idx = node.inputs[0].column_names.index(node.ptr_col)

    def process(self, t, inputs):
        touched: dict[int, None] = {}
        for b in inputs[0]:
            for k, d, vals in b.iter_rows():
                old_row = self.indexer.get(k)
                if old_row is not None:
                    old_ptr = old_row[self.ptr_idx]
                    if old_ptr is not None:
                        s = self.reverse.get(int(old_ptr))
                        if s:
                            s.discard(k)
                self.indexer.apply_row(k, d, vals)
                new_row = self.indexer.get(k)
                if new_row is not None:
                    ptr = new_row[self.ptr_idx]
                    if ptr is not None:
                        self.reverse.setdefault(int(ptr), set()).add(k)
                touched[k] = None
        for b in inputs[1]:
            for k, d, vals in b.iter_rows():
                self.indexed.apply_row(k, d, vals)
                for ik in self.reverse.get(k, ()):
                    touched[ik] = None
        from pathway_tpu_torch.engine.batch import _values_eq

        out_rows = []
        for k in touched:
            row = self.indexer.get(k)
            new = None
            if row is not None:
                ptr = row[self.ptr_idx]
                target = self.indexed.get(int(ptr)) if ptr is not None else None
                if target is not None:
                    new = target
                elif self.node.optional:
                    new = (None,) * len(self.node.column_names)
                else:
                    record_error(
                        KeyError(f"ix: no row with id {ptr!r}"), str(self.node)
                    )
                    new = tuple(ERROR for _ in self.node.column_names)
            old = self.emitted.get(k)
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


# ---------------------------------------------------------------------------
# Universe set ops


class UniverseSetOpNode(Node):
    """restrict / intersect / difference on key sets
    (reference: Graph::restrict_column / intersect_tables / subtract_table)."""

    is_stateful = True

    def __init__(self, left: Node, others: Sequence[Node], mode: str):
        super().__init__([left] + list(others), left.column_names)
        self.mode = mode  # 'intersect' | 'difference' | 'restrict'

    def make_exec(self):
        return UniverseSetOpExec(self)


class UniverseSetOpExec(NodeExec):
    def __init__(self, node: UniverseSetOpNode):
        super().__init__(node)
        self.left = MultisetState(node.inputs[0].column_names)
        self.other_counts: list[dict[int, int]] = [
            {} for _ in node.inputs[1:]
        ]
        self.emitted: dict[int, tuple] = {}

    def process(self, t, inputs):
        touched: dict[int, None] = {}
        for b in inputs[0]:
            for k, d, vals in b.iter_rows():
                self.left.apply_row(k, d, vals)
                touched[k] = None
        for counts, batches in zip(self.other_counts, inputs[1:]):
            for b in batches:
                for k, d, _vals in b.iter_rows():
                    counts[k] = counts.get(k, 0) + d
                    if counts[k] == 0:
                        del counts[k]
                    touched[k] = None
        from pathway_tpu_torch.engine.batch import _values_eq

        out_rows = []
        mode = self.node.mode
        for k in touched:
            row = self.left.get(k)
            present_in_others = [k in c for c in self.other_counts]
            if mode in ("intersect", "restrict"):
                ok = row is not None and all(present_in_others)
            else:  # difference
                ok = row is not None and not any(present_in_others)
            new = row if ok else None
            old = self.emitted.get(k)
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


# ---------------------------------------------------------------------------
# Output / subscribe


class OutputNode(Node):
    """(reference: output_table / subscribe_table,
    src/engine/dataflow.rs:3979,4080)"""

    def __init__(
        self,
        input: Node,
        on_batch: Callable[[int, DiffBatch], None],
        on_end: Callable[[], None] | None = None,
    ):
        super().__init__([input], input.column_names)
        self.on_batch = on_batch
        self.on_end_cb = on_end

    def make_exec(self):
        return OutputExec(self)


class OutputExec(NodeExec):
    def process(self, t, inputs):
        for b in inputs[0]:
            if len(b):
                self.node.on_batch(t, b)
        return []

    def on_end(self):
        if self.node.on_end_cb is not None:
            self.node.on_end_cb()
        return []


# ---------------------------------------------------------------------------
# Buffer / Forget / Freeze (temporal behaviors)


class BufferNode(Node):
    """Postpone rows until the time column passes a threshold
    (reference: postpone_core, src/engine/dataflow/operators/time_column.rs:248)."""

    is_stateful = True

    def __init__(
        self,
        input: Node,
        threshold_col: str,
        current_time_col: str,
        flush_on_end: bool = True,
    ):
        super().__init__([input], input.column_names)
        self.threshold_col = threshold_col
        self.current_time_col = current_time_col
        self.flush_on_end = flush_on_end

    def _make_local_exec(self):
        from pathway_tpu_torch.parallel.mesh import get_engine_mesh

        em = get_engine_mesh()
        if em is not None:
            from pathway_tpu_torch.engine.sharded import ShardedBufferExec

            return ShardedBufferExec(self, em[0], em[1])
        return BufferExec(self)

    def make_exec(self):
        return self._make_local_exec()


def _watermark_ledger_append(arr: Arrangement, ops) -> None:
    """Append per-row state transitions to a watermark exec's
    persistence ledger.  ``ops`` are (flag, row_key, diff, vals): the
    flag is the arrangement's join key (0 = held/live, 1 = released), so
    the two lifecycle states of one row key consolidate independently;
    the row's values ride in a single object column."""
    if not ops:
        return
    n = len(ops)
    jks = np.fromiter((f for f, _k, _d, _v in ops), dtype=np.uint64, count=n)
    keys = np.fromiter(
        (k & 0xFFFFFFFFFFFFFFFF for _f, k, _d, _v in ops),
        dtype=np.uint64,
        count=n,
    )
    diffs = np.fromiter((d for _f, _k, d, _v in ops), dtype=np.int64, count=n)
    vcol = np.empty(n, dtype=object)
    vcol[:] = [v for _f, _k, _d, v in ops]
    arr.append(jks, keys, diffs, [vcol])


class BufferExec(NodeExec):
    """Dict compute state + an arrangement-backed persistence ledger
    (PR-7 State Ledger protocol): every held/released transition mirrors
    into ``self.ledger`` as an append-only delta, so snapshots write
    bytes ∝ churn instead of pickling the whole buffer.
    ``PATHWAY_STATE_ROWWISE=1`` disables the ledger — the monolithic
    pickle is the differential oracle."""

    def __init__(self, node: BufferNode):
        super().__init__(node)
        in_cols = node.inputs[0].column_names
        self.thr_idx = in_cols.index(node.threshold_col)
        self.cur_idx = in_cols.index(node.current_time_col)
        self.held: dict[int, list] = {}  # key -> [threshold, vals, count]
        self.released: set[int] = set()
        self.max_seen: Any = None
        self._ledger_on = not _state_rowwise_env()
        self.ledger = Arrangement(1)  # jk: 0 = held, 1 = released

    # --- persistence ledger ----------------------------------------------

    def arranged_state(self):
        if not self._ledger_on:
            return None
        residual = {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("node", "held", "released", "ledger")
            and not k.startswith("_m_")
        }
        return residual, {"ledger": self.ledger}

    def load_arranged_state(self, residual, arrangements) -> None:
        self.__dict__.update(residual)
        self.ledger = arrangements["ledger"]
        self.held = {}
        self.released = set()
        rows = self.ledger.entries()
        if len(rows):
            vals_l = rows.cols[0].tolist()
            jks = rows.jk.tolist()
            keys = rows.key.tolist()
            counts = rows.count.tolist()
            for i in range(len(keys)):
                if counts[i] == 0:
                    continue
                if jks[i] == 0:
                    vals = vals_l[i]
                    self.held[keys[i]] = [
                        vals[self.thr_idx], vals, counts[i],
                    ]
                else:
                    self.released.add(keys[i])
        if _state_rowwise_env():
            self._ledger_on = False
            self.ledger = Arrangement(1)

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        # legacy (pre-ledger) monolith snapshot: seed the ledger so the
        # next incremental snapshot covers the restored state
        if (
            self._ledger_on
            and len(self.ledger) == 0
            and (self.held or self.released)
        ):
            ops = [
                (0, k, c, vals) for k, (_thr, vals, c) in self.held.items()
            ]
            ops += [(1, k, 1, ()) for k in self.released]
            _watermark_ledger_append(self.ledger, ops)

    def process(self, t, inputs):
        out_rows = []
        batch_max = None
        ops: list = []  # ledger mirror of every held/released transition
        for b in inputs[0]:
            for k, d, vals in b.iter_rows():
                cur = vals[self.cur_idx]
                if cur is not None and (batch_max is None or cur > batch_max):
                    batch_max = cur
                if k in self.released:
                    out_rows.append((k, d, vals))
                    if d < 0:
                        self.released.discard(k)
                        ops.append((1, k, -1, vals))
                    continue
                if d > 0:
                    thr = vals[self.thr_idx]
                    prev = self.held.get(k)
                    if prev is not None:
                        ops.append((0, k, -prev[2], prev[1]))
                    self.held[k] = [thr, vals, d]
                    ops.append((0, k, d, vals))
                else:
                    if k in self.held:
                        prev = self.held.pop(k)
                        ops.append((0, k, -prev[2], prev[1]))
                    else:
                        out_rows.append((k, d, vals))
        # release is IMMEDIATE within a tick (a row whose threshold the
        # same batch's time column already passes flows straight through —
        # reference: postpone_core releases against `now` including the
        # current batch, and delay=0 must not hold rows a tick); contrast
        # ForgetExec/FreezeExec, whose watermarks genuinely lag
        if batch_max is not None and (
            self.max_seen is None or batch_max > self.max_seen
        ):
            self.max_seen = batch_max
        # release rows whose threshold <= watermark
        if self.max_seen is not None:
            ready = [
                k
                for k, (thr, _v, _c) in self.held.items()
                if thr is not None and thr <= self.max_seen
            ]
            for k in ready:
                thr, vals, c = self.held.pop(k)
                out_rows.append((k, c, vals))
                self.released.add(k)
                ops.append((0, k, -c, vals))
                ops.append((1, k, 1, vals))
        if self._ledger_on:
            _watermark_ledger_append(self.ledger, ops)
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]

    def on_end(self):
        if not self.node.flush_on_end:
            return []
        out_rows = []
        ops: list = []
        for k, (thr, vals, c) in self.held.items():
            out_rows.append((k, c, vals))
            self.released.add(k)
            ops.append((0, k, -c, vals))
            ops.append((1, k, 1, vals))
        self.held.clear()
        if self._ledger_on:
            _watermark_ledger_append(self.ledger, ops)
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]


class ForgetNode(Node):
    """Retract rows older than threshold — bounds state
    (reference: TimeColumnForget, time_column.rs:426)."""

    is_stateful = True

    def __init__(
        self,
        input: Node,
        threshold_col: str,
        current_time_col: str,
        mark_forgetting_records: bool = False,
    ):
        super().__init__([input], input.column_names)
        self.threshold_col = threshold_col
        self.current_time_col = current_time_col
        if mark_forgetting_records:
            raise NotImplementedError(
                "mark_forgetting_records=True (tagging retractions caused "
                "by forgetting with an extra flag column, reference: "
                "TimeColumnForget) is not implemented yet"
            )
        self.mark_forgetting_records = mark_forgetting_records

    def make_exec(self):
        return ForgetExec(self)


class ForgetExec(NodeExec):
    """Same State-Ledger mirroring as BufferExec: the live-row dict is
    compute state, ``self.ledger`` is its append-only persistence mirror
    (single jk 0 — rows have one lifecycle state here)."""

    def __init__(self, node: ForgetNode):
        super().__init__(node)
        in_cols = node.inputs[0].column_names
        self.thr_idx = in_cols.index(node.threshold_col)
        self.cur_idx = in_cols.index(node.current_time_col)
        self.live: dict[int, list] = {}
        self.max_seen: Any = None
        self._scanned_at: Any = None  # watermark value at the last scan
        self._ledger_on = not _state_rowwise_env()
        self.ledger = Arrangement(1)

    def arranged_state(self):
        if not self._ledger_on:
            return None
        residual = {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("node", "live", "ledger") and not k.startswith("_m_")
        }
        return residual, {"ledger": self.ledger}

    def load_arranged_state(self, residual, arrangements) -> None:
        self.__dict__.update(residual)
        self.ledger = arrangements["ledger"]
        self.live = {}
        rows = self.ledger.entries()
        if len(rows):
            vals_l = rows.cols[0].tolist()
            keys = rows.key.tolist()
            counts = rows.count.tolist()
            for i in range(len(keys)):
                if counts[i] > 0:
                    vals = vals_l[i]
                    self.live[keys[i]] = [vals[self.thr_idx], vals]
        if _state_rowwise_env():
            self._ledger_on = False
            self.ledger = Arrangement(1)

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        if self._ledger_on and len(self.ledger) == 0 and self.live:
            _watermark_ledger_append(
                self.ledger,
                [(0, k, 1, vals) for k, (_thr, vals) in self.live.items()],
            )

    def process(self, t, inputs):
        out_rows = []
        ops: list = []
        # Forgetting is DATA-driven, lagged one tick: rows stale against
        # the watermark of STRICTLY EARLIER ticks retract when new data
        # (or an externally advanced DCN watermark) arrives — never at the
        # end-of-stream flush tick, which carries no time advancement
        # (reference: TimeColumnForget reacts to input batches,
        # time_column.rs:426; batch mode forgets nothing).
        has_rows = any(len(b) for b in inputs[0])
        # _scanned_at is refreshed at the END of process, so this only
        # fires when max_seen moved OUTSIDE process() — the DCN watermark
        # wrapper advancing it from a peer's data
        externally_advanced = (
            self.max_seen is not None and self.max_seen != self._scanned_at
        )
        if (
            (has_rows or externally_advanced)
            and t < END_OF_TIME
            and self.max_seen is not None
        ):
            stale = [
                k
                for k, (thr, _v) in self.live.items()
                if thr is not None and thr <= self.max_seen
            ]
            for k in stale:
                thr, vals = self.live.pop(k)
                out_rows.append((k, -1, vals))
                ops.append((0, k, -1, vals))
        batch_max = None
        for b in inputs[0]:
            for k, d, vals in b.iter_rows():
                cur = vals[self.cur_idx]
                if cur is not None and (batch_max is None or cur > batch_max):
                    batch_max = cur
                out_rows.append((k, d, vals))
                if d > 0:
                    prev = self.live.get(k)
                    if prev is not None:
                        ops.append((0, k, -1, prev[1]))
                    self.live[k] = [vals[self.thr_idx], vals]
                    ops.append((0, k, 1, vals))
                else:
                    prev = self.live.pop(k, None)
                    if prev is not None:
                        ops.append((0, k, -1, prev[1]))
        if batch_max is not None and (
            self.max_seen is None or batch_max > self.max_seen
        ):
            self.max_seen = batch_max
        self._scanned_at = self.max_seen
        if self._ledger_on:
            _watermark_ledger_append(self.ledger, ops)
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]


class FreezeNode(Node):
    """Drop late rows (reference: TimeColumnFreeze, time_column.rs:509)."""

    def __init__(self, input: Node, threshold_col: str, current_time_col: str):
        super().__init__([input], input.column_names)
        self.threshold_col = threshold_col
        self.current_time_col = current_time_col

    def make_exec(self):
        return FreezeExec(self)


class FreezeExec(NodeExec):
    def __init__(self, node: FreezeNode):
        super().__init__(node)
        in_cols = node.inputs[0].column_names
        self.thr_idx = in_cols.index(node.threshold_col)
        self.cur_idx = in_cols.index(node.current_time_col)
        self.max_seen: Any = None

    def process(self, t, inputs):
        out_rows = []
        batch_max = None
        for b in inputs[0]:
            for k, d, vals in b.iter_rows():
                thr = vals[self.thr_idx]
                # lateness is judged against the watermark of STRICTLY
                # EARLIER ticks (reference: TimeColumnFreeze,
                # time_column.rs:509) — same-tick rows never freeze each
                # other out
                if (
                    self.max_seen is not None
                    and thr is not None
                    and thr <= self.max_seen
                ):
                    continue  # late — frozen out
                out_rows.append((k, d, vals))
                cur = vals[self.cur_idx]
                if cur is not None and (batch_max is None or cur > batch_max):
                    batch_max = cur
        if batch_max is not None and (
            self.max_seen is None or batch_max > self.max_seen
        ):
            self.max_seen = batch_max
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]
