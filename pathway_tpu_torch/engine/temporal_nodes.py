"""The port's own copy of ``pathway_tpu/engine/temporal_nodes.py``. Temporal engine nodes: session assignment, interval/asof/asof-now joins.

Columnar-engine equivalents of the reference's temporal machinery
(upstream Pathway: src/engine/dataflow/operators/time_column.rs for behaviors —
see BufferNode/ForgetNode/FreezeNode in nodes.py — and the table-level
desugarings of python/pathway/stdlib/temporal/). The reference compiles
interval/asof joins down to bucketed equijoins + filters on differential
collections; here each temporal node keeps keyed columnar state and restates
only the equality-groups touched per microbatch tick, which is the same
incremental contract (diff in → diff out) on the columnar engine.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, Sequence

import numpy as np

from pathway_tpu_torch.engine.arrangement import Arrangement, Rows
from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import (
    Node,
    NodeExec,
    _concat_inputs,
    _fallback_counter,
    _none_col,
    _state_rowwise_env,
)
from pathway_tpu_torch.internals.api import (
    Pointer,
    ref_scalar,
    ref_scalars_columns,
)
from pathway_tpu_torch.internals.errors import record_error


# ---------------------------------------------------------------------------
# Session window assignment


class SessionAssignNode(Node):
    """Assign (window_start, window_end) to every row by merging adjacent rows
    (sorted by the time column, per instance) whenever `predicate(a, b)` holds
    or `b - a < max_gap` (reference: _SessionWindow,
    python/pathway/stdlib/temporal/_window.py:65).

    Output: same universe as input, columns ["_pw_window_start",
    "_pw_window_end"]. Incremental: per-instance full restate on touch, diffed
    against previously emitted assignments.
    """

    is_stateful = True

    def __init__(
        self,
        input: Node,
        key_col: str,
        instance_col: str | None,
        predicate: Callable[[Any, Any], bool] | None,
        max_gap: Any | None,
    ):
        super().__init__([input], ["_pw_window_start", "_pw_window_end"])
        self.key_col = key_col
        self.instance_col = instance_col
        self.predicate = predicate
        self.max_gap = max_gap

    def make_exec(self):
        return SessionAssignExec(self)


class SessionAssignExec(NodeExec):
    """Per-instance session buffers live in an Arrangement (jk = hashed
    instance, cols = [time, instance]): a tick derives instance keys with
    the C batch hasher, appends the delta, probes only the touched
    instances and restates their groupings.  The dict path survives as
    the differential-testing oracle (PATHWAY_STATE_ROWWISE=1) and the
    exception escape hatch."""

    def __init__(self, node: SessionAssignNode):
        super().__init__(node)
        in_cols = node.inputs[0].column_names
        self.k_idx = in_cols.index(node.key_col)
        self.i_idx = (
            in_cols.index(node.instance_col) if node.instance_col else None
        )
        # rowwise oracle/fallback state: inst -> {rowkey: t}
        self.instances: dict[Any, dict[int, Any]] = {}
        # keyed by the INSTANCE VALUE on both paths (the arrangement keeps
        # the instance value as a column, so the fallback can carry this
        # map over untouched — what was emitted must never be recomputed)
        self.emitted: dict[Any, dict[int, tuple]] = {}
        self.arr = Arrangement(2)  # cols: [time, instance value]
        self._rowwise = False
        self._fallback_reason: str | None = None
        self._m_fallbacks = _fallback_counter()
        if _state_rowwise_env():
            self._to_rowwise("env")

    # --- session grouping (shared by both paths) -------------------------

    def _grouped_rows(self, rows: dict[int, Any]) -> dict[int, tuple]:
        """rows: {rowkey: t} -> {rowkey: (window_start, window_end)}."""
        order = sorted(rows.items(), key=lambda kv: (kv[1], kv[0]))
        out: dict[int, tuple] = {}
        node = self.node
        group: list[tuple[int, Any]] = []

        def flush():
            if not group:
                return
            start = group[0][1]
            end = group[-1][1]
            for k, _t in group:
                out[k] = (start, end)

        for k, t in order:
            if group:
                prev_t = group[-1][1]
                if node.predicate is not None:
                    same = bool(node.predicate(prev_t, t))
                else:
                    same = (t - prev_t) < node.max_gap
                if not same:
                    flush()
                    group = []
            group.append((k, t))
        flush()
        return out

    def _grouped(self, inst) -> dict[int, tuple]:
        return self._grouped_rows(self.instances.get(inst, {}))

    def _emit_diffs(self, touched_keys, new_by_key) -> list[DiffBatch]:
        # two phases: build every diff first, mutate self.emitted only
        # after — an exception mid-loop must not record rows as emitted
        # that the caller then discards (the fallback retry diffs against
        # self.emitted, so it must exactly mirror what downstream holds)
        out_rows: list[tuple[int, int, tuple]] = []
        for tk in touched_keys:
            new_vals = new_by_key[tk]
            emitted = self.emitted.get(tk, ())
            for k in set(emitted) | set(new_vals):
                old = emitted.get(k) if emitted else None
                new = new_vals.get(k)
                if old == new:
                    continue
                if old is not None:
                    out_rows.append((k, -1, old))
                if new is not None:
                    out_rows.append((k, 1, new))
        for tk in touched_keys:
            self.emitted[tk] = dict(new_by_key[tk])
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]

    # --- fallback / oracle management -----------------------------------

    def _view_by_jk(
        self, rows: Rows
    ) -> tuple[dict[int, dict[int, Any]], dict[int, Any]]:
        """Probed entries -> ({jk: {rowkey: t}}, {jk: instance value})
        (count>0 only)."""
        view: dict[int, dict[int, Any]] = {}
        inst_of: dict[int, Any] = {}
        if not len(rows):
            return view, inst_of
        ts = rows.cols[0].tolist()
        insts = rows.cols[1].tolist()
        jks = rows.jk.tolist()
        keys = rows.key.tolist()
        counts = rows.count.tolist()
        for i in range(len(jks)):
            if counts[i] > 0:
                view.setdefault(jks[i], {})[keys[i]] = ts[i]
                inst_of[jks[i]] = insts[i]
        return view, inst_of

    def _to_rowwise(self, reason: str) -> None:
        self._rowwise = True
        self._fallback_reason = reason
        self._m_fallbacks.labels(type(self).__name__, reason).inc()
        rows = self.arr.entries()
        if len(rows):
            ts = rows.cols[0].tolist()
            insts = rows.cols[1].tolist()
            keys = rows.key.tolist()
            counts = rows.count.tolist()
            for i in range(len(keys)):
                if counts[i] > 0:
                    self.instances.setdefault(insts[i], {})[keys[i]] = ts[i]
        # self.emitted is inst-keyed on both paths and mirrors exactly
        # what downstream holds — carry it over UNTOUCHED (recomputing it
        # from post-delta state would swallow the failed tick's diffs)
        self.arr = Arrangement(2)

    # --- operator snapshots ---------------------------------------------

    def arranged_state(self):
        if self._rowwise:
            return None
        residual = {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("node", "arr", "instances", "emitted")
            and not k.startswith("_m_")
        }
        return residual, {"arr": self.arr}

    def load_arranged_state(self, residual, arrangements) -> None:
        self.__dict__.update(residual)
        self.arr = arrangements["arr"]
        self.instances = {}
        # emitted is derived state: recompute per stored instance
        view, inst_of = self._view_by_jk(self.arr.entries())
        self.emitted = {
            inst_of[jk]: self._grouped_rows(rows)
            for jk, rows in view.items()
        }
        if _state_rowwise_env():
            self._rowwise = False  # residual was snapshotted columnar
            self._to_rowwise("env")

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        if not self._rowwise and "arr" not in state and self.instances:
            # legacy monolith snapshot (pre-arrangement): seed the
            # arrangement from the restored dicts; emitted is already
            # inst-keyed and carries over as-is
            insts: list = []
            keys: list = []
            ts: list = []
            for inst, rows in self.instances.items():
                for k, t in rows.items():
                    insts.append(inst)
                    keys.append(k)
                    ts.append(t)
            inst_col = np.empty(len(insts), dtype=object)
            inst_col[:] = insts
            t_col = np.empty(len(ts), dtype=object)
            t_col[:] = ts
            self.arr = Arrangement(2)
            self.arr.append(
                ref_scalars_columns([inst_col], len(insts)),
                np.asarray(keys, dtype=np.uint64),
                np.ones(len(insts), dtype=np.int64),
                [t_col, inst_col],
            )
            self.instances = {}

    # --- columnar path ---------------------------------------------------

    def _process_arranged(self, b: DiffBatch) -> list[DiffBatch]:
        n = len(b)
        cols = list(b.columns.values())
        inst_col = cols[self.i_idx] if self.i_idx is not None else _none_col(n)
        jks = ref_scalars_columns([inst_col], n)
        tcol = cols[self.k_idx]
        order = np.argsort(jks, kind="stable")
        jks_s = jks[order]
        boundary = np.empty(n, dtype=bool)
        boundary[0] = True
        boundary[1:] = jks_s[1:] != jks_s[:-1]
        starts = np.nonzero(boundary)[0]
        touched = jks_s[starts]  # sorted unique
        # representative instance VALUE per touched jk (emission state is
        # inst-keyed so the fallback can carry it across paths)
        touched_inst = inst_col[order[starts]].tolist()
        # post-delta state is all this node needs (emission diffs against
        # self.emitted): append first, then probe the touched instances.
        # Safe under the exception fallback: the dict apply is idempotent
        # (insert overwrites, retract pops), so the rowwise retry
        # re-applying this delta over the materialized post-delta state
        # cannot double-count — and _emit_diffs defers its mutations, so
        # self.emitted still mirrors what downstream actually received.
        self.arr.append(jks, b.keys, b.diffs, [tcol, inst_col])
        view, _inst_of = self._view_by_jk(self.arr.probe(touched))
        new_by_key = {
            inst: self._grouped_rows(view.get(int(jk), {}))
            for jk, inst in zip(touched.tolist(), touched_inst)
        }
        return self._emit_diffs(list(new_by_key), new_by_key)

    # --- rowwise oracle / fallback ---------------------------------------

    def _process_rowwise(self, inputs) -> list[DiffBatch]:
        touched: dict[Any, None] = {}
        for b in inputs[0]:
            for k, d, vals in b.iter_rows():
                inst = vals[self.i_idx] if self.i_idx is not None else None
                rows = self.instances.setdefault(inst, {})
                if d > 0:
                    rows[k] = vals[self.k_idx]
                else:
                    rows.pop(k, None)
                touched[inst] = None
        new_by_key = {inst: self._grouped(inst) for inst in touched}
        return self._emit_diffs(list(touched), new_by_key)

    def process(self, t, inputs):
        if self._rowwise:
            return self._process_rowwise(inputs)
        b = _concat_inputs(inputs[0], self.node.inputs[0].column_names)
        if not len(b):
            return []
        try:
            return self._process_arranged(b)
        except Exception:
            import logging

            logging.getLogger("pathway_tpu_torch").exception(
                "session-assign columnar path failed; falling back to the "
                "rowwise path for node %s", self.node
            )
            self._to_rowwise("exception")
            return self._process_rowwise(inputs)


# ---------------------------------------------------------------------------
# Temporal pair joins (interval / asof): shared state + restate machinery


class _TimedSide:
    """Rows of one join side, grouped by equality key, sorted by time —
    the rowwise dict representation.  In the arranged engine it survives
    as the differential-testing oracle's state, the exception fallback's
    state, AND the per-tick *view* the columnar path materializes for
    touched groups only (probe → view → apply delta → restate), so both
    paths share one apply/sort semantics."""

    __slots__ = ("by_jk",)

    def __init__(self):
        # jk -> {rowkey: (time, vals, count)}
        self.by_jk: dict[int, dict[int, list]] = {}

    def apply(self, jk: int, k: int, d: int, time: Any, vals: tuple):
        rows = self.by_jk.setdefault(jk, {})
        e = rows.get(k)
        if e is None:
            if d != 0:
                rows[k] = [time, vals, d]
        else:
            e[2] += d
            if d > 0:
                e[0], e[1] = time, vals
            if e[2] == 0:
                del rows[k]
        if not rows:
            self.by_jk.pop(jk, None)

    def sorted_rows(self, jk: int) -> list[tuple[Any, int, tuple]]:
        rows = self.by_jk.get(jk, {})
        return sorted(
            (
                (time, k, vals)
                for k, (time, vals, c) in rows.items()
                if c > 0
            ),
            key=lambda r: (r[0], r[1]),
        )


class _ArrangedSide:
    """One side's buffered rows in a columnar Arrangement — jk = hashed
    on-columns, rowkey = row id, cols = the side's value columns."""

    __slots__ = ("arr",)

    def __init__(self, n_cols: int, arr: Arrangement | None = None):
        self.arr = arr if arr is not None else Arrangement(n_cols)

    def view(self, rows: Rows) -> _TimedSide:
        """Materialize probed entries as a dict view (touched groups
        only) that _TimedSide.apply/sorted_rows can drive."""
        side = _TimedSide()
        if not len(rows):
            return side
        cols = [c.tolist() for c in rows.cols]
        jks = rows.jk.tolist()
        keys = rows.key.tolist()
        counts = rows.count.tolist()
        by_jk = side.by_jk
        vals_it = zip(*cols) if cols else iter([()] * len(jks))
        for jk, k, c, vals in zip(jks, keys, counts, vals_it):
            by_jk.setdefault(jk, {})[k] = [None, tuple(vals), c]
        return side


class _TemporalJoinExecBase(NodeExec):
    """Touched-group restate: like JoinExec (nodes.py) but match rules involve
    the time columns and unmatched rows are tracked per row, not per group.

    State lives in per-side Arrangements: a tick derives both sides' join
    keys with the C batch hasher, probes only the touched keys (one
    searchsorted pair per segment), materializes those groups as a dict
    view, overlays the delta through the SAME apply the rowwise oracle
    uses, and restates.  The arrangement commit happens last, so the
    exception fallback (and the PATHWAY_STATE_ROWWISE oracle) always sees
    consistent pre-tick state."""

    def __init__(self, node):
        super().__init__(node)
        lcols = node.inputs[0].column_names
        rcols = node.inputs[1].column_names
        self.l_on_idx = [lcols.index(c) for c in node.left_on]
        self.r_on_idx = [rcols.index(c) for c in node.right_on]
        self.lt_idx = lcols.index(node.left_time)
        self.rt_idx = rcols.index(node.right_time)
        self.n_l = len(lcols)
        self.n_r = len(rcols)
        self._rowwise = False
        self._fallback_reason: str | None = None
        self._m_fallbacks = _fallback_counter()
        if _state_rowwise_env():
            self._rowwise = True
            self._fallback_reason = "env"
            self._m_fallbacks.labels(type(self).__name__, "env").inc()
            self.left: Any = _TimedSide()
            self.right: Any = _TimedSide()
        else:
            self.left = _ArrangedSide(self.n_l)
            self.right = _ArrangedSide(self.n_r)

    def _jk(self, vals: tuple, idx: list[int]) -> int:
        return int(ref_scalar(*(vals[i] for i in idx)))

    def _outputs_for_jk(self, jk, lrows, rrows) -> dict[int, tuple]:
        """Current output rows for one join key given both sides' sorted
        row lists [(time, rowkey, vals), ...]."""
        raise NotImplementedError

    def _pad_left(self, lk: int, lvals: tuple) -> tuple[int, tuple]:
        okey = int(ref_scalar(Pointer(lk), None))
        return okey, lvals + (None,) * self.n_r + (Pointer(lk), None)

    def _pad_right(self, rk: int, rvals: tuple) -> tuple[int, tuple]:
        okey = int(ref_scalar(None, Pointer(rk)))
        return okey, (None,) * self.n_l + rvals + (None, Pointer(rk))

    def _pair(self, lk: int, lvals: tuple, rk: int, rvals: tuple):
        okey = int(ref_scalar(Pointer(lk), Pointer(rk)))
        return okey, lvals + rvals + (Pointer(lk), Pointer(rk))

    # --- fallback / oracle management -----------------------------------

    def _to_rowwise(self, reason: str) -> None:
        self._rowwise = True
        self._fallback_reason = reason
        self._m_fallbacks.labels(type(self).__name__, reason).inc()
        for attr, t_idx in (("left", self.lt_idx), ("right", self.rt_idx)):
            arranged = getattr(self, attr)
            side = arranged.view(arranged.arr.entries())
            for rows in side.by_jk.values():
                for e in rows.values():
                    e[0] = e[1][t_idx]
            setattr(self, attr, side)

    # --- operator snapshots ---------------------------------------------

    def arranged_state(self):
        if self._rowwise:
            return None
        residual = {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("node", "left", "right") and not k.startswith("_m_")
        }
        return residual, {"left": self.left.arr, "right": self.right.arr}

    def load_arranged_state(self, residual, arrangements) -> None:
        self.__dict__.update(residual)
        self.left = _ArrangedSide(self.n_l, arrangements["left"])
        self.right = _ArrangedSide(self.n_r, arrangements["right"])
        if _state_rowwise_env():
            self._rowwise = False  # residual was snapshotted columnar
            self._to_rowwise("env")

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        if not self._rowwise and isinstance(self.left, _TimedSide):
            # legacy monolith snapshot (pre-arrangement dict sides): seed
            # per-side arrangements so the columnar path continues with
            # the restored state instead of silently ignoring it
            self.left = self._seed_side(self.left, self.n_l)
            self.right = self._seed_side(self.right, self.n_r)

    @staticmethod
    def _seed_side(side: _TimedSide, n_cols: int) -> _ArrangedSide:
        jks: list[int] = []
        keys: list[int] = []
        counts: list[int] = []
        vals_rows: list[tuple] = []
        for jk, rows in side.by_jk.items():
            for k, (_t, vals, c) in rows.items():
                jks.append(jk)
                keys.append(k)
                counts.append(c)
                vals_rows.append(vals)
        arranged = _ArrangedSide(n_cols)
        if jks:
            cols = []
            for ci in range(n_cols):
                col = np.empty(len(vals_rows), dtype=object)
                col[:] = [v[ci] for v in vals_rows]
                cols.append(col)
            arranged.arr.append(
                np.asarray(jks, dtype=np.uint64),
                np.asarray(keys, dtype=np.uint64),
                np.asarray(counts, dtype=np.int64),
                cols,
            )
        return arranged

    # --- emission (shared) ------------------------------------------------

    def _emit(self, touched, before, after) -> list[DiffBatch]:
        from pathway_tpu_torch.engine.batch import _values_eq

        out_rows: list[tuple[int, int, tuple]] = []
        for jk in touched:
            aft = after[jk]
            bef = before[jk]
            for okey, vals in bef.items():
                new = aft.get(okey)
                if new is None or not _values_eq(vals, new):
                    out_rows.append((okey, -1, vals))
            for okey, vals in aft.items():
                old = bef.get(okey)
                if old is None or not _values_eq(old, vals):
                    out_rows.append((okey, 1, vals))
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]

    # --- columnar path ---------------------------------------------------

    def _batch_jks(self, b: DiffBatch, on_idx: list[int]) -> np.ndarray:
        cols = list(b.columns.values())
        return ref_scalars_columns([cols[i] for i in on_idx], len(b))

    def _process_arranged(self, lb, rb) -> list[DiffBatch]:
        jks_l = (
            self._batch_jks(lb, self.l_on_idx)
            if len(lb)
            else np.empty(0, np.uint64)
        )
        jks_r = (
            self._batch_jks(rb, self.r_on_idx)
            if len(rb)
            else np.empty(0, np.uint64)
        )
        touched_arr = np.unique(np.concatenate([jks_l, jks_r]))
        # probe pre-tick state for the touched keys; the dict view carries
        # times lazily (filled from the stored vals below)
        view_l = self.left.view(self.left.arr.probe(touched_arr))
        view_r = self.right.view(self.right.arr.probe(touched_arr))
        for side, t_idx in ((view_l, self.lt_idx), (view_r, self.rt_idx)):
            for rows in side.by_jk.values():
                for e in rows.values():
                    e[0] = e[1][t_idx]
        touched = [int(j) for j in touched_arr.tolist()]
        before = {
            jk: self._outputs_for_jk(
                jk, view_l.sorted_rows(jk), view_r.sorted_rows(jk)
            )
            for jk in touched
        }
        # overlay the delta through the oracle's own apply
        lrows_py = list(lb.iter_rows()) if len(lb) else []
        rrows_py = list(rb.iter_rows()) if len(rb) else []
        for (k, d, vals), jk in zip(lrows_py, jks_l.tolist()):
            view_l.apply(jk, k, d, vals[self.lt_idx], vals)
        for (k, d, vals), jk in zip(rrows_py, jks_r.tolist()):
            view_r.apply(jk, k, d, vals[self.rt_idx], vals)
        after = {
            jk: self._outputs_for_jk(
                jk, view_l.sorted_rows(jk), view_r.sorted_rows(jk)
            )
            for jk in touched
        }
        out = self._emit(touched, before, after)
        # commit the delta into arranged state only after the pure
        # computation succeeded (the exception fallback must see pre-tick
        # state); stage both sides before committing either
        staged_l = self.left.arr.stage(
            jks_l, lb.keys, lb.diffs, list(lb.columns.values())
        ) if len(lb) else None
        staged_r = self.right.arr.stage(
            jks_r, rb.keys, rb.diffs, list(rb.columns.values())
        ) if len(rb) else None
        self.left.arr.commit(staged_l)
        self.right.arr.commit(staged_r)
        return out

    # --- rowwise oracle / fallback ---------------------------------------

    def _process_rowwise(self, lb, rb) -> list[DiffBatch]:
        touched: dict[int, None] = {}
        l_updates, r_updates = [], []
        for k, d, vals in lb.iter_rows():
            jk = self._jk(vals, self.l_on_idx)
            touched[jk] = None
            l_updates.append((jk, k, d, vals[self.lt_idx], vals))
        for k, d, vals in rb.iter_rows():
            jk = self._jk(vals, self.r_on_idx)
            touched[jk] = None
            r_updates.append((jk, k, d, vals[self.rt_idx], vals))
        before = {
            jk: self._outputs_for_jk(
                jk, self.left.sorted_rows(jk), self.right.sorted_rows(jk)
            )
            for jk in touched
        }
        for jk, k, d, time, vals in l_updates:
            self.left.apply(jk, k, d, time, vals)
        for jk, k, d, time, vals in r_updates:
            self.right.apply(jk, k, d, time, vals)
        after = {
            jk: self._outputs_for_jk(
                jk, self.left.sorted_rows(jk), self.right.sorted_rows(jk)
            )
            for jk in touched
        }
        return self._emit(touched, before, after)

    def process(self, t, inputs):
        lb = _concat_inputs(inputs[0], self.node.inputs[0].column_names)
        rb = _concat_inputs(inputs[1], self.node.inputs[1].column_names)
        if not len(lb) and not len(rb):
            return []
        if self._rowwise:
            return self._process_rowwise(lb, rb)
        try:
            return self._process_arranged(lb, rb)
        except Exception:
            import logging

            logging.getLogger("pathway_tpu_torch").exception(
                "temporal-join columnar path failed; falling back to the "
                "rowwise path for node %s", self.node
            )
            self._to_rowwise("exception")
            return self._process_rowwise(lb, rb)


def _join_out_cols(left: Node, right: Node) -> list[str]:
    return (
        ["l." + c for c in left.column_names]
        + ["r." + c for c in right.column_names]
        + ["_left_id", "_right_id"]
    )


class IntervalJoinNode(Node):
    """Pairs (l, r) with equal on-columns and
    l.time + lower <= r.time <= l.time + upper
    (reference: stdlib/temporal/_interval_join.py interval_join — there
    desugared into bucketed equijoins; here a dedicated incremental node).
    """

    is_stateful = True

    def __init__(
        self,
        left: Node,
        right: Node,
        left_on: Sequence[str],
        right_on: Sequence[str],
        left_time: str,
        right_time: str,
        lower: Any,
        upper: Any,
        mode: str,  # inner | left | right | outer
    ):
        super().__init__([left, right], _join_out_cols(left, right))
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.left_time = left_time
        self.right_time = right_time
        self.lower = lower
        self.upper = upper
        self.mode = mode

    def make_exec(self):
        return IntervalJoinExec(self)


class IntervalJoinExec(_TemporalJoinExecBase):
    def _outputs_for_jk(self, jk, lrows, rrows) -> dict[int, tuple]:
        node = self.node
        out: dict[int, tuple] = {}
        r_times = [r[0] for r in rrows]
        matched_right: set[int] = set()
        for lt, lk, lvals in lrows:
            lo = bisect.bisect_left(r_times, lt + node.lower)
            hi = bisect.bisect_right(r_times, lt + node.upper)
            if lo < hi:
                for rt, rk, rvals in rrows[lo:hi]:
                    matched_right.add(rk)
                    okey, vals = self._pair(lk, lvals, rk, rvals)
                    out[okey] = vals
            elif node.mode in ("left", "outer"):
                okey, vals = self._pad_left(lk, lvals)
                out[okey] = vals
        if node.mode in ("right", "outer"):
            for rt, rk, rvals in rrows:
                if rk not in matched_right:
                    okey, vals = self._pad_right(rk, rvals)
                    out[okey] = vals
        return out


class AsofJoinNode(Node):
    """As-of join: each left row matches the single best right row per
    `direction` (reference: stdlib/temporal/_asof_join.py).

    direction: 'backward' (largest r.t <= l.t), 'forward' (smallest
    r.t >= l.t), 'nearest'. mode: left | right | outer — 'outer' emits every
    left row (matched or padded) plus every right row that is nobody's match.
    """

    is_stateful = True

    def __init__(
        self,
        left: Node,
        right: Node,
        left_on: Sequence[str],
        right_on: Sequence[str],
        left_time: str,
        right_time: str,
        direction: str,
        mode: str,
    ):
        # _pw_self_t / _pw_side = the perspective row's OWN time and side
        # (the reference's synthetic `t` and `side` output columns;
        # side=False for left-perspective rows, True for right)
        super().__init__(
            [left, right],
            _join_out_cols(left, right) + ["_pw_self_t", "_pw_side"],
        )
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.left_time = left_time
        self.right_time = right_time
        self.direction = direction
        self.mode = mode

    def make_exec(self):
        return AsofJoinExec(self)


def _asof_inclusive(direction: str, mode: str, probe_side: str) -> bool:
    """Whether an other-side row at the SAME time as the probe matches.

    The reference decides ties by its merged sort order (t, side ^
    right_first, id) with right_first = (BACKWARD and LEFT) or (FORWARD
    and RIGHT) — a same-time other-side row only matches when that order
    puts it on the probed side of the row (_asof_join.py:258-292)."""
    right_first = (direction == "backward" and mode == "left") or (
        direction == "forward" and mode == "right"
    )
    other_before = right_first if probe_side == "l" else not right_first
    if direction == "backward":
        return other_before
    if direction == "forward":
        return not other_before
    return True  # nearest: distance ties resolved in _asof_pick


def _asof_pick(
    rows: list[tuple[Any, int, tuple]],
    times: list[Any],
    t: Any,
    direction: str,
    inclusive: bool = True,
):
    """Best match among `rows` (sorted by time) for a probe at time t."""
    if not rows:
        return None
    if direction == "backward":
        i = (
            bisect.bisect_right(times, t) - 1
            if inclusive
            else bisect.bisect_left(times, t) - 1
        )
        return rows[i] if i >= 0 else None
    if direction == "forward":
        i = (
            bisect.bisect_left(times, t)
            if inclusive
            else bisect.bisect_right(times, t)
        )
        return rows[i] if i < len(rows) else None
    # nearest — a distance tie picks the later row (reference:
    # select_nearest uses prev only when strictly closer)
    i = bisect.bisect_left(times, t) - 1
    j = bisect.bisect_left(times, t)
    prev_r = rows[i] if i >= 0 else None
    next_r = rows[j] if j < len(rows) else None
    if prev_r is None:
        return next_r
    if next_r is None:
        return prev_r
    return prev_r if (t - prev_r[0]) < (next_r[0] - t) else next_r


class AsofJoinExec(_TemporalJoinExecBase):
    def _outputs_for_jk(self, jk, lrows, rrows) -> dict[int, tuple]:
        node = self.node
        out: dict[int, tuple] = {}
        l_times = [r[0] for r in lrows]
        r_times = [r[0] for r in rrows]
        # output keys mix the side into the hash — a left row and a right row
        # can share a raw row id (e.g. two fixture tables), so plain lk/rk
        # keys would collide and silently drop rows
        if node.mode in ("left", "outer"):
            for lt, lk, lvals in lrows:
                okey = int(ref_scalar(Pointer(lk), 0))
                m = _asof_pick(
                    rrows, r_times, lt, node.direction,
                    _asof_inclusive(node.direction, node.mode, "l"),
                )
                if m is not None:
                    _rt, rk, rvals = m
                    out[okey] = lvals + rvals + (
                        Pointer(lk), Pointer(rk), lt, False,
                    )
                else:
                    out[okey] = lvals + (None,) * self.n_r + (
                        Pointer(lk), None, lt, False,
                    )
        if node.mode in ("right", "outer"):
            # the direction stays the SAME from the right row's perspective
            # (backward = latest left at-or-before the right row's time) —
            # outer emits every right-perspective row, matched or not
            # (reference: _asof_join merges the m0 and m1 perspectives)
            for rt, rk, rvals in rrows:
                okey = int(ref_scalar(Pointer(rk), 1))
                m = _asof_pick(
                    lrows, l_times, rt, node.direction,
                    _asof_inclusive(node.direction, node.mode, "r"),
                )
                if m is not None:
                    _lt, lk, lvals = m
                    out[okey] = lvals + rvals + (
                        Pointer(lk), Pointer(rk), rt, True,
                    )
                else:
                    out[okey] = (None,) * self.n_l + rvals + (
                        None, Pointer(rk), rt, True,
                    )
        return out


class AsofNowJoinNode(Node):
    """`asof_now` join: left is a query stream — each left insertion is joined
    against the right side's state *at that moment* and the result is never
    revised by later right-side updates (reference:
    stdlib/temporal/_asof_now_join.py; engine analog: the as-of-now query path
    of use_external_index, src/engine/dataflow.rs:2694). Left retractions do
    retract their previously-emitted results. mode: inner | left."""

    is_stateful = True

    def __init__(
        self,
        left: Node,
        right: Node,
        left_on: Sequence[str],
        right_on: Sequence[str],
        mode: str,
        id_from: str | None = None,
    ):
        super().__init__([left, right], _join_out_cols(left, right))
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.mode = mode
        self.id_from = id_from  # "left": output rows keyed by query row id

    def make_exec(self):
        return AsofNowJoinExec(self)


_U64 = 0xFFFFFFFFFFFFFFFF


class AsofNowJoinExec(NodeExec):
    """Dict compute state + arrangement-backed persistence ledgers (the
    PR-7 State Ledger protocol): the right side's buffered rows and the
    per-query emitted rows mirror into two Arrangements as append-only
    deltas, so snapshots write bytes ∝ churn and recovery mmap-rebuilds
    instead of unpickling a monolith.  ``PATHWAY_STATE_ROWWISE=1``
    disables the ledgers — the monolithic ``state_dict`` pickle is the
    differential oracle for the ledger path."""

    def __init__(self, node: AsofNowJoinNode):
        super().__init__(node)
        lcols = node.inputs[0].column_names
        rcols = node.inputs[1].column_names
        self.l_on_idx = [lcols.index(c) for c in node.left_on]
        self.r_on_idx = [rcols.index(c) for c in node.right_on]
        self.n_r = len(rcols)
        # right state: jk -> {rowkey: (vals, count)}
        self.right: dict[int, dict[int, list]] = {}
        # what each left row key emitted: lk -> list[(okey, vals)]
        self.emitted_by_left: dict[int, list[tuple[int, tuple]]] = {}
        self._ledger_on = not _state_rowwise_env()
        # ledger arrangements (persistence only, never probed on the hot
        # path): right rows keyed (hashed on-cols, row key), emissions
        # keyed (left row key, output key) with exact ints in the cols
        self.arr_right = Arrangement(self.n_r)
        self.arr_emit = Arrangement(3)  # cols: [lk, okey, vals tuple]

    # --- persistence ledger ----------------------------------------------

    def _emit_ledger_ops(
        self,
        ops: list[tuple[int, int, int, tuple]],  # (lk, okey, diff, vals)
    ) -> None:
        if not ops or not self._ledger_on:
            return
        n = len(ops)
        jks = np.fromiter(
            (lk & _U64 for lk, _o, _d, _v in ops), dtype=np.uint64, count=n
        )
        keys = np.fromiter(
            (o & _U64 for _lk, o, _d, _v in ops), dtype=np.uint64, count=n
        )
        diffs = np.fromiter(
            (d for _lk, _o, d, _v in ops), dtype=np.int64, count=n
        )
        lk_col = np.empty(n, dtype=object)
        lk_col[:] = [lk for lk, _o, _d, _v in ops]
        ok_col = np.empty(n, dtype=object)
        ok_col[:] = [o for _lk, o, _d, _v in ops]
        val_col = np.empty(n, dtype=object)
        val_col[:] = [v for _lk, _o, _d, v in ops]
        self.arr_emit.append(jks, keys, diffs, [lk_col, ok_col, val_col])

    def arranged_state(self):
        if not self._ledger_on:
            return None
        residual = {
            k: v
            for k, v in self.__dict__.items()
            if k
            not in ("node", "right", "emitted_by_left", "arr_right", "arr_emit")
            and not k.startswith("_m_")
        }
        return residual, {"right": self.arr_right, "emit": self.arr_emit}

    def load_arranged_state(self, residual, arrangements) -> None:
        self.__dict__.update(residual)
        self.arr_right = arrangements["right"]
        self.arr_emit = arrangements["emit"]
        # rebuild the dict compute state; jks recomputed from the stored
        # values with the compute path's own hash, so signedness of the
        # arrangement grouping key never leaks into lookups
        self.right = {}
        rows = self.arr_right.entries()
        if len(rows):
            cols = [c.tolist() for c in rows.cols]
            keys = rows.key.tolist()
            counts = rows.count.tolist()
            for i in range(len(keys)):
                if counts[i] == 0:
                    continue
                vals = tuple(c[i] for c in cols)
                jk = int(ref_scalar(*(vals[j] for j in self.r_on_idx)))
                self.right.setdefault(jk, {})[keys[i]] = [vals, counts[i]]
        self.emitted_by_left = {}
        rows = self.arr_emit.entries()
        if len(rows):
            lks = rows.cols[0].tolist()
            okeys = rows.cols[1].tolist()
            vals_l = rows.cols[2].tolist()
            counts = rows.count.tolist()
            for i in range(len(lks)):
                if counts[i] > 0:
                    self.emitted_by_left.setdefault(int(lks[i]), []).append(
                        (int(okeys[i]), vals_l[i])
                    )
        if _state_rowwise_env():
            # env oracle: drop the ledgers, snapshot monolithically
            self._ledger_on = False
            self.arr_right = Arrangement(self.n_r)
            self.arr_emit = Arrangement(3)

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        # legacy (pre-ledger) monolith snapshot: seed the ledgers from
        # the restored dicts so the next incremental snapshot covers the
        # preexisting state instead of silently dropping it
        if (
            self._ledger_on
            and getattr(self, "arr_right", None) is not None
            and len(self.arr_right) == 0
            and (self.right or self.emitted_by_left)
        ):
            r_ops: list[tuple[int, int, tuple]] = []
            for _jk, rows in self.right.items():
                for k, (vals, c) in rows.items():
                    r_ops.append((k, c, vals))
            if r_ops:
                n = len(r_ops)
                jks = np.fromiter(
                    (
                        int(ref_scalar(*(v[i] for i in self.r_on_idx)))
                        & _U64
                        for _k, _c, v in r_ops
                    ),
                    dtype=np.uint64,
                    count=n,
                )
                keys = np.fromiter(
                    (k & _U64 for k, _c, _v in r_ops),
                    dtype=np.uint64,
                    count=n,
                )
                diffs = np.fromiter(
                    (c for _k, c, _v in r_ops), dtype=np.int64, count=n
                )
                cols = []
                for ci in range(self.n_r):
                    col = np.empty(n, dtype=object)
                    col[:] = [v[ci] for _k, _c, v in r_ops]
                    cols.append(col)
                self.arr_right.append(jks, keys, diffs, cols)
            e_ops = [
                (lk, okey, 1, vals)
                for lk, emitted in self.emitted_by_left.items()
                for okey, vals in emitted
            ]
            self._emit_ledger_ops(e_ops)

    def process(self, t, inputs):
        # right updates first: queries arriving at tick T see right state of T
        for b in inputs[1]:
            n = len(b)
            if n and self._ledger_on:
                # the right ledger IS the input delta: append verbatim
                cols = list(b.columns.values())
                self.arr_right.append(
                    ref_scalars_columns(
                        [cols[i] for i in self.r_on_idx], n
                    ),
                    b.keys,
                    b.diffs,
                    cols,
                )
            for k, d, vals in b.iter_rows():
                jk = int(ref_scalar(*(vals[i] for i in self.r_on_idx)))
                rows = self.right.setdefault(jk, {})
                e = rows.get(k)
                if e is None:
                    if d != 0:
                        rows[k] = [vals, d]
                else:
                    e[1] += d
                    if d > 0:
                        e[0] = vals
                    if e[1] <= 0:
                        del rows[k]
                if not rows:
                    self.right.pop(jk, None)
        out_rows: list[tuple[int, int, tuple]] = []
        ledger_ops: list[tuple[int, int, int, tuple]] = []
        for b in inputs[0]:
            for lk, d, lvals in b.iter_rows():
                if d < 0:
                    for okey, vals in self.emitted_by_left.pop(lk, []):
                        out_rows.append((okey, -1, vals))
                        ledger_ops.append((lk, okey, -1, vals))
                    continue
                jk = int(ref_scalar(*(lvals[i] for i in self.l_on_idx)))
                rrows = self.right.get(jk, {})
                emitted: list[tuple[int, tuple]] = []
                use_lk = self.node.id_from == "left"
                # a re-insert replaces this query's previous emissions in
                # the dict — mirror the replacement into the ledger
                for okey, vals in self.emitted_by_left.get(lk, ()):
                    ledger_ops.append((lk, okey, -1, vals))
                if use_lk and len(rrows) > 1:
                    # id=left.id promises ONE output row per query row; two
                    # matches would silently collapse under the same key.
                    # Recorded (not raised) so non-terminate_on_error runs
                    # keep going with the row poisoned/skipped, matching
                    # GroupByExec's reducer-error contract; terminate_on_
                    # error runs re-raise it as a ValueError when the run
                    # terminates (like every recorded error, it does not
                    # abort an unbounded stream mid-run).
                    record_error(
                        ValueError(
                            "asof_now_join with id=pw.left.id: query row "
                            f"matched {len(rrows)} rows; the id contract "
                            "requires at most one match per query"
                        ),
                        str(self.node),
                    )
                    self.emitted_by_left[lk] = []
                    continue
                if rrows:
                    for rk, (rvals, _c) in rrows.items():
                        okey = lk if use_lk else int(
                            ref_scalar(Pointer(lk), Pointer(rk))
                        )
                        vals = lvals + rvals + (Pointer(lk), Pointer(rk))
                        emitted.append((okey, vals))
                elif self.node.mode == "left":
                    vals = lvals + (None,) * self.n_r + (Pointer(lk), None)
                    emitted.append((lk, vals))
                for okey, vals in emitted:
                    out_rows.append((okey, 1, vals))
                    ledger_ops.append((lk, okey, 1, vals))
                self.emitted_by_left[lk] = emitted
        self._emit_ledger_ops(ledger_ops)
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]
