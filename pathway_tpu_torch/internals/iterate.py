"""The port's own copy of ``pathway_tpu/internals/iterate.py``. In a
process group ``IterateNode.make_exec`` builds ``engine/dcn.py``'s
``DcnIterateExec`` (the fixpoint runs on process 0). A depth's inner runtime
keeps its own Tick Scope recorder and does not replace the outer runtime's
as the process's published one (``tickscope.recorder()``).

pw.iterate — fixed-point iteration
(reference: internals/common.py:39 pw.iterate; engine iterate,
src/engine/dataflow.rs:4185-4282).

Engine strategy: a persistent inner runtime PER ITERATION DEPTH, fed
by DIFF batches — the microbatch realization of differential's nested
product-order scopes ((outer time, iteration) lexicographic). Depth-i's
runtime holds the incremental state of the i-th body application; an
outer delta touching d rows flows down the depth chain as diff batches,
costing O(d · depths-reached) instead of O(n · iters) per tick:

  - per-depth consumed-pointer logs (xlog/blog) let a depth that was
    skipped on earlier ticks (early convergence) catch up with exactly
    the accumulated diffs when a later tick reaches it;
  - fixpoint detection is incremental: neq[i] tracks the keys where
    X_i != X_{i-1}, updated only for keys touched this tick — all-empty
    means the sequence is self-converged at depth i;
  - if the incoming diff dies out at depth i (nothing to inject and the
    depth's cache matches), every deeper value is unchanged from the
    previous tick, so the previous fixpoint stands (emit nothing).

The outer input state is still mirrored in MultisetStates so persistence
can snapshot the exec (inner runtimes are not picklable); on restore the
depth chain reseeds from the full snapshot on the next tick.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.batch import DiffBatch, MultisetState, _values_eq
from pathway_tpu_torch.engine.nodes import InputNode, Node, NodeExec, OutputNode
from pathway_tpu_torch.engine.runtime import Runtime, StaticSource
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.observability import tickscope


class _PlaceholderSource(StaticSource):
    def events(self):
        return []


class IterateNode(Node):
    def __init__(
        self,
        outer_inputs: list[Node],
        placeholder_nodes: list[InputNode],
        boundary_proxies: list[InputNode],
        result_nodes: dict[str, Node],
        iterated_names: list[str],
        out_name: str,
        iteration_limit: int | None,
    ):
        # inputs = initial iterated tables, then boundary outer tables the
        # body reads (their diffs stream in from the OUTER runtime; inside
        # the body they are injected as frozen snapshots via proxies)
        # canonical column order = the PLACEHOLDER (input) order: bodies
        # may reorder columns in their selects, and every feedback path
        # (value store, logs, injection) indexes tuples positionally
        out_idx = iterated_names.index(out_name)
        ph_cols = placeholder_nodes[out_idx].column_names
        out_cols = result_nodes[out_name].column_names
        super().__init__(
            outer_inputs,
            ph_cols if set(ph_cols) == set(out_cols) else out_cols,
        )
        self.placeholder_nodes = placeholder_nodes
        self.boundary_proxies = boundary_proxies
        self.result_nodes = result_nodes
        self.iterated_names = iterated_names
        self.out_name = out_name
        self.iteration_limit = iteration_limit

    def _make_local_exec(self):
        return IterateExec(self)

    def make_exec(self):
        if getattr(self, "_dcn", False):
            from pathway_tpu_torch.engine.dcn import DcnIterateExec

            return DcnIterateExec(self)
        return self._make_local_exec()


class _Depth:
    """One iteration depth: a persistent inner runtime computing the
    (i+1)-th sequence element from diffs of the i-th, plus its bookkeeping
    (consumed-log pointers, captured output value, this-tick deltas)."""

    def __init__(self, node: IterateNode):
        self.node = node
        # captured CURRENT value of every result table at this depth
        self.value: dict[str, dict[int, tuple]] = {
            name: {} for name in node.result_nodes
        }
        # diffs captured during the current tick() only
        self.tick_out: dict[str, list[DiffBatch]] = {}
        outputs = []

        ph_order = {
            name: node.placeholder_nodes[i].column_names
            for i, name in enumerate(node.iterated_names)
        }

        def make_cb(name):
            def cb(t, batch: DiffBatch):
                # canonicalize to placeholder column order: feedback and
                # value stores index tuples positionally
                wanted = ph_order.get(name)
                if wanted is not None and set(wanted) == set(batch.columns):
                    if list(batch.columns) != wanted:
                        batch = DiffBatch(
                            keys=batch.keys,
                            diffs=batch.diffs,
                            columns={n: batch.columns[n] for n in wanted},
                        )
                self.tick_out.setdefault(name, []).append(batch)
                store = self.value[name]
                for k, d, vals in batch.iter_rows():
                    if d > 0:
                        store[k] = vals
                    else:
                        store.pop(k, None)

            return cb

        for name, rnode in node.result_nodes.items():
            outputs.append(OutputNode(rnode, make_cb(name)))
        # inner runtimes are driven via tick() directly; no worker pool,
        # never part of the cross-process lockstep cadence; the recorder
        # the process publishes stays the outer runtime's
        published = tickscope.recorder()
        try:
            self.runtime = Runtime(outputs, worker_threads=False, distributed=False)
        finally:
            tickscope.publish_recorder(published)
        # on_end-dependent operators (temporal buffers) cannot live in a
        # persistent per-depth runtime: there is no final tick to flush
        # them, so rows would be silently held forever — refuse loudly
        for ex in self.runtime.execs.values():
            if type(ex).__name__ in ("BufferExec", "ForgetExec", "FreezeExec"):
                raise NotImplementedError(
                    "temporal buffer/forget/freeze operators inside a "
                    "pw.iterate body are not supported by the incremental "
                    "iterate engine (no final flush tick inside the "
                    "fixpoint loop)"
                )
        self.time = 0
        self.xptr: dict[str, int] = {}  # consumed xlog prefix, per name
        self.bptr = 0  # consumed prefix of the boundary log

    def run(
        self,
        x_batches: dict[int, list[DiffBatch]],
        b_batches: dict[int, list[DiffBatch]],
    ) -> dict[str, list[DiffBatch]]:
        self.tick_out = {}
        injected = dict(x_batches)
        injected.update(b_batches)
        self.runtime.tick(self.time, injected)
        self.time += 1
        return self.tick_out


class IterateExec(NodeExec):
    def __init__(self, node: IterateNode):
        super().__init__(node)
        self.states = [
            MultisetState(inp.column_names) for inp in node.inputs
        ]
        self.emitted: dict[int, tuple] = {}
        self._depths: list[_Depth] = []
        # xlog[i] = every diff batch ever produced for sequence element i
        # (i=0: outer input diffs; i>0: depth i-1 output diffs), so a depth
        # skipped by early convergence can catch up later via its xptr
        self._xlog: list[dict[str, list[DiffBatch]]] = []
        self._blog: list[dict[int, list[DiffBatch]]] = []  # boundary diffs
        # neq[i][name] = keys where X_i differs from X_{i-1} (all empty =
        # self-converged at depth i); updated only for touched keys
        self._neq: list[dict[str, set]] = []
        self._v0: dict[str, dict[int, tuple]] = {
            name: {} for name in node.iterated_names
        }
        self._final_depth: int | None = None
        self._needs_reseed = False

    # --- persistence: inner runtimes are rebuilt, not pickled -------------

    def state_dict(self) -> dict | None:
        return {
            "states": self.states,
            "emitted": self.emitted,
            "_needs_reseed": True,
        }

    def load_state(self, state: dict) -> None:
        self.states = state["states"]
        self.emitted = state["emitted"]
        self._needs_reseed = True

    # --- incremental fixpoint --------------------------------------------

    def _depth(self, i: int) -> _Depth:
        while len(self._depths) <= i:
            self._depths.append(_Depth(self.node))
            self._xlog.append({n: [] for n in self.node.iterated_names})
            self._neq.append({n: set() for n in self.node.iterated_names})
        return self._depths[i]

    def _value_at(self, i: int, name: str) -> dict[int, tuple]:
        """X_i: the i-th sequence element (0 = outer input mirror)."""
        if i == 0:
            return self._v0[name]
        return self._depths[i - 1].value[name]

    def _update_neq(self, i: int, name: str, touched) -> None:
        """Re-evaluate X_i vs X_{i-1} equality for the touched keys only.
        Stored in _neq[i-1] (convention: _neq[j] compares X_{j+1} vs X_j,
        created alongside depth j)."""
        if i < 1:
            return
        self._depth(i - 1)
        lo = self._value_at(i - 1, name)
        hi = self._value_at(i, name)
        neq = self._neq[i - 1][name]
        for k in touched:
            a = lo.get(k)
            b = hi.get(k)
            if (a is None) != (b is None) or (
                a is not None and not _values_eq(a, b)
            ):
                neq.add(k)
            else:
                neq.discard(k)

    def _converged_at(self, i: int) -> bool:
        """True when X_{i+1} == X_i (depth i's output equals its input)."""
        return all(not s for s in self._neq[i].values())

    def process(self, t, inputs):
        node = self.node
        n_iter = len(node.iterated_names)
        touched_any = False
        for state, batches in zip(self.states, inputs):
            for b in batches:
                if len(b):
                    touched_any = True
                state.apply(b)
        if self._needs_reseed:
            # after a persistence restore the depth chain is empty: feed
            # the full mirrored state through it once
            self._needs_reseed = False
            self._depths = []
            self._xlog = []
            self._blog = []
            self._neq = []
            self._v0 = {n: {} for n in node.iterated_names}
            seed: list[DiffBatch] = []
            for idx, (name, state) in enumerate(
                zip(node.iterated_names, self.states[:n_iter])
            ):
                rows = [(k, 1, e[0]) for k, e in state.rows.items()]
                ncols = node.placeholder_nodes[idx].column_names
                seed.append(DiffBatch.from_rows(rows, ncols))
            inputs = [[b] for b in seed] + [
                [
                    DiffBatch.from_rows(
                        [(k, 1, e[0]) for k, e in state.rows.items()],
                        proxy.column_names,
                    )
                ]
                for state, proxy in zip(
                    self.states[n_iter:], node.boundary_proxies
                )
            ]
            touched_any = True
        if not touched_any:
            return []

        # stage this tick's outer diffs into the logs + the V0 mirror
        out_touched: set[int] = set()
        self._depth(0)
        x0 = self._xlog[0]
        v0_touched: dict[str, set] = {}
        for idx, name in enumerate(node.iterated_names):
            batches = [b for b in inputs[idx] if len(b)]
            x0[name].extend(batches)
            mirror = self._v0[name]
            tk = v0_touched.setdefault(name, set())
            for b in batches:
                for k, d, vals in b.iter_rows():
                    tk.add(k)
                    if d > 0:
                        mirror[k] = vals
                    else:
                        mirror.pop(k, None)
        bdiffs: dict[int, list[DiffBatch]] = {}
        for bidx, proxy in enumerate(node.boundary_proxies):
            batches = [b for b in inputs[n_iter + bidx] if len(b)]
            if batches:
                bdiffs.setdefault(proxy.id, []).extend(batches)
        self._blog.append(bdiffs)
        for name, tk in v0_touched.items():
            self._update_neq(1, name, tk)

        limit = node.iteration_limit or 1000
        prev_final_depth = self._final_depth
        converged_depth: int | None = None
        i = 0
        # walk the depth chain. Before convergence, new depths are created
        # as diffs demand them; after convergence, EXISTING deeper depths
        # are still drained (their backlogs consumed) so every per-depth
        # log can be truncated each tick — memory stays bounded by one
        # tick's churn, not total history.
        while i < limit:
            if i >= len(self._depths) and converged_depth is not None:
                break
            depth = self._depth(i)
            fresh = depth.time == 0
            xlog_i = self._xlog[i]
            x_pending: dict[int, list[DiffBatch]] = {}
            if fresh:
                # a fresh depth seeds from the CURRENT value of X_i (the
                # consolidated equivalent of the full history) instead of
                # the log — logs can therefore be truncated aggressively
                for idx, name in enumerate(node.iterated_names):
                    rows = [
                        (k, 1, v) for k, v in self._value_at(i, name).items()
                    ]
                    ncols = node.placeholder_nodes[idx].column_names
                    if rows:
                        x_pending[node.placeholder_nodes[idx].id] = [
                            DiffBatch.from_rows(rows, ncols)
                        ]
                    depth.xptr[name] = len(xlog_i[name])
                b_pending: dict[int, list[DiffBatch]] = {}
                for state, proxy in zip(
                    self.states[n_iter:], node.boundary_proxies
                ):
                    rows = [(k, 1, e[0]) for k, e in state.rows.items()]
                    if rows:
                        b_pending[proxy.id] = [
                            DiffBatch.from_rows(rows, proxy.column_names)
                        ]
                depth.bptr = len(self._blog)
            else:
                for idx, name in enumerate(node.iterated_names):
                    tail = xlog_i[name][depth.xptr.get(name, 0) :]
                    if tail:
                        x_pending[node.placeholder_nodes[idx].id] = tail
                    depth.xptr[name] = len(xlog_i[name])
                b_pending = {}
                for blog_entry in self._blog[depth.bptr :]:
                    for pid_, bs in blog_entry.items():
                        b_pending.setdefault(pid_, []).extend(bs)
                depth.bptr = len(self._blog)
            if not x_pending and not b_pending:
                # the delta died out: X_j unchanged from the previous tick
                # for every j >= i, and no deeper depth has backlog either
                # (boundary diffs fan out to every depth, X diffs chain
                # contiguously) — the previous fixpoint stands
                break
            out = depth.run(x_pending, b_pending)
            # record depth output diffs into the next depth's log + neq
            # (unless this is the last depth we will touch: a fresh depth
            # created later seeds from the value, which already includes
            # these diffs)
            if i + 1 < len(self._depths) or converged_depth is None:
                self._depth(i + 1)
                next_log = self._xlog[i + 1]
            else:
                next_log = None
            for name in node.iterated_names:
                produced = [b for b in out.get(name, []) if len(b)]
                if next_log is not None:
                    next_log[name].extend(produced)
                tk = set()
                for b in produced:
                    tk.update(b.keys.tolist())
                if tk:
                    self._update_neq(i + 1, name, tk)
                    if len(self._depths) >= i + 2:
                        self._update_neq(i + 2, name, tk)
            for b in out.get(node.out_name, []):
                out_touched.update(b.keys.tolist())
            if converged_depth is None and self._converged_at(i):
                converged_depth = i
            i += 1
        if converged_depth is not None:
            final_depth = converged_depth
        elif i >= limit:
            final_depth = limit - 1  # iteration_limit semantics: X_limit
        else:
            final_depth = prev_final_depth  # delta died out: unchanged
        # every existing depth has now consumed its full backlog: truncate
        # the logs and drop far-beyond-convergence depths (recreated from
        # value seeds if ever needed again)
        for d_i, depth in enumerate(self._depths):
            log = self._xlog[d_i]
            for name in node.iterated_names:
                consumed = depth.xptr.get(name, 0)
                if consumed:
                    del log[name][:consumed]
                    depth.xptr[name] = 0
            depth.bptr = 0
        self._blog.clear()
        if final_depth is not None and len(self._depths) > final_depth + 4:
            del self._depths[final_depth + 4 :]
            del self._xlog[final_depth + 4 :]
            del self._neq[final_depth + 4 :]
        self._final_depth = final_depth

        # emit the fixpoint's delta vs what we last emitted, checking only
        # keys touched this tick (untouched keys keep their old fixpoint)
        if final_depth is None:
            return []
        final = self._depths[final_depth].value[node.out_name]
        candidates = set(out_touched)
        if prev_final_depth != final_depth:
            # the converged depth moved: values at both depths are the
            # fixpoints, but re-check everything that differs between them
            candidates.update(final.keys())
            candidates.update(self.emitted.keys())
        out_rows = []
        for k in candidates:
            old = self.emitted.get(k)
            neww = final.get(k)
            if old is not None and (
                neww is None or not _values_eq(old, neww)
            ):
                out_rows.append((k, -1, old))
                del self.emitted[k]
                old = None
            if neww is not None and old is None:
                out_rows.append((k, 1, neww))
                self.emitted[k] = neww
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, node.column_names)]


def iterate(
    func: Callable,
    iteration_limit: int | None = None,
    **kwargs: Table,
) -> Any:
    """Iterate ``func`` to a fixed point.

    ``func`` receives tables (as keyword args) and returns a Table or a dict /
    namespace of Tables with the same keys; those are fed back until stable.

    Limitation: temporal ``buffer`` / ``forget`` / ``freeze`` operators
    (windowby behaviors, ``_buffer`` time-column cutoffs) are not supported
    inside the iterate body and raise ``NotImplementedError`` at build time
    — the incremental fixpoint engine keeps per-depth runtimes alive across
    ticks, so there is no final flush tick that would release buffered rows.
    Apply temporal behaviors before or after the ``iterate`` instead.
    """
    if iteration_limit is not None and iteration_limit < 1:
        raise ValueError("wrong iteration limit")
    iterated_names = list(kwargs.keys())
    placeholders: list[InputNode] = []
    ph_tables: dict[str, Table] = {}
    for name, tbl in kwargs.items():
        ph = InputNode(
            _PlaceholderSource(tbl.column_names()), tbl.column_names()
        )
        placeholders.append(ph)
        ph_tables[name] = Table._from_node(
            ph,
            {n: tbl._schema[n].dtype for n in tbl.column_names()},
            Universe(),
        )
    result = func(**ph_tables)
    if isinstance(result, Table):
        result_map = {iterated_names[0]: result}
        single = True
    elif isinstance(result, dict):
        result_map = result
        single = False
    else:  # namedtuple-ish
        result_map = {
            name: getattr(result, name) for name in iterated_names
        }
        single = False
    result_nodes = {name: tbl._node for name, tbl in result_map.items()}

    # Cut the body graph at the placeholder-downstream boundary: any node
    # the body reads that is NOT downstream of a placeholder belongs to the
    # outer graph (e.g. the edges table of pagerank/louvain). It must not be
    # re-executed inside the body runtime (its execs there would be empty) —
    # instead it becomes an extra IterateNode input whose consolidated state
    # is injected into a proxy InputNode on every body run.
    # (reference analog: differential `iterate` closes over outer-scope
    # collections via `enter`, external/differential-dataflow iterate.rs)
    ph_ids = {ph.id for ph in placeholders}
    downstream_memo: dict[int, bool] = {}

    def downstream(node: Node) -> bool:
        if node.id in ph_ids:
            return True
        if node.id in downstream_memo:
            return downstream_memo[node.id]
        downstream_memo[node.id] = False  # DAG: safe guard
        r = any(downstream(i) for i in node.inputs)
        downstream_memo[node.id] = r
        return r

    topo: list[Node] = []
    visited: set[int] = set()

    def visit(n: Node):
        if n.id in visited:
            return
        visited.add(n.id)
        for i in n.inputs:
            visit(i)
        topo.append(n)

    for rn in result_nodes.values():
        visit(rn)
    boundary_nodes: list[Node] = []
    proxies: dict[int, InputNode] = {}
    for n in topo:
        if not downstream(n) or n.id in ph_ids:
            continue
        for idx, i in enumerate(n.inputs):
            if downstream(i):
                continue
            proxy = proxies.get(i.id)
            if proxy is None:
                proxy = InputNode(
                    _PlaceholderSource(i.column_names), i.column_names
                )
                proxies[i.id] = proxy
                boundary_nodes.append(i)
            n.inputs[idx] = proxy
    boundary_proxies = [proxies[b.id] for b in boundary_nodes]

    outer_nodes = [tbl._node for tbl in kwargs.values()]
    out_tables = {}
    for out_name, rtbl in result_map.items():
        it_node = IterateNode(
            outer_nodes + boundary_nodes,
            placeholders,
            boundary_proxies,
            result_nodes,
            iterated_names,
            out_name,
            iteration_limit,
        )
        out_tables[out_name] = Table._from_node(
            it_node,
            # the node may canonicalize to the placeholder column order
            {n: rtbl._schema[n].dtype for n in it_node.column_names},
            Universe(),
        )
    if single:
        return out_tables[iterated_names[0]]
    import types

    return types.SimpleNamespace(**out_tables)


def iterate_universe(arg: Any = None, **kwargs: Table) -> Any:
    """`pw.iterate_universe(table)` marks an iterated table whose key set
    changes across iterations (reference: iterate_universe). The
    incremental engine handles changing universes natively, so the marker
    is a passthrough; the legacy callable form aliases iterate()."""
    if callable(arg):
        return iterate(arg, **kwargs)
    return arg
