"""Microbatch runtime: the tick loop — the port's own copy of
``pathway_tpu/engine/runtime.py``: scheduling (topological order, the
per-level worker pool), autocommit, streaming and static runs, the stop
path, metrics, spans and the fault plan, as in the reference.

Under an engine mesh (``set_engine_mesh`` or ``PATHWAY_ENGINE_SHARDS`` > 1,
``parallel/mesh.py``) the stateful operators shard their keyed state
(``engine/sharded.py``) and every tick ends with the frontier consensus, a
min-all-reduce over the shards (``frontier_syncs``). Not ported, and
raising ``NotImplementedError`` rather than running without it: the
multi-process engine (``PATHWAY_PROCESSES`` > 1; [mesh]). Every tick lands
in the runtime's Tick Scope recorder (``observability/tickscope.py``), as
in the reference.

The reference's design: a replacement for the timely worker main loop
(upstream Pathway: src/engine/dataflow.rs:5962-6173): instead of N OS worker
threads stepping a distributed dataflow, one driver advances a totally-ordered
logical clock (u64 ms, like the reference's src/engine/timestamp.rs). Each tick
drains connector sessions, then pushes columnar diff batches through the node
graph in topological order. Device-heavy nodes (embedders, indexes) run
their work on the card inside their operator.
"""

from __future__ import annotations

import os
import threading
import time as _time
from typing import Any, Callable, Iterable, Sequence

from pathway_tpu_torch._unported import MESH, unported
from pathway_tpu_torch.engine.batch import END_OF_TIME, DiffBatch
import concurrent.futures as _cf

from pathway_tpu_torch.engine.nodes import (
    InputExec,
    InputNode,
    Node,
    NodeExec,
    OutputNode,
)


def annotate_live_columns(order: Sequence[Node]) -> None:
    """Backward column-liveness pass: sets node._live_cols to the set of
    output columns any consumer may read, or None for "all" (the safe
    default). Lets JoinExec skip materializing the `_left_id`/`_right_id`
    Pointer columns on bulk ticks when no downstream expression references
    them — per-row Pointer boxing dominated the bulk join profile
    (reference analog: differential's arrangements never materialize
    unused columns either; they are demand-built from traces)."""
    from pathway_tpu_torch.engine.expression_eval import InternalColRef
    from pathway_tpu_torch.engine.nodes import FilterNode, RowwiseNode

    live: dict[int, set | None] = {n.id: set() for n in order}

    def demand(node: Node, cols: set | None) -> None:
        if cols is None:
            live[node.id] = None
        elif live[node.id] is not None:
            live[node.id] |= cols  # type: ignore[operator]

    def expr_refs(exprs, n_inputs: int) -> list[set]:
        sets: list[set] = [set() for _ in range(n_inputs)]

        def walk(e):
            if isinstance(e, InternalColRef):
                if e._name != "id" and 0 <= e._input_index < n_inputs:
                    sets[e._input_index].add(e._name)
                return
            for c in e._children:
                walk(c)

        for e in exprs:
            walk(e)
        return sets

    # roots (no consumers in `order`) may be captured externally: all live
    has_consumer = {inp.id for node in order for inp in node.inputs}
    for node in order:
        if node.id not in has_consumer:
            live[node.id] = None

    for node in reversed(order):
        if isinstance(node, RowwiseNode):
            per_input = expr_refs(node.exprs.values(), len(node.inputs))
            for pos, inp in enumerate(node.inputs):
                demand(inp, per_input[pos])
        elif isinstance(node, FilterNode):
            refs = expr_refs([node.predicate], 1)[0]
            own = live[node.id]
            demand(
                node.inputs[0], None if own is None else (refs | own)
            )
        else:
            for inp in node.inputs:
                demand(inp, None)

    for node in order:
        # merge with any annotation from another Runtime over the same
        # graph nodes (interactive mode builds overlapping runtimes):
        # liveness only ever widens, so concurrent annotation can cost
        # optimization but never correctness
        prev = getattr(node, "_live_cols", ())
        new = live[node.id]
        if prev is None or new is None:
            node._live_cols = None
        elif prev == ():  # never annotated
            node._live_cols = new
        else:
            node._live_cols = prev | new


def collect_nodes(outputs: Sequence[Node]) -> list[Node]:
    """Tree-shake + topological order (inputs first)."""
    order: list[Node] = []
    seen: set[int] = set()

    def visit(node: Node):
        if node.id in seen:
            return
        seen.add(node.id)
        for inp in node.inputs:
            visit(inp)
        order.append(node)

    for out in outputs:
        visit(out)
    return order


class InputSession:
    """Thread-safe staging area connector threads feed
    (reference: InputSession/UpsertSession, src/connectors/adaptors.rs:27-42;
    the mpsc sender + poller pattern of src/connectors/mod.rs:426)."""

    # priority classes (Surge Gate): 0 = interactive serving queries,
    # 1 = bulk ingest/backfill. When an interactive session has data,
    # the streaming loop defers draining bulk sessions for a bounded
    # number of ticks so query latency is not paid behind a backfill.
    PRIORITY_INTERACTIVE = 0
    PRIORITY_BULK = 1

    def __init__(self, column_names: Sequence[str]):
        self.column_names = list(column_names)
        self.priority = self.PRIORITY_BULK
        self._lock = threading.Lock()
        self._rows: list[tuple[int, int, tuple]] = []
        self._upserts: dict[int, tuple | None] = {}
        self._last_upserted: dict[int, tuple] = {}
        self.finished = False
        self._wake: Callable[[], None] | None = None
        # offset marker protocol: a source may enqueue its offset snapshot
        # atomically WITH the rows it covers (insert_batch); drain() then
        # surfaces the marker only once those rows have left the session, so
        # persisted offsets can never run ahead of the logged input
        # (reference: offsets recorded under the same frontier as the input
        # snapshot, src/persistence/state.rs + src/connectors/offset.rs)
        self._pending_offsets: Any = None
        self.last_offsets: Any = None

    def hot(self) -> bool:
        """Data pending now, or (for gated sessions) queued upstream in
        the micro-batcher and about to land."""
        if self.has_data():
            return True
        backlog = getattr(self, "backlog", None)
        return backlog is not None and backlog() > 0

    def insert(self, key: int, values: tuple) -> None:
        with self._lock:
            self._rows.append((key, 1, values))
        self._notify()

    def remove(self, key: int, values: tuple) -> None:
        with self._lock:
            self._rows.append((key, -1, values))
        self._notify()

    def upsert(self, key: int, values: tuple | None) -> None:
        """None value = delete (reference: UpsertSession)."""
        with self._lock:
            self._upserts[key] = values
        self._notify()

    def insert_batch(
        self, rows: Iterable[tuple[int, int, tuple]], offsets: Any = None
    ) -> None:
        """Atomically enqueue a group of rows plus the offset snapshot that
        covers them — one drain observes both or neither."""
        with self._lock:
            self._rows.extend(rows)
            if offsets is not None:
                self._pending_offsets = offsets
        self._notify()

    def close(self) -> None:
        with self._lock:
            self.finished = True
        self._notify()

    def _notify(self):
        if self._wake is not None:
            self._wake()

    def has_data(self) -> bool:
        with self._lock:
            return bool(self._rows) or bool(self._upserts)

    def drain(
        self, max_rows: int | None = None
    ) -> list[tuple[int, int, tuple]]:
        """Take pending rows. ``max_rows`` bounds the take (Surge Gate
        bulk chunking: a backfill burst must not block a serving tick
        longer than one chunk) — a partial drain returns a prefix of the
        row log (then a bounded slice of pending upserts) and leaves the
        offset marker pending, so persisted offsets can never run ahead
        of ticked input."""
        with self._lock:
            partial = max_rows is not None and (
                len(self._rows) + len(self._upserts) > max_rows
            )
            if partial:
                take = min(len(self._rows), max_rows)
                rows = self._rows[:take]
                self._rows = self._rows[take:]
                upserts: dict[int, tuple | None] = {}
                if not self._rows:
                    # row log exhausted: spend the remaining budget on
                    # upserts (insertion order) so upsert-fed bulk
                    # sources are chunk-bounded too
                    for k in list(self._upserts)[: max_rows - take]:
                        upserts[k] = self._upserts.pop(k)
            else:
                rows = self._rows
                self._rows = []
                upserts = self._upserts
                self._upserts = {}
                if self._pending_offsets is not None:
                    self.last_offsets = self._pending_offsets
                    self._pending_offsets = None
        for k, vals in upserts.items():
            old = self._last_upserted.get(k)
            if old is not None:
                rows.append((k, -1, old))
            if vals is not None:
                rows.append((k, 1, vals))
                self._last_upserted[k] = vals
            else:
                self._last_upserted.pop(k, None)
        return rows


class StaticSource:
    """Bounded source with explicit event times (test fixtures, files read
    once)."""

    def __init__(self, column_names: Sequence[str]):
        self.column_names = list(column_names)

    def events(self) -> Iterable[tuple[int, DiffBatch]]:
        raise NotImplementedError


class StreamingSource:
    """Unbounded (or long-running) source: runs a thread feeding an
    InputSession."""

    def __init__(self, column_names: Sequence[str]):
        self.column_names = list(column_names)
        self.session = InputSession(column_names)

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass



def _dcn_requested() -> bool:
    """True when the reference's env contract asks for a multi-process
    engine group (``PATHWAY_PROCESSES`` > 1, ``PATHWAY_DCN`` not 0)."""
    n = int(os.environ.get("PATHWAY_PROCESSES", "1") or 1)
    return n > 1 and os.environ.get("PATHWAY_DCN", "1") != "0"


def refuse_unported_fabric(distributed: bool = True) -> None:
    """Raise naming [mesh] when the env asks for an exchange fabric the
    port does not run: a multi-process engine group (checked unless
    ``distributed`` is False, as for an inner runtime). The ``Runtime`` and
    ``parallel.exchange_topology`` both refuse through it rather than run,
    or describe, a single process."""
    if distributed and _dcn_requested():
        raise unported("the multi-process engine (PATHWAY_PROCESSES>1)", MESH)

class RuntimeStats:
    """Prober-style counters (reference: ProberStats src/engine/graph.rs:533,
    connector monitors src/connectors/monitoring.rs) — fed to the
    Prometheus endpoint and the TUI monitor."""

    def __init__(self):
        self.ticks = 0
        self.current_time = 0
        self.rows_in: dict[int, int] = {}  # input node id -> rows ingested
        self.rows_out: dict[int, int] = {}  # output node id -> rows emitted
        self.node_rows: dict[int, int] = {}  # node id -> rows produced
        self.node_ns: dict[int, int] = {}  # node id -> cumulative process ns
        self.last_tick_ns = 0
        self.started_at = _time.time()

    def snapshot(self) -> dict:
        return {
            "ticks": self.ticks,
            "current_time": self.current_time,
            "rows_in_total": sum(self.rows_in.values()),
            "rows_out_total": sum(self.rows_out.values()),
            "last_tick_ns": self.last_tick_ns,
            "uptime_s": _time.time() - self.started_at,
        }


class Runtime:
    def __init__(
        self,
        outputs: Sequence[Node],
        *,
        autocommit_ms: int = 50,
        on_tick: Callable[[int], None] | None = None,
        worker_threads: bool = True,
        distributed: bool | None = None,
    ):
        self.order = collect_nodes(outputs)
        # error-log nodes (and everything downstream of them) run LAST:
        # at the final tick every other node processes + flushes first, so
        # the log drain sees final-tick errors and its consumers' on_end
        # callbacks still fire after their last on_change (stable
        # partition — moved nodes only consume already-processed outputs)
        _late = set()
        for node in self.order:
            if type(node).__name__ == "ErrorLogNode" or any(
                inp.id in _late for inp in node.inputs
            ):
                _late.add(node.id)
        if _late:
            self.order = [n for n in self.order if n.id not in _late] + [
                n for n in self.order if n.id in _late
            ]
        annotate_live_columns(self.order)
        # the multi-process engine (reference: stateful execs exchange host
        # rows over a TCP mesh, ticks in lockstep across the process group)
        # is not ported; it raises rather than run each process alone.
        # Inner runtimes pass distributed=False.
        refuse_unported_fabric(distributed is not False)
        # engine-level mesh sharding: the stateful execs shard (their
        # _make_local_exec reads the same mesh) and the per-tick frontier
        # consensus is a min-all-reduce over the shards
        from pathway_tpu_torch.parallel.mesh import get_engine_mesh

        self.engine_mesh = get_engine_mesh()
        self.global_frontier = 0
        self.frontier_syncs = 0
        self._frontier_base: int | None = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.execs: dict[int, NodeExec] = {
            node.id: node.make_exec() for node in self.order
        }
        # Tick Forge: run stateless operator chains as torch programs on
        # the compiled device (engine/compile.py). Off unless
        # PATHWAY_COMPILED_TICK=1; then a missing card raises here. Other
        # planning failures are never fatal — the interpreter path below
        # is always complete.
        from pathway_tpu_torch.engine import compile as _compile

        self.compiled_plan = None
        if _compile.compiled_tick_enabled():
            _compile.compiled_device()
            try:
                self.compiled_plan = _compile.plan_segments(self.order, self.execs)
            except Exception:
                import logging

                logging.getLogger("pathway_tpu_torch").warning(
                    "compiled-tick planning failed; running interpreted",
                    exc_info=True,
                )
        self.autocommit_ms = autocommit_ms
        self.on_tick = on_tick
        self.current_time = 0
        self._tick_count = 0
        self.stats = RuntimeStats()
        has_consumer = {inp.id for node in self.order for inp in node.inputs}
        self._sinks = [n for n in self.order if n.id not in has_consumer]
        # OTLP operator-latency histogram (no-op without a metrics SDK)
        from pathway_tpu_torch.internals.telemetry import get_metrics

        self._otel_metrics = get_metrics()
        self._otel_on = self._otel_metrics.enabled
        self._node_names = {n.id: type(n).__name__ for n in self.order}
        # Flight Recorder: per-operator tick-time histogram on the
        # process-wide registry (labels prebound per node — the per-tick
        # cost is one lock + bisect; idle autocommit ticks are skipped so
        # ~0-sample ticks don't swamp the distribution). The `/metrics`
        # endpoint serves these as pathway_operator_tick_seconds_bucket.
        from pathway_tpu_torch.observability import REGISTRY
        from pathway_tpu_torch.observability.registry import log_linear_buckets

        # sub-millisecond floor (1 us): Tick Forge compiled ticks finish
        # in 10-100 us — the registry's default 0.1 ms floor flattened
        # them all into the lowest bucket, hiding the 2.5-4.7x speedup
        # from every quantile
        _tick_hist = REGISTRY.histogram(
            "pathway_operator_tick_seconds",
            "per-operator processing time per tick that moved rows, "
            "by operator type",
            labelnames=("operator",),
            buckets=log_linear_buckets(lo=1e-6, hi=64.0, per_octave=4),
        )
        self._tick_hist_children = {
            n.id: _tick_hist.labels(self._node_names[n.id])
            for n in self.order
        }
        # Trace Weaver: per-tick and per-operator spans. The tick span
        # adopts the oldest pending REST request's context (or, in
        # lockstep mode, the group traceparent the barrier agreed on), so
        # the dataflow work serving a request lands in its trace.
        from pathway_tpu_torch.observability.tracing import get_tracer

        self._tracer = get_tracer()
        self.http_server = None  # set by start_http_server when attached
        # Fault Forge (chaos testing): None unless PATHWAY_FAULTS is set,
        # so the per-tick cost is one attribute check
        from pathway_tpu_torch.testing import faults

        self._fault_plan = faults.active()
        # Tick Scope (observability/tickscope.py): per-runtime flight
        # recorder. Per-runtime, NOT process-global — nested runtimes'
        # inner ticks would otherwise corrupt the outer tick's record.
        # Disabled (PATHWAY_TICKSCOPE=0) the hot loop pays one `is None`
        # check per node and nothing else.
        from pathway_tpu_torch.observability import tickscope as _tickscope_mod

        self._tickscope = _tickscope_mod.make_recorder(self)
        self._ts_entries: list | None = None
        # intra-tick worker parallelism (reference: PATHWAY_THREADS timely
        # workers, src/engine/dataflow/config.rs:63-86): independent nodes
        # of one topo level process concurrently on a thread pool. Each
        # exec is touched by exactly one thread per tick; the win comes
        # from branches whose hot work releases the GIL (numpy/torch/IO).
        if worker_threads:
            from pathway_tpu_torch.internals.config import engine_threads

            n_threads = engine_threads()
        else:
            n_threads = 1
        self._pool = None
        self._levels: list[list[Any]] | None = None
        if n_threads > 1:
            level_of: dict[int, int] = {}
            levels: list[list[Any]] = []
            for node in self.order:
                lvl = (
                    max((level_of[i.id] for i in node.inputs), default=-1) + 1
                )
                level_of[node.id] = lvl
                while len(levels) <= lvl:
                    levels.append([])
                levels[lvl].append(node)
            # sinks run user callbacks — keep them serialized on their own
            # levels so pre-existing callbacks need not be thread-safe
            split: list[list[Any]] = []
            for lv in levels:
                sinks = [n for n in lv if isinstance(n, OutputNode)]
                rest = [n for n in lv if not isinstance(n, OutputNode)]
                if rest:
                    split.append(rest)
                for s in sinks:
                    split.append([s])
            levels = split
            if any(len(lv) > 1 for lv in levels):
                self._levels = levels
                self._pool = _cf.ThreadPoolExecutor(
                    max_workers=min(n_threads, 16),
                    thread_name_prefix="pathway-worker",
                )

    # --- core tick ------------------------------------------------------------

    def _process_node(self, node, t, produced, injected, final, stats):
        runner = None
        if self.compiled_plan is not None:
            if node.id in self.compiled_plan.member_ids:
                # produced inside its segment; the tail emits for it
                # (members are stateless with no on_end work)
                produced[node.id] = []
                return
            runner = self.compiled_plan.by_tail.get(node.id)
        ex = self.execs[node.id]
        has_injected = (
            isinstance(ex, InputExec) and injected and node.id in injected
        )
        # Tick Scope: entries is None when the recorder is off — that
        # one check is the entire disabled-path cost. compiled_ticks is
        # sampled around the call to tag the entry compiled-vs-interpreted
        # (SegmentRunner only bumps it on a run on the device). The
        # operator clock starts BEFORE injection: batch tightening is the
        # single biggest cost of an ingest tick and it belongs to the
        # InputNode, not to the unattributed gap between stage sum and
        # tick wall
        ts_entries = self._ts_entries
        seg_c0 = (
            runner.compiled_ticks
            if (ts_entries is not None and runner is not None)
            else 0
        )
        t0 = _time.perf_counter_ns()
        if has_injected:
            for b in injected[node.id]:
                ex.inject(b)
        inputs = (
            runner.gather(produced)
            if runner is not None
            else [produced.get(inp.id, []) for inp in node.inputs]
        )
        from pathway_tpu_torch.internals.errors import set_exec_scope

        set_exec_scope(getattr(node, "_error_scope", None))
        # operator span only when the node has work this tick — idle
        # autocommit passes must not flood the span ring
        span = (
            self._tracer.span(
                f"op.{self._node_names[node.id]}",
                node=f"{node.name}_{node.id}",
            )
            if self._tracer.enabled and (has_injected or any(inputs))
            else None
        )
        try:
            if span is not None:
                with span:
                    out = (
                        runner.process(t, inputs)
                        if runner is not None
                        else ex.process(t, inputs)
                    )
                    if final:
                        out = list(out) + list(ex.on_end())
                    span.set_attribute(
                        "rows", sum(len(b) for b in out)
                    )
            else:
                out = (
                    runner.process(t, inputs)
                    if runner is not None
                    else ex.process(t, inputs)
                )
                if final:
                    out = list(out) + list(ex.on_end())
        finally:
            set_exec_scope(None)
        produced[node.id] = out
        nrows = sum(len(b) for b in out)
        if nrows:
            stats.node_rows[node.id] = stats.node_rows.get(node.id, 0) + nrows
        node_ns = _time.perf_counter_ns() - t0
        stats.node_ns[node.id] = stats.node_ns.get(node.id, 0) + node_ns
        if nrows or any(inputs):
            # only ticks that did work: idle 50 ms autocommit ticks
            # would swamp the latency distribution with ~0 samples
            self._tick_hist_children[node.id].observe(node_ns / 1e9)
            if self._otel_on:
                self._otel_metrics.record_operator_latency(
                    self._node_names[node.id], node_ns
                )
            if ts_entries is not None:
                # list.append is GIL-atomic — safe from pool threads
                ts_entries.append(
                    (
                        node.id,
                        t0,
                        t0 + node_ns,
                        sum(len(b) for b in inputs),
                        nrows,
                        runner is not None
                        and runner.compiled_ticks > seg_c0,
                    )
                )
        if isinstance(ex, InputExec) and nrows:
            stats.rows_in[node.id] = stats.rows_in.get(node.id, 0) + nrows

    def tick(self, t: int, injected: dict[int, list[DiffBatch]] | None = None) -> None:
        """Process one logical time: push diffs through all nodes in topo
        order. `injected` maps input-node id -> batches. The whole tick
        runs under an ``engine.tick`` span parented on the trace being
        served (the pending REST request) so per-operator child spans
        attribute the tick's work to that request."""
        if not self._tracer.enabled:
            self._tick_inner(t, injected)
            return
        from pathway_tpu_torch.observability import tracing

        parent = tracing.pending_context()
        with self._tracer.span(
            "engine.tick", parent=parent, root=True, t=t
        ):
            self._tick_inner(t, injected)

    def _tick_inner(
        self, t: int, injected: dict[int, list[DiffBatch]] | None
    ) -> None:
        self.current_time = t
        produced: dict[int, list[DiffBatch]] = {}
        final = t >= END_OF_TIME
        if self._fault_plan is not None and not final:
            self._fault_plan.on_tick(t, "head")
        stats = self.stats
        self._ts_entries = self._tickscope.begin_tick(t)
        tick_start = _time.perf_counter_ns()
        if self._pool is not None and self._levels is not None:
            import contextvars as _cv

            traced = self._tracer.enabled
            for level in self._levels:
                if len(level) == 1:
                    self._process_node(
                        level[0], t, produced, injected, final, stats
                    )
                    continue
                futures = [
                    # pool threads don't inherit the tick span's
                    # contextvars; run each node in a fresh copy of the
                    # submitting context so operator spans nest correctly
                    self._pool.submit(
                        _cv.copy_context().run,
                        self._process_node,
                        node, t, produced, injected, final, stats,
                    )
                    if traced
                    else self._pool.submit(
                        self._process_node,
                        node, t, produced, injected, final, stats,
                    )
                    for node in level
                ]
                # fail-stop: wait for the WHOLE level first so no sibling
                # keeps producing side effects after the error propagates
                _cf.wait(futures)
                for f in futures:
                    exc = f.exception()
                    if exc is not None:
                        raise exc
        else:
            for node in self.order:
                self._process_node(node, t, produced, injected, final, stats)
        for node in self._sinks:
            consumed = sum(
                len(b) for inp in node.inputs for b in produced.get(inp.id, [])
            )
            if consumed:
                stats.rows_out[node.id] = (
                    stats.rows_out.get(node.id, 0) + consumed
                )
        stats.ticks += 1
        stats.current_time = t if not final else stats.current_time
        stats.last_tick_ns = _time.perf_counter_ns() - tick_start
        self._tickscope.end_tick(self._ts_entries, stats.last_tick_ns)
        self._ts_entries = None
        self._tick_count += 1
        if self._fault_plan is not None and not final:
            # "tail" kills land AFTER this tick's node processing but
            # BEFORE the persistence driver commits it — the group-
            # visible mid-tick death the chaos matrix exercises
            self._fault_plan.on_tick(t, "tail")
        if self.engine_mesh is not None and not final:
            self.global_frontier = self._frontier_consensus(t)
        if self.on_tick is not None:
            self.on_tick(t)

    # --- static run -----------------------------------------------------------

    def run_static(self) -> None:
        """Run all static sources to completion, merging events by time
        (deterministic 'batch mode' — reference PersistenceMode::Batch).
        The reference's multi-process lockstep variant is not ported."""
        events: list[tuple[int, int, DiffBatch]] = []  # (time, node_id, batch)
        for node in self.order:
            if isinstance(node, InputNode) and isinstance(
                node.source, StaticSource
            ):
                for t, batch in node.source.events():
                    events.append((t, node.id, batch))
        events.sort(key=lambda e: e[0])
        i = 0
        n = len(events)
        while i < n:
            t = events[i][0]
            injected: dict[int, list[DiffBatch]] = {}
            while i < n and events[i][0] == t:
                injected.setdefault(events[i][1], []).append(events[i][2])
                i += 1
            self.tick(t, injected)
        self.tick(END_OF_TIME)

    # --- streaming run --------------------------------------------------------

    def run_streaming(self) -> None:
        """Drive streaming sources: connector threads feed InputSessions; every
        autocommit interval a tick assigns a wall-clock logical time (even ms,
        like reference Timestamp::new_from_current_time)."""
        sources: list[tuple[InputNode, StreamingSource]] = []
        static_events: list[tuple[int, int, DiffBatch]] = []
        for node in self.order:
            if isinstance(node, InputNode):
                if isinstance(node.source, StreamingSource):
                    node.source.session._wake = lambda: self._wake.set()
                    sources.append((node, node.source))
                elif isinstance(node.source, StaticSource):
                    for t, batch in node.source.events():
                        static_events.append((t, node.id, batch))
        for _node, src in sources:
            src.start()
        # feed all static data at the first tick
        last_t = 0
        if static_events:
            injected: dict[int, list[DiffBatch]] = {}
            for _t, nid, batch in static_events:
                injected.setdefault(nid, []).append(batch)
            last_t = self._now_ms()
            self.tick(last_t, injected)
        # Surge Gate priority classes: while an interactive session (REST
        # queries behind a gate) is hot — rows pending, or queued in its
        # micro-batcher — bulk ingest/backfill sessions drain at most
        # BULK_CHUNK rows per tick, so serving ticks never stall behind
        # an unbounded backfill batch. Chunking (vs skipping) keeps
        # ingest starvation-free: every tick still moves bulk rows.
        from pathway_tpu_torch.internals.config import serving_bulk_chunk

        BULK_CHUNK = serving_bulk_chunk()
        while not self._stop.is_set():
            self._wake.wait(timeout=self.autocommit_ms / 1000.0)
            self._wake.clear()
            injected = {}
            any_data = False
            all_done = True
            # re-read priorities every tick: the SurgeGate marks its
            # session interactive from the connector thread, possibly
            # after this loop already started
            hot = any(
                src.session.hot()
                for _node, src in sources
                if getattr(src.session, "priority", 1)
                == InputSession.PRIORITY_INTERACTIVE
            )
            for node, src in sources:
                sess = src.session
                limit = (
                    BULK_CHUNK
                    if (
                        hot
                        and getattr(sess, "priority", 1)
                        != InputSession.PRIORITY_INTERACTIVE
                        and not sess.finished
                    )
                    else None
                )
                rows = sess.drain(limit)
                if rows:
                    any_data = True
                    injected[node.id] = [
                        DiffBatch.from_rows(rows, src.column_names)
                    ]
                if sess.has_data():
                    # chunk leftover: re-tick promptly instead of waiting
                    # out the autocommit interval
                    self._wake.set()
                if not sess.finished:
                    all_done = False
            if any_data:
                t = max(self._now_ms(), last_t + 2)
                last_t = t
                self.tick(t, injected)
            if all_done and not any_data:
                break
        for _node, src in sources:
            src.stop()
        self.tick(END_OF_TIME)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def _frontier_consensus(self, t: int) -> int:
        """min-all-reduce of the local clock across engine shards. Times are
        wall-clock ms (> int32), so the collective carries the int32 offset
        from the first tick, as the reference's does."""
        import torch

        from pathway_tpu_torch.parallel.collectives import frontier_allreduce

        mesh, axis = self.engine_mesh
        if self._frontier_base is None:
            self._frontier_base = t
        rel = t - self._frontier_base
        if rel > (1 << 30):
            # re-base before the int32 payload could overflow (~24.8 days
            # of uptime); the consensus value is monotone either way
            self._frontier_base = t
            rel = 0
        local = [
            torch.tensor(rel, dtype=torch.int32, device=dev)
            for dev in mesh.shard_devices(axis)
        ]
        ft = frontier_allreduce(local, mesh, axis)
        self.frontier_syncs += 1
        return int(ft[0]) + self._frontier_base

    @staticmethod
    def _now_ms() -> int:
        # even ms only — odd timestamps are reserved for intermediate
        # "alt-neu" steps (reference: src/engine/timestamp.rs:20-32)
        return (int(_time.time() * 1000) // 2) * 2

    def run(self) -> None:
        has_streaming = any(
            isinstance(node, InputNode)
            and isinstance(node.source, StreamingSource)
            for node in self.order
        )
        try:
            if has_streaming:
                self.run_streaming()
            else:
                self.run_static()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True, cancel_futures=True)
                self._pool = None
                self._levels = None  # reused Runtime runs sequentially
