"""External index node: streams data-side updates into an index object and
answers query-side rows with top-k matches — the port's own copy of
``pathway_tpu/engine/index_node.py`` (``ExternalIndexNode``,
``ExternalIndexExec``, ``IndexImpl``), with the same metrics and span.

Reference: use_external_index_as_of_now (src/engine/dataflow.rs:2694) +
operators/external_index.rs — there, queries broadcast to all workers and each
worker searches its shard. Here the index lives on the card (the port's
``TpuDenseKnnIndex``: one block top-k launch per tick's query batch).

The serving hooks are the reference's: the exec registers with
``serving/degrade.py`` as the index stale reads answer from while the
engine recovers, and a query whose REST deadline expired
(``serving/deadline.py``) answers empty without a device search.

With ``PATHWAY_REPL_PORT`` set the process is the replication writer: the
exec publishes each tick's consolidated corpus deltas (an empty marker on
an idle tick) to ``parallel/replicate.py``'s delta stream, as the
reference does. Not ported: the multi-process exec (the runtime raises for
a process group, [mesh]).
"""

from __future__ import annotations

from typing import Any, Protocol, Sequence

from pathway_tpu_torch.engine.batch import END_OF_TIME, DiffBatch
from pathway_tpu_torch.engine.nodes import Node, NodeExec
from pathway_tpu_torch.internals.api import Pointer
from pathway_tpu_torch.internals.errors import record_error


class IndexImpl(Protocol):
    """Host-side index protocol (device work happens inside search)."""

    def upsert(self, key: int, data: Any, metadata: Any) -> None: ...

    def remove(self, key: int) -> None: ...

    def search(
        self, queries: Sequence[tuple[Any, int, Any]]
    ) -> list[tuple[tuple[int, float], ...]]:
        """queries: (data, k, filter) triples → per query a tuple of
        (row_key, score) sorted best-first."""
        ...


class ExternalIndexNode(Node):
    """inputs: [data_node(cols: _data, _meta), query_node(cols: _q, _k, _filter)]
    output: query universe, column _pw_index_reply (tuple of (ptr, score))."""

    REPLY = "_pw_index_reply"

    def __init__(
        self,
        data_node: Node,
        query_node: Node,
        index_factory: Any,
        as_of_now: bool = True,
    ):
        super().__init__([data_node, query_node], [self.REPLY])
        self.index_factory = index_factory
        self.as_of_now = as_of_now

    def make_exec(self):
        return ExternalIndexExec(self)


class ExternalIndexExec(NodeExec):
    def __init__(self, node: ExternalIndexNode):
        super().__init__(node)
        self.index: IndexImpl = node.index_factory()
        # Flight Recorder: end-to-end KNN serving latency (host rows in →
        # device top-k → host replies), the BASELINE.md "KNN p50" metric,
        # labeled by index implementation. Prebound once per exec.
        from pathway_tpu_torch.observability import REGISTRY

        index_label = type(self.index).__name__
        self._m_query_seconds = REGISTRY.histogram(
            "pathway_knn_query_seconds",
            "index search batch latency (all queries of one tick batch)",
            labelnames=("index",),
        ).labels(index_label)
        self._m_queries = REGISTRY.counter(
            "pathway_knn_queries_total",
            "queries answered, by index implementation",
            labelnames=("index",),
        ).labels(index_label)
        self._m_updates = REGISTRY.counter(
            "pathway_knn_index_updates_total",
            "upserts/removals applied to the index corpus",
            labelnames=("index",),
        ).labels(index_label)
        from pathway_tpu_torch.serving import metrics as serving_metrics

        self._m_expired = serving_metrics.expired_counter().labels("knn")
        dcols = node.inputs[0].column_names
        qcols = node.inputs[1].column_names
        self.d_data = dcols.index("_data")
        self.d_meta = dcols.index("_meta") if "_meta" in dcols else None
        self.q_data = qcols.index("_q")
        self.q_k = qcols.index("_k") if "_k" in qcols else None
        self.q_filter = qcols.index("_filter") if "_filter" in qcols else None
        # live queries (for full `query` mode re-answers) / emitted replies
        self.live_queries: dict[int, tuple] = {}
        self.emitted: dict[int, tuple] = {}
        # Phoenix degradation: this exec's corpus is the "last hydrated
        # index snapshot" degraded serving answers from — register it
        # (weakly) and keep the staleness clock fresh per tick
        from pathway_tpu_torch.serving import degrade as _degrade

        self._degrade = _degrade
        _degrade.register_index_reader(self)
        # Replica Shield: when this process is the replication WRITER
        # (PATHWAY_REPL_PORT set), every tick's consolidated corpus
        # deltas stream to the read replicas (parallel/replicate.py);
        # the resolved None costs one attribute check per tick otherwise
        from pathway_tpu_torch.parallel import replicate as _replicate

        self._repl = _replicate.publisher()

    def state_dict(self) -> dict:
        # indexes holding device arrays expose their own host-side snapshot;
        # pure-python indexes (BM25) pickle wholesale
        if hasattr(self.index, "state_dict"):
            index_state = ("dict", self.index.state_dict())
        else:
            index_state = ("pickle", self.index)
        return {
            "live_queries": self.live_queries,
            "emitted": self.emitted,
            "index_state": index_state,
        }

    def load_state(self, state: dict) -> None:
        self.live_queries = dict(state["live_queries"])
        self.emitted = dict(state["emitted"])
        kind, payload = state["index_state"]
        if kind == "dict":
            self.index.load_state(payload)
        else:
            self.index = payload

    def _answer(self, items: list[tuple[int, tuple]]) -> dict[int, tuple]:
        """items: (query_key, qvals) → reply tuples."""
        triples = []
        for _k, vals in items:
            q = vals[self.q_data]
            k = int(vals[self.q_k]) if self.q_k is not None else 3
            flt = vals[self.q_filter] if self.q_filter is not None else None
            triples.append((q, k, flt))
        import time as _time

        from pathway_tpu_torch.observability.tracing import get_tracer

        # Trace Weaver: the device top-k child span — with the embed and
        # HTTP spans this completes the per-request serving breakdown
        with get_tracer().span(
            "knn.search",
            index=type(self.index).__name__,
            queries=len(triples),
        ) as sp:
            t0 = _time.perf_counter()
            try:
                results = self.index.search(triples)
            except Exception as exc:
                record_error(exc, str(self.node))
                results = [() for _ in triples]
        self._m_query_seconds.observe(
            _time.perf_counter() - t0, exemplar=sp.trace_id
        )
        self._m_queries.inc(len(triples))
        out = {}
        for (qk, _vals), matches in zip(items, results):
            out[qk] = tuple(
                (Pointer(mk), float(score)) for mk, score in matches
            )
        return out

    def process(self, t, inputs):
        node = self.node
        data_changed = False
        # corpus mutation races a concurrent degraded-mode stale search
        # (replay ticks rebuild state while the REST handler reads it):
        # the shared guard serializes them. Uncontended cost is one
        # RLock acquire per tick.
        repl_rows: list[tuple[int, int, tuple]] = []
        with self._degrade.index_guard:
            for b in inputs[0]:
                for k, d, vals in b.iter_rows():
                    data_changed = True
                    self._m_updates.inc()
                    if d > 0:
                        meta = (
                            vals[self.d_meta]
                            if self.d_meta is not None
                            else None
                        )
                        try:
                            self.index.upsert(k, vals[self.d_data], meta)
                        except Exception as exc:
                            record_error(exc, str(node))
                            continue  # a row the writer's index rejected
                            # must not reach the replicas either
                        if self._repl is not None:
                            repl_rows.append((k, 1, (vals[self.d_data], meta)))
                    else:
                        self.index.remove(k)
                        if self._repl is not None:
                            repl_rows.append((k, -1, (None, None)))
        # the engine is ticking this node: whatever the corpus now holds
        # is as fresh as the stream — restart the staleness clock
        self._degrade.mark_fresh()
        if self._repl is not None and t < END_OF_TIME:
            # consolidated per-tick deltas to the read replicas; idle
            # ticks publish an empty marker so replica freshness tracks
            # the writer's tick cadence, not just corpus churn
            from pathway_tpu_torch.parallel.replicate import consolidate_rows

            batches = []
            if repl_rows:
                batches.append(
                    DiffBatch.from_rows(
                        consolidate_rows(repl_rows), ("_data", "_meta")
                    )
                )
            self._repl.publish(t, batches)
        # Surge Gate deadline propagation: queries whose REST deadline
        # already expired answer empty WITHOUT a device search — the
        # client got its 504, so the top-k would burn a batch slot for a
        # response nobody reads (the empty reply keeps the output
        # universe aligned for downstream row-wise stages).
        from pathway_tpu_torch.serving import deadline as _deadline

        to_answer: list[tuple[int, tuple]] = []
        expired_keys: list[int] = []
        retracted: list[int] = []
        for b in inputs[1]:
            for k, d, vals in b.iter_rows():
                if d > 0:
                    if _deadline.expired(k):
                        self._m_expired.inc()
                        expired_keys.append(k)
                        continue
                    if not node.as_of_now:
                        self.live_queries[k] = vals
                    to_answer.append((k, vals))
                else:
                    self.live_queries.pop(k, None)
                    retracted.append(k)
        if not node.as_of_now and data_changed:
            # re-answer every live query against the new index state
            answered_keys = {k for k, _ in to_answer}
            for k, vals in self.live_queries.items():
                if k not in answered_keys:
                    to_answer.append((k, vals))
        out_rows: list[tuple[int, int, tuple]] = []
        for k in retracted:
            old = self.emitted.pop(k, None)
            if old is not None:
                out_rows.append((k, -1, old))
        replies: dict[int, tuple] = {k: () for k in expired_keys}
        if to_answer:
            replies.update(self._answer(to_answer))
        if replies:
            for k, reply in replies.items():
                new = (reply,)
                old = self.emitted.get(k)
                if old == new:
                    continue
                if old is not None:
                    out_rows.append((k, -1, old))
                out_rows.append((k, 1, new))
                self.emitted[k] = new
        if not out_rows:
            return []
        return [DiffBatch.from_rows(out_rows, self.node.column_names)]
