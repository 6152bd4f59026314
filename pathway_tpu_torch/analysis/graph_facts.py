"""Own copy of ``pathway_tpu/analysis/graph_facts.py`` over the port's engine.

Derived facts over a declared ParseGraph: reachability, streaming
provenance, temporal bounding, column liveness, exchange edges.

All rules consume one `GraphFacts` instance so each walk over the node
graph happens once per doctor run. The analyses are conservative: where
a node type is unknown the pass assumes it reads every input column and
propagates streaming-ness unchanged.
"""

from __future__ import annotations

from typing import Iterable

from pathway_tpu_torch.engine.nodes import (
    BufferNode,
    ConcatNode,
    FilterNode,
    FlattenNode,
    ForgetNode,
    FreezeNode,
    GroupByNode,
    InputNode,
    IxNode,
    JoinNode,
    Node,
    OutputNode,
    ReindexNode,
    RowwiseNode,
    SortNode,
    UniverseSetOpNode,
    UpdateRowsNode,
)
from pathway_tpu_torch.engine.runtime import StreamingSource, collect_nodes
from pathway_tpu_torch.engine.sharded import exchange_facts

# operators that bound temporal state downstream: a Forget retracts rows
# past the watermark (the canonical state cap); Buffer/Freeze come from
# the same `behavior=` desugaring and mark a consciously-managed temporal
# scope (stdlib/temporal/temporal_behavior.py)
TEMPORAL_GUARDS = (ForgetNode, BufferNode, FreezeNode)


class GraphFacts:
    def __init__(
        self,
        outputs: Iterable[Node] | None = None,
        all_nodes: Iterable[Node] | None = None,
    ):
        if all_nodes is None:
            from pathway_tpu_torch.engine.nodes import ALL_NODES

            all_nodes = list(ALL_NODES)
        self.outputs = list(outputs) if outputs is not None else [
            n for n in all_nodes if isinstance(n, OutputNode)
        ]
        # nodes reaching an output (topological, inputs first)
        self.reachable_order = collect_nodes(self.outputs)
        self.reachable = {n.id for n in self.reachable_order}
        # the WHOLE declared graph, outputs or not
        self.order = collect_nodes(list(all_nodes) + self.outputs)
        self.consumers: dict[int, list[Node]] = {n.id: [] for n in self.order}
        for node in self.order:
            for inp in node.inputs:
                self.consumers[inp.id].append(node)
        self._streaming = self._propagate_streaming()
        self._unguarded = self._propagate_unguarded_streaming()
        self.live_columns = self._column_liveness()
        self.exchange_edges: dict[int, list[tuple[str, tuple[str, ...]]]] = {}
        for node in self.order:
            fx = exchange_facts(node)
            if fx:
                self.exchange_edges[node.id] = fx

    # --- streaming provenance ---------------------------------------------

    @staticmethod
    def _is_streaming_input(node: Node) -> bool:
        return isinstance(node, InputNode) and isinstance(
            node.source, StreamingSource
        )

    def _propagate_streaming(self) -> dict[int, bool]:
        out: dict[int, bool] = {}
        for node in self.order:
            if isinstance(node, InputNode):
                out[node.id] = self._is_streaming_input(node)
            else:
                out[node.id] = any(out[i.id] for i in node.inputs)
        return out

    def _propagate_unguarded_streaming(self) -> dict[int, bool]:
        """True when some STREAMING source reaches the node with no
        temporal guard (Forget/Buffer/Freeze) anywhere on the path — the
        precondition for unbounded keyed state."""
        out: dict[int, bool] = {}
        for node in self.order:
            if isinstance(node, InputNode):
                out[node.id] = self._is_streaming_input(node)
            elif isinstance(node, TEMPORAL_GUARDS):
                out[node.id] = False
            else:
                out[node.id] = any(out[i.id] for i in node.inputs)
        return out

    def is_streaming(self, node: Node) -> bool:
        return self._streaming.get(node.id, False)

    def has_unguarded_streaming_input(self, node: Node) -> bool:
        return any(self._unguarded.get(i.id, False) for i in node.inputs)

    # --- user-facing column labels -----------------------------------------

    def input_column_label(self, node: Node, col: str, side: int = 0) -> str:
        """Name an operator's key column in user terms: prep columns a
        groupby/join manufactures (`_g0`, `_a0_0`) resolve through the
        RowwiseNode that computed them back to the referenced source
        column, when the prep is a plain reference."""
        from pathway_tpu_torch.engine.expression_eval import InternalColRef

        side = min(side, len(node.inputs) - 1) if node.inputs else 0
        inp = node.inputs[side] if node.inputs else None
        if isinstance(inp, RowwiseNode):
            e = inp.exprs.get(col)
            if isinstance(e, InternalColRef) and e._name != "id":
                return e._name
        return col

    def output_column_label(self, node: Node, col: str) -> str:
        """Name an operator's output slot (`_agg1`) the way the consuming
        select exposes it to the user, when recoverable."""
        from pathway_tpu_torch.engine.expression_eval import InternalColRef

        for c in self.consumers.get(node.id, ()):
            if not isinstance(c, RowwiseNode):
                continue
            try:
                idx = c.inputs.index(node)
            except ValueError:
                continue
            for uname, e in c.exprs.items():
                if (
                    isinstance(e, InternalColRef)
                    and e._input_index == idx
                    and e._name == col
                ):
                    return uname
        return col

    # --- column liveness ---------------------------------------------------

    def _column_liveness(self) -> dict[int, "set[str] | None"]:
        """Per node: the set of its output columns any consumer may read,
        or None for "all" (the conservative default). A superset of the
        runtime's `annotate_live_columns` (engine/runtime.py) — this pass
        understands more node types because it powers the dead-column
        diagnostic, not just the join fast path."""
        from pathway_tpu_torch.engine.expression_eval import InternalColRef

        live: dict[int, set[str] | None] = {}
        for node in self.order:
            # terminal tables may be captured externally (pw.debug, io
            # writers added later): everything live unless consumed
            live[node.id] = set() if self.consumers[node.id] else None
        for node in self.outputs:
            live[node.id] = None

        def demand(node: Node, cols: "set[str] | None") -> None:
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

        for node in reversed(self.order):
            own = live[node.id]
            if isinstance(node, RowwiseNode):
                per_input = expr_refs(node.exprs.values(), len(node.inputs))
                for pos, inp in enumerate(node.inputs):
                    demand(inp, per_input[pos])
            elif isinstance(node, FilterNode):
                refs = expr_refs([node.predicate], 1)[0]
                demand(node.inputs[0], None if own is None else refs | own)
            elif isinstance(node, ReindexNode):
                refs = expr_refs([node.key_expr], 1)[0]
                demand(node.inputs[0], None if own is None else refs | own)
            elif isinstance(node, GroupByNode):
                need = set(node.key_columns())
                if node.sort_by:
                    need.add(node.sort_by)
                for spec in node.reducer_specs.values():
                    need.update(spec.arg_cols)
                demand(node.inputs[0], need)
            elif isinstance(node, JoinNode):
                for side, prefix, on in (
                    (0, "l.", node.left_on),
                    (1, "r.", node.right_on),
                ):
                    if own is None:
                        demand(node.inputs[side], None)
                    else:
                        need = set(on)
                        need.update(
                            c[len(prefix):]
                            for c in own
                            if c.startswith(prefix)
                        )
                        demand(node.inputs[side], need)
            elif isinstance(node, SortNode):
                demand(node.inputs[0], set(node.key_columns()))
            elif isinstance(node, FlattenNode):
                if own is None:
                    demand(node.inputs[0], None)
                else:
                    need = {
                        c for c in own if c in node.inputs[0].column_names
                    }
                    need.add(node.flatten_col)
                    demand(node.inputs[0], need)
            elif isinstance(node, TEMPORAL_GUARDS):
                refs = {node.threshold_col, node.current_time_col}
                demand(node.inputs[0], None if own is None else refs | own)
            elif isinstance(
                node, (ConcatNode, UpdateRowsNode, UniverseSetOpNode)
            ):
                # pass-through column names (UniverseSetOp reads only the
                # primary input's values; the others gate by key)
                for inp in node.inputs:
                    shared = set(inp.column_names) & (own or set())
                    demand(inp, None if own is None else shared)
            elif isinstance(node, IxNode):
                refs = {node.ptr_col}
                demand(node.inputs[0], refs)
                demand(node.inputs[1], own)
            else:
                for inp in node.inputs:
                    demand(inp, None)
        return live
