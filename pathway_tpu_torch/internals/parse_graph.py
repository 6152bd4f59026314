"""The port's own copy of ``pathway_tpu/internals/parse_graph.py``. Global parse graph (reference: python/pathway/internals/parse_graph.py:104).

User code *declares* a dataflow; every io.write/subscribe registers an output
node here. `pw.run` hands the registered outputs to the engine Runtime."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.nodes import Node


class _UniverseSolver:
    """Minimal query surface of the reference's universe solver: answers
    the relations our Universe objects track structurally."""

    def query_are_equal(self, a, b) -> bool:
        return a is b or (a.is_subset_of(b) and b.is_subset_of(a))

    def query_is_subset(self, a, b) -> bool:
        return a.is_subset_of(b)


class ParseGraph:
    def __init__(self) -> None:
        self.outputs: list[Node] = []
        self.streaming_sources: list[Any] = []
        self.post_run_hooks: list[Callable[[], None]] = []
        self.runtime: Any = None  # set while a run is active
        self.last_runtime: Any = None  # kept after the run for stats probing

    def add_output(self, node: Node) -> None:
        self.outputs.append(node)

    @property
    def universe_solver(self) -> _UniverseSolver:
        return _UniverseSolver()

    def clear(self) -> None:
        from pathway_tpu_torch.engine.nodes import ALL_NODES

        self.outputs.clear()
        self.streaming_sources.clear()
        self.post_run_hooks.clear()
        self.runtime = None
        self.last_runtime = None
        ALL_NODES.clear()


G = ParseGraph()
