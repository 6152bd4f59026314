"""Structured diagnostics emitted by the Graph Doctor — own copy of
``pathway_tpu/analysis/diagnostics.py``.

Each diagnostic carries a stable rule id, a severity, the engine node it
is anchored to (with the declaration-site trace frame captured at build
time — engine/nodes.py Node.trace), and a fix hint. The ahead-of-time
stance: problems a static pass can prove about the declared dataflow
should surface before the engine runs.
"""

from __future__ import annotations

import enum
import linecache
from dataclasses import dataclass, field
from typing import Any


class Severity(enum.IntEnum):
    INFO = 1
    WARNING = 2
    ERROR = 3

    @classmethod
    def parse(cls, value: "Severity | str") -> "Severity":
        if isinstance(value, Severity):
            return value
        try:
            return cls[str(value).upper()]
        except KeyError:
            raise ValueError(
                f"unknown severity {value!r}; expected one of "
                f"{[s.name.lower() for s in cls]}"
            ) from None

    @property
    def tag(self) -> str:
        return {self.INFO: "I", self.WARNING: "W", self.ERROR: "E"}[self]


def node_provenance(node: Any) -> str:
    """`<GroupByNode#12> declared at file.py:10 in main` — repr + the user
    frame captured when the node was built."""
    if node is None:
        return "<graph>"
    out = repr(node)
    trace = getattr(node, "trace", None)
    if trace:
        fname, lineno, func = trace
        out += f" declared at {fname}:{lineno} in {func}"
    return out


def declaration_line(node: Any) -> str | None:
    """The source line that declared the node, when resolvable."""
    trace = getattr(node, "trace", None)
    if not trace:
        return None
    line = linecache.getline(trace[0], trace[1]).strip()
    return line or None


@dataclass
class Diagnostic:
    rule: str
    severity: Severity
    message: str
    node: Any = None
    fix_hint: str | None = None
    data: dict = field(default_factory=dict)

    def format(self, show_source: bool = True) -> str:
        lines = [
            f"[{self.severity.tag}] {self.rule}: {self.message}",
            f"    at {node_provenance(self.node)}",
        ]
        if show_source:
            src = declaration_line(self.node)
            if src:
                lines.append(f"       | {src}")
        if self.fix_hint:
            lines.append(f"    fix: {self.fix_hint}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        trace = getattr(self.node, "trace", None)
        return {
            "rule": self.rule,
            "severity": self.severity.name.lower(),
            "message": self.message,
            "node": repr(self.node) if self.node is not None else None,
            "trace": (
                {"file": trace[0], "line": trace[1], "function": trace[2]}
                if trace
                else None
            ),
            "fix_hint": self.fix_hint,
            **({"data": self.data} if self.data else {}),
        }
