"""Own copy of ``pathway_tpu/analysis/doctor.py`` over the port's engine.

The Graph Doctor: run the registered rules over a declared graph.

Three entry points share this module:

- ``pw.run(diagnostics="warn"|"error"|"off")`` — internals/run.py calls
  :func:`run_doctor` before the engine builds a Runtime;
- ``python -m pathway_tpu_torch.analysis script.py`` — builds the script's
  graph without executing it, then reports (analysis/__main__.py);
- ``pw.debug.diagnose(table)`` — notebook-friendly report scoped to the
  graph feeding one table.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Iterable

from pathway_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from pathway_tpu_torch.analysis.graph_facts import GraphFacts
from pathway_tpu_torch.analysis.rules import RULES, default_rules

logger = logging.getLogger("pathway_tpu_torch.analysis")

_SUPPRESS_ATTR = "_doctor_suppress"


def suppress(table_or_node: Any, *rule_ids: str) -> Any:
    """Silence specific rules for one table/node (and only that node):
    ``pw.analysis.suppress(stats, "unbounded-state")``. Returns its
    argument so it chains inside pipeline definitions.

    Findings anchored at engine nodes the user API never hands out (the
    GroupByNode under a ``groupby().reduce()`` result, the JoinNode under
    a ``join().select()``) are silenced by suppressing the result table —
    the anchored node's direct consumer.
    """
    node = getattr(table_or_node, "_node", table_or_node)
    current = set(getattr(node, _SUPPRESS_ATTR, ()))
    current.update(rule_ids)
    setattr(node, _SUPPRESS_ATTR, frozenset(current))
    return table_or_node


def _suppressed(diag: Diagnostic, consumers: dict[int, list]) -> bool:
    if diag.node is None:
        return False
    # the anchored node, or its direct consumers: every operator node the
    # API keeps internal (GroupByNode, JoinNode, temporal joins) carries a
    # user-visible projection directly on top, so suppressing that result
    # table covers the operator's findings
    for n in (diag.node, *consumers.get(diag.node.id, ())):
        if diag.rule in getattr(n, _SUPPRESS_ATTR, ()):
            return True
    return False


@dataclass
class DoctorReport:
    diagnostics: list[Diagnostic] = field(default_factory=list)

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def by_rule(self, rule_id: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.rule == rule_id]

    def worst(self) -> Severity | None:
        return max(
            (d.severity for d in self.diagnostics), default=None
        )

    def count_at_least(self, severity: Severity) -> int:
        return sum(1 for d in self.diagnostics if d.severity >= severity)

    def format(
        self,
        min_severity: Severity = Severity.INFO,
        show_source: bool = True,
    ) -> str:
        shown = [
            d for d in self.diagnostics if d.severity >= min_severity
        ]
        if not shown:
            return "graph doctor: no findings"
        lines = [d.format(show_source=show_source) for d in shown]
        counts = {
            s: sum(1 for d in shown if d.severity == s)
            for s in reversed(Severity)
        }
        summary = ", ".join(
            f"{n} {s.name.lower()}" for s, n in counts.items() if n
        )
        lines.append(f"graph doctor: {len(shown)} finding(s) ({summary})")
        return "\n".join(lines)

    def to_list(self) -> list[dict]:
        return [d.to_dict() for d in self.diagnostics]


class GraphDoctorError(RuntimeError):
    """Raised by ``pw.run(diagnostics="error")`` before the engine starts
    when the doctor finds warning-or-worse problems."""

    def __init__(self, report: DoctorReport):
        self.report = report
        super().__init__(
            "graph doctor found problems (diagnostics='error'):\n"
            + report.format(min_severity=Severity.WARNING)
        )


_SEVERITY_ORDER = (Severity.ERROR, Severity.WARNING, Severity.INFO)


def run_doctor(
    outputs: Iterable[Any] | None = None,
    all_nodes: Iterable[Any] | None = None,
    rules: "dict | Iterable[str] | None" = None,
) -> DoctorReport:
    """Run the rule set over the declared graph and return the report.

    ``outputs`` defaults to the OutputNodes found in ``all_nodes``;
    ``all_nodes`` defaults to every node declared since the last
    ``G.clear()``. ``rules`` narrows to a subset (iterable of rule ids)
    or replaces the registry (dict)."""
    facts = GraphFacts(outputs=outputs, all_nodes=all_nodes)
    if rules is None:
        active = default_rules()
    elif isinstance(rules, dict):
        active = rules
    else:
        rules = list(rules)
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            raise ValueError(
                f"unknown rule id(s) {unknown}; "
                f"registered rules: {sorted(RULES)}"
            )
        active = {rid: RULES[rid] for rid in rules}
    diags: list[Diagnostic] = []
    for rule_id, fn in active.items():
        try:
            found = list(fn(facts))
        except Exception:
            logger.exception("graph doctor rule %r crashed", rule_id)
            continue
        diags.extend(
            d for d in found if not _suppressed(d, facts.consumers)
        )
    diags.sort(key=lambda d: (-int(d.severity), d.rule))
    return DoctorReport(diags)


def run_plane_doctor(
    outputs: Iterable[Any] | None = None,
    all_nodes: Iterable[Any] | None = None,
    rules: "dict | Iterable[str] | None" = None,
) -> DoctorReport:
    """Run the deployment-scope rules (analysis/plane.py) and return
    the report: snapshot coverage for elastic resizes, pickle-on-hot-
    path over the wire/segment encoders, ``PATHWAY_*`` knob coherence.
    Unlike :func:`run_doctor` this is meaningful even with NO declared
    graph (the knob lint is pure environment), so an empty graph is
    fine."""
    from pathway_tpu_torch.analysis.plane import PLANE_RULES, default_plane_rules

    facts = GraphFacts(outputs=outputs, all_nodes=all_nodes)
    if rules is None:
        active = default_plane_rules()
    elif isinstance(rules, dict):
        active = rules
    else:
        rules = list(rules)
        unknown = sorted(set(rules) - set(PLANE_RULES))
        if unknown:
            raise ValueError(
                f"unknown plane rule id(s) {unknown}; "
                f"registered plane rules: {sorted(PLANE_RULES)}"
            )
        active = {rid: PLANE_RULES[rid] for rid in rules}
    diags: list[Diagnostic] = []
    for rule_id, fn in active.items():
        try:
            found = list(fn(facts))
        except Exception:
            logger.exception("plane doctor rule %r crashed", rule_id)
            continue
        diags.extend(
            d for d in found if not _suppressed(d, facts.consumers)
        )
    diags.sort(key=lambda d: (-int(d.severity), d.rule))
    return DoctorReport(diags)


def check_before_run(seeds: list, mode: str) -> None:
    """The pw.run() integration: run the doctor and act per `mode`
    ("off" | "warn" | "error"). Raises GraphDoctorError in error mode
    when any warning-or-worse diagnostic is found."""
    if mode in (None, "off"):
        return
    if mode not in ("warn", "error"):
        raise ValueError(
            f"diagnostics={mode!r}: expected 'off', 'warn' or 'error'"
        )
    report = run_doctor(outputs=seeds)
    if mode == "error" and report.count_at_least(Severity.WARNING):
        raise GraphDoctorError(report)
    for diag in report:
        if diag.severity >= Severity.WARNING:
            logger.warning("%s", diag.format(show_source=False))
        else:
            logger.info("%s", diag.format(show_source=False))
