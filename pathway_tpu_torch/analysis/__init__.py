"""pathway_tpu_torch.analysis — the Graph Doctor (counterpart of
``pathway_tpu/analysis``: the same rules, rule ids, severities and
messages) and the Hopper launch ledger (``lowering.py``, the counterpart of
the TPU Lowering Ledger).

A pre-execution static-analysis pass over the declared dataflow
(`ParseGraph`): walks the registered node graph BEFORE the engine starts
and emits structured diagnostics (rule id, severity, node provenance
with declaration-site trace, fix hint) — the correctness-tooling
counterpart of an ahead-of-time compiler's checks.

Entry points:

- ``pw.run(diagnostics="warn"|"error"|"off")``
- ``python -m pathway_tpu_torch.analysis <script.py>`` (build, don't execute;
  ``--plane`` adds the plane rules and the launch ledger)
- ``pw.debug.diagnose(table)``
- library use: ``run_doctor()`` / ``GraphFacts`` / ``@rule`` to extend.
"""

from pathway_tpu_torch.analysis.diagnostics import (
    Diagnostic,
    Severity,
    node_provenance,
)
from pathway_tpu_torch.analysis.doctor import (
    DoctorReport,
    GraphDoctorError,
    check_before_run,
    run_doctor,
    run_plane_doctor,
    suppress,
)
from pathway_tpu_torch.analysis.graph_facts import GraphFacts
from pathway_tpu_torch.analysis.lowering import (
    LoweringCase,
    LoweringReport,
    LoweringRuleViolation,
    check_tpu_block_rules,
    lane_pad,
    prove_lowering,
    write_manifest,
)
from pathway_tpu_torch.analysis.plane import PLANE_RULES, plane_rule
from pathway_tpu_torch.analysis.rules import RULES, default_rules, rule

__all__ = [
    "Diagnostic",
    "DoctorReport",
    "GraphDoctorError",
    "GraphFacts",
    "LoweringCase",
    "LoweringReport",
    "LoweringRuleViolation",
    "PLANE_RULES",
    "RULES",
    "Severity",
    "check_before_run",
    "check_tpu_block_rules",
    "default_rules",
    "lane_pad",
    "node_provenance",
    "plane_rule",
    "prove_lowering",
    "rule",
    "run_doctor",
    "run_plane_doctor",
    "suppress",
    "write_manifest",
]
