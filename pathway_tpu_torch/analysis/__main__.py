"""``python -m pathway_tpu_torch.analysis <script.py>`` — build, don't
execute (counterpart of ``python -m pathway_tpu.analysis``, with its flags).

Runs the user script with ``pw.run``/``pw.run_all`` turned into no-ops,
so the script *declares* its dataflow exactly as it would in production
but the engine never starts; then the Graph Doctor reports over the
declared graph. Exit status is governed by ``--fail-on`` (default:
nonzero when any ERROR-severity finding exists), so the command slots
into CI next to a type-checker.

``--plane`` widens the scope from one graph to the deployment plane:
the plane rules (snapshot coverage, pickle-on-hot-path, ``PATHWAY_*``
knob coherence — analysis/plane.py) run alongside the graph rules, and
the Hopper launch ledger proves every kernel family's launches against
Hopper's limits with no GPU (analysis/lowering.py), writing the
content-addressed manifest to ``build/pathway_tpu_torch/launch_ledger.json``
(``--manifest PATH`` elsewhere, ``--manifest none`` skips it). The script
argument becomes optional: knob lint + launch proofs are meaningful with
no graph at all.
"""

from __future__ import annotations

import argparse
import json
import runpy
import sys

from pathway_tpu_torch.analysis.diagnostics import Severity
from pathway_tpu_torch.analysis.doctor import (
    DoctorReport,
    run_doctor,
    run_plane_doctor,
)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.analysis",
        description="Graph Doctor: static analysis over the dataflow a "
        "pathway_tpu_torch script declares, without executing it. Doctor "
        "options go BEFORE the script path; everything after it is "
        "passed through to the script (like `python` itself).",
    )
    parser.add_argument(
        "script",
        nargs="?",
        default=None,
        help="pipeline script to analyze (optional with --plane)",
    )
    parser.add_argument(
        "script_args",
        nargs=argparse.REMAINDER,
        help="arguments passed through to the script's sys.argv",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit diagnostics as a JSON document instead of text",
    )
    parser.add_argument(
        "--min-severity",
        default="info",
        choices=["info", "warning", "error"],
        help="hide findings below this severity (default: info)",
    )
    parser.add_argument(
        "--fail-on",
        default="error",
        choices=["error", "warning", "never"],
        help="exit nonzero when a finding at/above this severity exists "
        "(default: error)",
    )
    parser.add_argument(
        "--rule",
        action="append",
        dest="rules",
        metavar="RULE_ID",
        help="run only this rule (repeatable)",
    )
    parser.add_argument(
        "--plane",
        action="store_true",
        help="deployment-plane mode: run the plane rules (snapshot "
        "coverage, pickle-hot-path, PATHWAY_* knob lint) and prove "
        "every kernel family's launches against Hopper's limits with no "
        "GPU, writing the launch manifest",
    )
    parser.add_argument(
        "--manifest",
        default=None,
        metavar="PATH",
        help="where --plane writes the content-addressed launch "
        "manifest (default: build/pathway_tpu_torch/launch_ledger.json; "
        "'none' skips)",
    )
    parser.add_argument(
        "--prove-shape",
        action="append",
        dest="prove_shapes",
        metavar="FAMILY:k=v,...",
        help="prove one extra kernel shape in --plane mode, e.g. "
        "paged_attention:head_dim=129 or block_topk:b=16,d=32768 "
        "(repeatable); shapes the launch gate rejects become ERROR "
        "findings",
    )
    args = parser.parse_args(argv)

    if args.script is None and not args.plane:
        parser.error("a script is required unless --plane is given")

    if args.script is not None:
        import importlib

        # the module, not the re-exported `run` function: the build-only
        # flag lives in the module namespace
        run_mod = importlib.import_module("pathway_tpu_torch.internals.run")

        # declare-only mode: pw.run()/run_all() inside the script return
        # without building a Runtime
        run_mod._build_only = True
        saved_argv = sys.argv
        sys.argv = [args.script] + args.script_args
        try:
            runpy.run_path(args.script, run_name="__main__")
        finally:
            sys.argv = saved_argv
            run_mod._build_only = False

    from pathway_tpu_torch.internals import parse_graph

    seeds = list(parse_graph.G.outputs) or None

    diagnostics = []
    manifest_doc = None
    try:
        # --rule may name ids from either registry; unknown ids error
        graph_rule_ids = args.rules
        plane_rule_ids = args.rules
        if args.plane and args.rules:
            from pathway_tpu_torch.analysis.plane import PLANE_RULES
            from pathway_tpu_torch.analysis.rules import RULES

            unknown = sorted(
                set(args.rules) - set(RULES) - set(PLANE_RULES)
            )
            if unknown:
                raise ValueError(
                    f"unknown rule id(s) {unknown}; registered: "
                    f"{sorted(set(RULES) | set(PLANE_RULES))}"
                )
            graph_rule_ids = [r for r in args.rules if r in RULES]
            plane_rule_ids = [r for r in args.rules if r in PLANE_RULES]
        if args.script is not None and (
            graph_rule_ids is None or graph_rule_ids
        ):
            diagnostics.extend(
                run_doctor(outputs=seeds, rules=graph_rule_ids)
            )
        if args.plane and (plane_rule_ids is None or plane_rule_ids):
            diagnostics.extend(
                run_plane_doctor(outputs=seeds, rules=plane_rule_ids)
            )
    except ValueError as e:  # e.g. a typoed --rule id
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.plane:
        from pathway_tpu_torch.analysis import lowering as ledger

        extra_cases = []
        for spec in args.prove_shapes or ():
            try:
                family, shape = ledger.parse_shape_spec(spec)
                extra_cases.append(ledger.case_for_shape(family, shape))
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        lowering_report = ledger.prove_lowering()
        if extra_cases:
            extra = ledger.prove_lowering(cases=extra_cases)
            lowering_report.entries.extend(extra.entries)
            lowering_report.findings.extend(extra.findings)
        diagnostics.extend(lowering_report.findings)
        manifest_doc = lowering_report.to_manifest()
        if args.manifest != "none":
            ledger.write_manifest(lowering_report, args.manifest)

    report = DoctorReport(
        sorted(diagnostics, key=lambda d: (-int(d.severity), d.rule))
    )

    min_sev = Severity.parse(args.min_severity)
    if args.json:
        out: dict | list = [
            d.to_dict() for d in report if d.severity >= min_sev
        ]
        if args.plane:
            from pathway_tpu_torch.serving.config import plane_knobs

            out = {
                "findings": out,
                "knobs": plane_knobs(),
                "lowering": manifest_doc,
            }
        print(json.dumps(out, indent=2, default=str))
    else:
        print(report.format(min_severity=min_sev))
        if manifest_doc is not None:
            counts: dict[str, int] = {}
            for case in manifest_doc["cases"]:
                counts[case["status"]] = counts.get(case["status"], 0) + 1
            summary = ", ".join(
                f"{n} {s}" for s, n in sorted(counts.items())
            )
            print(
                f"launch ledger: {len(manifest_doc['cases'])} case(s) "
                f"({summary}) — sha256 "
                f"{manifest_doc['content_sha256'][:12]}"
            )

    if args.fail_on == "never":
        return 0
    threshold = Severity.parse(args.fail_on)
    return 1 if report.count_at_least(threshold) else 0


if __name__ == "__main__":
    sys.exit(main())
