"""Reads the correctness check's controls on the card, judged like a run,
over several seeds. By default the control is the reference in the
program's place one precision step below the configuration's (fp8 encoder,
TF32 scoring):

    python3 benchmarks/control.py --workload nq1m.query --seeds 1 2 3 [--passages 40960]
        [--encoder fp8|float32] [--scoring tf32|float32]

``--passages`` sizes an ingest cell's index as a run's window fills it.
With ``--program-bf16 SECONDS`` the control is a run of the cell itself,
a window of SECONDS at the cell's own load, with the program's bfloat16
scoring path switched on for its index:

    python3 benchmarks/control.py --workload nq1m.query --seeds 1 2 3 --program-bf16 10

Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--passages", type=int, default=0)
    ap.add_argument("--encoder", default="fp8")
    ap.add_argument("--scoring", default="tf32")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--program-bf16", type=float, default=0.0, metavar="SECONDS")
    args = ap.parse_args()
    os.environ["USE_FLAX"] = "0"
    sys.modules.setdefault("transformers", None)
    sys.path.insert(0, str(ROOT))
    from benchmarks.harness import cell as cellmod, control, spec

    c = spec.cell(args.workload, False)
    for seed in args.seeds:
        if args.program_bf16:
            with control.program_bf16_scoring():
                out = cellmod.run_cell(c, seed, args.program_bf16, False, args.device, time.perf_counter())
            print(json.dumps({"workload": c.name, "seed": seed, "program": "bf16 scoring",
                              "correct": out["correct"],
                              **{name: chk["value"] for name, chk in out["checks"].items()}}), flush=True)
            continue
        got = control.readings(c.config, c.traffic, seed, args.device, args.passages,
                               encoder=args.encoder, scoring=args.scoring)
        print(json.dumps({"workload": c.name, "seed": seed, "encoder": args.encoder,
                          "scoring": args.scoring, "passages": args.passages, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
