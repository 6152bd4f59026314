"""The benchmark of pathway_tpu_torch on one NVIDIA H100.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
its result as the last line of standard output (one JSON object), and the
numbers its correctness was judged by, each beside its limit, as the last
lines of standard error. Exits non-zero, printing no result, without a CUDA
card, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # no library the port may import loads JAX or looks up a model online
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.modules.setdefault("transformers", None)  # the configurations state the hashing tokenizer
    # the span ring holds a whole window
    os.environ["PATHWAY_TRACE_BUFFER"] = str(1 << 20)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from benchmarks.harness import cell as cellmod, spec

    c = spec.cell(args.workload, bool(args.trace))
    if torch.cuda.device_count() < c.chips:
        print(f"{c.name} needs {c.chips} cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = cellmod.run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = cellmod.forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, chk in out["checks"].items():
        print(f"check {name} = {chk['value']!r} (limit {chk['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
