"""A run loads neither JAX nor the JAX package: a fresh process imports the
harness, every metric reader and a cell's modules, drives a tiny run on the
CPU, and finds no module whose top-level name is jax, jaxlib, flax or
pathway_tpu."""

import json
import os
import subprocess
import sys

from benchmarks.harness import spec

SCRIPT = r"""
import json, sys, time
sys.modules.setdefault("transformers", None)
sys.path.insert(0, sys.argv[1])
from benchmarks.harness import cell as cellmod, control, devtrace, drive, judge, spec
from benchmarks.tests import tiny
for p in (spec.BENCH_DIR / "metrics").glob("*.py"):
    spec.reader(p.stem)
out = cellmod.run_cell(tiny.query_cell(), 5, 0.5, False, "cpu", time.perf_counter())
print(json.dumps({"correct": out["correct"], "found": cellmod.forbidden_modules(),
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    done = subprocess.run([sys.executable, "-c", SCRIPT, str(spec.ROOT)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["found"] == []
    assert not {"jax", "jaxlib", "flax", "pathway_tpu"} & set(got["top"])
    assert "pathway_tpu_torch" in got["top"]
