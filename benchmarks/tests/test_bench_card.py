"""On the card: each cell of BENCHMARK.json runs a short window, traced and
untraced, and is judged correct. Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmarks.harness import spec


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_a_short_run_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    done = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", workload,
                           "--seed", "2147483999", "--seconds", "3", "--trace", str(trace)],
                          capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
