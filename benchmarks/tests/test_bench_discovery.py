"""A cell, a configuration, a traffic mix and a metric are added with new
files and new entries only: the harness finds them by name."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

from benchmarks.harness import cell as cellmod, spec
from benchmarks.tests import tiny

METRIC = '''"""Replies per tick of the window."""


def read(ctx):
    return len(ctx.query_tokens_answered) / ctx.ticks if ctx.ticks else None
'''


def test_new_files_and_entries_make_a_new_cell(tmp_path: Path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "benchmarks").rglob("*") if p.is_file()}
    before[tmp_path / "BENCHMARK.json"] = (tmp_path / "BENCHMARK.json").read_bytes()

    # the three new files
    cfg = tiny.config(4096)
    (tmp_path / "benchmarks/configs/tiny-minilm.json").write_text(json.dumps(cfg))
    traffic = tiny.query_cell().traffic
    (tmp_path / "benchmarks/traffic/closed4.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmarks/metrics/replies_per_tick.py").write_text(METRIC)
    # and new entries in BENCHMARK.json, nothing else in it changed
    bench = json.loads(before[tmp_path / "BENCHMARK.json"])
    bench["configs"].append({"name": "tiny-minilm", "source": "https://arxiv.org/abs/2104.08663",
                             "file": "benchmarks/configs/tiny-minilm.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny.query", "config": "tiny-minilm", "traffic": "closed4",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny.query")
    bench["per_layer"].append({"name": "replies_per_tick", "unit": "replies", "better": "higher",
                               "source": "program_counter", "layer": "engine tick",
                               "moves": "queries_per_s", "workloads": ["tiny.query"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data, f"{path} was edited"

    e2e = spec.cell("tiny.query", False, root=tmp_path)
    assert [m["name"] for m in e2e.metrics] == ["queries_per_s", "setup_s"]
    assert e2e.config == cfg and e2e.traffic == traffic
    per_layer = spec.cell("tiny.query", True, root=tmp_path)
    assert [m["name"] for m in per_layer.metrics] == ["replies_per_tick"]
    # the existing cells' metrics are unchanged
    assert [m["name"] for m in spec.cell("nq1m.query", True, root=tmp_path).metrics] == \
        [m["name"] for m in spec.cell("nq1m.query", True).metrics]

    sys.modules.setdefault("transformers", None)
    out = cellmod.run_cell(per_layer, 2**31 + 3, 1.0, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["metrics"]["replies_per_tick"]["value"] > 0


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    done = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", "nq1m.query",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0
    assert "correct" not in done.stdout


def test_every_configured_cell_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        for trace in (False, True):
            c = spec.cell(w["name"], trace)
            assert c.metrics
            for m in c.metrics:
                assert callable(spec.reader(m["name"]))
