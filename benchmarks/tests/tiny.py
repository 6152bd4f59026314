"""Tiny stand-ins of the benchmark's configurations and traffic, for the
CPU tests: the same keys at sizes a test run holds."""

from __future__ import annotations

import copy
import json

from benchmarks.harness import spec

ENCODER = {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
           "intermediate_size": 128, "vocab_size": 30522, "max_seq_length": 64,
           "weights": "bfloat16", "compute": "bfloat16", "tokenizer": "hashing"}


# set from CPU readings at these sizes: sound runs read rank and score gaps
# of 1e-4 to 7e-4, the fp8 / TF32 control 1.2e-3 to 5.7e-3; the index's
# gaps read under 1e-6 in sound runs, 2e-5 and more under TF32 or bf16
# scoring
INDEX = {"index_rank_gap": 5e-6, "index_score_gap": 5e-6}
LIMITS = {"query": {"rank_gap": 2e-3, "score_gap": 2e-3, **INDEX},
          "ingest": {"rank_gap": 9e-4, "score_gap": 9e-4, **INDEX}}


def config(prefilled: int) -> dict:
    cfg = json.loads((spec.BENCH_DIR / "configs" / "nq-minilm-1m.json").read_text())
    cfg["encoder"] = copy.deepcopy(ENCODER)
    cfg["correct_limits"] = dict(LIMITS["query" if prefilled else "ingest"])
    cfg["index"].update(reserved_space=4096, prefilled_rows=prefilled, prefill_commit_rows=1024)
    cfg["queries"] = {"mean_words": 8, "sigma": 0.4, "min_words": 2, "max_words": 20}
    cfg["passages"] = {"mean_words": 20, "sigma": 0.5, "min_words": 4, "max_words": 60}
    return cfg


def query_cell(metrics=()) -> spec.Cell:
    traffic = {"clients": 4, "autocommit_ms": 5, "warmup_s": 0.3, "pool": 64,
               "judged_replies": 16, "ingest": None}
    return spec.Cell("tiny.query", config(4096), traffic, list(metrics), 1)


def ingest_cell(metrics=()) -> spec.Cell:
    traffic = {"clients": 0, "autocommit_ms": 5, "pool": 64, "judged_replies": 16,
               "ingest": {"commit_rows": 32, "max_unfinished": 2, "warmup_commits": 2}}
    return spec.Cell("tiny.ingest", config(0), traffic, list(metrics), 1)


def mixed_cell(metrics=()) -> spec.Cell:
    """Open-loop queries and a periodic feeder side by side."""
    traffic = {"arrivals": {"process": "poisson", "rate_per_s": 40}, "autocommit_ms": 5,
               "warmup_s": 0.3, "pool": 64, "judged_replies": 16,
               "ingest": {"commit_rows": 32, "period_s": 0.25, "warmup_commits": 2}}
    return spec.Cell("tiny.mixed", config(1024), traffic, list(metrics), 1)
