"""The one general traffic generator: its sources run side by side in the
window, and a traffic file asking for what it does not do is refused."""

import sys
import time

import pytest

from benchmarks.harness import drive, judge
from benchmarks.tests import tiny


@pytest.mark.parametrize("bad", [
    {"clients": 2, "autocommit_ms": 5, "pool": 8, "judged_replies": 4, "burst": 3},
    {"clients": 2, "arrivals": {"process": "poisson", "rate_per_s": 5}, "autocommit_ms": 5},
    {"arrivals": {"process": "uniform", "rate_per_s": 5}, "autocommit_ms": 5},
    {"arrivals": {"process": "poisson", "rate_per_s": 5, "burst": 2}, "autocommit_ms": 5},
    {"clients": 0, "ingest": {"commit_rows": 8, "warmup_commits": 1}, "autocommit_ms": 5},
    {"clients": 0, "ingest": {"commit_rows": 8, "max_unfinished": 2, "period_s": 1.0,
                              "warmup_commits": 1}, "autocommit_ms": 5},
    {"clients": 0, "ingest": {"commit_rows": 8, "max_unfinished": 2, "filter": "x",
                              "warmup_commits": 1}, "autocommit_ms": 5},
    {"clients": 0, "ingest": None, "autocommit_ms": 5},
], ids=["top_key", "closed_and_open", "process", "arrival_key", "no_pace", "two_paces",
        "ingest_key", "nothing_to_send"])
def test_a_key_the_generator_does_not_implement_is_refused(bad):
    with pytest.raises(ValueError):
        drive.check_traffic(bad)


def test_the_existing_traffic_files_are_accepted():
    from benchmarks.harness import spec

    for w in spec.load_benchmark()["workloads"]:
        drive.check_traffic(spec.cell(w["name"], False).traffic)


def test_clients_and_a_feeder_run_side_by_side_in_the_window():
    c = tiny.ingest_cell()
    c.traffic = dict(c.traffic, clients=3, warmup_s=0.3)
    c.config = tiny.config(1024)
    sys.modules.setdefault("transformers", None)
    rec = drive.run(c.config, c.traffic, 2**31 + 41, 1.5, False, "cpu", time.perf_counter())
    queries, probes = judge.window_queries(rec), judge.window_probes(rec)
    assert len(queries) > 10 and len(probes) > 3, (len(queries), len(probes))
    checks, _attempted, failed = judge.judge(c.config, c.traffic, 2**31 + 41, rec, "cpu")
    assert judge.correct(checks), checks
    assert failed == 0


def test_open_loop_arrivals_and_periodic_commits():
    c = tiny.mixed_cell()
    sys.modules.setdefault("transformers", None)
    rec = drive.run(c.config, c.traffic, 2**31 + 43, 2.0, False, "cpu", time.perf_counter())
    queries, probes = judge.window_queries(rec), judge.window_probes(rec)
    # 40 queries/s and a commit every 0.25 s over 2 s, both in the window
    assert 40 <= len(queries) <= 120, len(queries)
    assert 6 <= len(probes) <= 9, len(probes)
    assert all(q in rec.replies for q in queries)
    starts = [t for t, *_x in probes]
    assert min(b - a for a, b in zip(starts, starts[1:])) > 0.2
    checks, attempted, failed = judge.judge(c.config, c.traffic, 2**31 + 43, rec, "cpu")
    assert judge.correct(checks), checks
    assert attempted == len(queries) + len(probes) and failed == 0


def test_open_loop_gaps_are_one_multiset_for_every_seed():
    import numpy as np

    from benchmarks.harness import textgen

    a = drive._OpenLoop(drive.Record(), None, None, {"rate_per_s": 50}, 256, textgen.seed_seq(1, 7))
    b = drive._OpenLoop(drive.Record(), None, None, {"rate_per_s": 50}, 256, textgen.seed_seq(2, 7))
    assert np.array_equal(np.sort(a.gaps), np.sort(b.gaps))
    assert a.gaps.mean() == pytest.approx(1 / 50, rel=0.05)
