"""The check must fail what it exists to catch. The controls (the reference
one precision step below the configuration's: fp8 encoder, TF32 scoring;
the program with its bf16 scoring path switched on) and runs whose timed
path is broken underneath, one fault each, must all come out not correct;
the look for a card is skipped, the rest of a run is driven as on the
card."""

import sys
import time

import pytest

from benchmarks.harness import cell as cellmod, control, judge
from benchmarks.tests import tiny


@pytest.mark.parametrize("make", [tiny.query_cell, tiny.ingest_cell], ids=["query", "ingest"])
@pytest.mark.parametrize("seed", [1, 2])
def test_the_control_fails_the_check(make, seed):
    c = make()
    got = control.readings(c.config, c.traffic, seed, "cpu", 640)
    limits = c.config["correct_limits"]
    assert any(got[name] > limit for name, limit in limits.items()), got


@pytest.mark.parametrize("make", [tiny.query_cell, tiny.ingest_cell], ids=["query", "ingest"])
@pytest.mark.parametrize("steps", [{"encoder": "float32", "scoring": "tf32"},
                                   {"encoder": "fp8", "scoring": "float32"}], ids=["tf32", "fp8"])
def test_each_precision_step_alone_fails_its_own_numbers(make, steps):
    """TF32 scoring alone fails the index's gaps; the fp8 encoder alone
    fails the encoder's and leaves the index's, scored exactly, alone."""
    c = make()
    got = control.readings(c.config, c.traffic, 5, "cpu", 640, **steps)
    limits = c.config["correct_limits"]
    index = {"index_rank_gap", "index_score_gap"}
    if steps["scoring"] == "tf32":
        assert any(got[n] > limits[n] for n in index), got
    else:
        assert all(got[n] <= limits[n] for n in index), got
        assert any(got[n] > limits[n] for n in limits if n not in index), got


def _run(cell):
    sys.modules.setdefault("transformers", None)
    return cellmod.run_cell(cell, 2**31 + 23, 1.0, False, "cpu", time.perf_counter())


def _altered(monkeypatch):
    """An answer altered where it is produced: the index's best row swapped
    with its last."""
    from pathway_tpu_torch.stdlib.indexing import _index_impls

    orig = _index_impls.TpuDenseKnnIndex._replies

    def swapped(self, queries, qmat, n_q, eff_k, scores, idx, t0):
        idx = idx.clone()
        idx[:, [0, -1]] = idx[:, [-1, 0]]
        return orig(self, queries, qmat, n_q, eff_k, scores, idx, t0)

    monkeypatch.setattr(_index_impls.TpuDenseKnnIndex, "_replies", swapped)


def _half_left_out(monkeypatch):
    """Half of each search's batch left out: its second half answered with
    nothing (a batch of one loses its one query)."""
    from pathway_tpu_torch.stdlib.indexing import _index_impls

    orig = _index_impls.TpuDenseKnnIndex.search

    def half(self, queries):
        keep = len(queries) // 2
        return list(orig(self, queries[:keep])) + [()] * (len(queries) - keep)

    monkeypatch.setattr(_index_impls.TpuDenseKnnIndex, "search", half)


def _state_unchanged(monkeypatch, allowed: int):
    """A step that returns its state unchanged: the index's upserts after
    the first ``allowed`` (the set-up's) do nothing."""
    from pathway_tpu_torch.stdlib.indexing import _index_impls

    orig = _index_impls.TpuDenseKnnIndex.upsert
    seen = [0]

    def frozen(self, key, data, metadata):
        seen[0] += 1
        if seen[0] <= allowed:
            orig(self, key, data, metadata)

    monkeypatch.setattr(_index_impls.TpuDenseKnnIndex, "upsert", frozen)


# the faults each cell can have: the query cell's window changes no state,
# and no cell exchanges anything between cards
CASES = [("query", "altered"), ("query", "half_left_out"),
         ("ingest", "altered"), ("ingest", "half_left_out"), ("ingest", "state_unchanged")]


@pytest.mark.parametrize("kind", ["query", "ingest"])
def test_the_programs_bf16_scoring_is_not_correct(kind):
    c = tiny.query_cell() if kind == "query" else tiny.ingest_cell()
    with control.program_bf16_scoring():
        out = _run(c)
    assert not out["correct"], out["checks"]
    checks = out["checks"]
    assert checks["index_score_gap"]["value"] > checks["index_score_gap"]["limit"], checks


@pytest.mark.parametrize("kind, fault", CASES)
def test_a_broken_timed_path_is_not_correct(kind, fault, monkeypatch):
    c = tiny.query_cell() if kind == "query" else tiny.ingest_cell()
    if fault == "altered":
        _altered(monkeypatch)
    elif fault == "half_left_out":
        _half_left_out(monkeypatch)
    else:
        ingest = c.traffic["ingest"]
        _state_unchanged(monkeypatch, ingest["warmup_commits"] * ingest["commit_rows"])
    out = _run(c)
    assert not out["correct"], out["checks"]
    assert not judge.correct(out["checks"])
