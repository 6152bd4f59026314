"""Temporal behaviors of the port against the JAX package's, and the
windowed-index slice that ``chip_smoke.py`` drives on the card.

- ``Table._buffer``, ``_forget`` and ``_freeze`` over int, float, naive and
  UTC datetime times, and the behaviors' glue (``apply_behavior`` on a
  windowed table, ``apply_behavior_to_side`` on one side of a join): one
  graph under both packages over the same seeded stream, the update
  streams pinned (keys, diffs, times, values exact). Refusals alike:
  ``mark_forgetting_records=True``, ``keep_results=False`` without a
  cutoff, exactly-once on a join side.
- The smoke's oracle (``chip_smoke.wi_oracle``, a numpy model of tumbling
  windows under ``common_behavior(delay, cutoff, keep_results=False)``)
  against the JAX package on a smaller stream from ``chip_smoke.wi_stream``:
  after every commit the documents the windows hold equal the oracle's
  live ones, and the documents that never enter a window are its frozen
  ones.
- The slice as a whole: ``chip_smoke.wi_pipeline`` (embedder → windows →
  flatten → join → ``DataIndex`` over ``TpuKnn`` → standing queries, and
  the interval-join leg) under both packages with a 2-layer, 32-wide
  seeded encoder (float32 on both sides): the windows' and the counts'
  update streams equal exactly; the replies' streams equal in keys, diffs,
  times and documents, scores within 1e-5; after every commit each reply
  is the numpy top-k over the oracle's live documents.
- ``inactivity_detection`` with and without instances over a replaced
  ``utc_now`` (the reference's ``test_time_utils.py`` cases), and
  ``utc_now`` itself: a live stream of current UTC timestamps, cached per
  refresh rate, in both packages.

The JAX side runs with ``PATHWAY_COMPILED_TICK=0``."""

import datetime

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from chip_smoke import WI_K, wi_counts, wi_oracle, wi_pipeline, wi_stream
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from test_torch_components import DIM, _embedder
from torch_parity import (
    TIME_KINDS,
    wi_tables,
    assert_outcomes_equal,
    assert_streams_equal,
    event_time,
    markdown,
    outcomes,
    span,
    stream,
    streams,
    time_cell,
)

PACKAGES = {"jax": jpw, "port": tpw}
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _rows(kind, seed, n=30):
    """(id, t, thr, v, __time__, __diff__): event times rising with the
    processing time and some late, thresholds a few units after them, a
    fifth retracted later."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        t = max(0, i // 2 - int(rng.integers(0, 6)) * (rng.random() < 0.3))
        thr = t + int(rng.integers(0, 4))
        tick = 2 * (1 + i // 3)
        v = int(rng.integers(-5, 20))
        rows.append((i + 1, time_cell(kind, t), time_cell(kind, thr), v, tick, 1))
        if rng.random() < 0.2:
            rows.append((i + 1, time_cell(kind, t), time_cell(kind, thr), v, tick + 4, -1))
    return rows


def _table(pw, kind, seed):
    t = pw.debug.table_from_markdown(markdown(["t", "thr", "v"], _rows(kind, seed)))
    return event_time(event_time(t, kind, "t"), kind, "thr")


@pytest.mark.parametrize("op", ["_buffer", "_forget", "_freeze"])
@pytest.mark.parametrize("kind", TIME_KINDS)
def test_time_column_operator(kind, op):
    def build(pw):
        t = _table(pw, kind, 61)
        return getattr(t, op)(t.thr, t.t).select(pw.this.v, pw.this.t)

    got, want = streams(PACKAGES, build)
    assert got
    assert_streams_equal(got, want)


@pytest.mark.parametrize("kind", TIME_KINDS)
def test_time_column_operators_chained(kind):
    def build(pw):
        t = _table(pw, kind, 62)
        frozen = t._freeze(t.thr, t.t)
        forgotten = frozen._forget(frozen.thr, frozen.t)
        return forgotten._buffer(forgotten.thr, forgotten.t).select(pw.this.v)

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want)


def _behavior_module(pw):
    from importlib import import_module

    return import_module(pw.__name__ + ".stdlib.temporal.temporal_behavior")


BEHAVIORS = {
    "none": lambda pw, kind: None,
    "delay": lambda pw, kind: pw.temporal.common_behavior(delay=span(kind, 2)),
    "cutoff": lambda pw, kind: pw.temporal.common_behavior(cutoff=span(kind, 2)),
    "cutoff_forget": lambda pw, kind: pw.temporal.common_behavior(
        delay=span(kind, 1), cutoff=span(kind, 3), keep_results=False),
    "exactly_once": lambda pw, kind: pw.temporal.exactly_once_behavior(shift=span(kind, 1)),
}


@pytest.mark.parametrize("behavior", list(BEHAVIORS))
@pytest.mark.parametrize("kind", TIME_KINDS)
def test_apply_behavior(kind, behavior):
    """apply_behavior on a (row, window) table: thr is the window's start,
    start + 3 units its end."""
    def build(pw):
        t = _table(pw, kind, 63)
        t = t.with_columns(end=t.thr + span(kind, 3))
        return _behavior_module(pw).apply_behavior(t, "t", "thr", "end", BEHAVIORS[behavior](pw, kind))

    got, want = outcomes(PACKAGES, build)
    assert not isinstance(want, tuple), want
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("behavior", list(BEHAVIORS))
@pytest.mark.parametrize("kind", TIME_KINDS)
def test_apply_behavior_to_side(kind, behavior):
    def build(pw):
        t = _table(pw, kind, 64)
        return _behavior_module(pw).apply_behavior_to_side(t, "t", BEHAVIORS[behavior](pw, kind))

    got, want = outcomes(PACKAGES, build)
    assert isinstance(want, tuple) == (behavior == "exactly_once"), want
    assert_outcomes_equal(got, want)


def test_behavior_objects_alike():
    for pw in PACKAGES.values():
        b = pw.temporal.common_behavior(delay=1, cutoff=2, keep_results=False)
        assert (b.delay, b.cutoff, b.keep_results) == (1, 2, False)
        assert isinstance(b, pw.temporal.CommonBehavior)
        e = pw.temporal.exactly_once_behavior(shift=3)
        assert isinstance(e, pw.temporal.ExactlyOnceBehavior) and e.shift == 3
        with pytest.raises(AssertionError):
            pw.temporal.common_behavior(keep_results=False)


def test_forget_marking_records_is_refused_alike():
    def build(pw):
        t = _table(pw, "int", 65)
        return t._forget(t.thr, t.t, mark_forgetting_records=True)

    got, want = outcomes(PACKAGES, build)
    assert want == ("raises", "NotImplementedError")
    assert got == want


# --- the windowed-index slice of chip_smoke.py --------------------------------


def _windowed_docs(pw, s):
    """Only the windows of wi_pipeline (no embedder, no index)."""
    docs, _queries = wi_tables(pw, s)
    from chip_smoke import WI_CUTOFF, WI_DELAY, WI_WINDOW

    return docs.windowby(
        docs.t,
        window=pw.temporal.tumbling(duration=WI_WINDOW),
        instance=docs.topic,
        behavior=pw.temporal.common_behavior(delay=WI_DELAY, cutoff=WI_CUTOFF, keep_results=False),
    ).reduce(ids=pw.reducers.tuple(pw.this.doc_id), n=pw.reducers.count())


def _live_by_commit(events, commits):
    """The documents the windows hold after each commit's tick (tick
    2 * c + 4), from the windows' update stream; and every document that
    ever entered a window."""
    state: dict[int, tuple] = {}
    entered: set[int] = set()
    out = []
    by_time: dict[int, list] = {}
    for time, diff, key, row in events:
        by_time.setdefault(time, []).append((diff, key, dict(row)))
    times = sorted(by_time)
    for c in range(commits):
        for time in [x for x in times if x <= 2 * c + 4]:
            for diff, key, row in sorted(by_time.pop(time), key=lambda e: e[0]):
                if diff > 0:
                    state[key] = row["ids"]
                    entered.update(row["ids"])
                else:
                    state.pop(key, None)
            times.remove(time)
        out.append(np.array(sorted(d for ids in state.values() for d in ids), dtype=np.int64))
    for time in times:
        for diff, _key, row in by_time[time]:
            if diff > 0:
                entered.update(row["ids"])
    return out, entered


@pytest.mark.parametrize("seed", [3, 4])
def test_smoke_oracle_against_the_jax_package(seed):
    s = wi_stream(seed, 1536, 12, 6, 8)
    lives, frozen = wi_oracle(s["t"], s["commit"], s["commits"])
    assert frozen > 0 and max(map(len, lives)) > min(map(len, lives[4:]))  # it drops and forgets
    jpw.internals.parse_graph.G.clear()
    events = stream(jpw, _windowed_docs(jpw, s))
    got, entered = _live_by_commit(events, s["commits"])
    for c, (g, want) in enumerate(zip(got, lives)):
        assert np.array_equal(g, np.sort(want)), f"commit {c}: {len(g)} live, the oracle {len(want)}"
    assert len(s["t"]) - len(entered) == frozen


def test_windowed_index_slice_through_both_packages():
    s = wi_stream(5, 768, 8, 4, 12)
    lives, _frozen = wi_oracle(s["t"], s["commit"], s["commits"])
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        docs, queries = wi_tables(pw, s)
        knn_kw = {"device": "cpu"} if pw is tpw else {}
        tables = wi_pipeline(pw, docs, queries, _embedder(pw), DIM, knn_kw)
        got = {}
        for part in ("windows", "pairs", "counts", "embedded", "asked"):
            got[part] = []

            def on_change(key, row, time, is_addition, into=got[part]):
                into.append((time, 1 if is_addition else -1, int(key), dict(row)))

            pw.io.subscribe(tables[part], on_change=on_change)
        pw.run()
        out[name] = got
    port, ref = out["port"], out["jax"]

    def plain(events):
        return sorted((t, d, k, tuple(sorted(r.items()))) for t, d, k, r in events)

    assert plain(port["windows"]) == plain(ref["windows"])
    assert plain(port["counts"]) == plain(ref["counts"])
    pp = sorted((t, d, k, r["qid"], r["doc_id"], r["score"]) for t, d, k, r in port["pairs"])
    rp = sorted((t, d, k, r["qid"], r["doc_id"], r["score"]) for t, d, k, r in ref["pairs"])
    assert [p[:5] for p in pp] == [r[:5] for r in rp]
    # a query of an empty index gets one row with no document and no score
    assert all((p[5] is None) == (r[5] is None) for p, r in zip(pp, rp))
    assert max(abs(p[5] - r[5]) for p, r in zip(pp, rp) if p[5] is not None) <= SCORE_TOL
    # after every commit: each reply is the numpy top-k over the oracle's
    # live documents, and the counts are numpy's
    vecs = {r["doc_id"]: np.asarray(r["vec"], dtype=np.float64) for _t, d, _k, r in port["embedded"] if d > 0}
    qvecs = {r["qid"]: np.asarray(r["vec"], dtype=np.float64) for _t, d, _k, r in port["asked"] if d > 0}
    for c in range(s["commits"]):
        tick = 2 * c + 4
        state: dict[int, tuple] = {}
        counts: dict[int, int] = {}
        for t, d, k, r in sorted(port["pairs"], key=lambda e: (e[0], e[1])):
            if t <= tick:
                if d > 0:
                    state[k] = (r["qid"], r["doc_id"], r["score"])
                elif state.get(k) == (r["qid"], r["doc_id"], r["score"]):
                    del state[k]
        for t, d, _k, r in sorted(port["counts"], key=lambda e: (e[0], e[1])):
            if t <= tick:
                if d > 0:
                    counts[r["qid"]] = r["n"]
                elif counts.get(r["qid"]) == r["n"]:
                    del counts[r["qid"]]
        assert counts == wi_counts(s, c)
        live = lives[c]
        m = np.stack([vecs[int(x)] for x in live])
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        for q, v in qvecs.items():
            sc = m @ (v / np.linalg.norm(v))
            order = np.argsort(-sc, kind="stable")[:WI_K]
            got = sorted(((dd, ss) for qq, dd, ss in state.values() if qq == q and dd is not None),
                         key=lambda p: -p[1])
            assert [dd for dd, _ss in got] == [int(live[j]) for j in order], (c, q)
            assert np.allclose([ss for _dd, ss in got], sc[order] - 1.0, atol=SCORE_TOL)


# --- time_utils: inactivity_detection over a replaced utc_now, and utc_now ----


def _inactivity_build(with_instance):
    """The reference's ``test_time_utils.py`` cases: events with gaps, and
    ``utc_now`` replaced by a ticking stream of timestamps every 50 ms. The
    events lie 100 s ahead of the wall clock: the detection ignores
    events older than the graph's build (its backfill filter)."""
    now = datetime.datetime.now(datetime.timezone.utc)
    now_ms = int(now.timestamp()) * 1000 + 100_000

    def build(pw, monkeypatch):
        from importlib import import_module

        rows = [(1, 0, "A"), (2, 50, "A"), (3, 150, "A"), (4, 200, "A"), (5, 900, "A"), (6, 1000, "A"),
                (7, 0, "B"), (8, 200, "B"), (9, 400, "B"), (10, 1000, "B")]
        if not with_instance:
            rows = [r for r in rows if r[2] == "A"]
        events = pw.debug.table_from_markdown(markdown(
            ["t", "instance"], [(i, now_ms + dt, inst, now_ms + dt, 1) for i, dt, inst in rows]
        )).with_columns(t=pw.this.t.dt.utc_from_timestamp(unit="ms"))

        def utc_now(refresh_rate):
            step = int(refresh_rate.total_seconds() * 1000)
            return pw.debug.table_from_rows(
                pw.schema_from_types(t=int),
                [(ms, ms, 1) for ms in range(now_ms, now_ms + 1400, step)],
                is_stream=True,
            ).select(timestamp_utc=pw.this.t.dt.utc_from_timestamp(unit="ms"))

        monkeypatch.setattr(import_module(pw.__name__ + ".stdlib.temporal.time_utils"), "utc_now", utc_now)
        kw = {"instance": pw.this.instance} if with_instance else {}
        inactive, resumed = pw.temporal.inactivity_detection(
            events.t, datetime.timedelta(milliseconds=300), refresh_rate=datetime.timedelta(milliseconds=50), **kw)
        return (inactive.with_columns(inactive_t=pw.cast(int, pw.this.inactive_t.dt.timestamp(unit="ms"))),
                resumed.with_columns(resumed_t=pw.cast(int, pw.this.resumed_t.dt.timestamp(unit="ms"))))

    return build


@pytest.mark.parametrize("part", [0, 1], ids=["inactivities", "resumed_activities"])
@pytest.mark.parametrize("with_instance", [False, True])
def test_inactivity_detection(with_instance, part, monkeypatch):
    build = _inactivity_build(with_instance)
    got, want = streams(PACKAGES, lambda pw: build(pw, monkeypatch)[part])
    assert got
    assert_streams_equal(got, want)


def test_utc_now_streams_current_timestamps_alike():
    import threading
    import time as _time

    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
        rate = datetime.timedelta(milliseconds=20)
        table = pw.temporal.utc_now(refresh_rate=rate)
        assert pw.temporal.utc_now(refresh_rate=rate) is table  # cached per refresh rate
        assert table.column_names() == ["timestamp_utc"]
        seen = []
        pw.io.subscribe(table, on_change=lambda key, row, time, is_addition: seen.append(row["timestamp_utc"]))
        before = datetime.datetime.now(datetime.timezone.utc)
        runner = threading.Thread(target=pw.run, daemon=True)
        runner.start()
        deadline = _time.time() + 30
        while len(seen) < 3 and _time.time() < deadline:
            _time.sleep(0.01)
        pw.internals.parse_graph.G.runtime.stop()
        runner.join(timeout=30)
        assert len(seen) >= 3 and seen == sorted(seen), (pw.__name__, seen)
        assert all(s.tzinfo is not None and s >= before for s in seen), (pw.__name__, seen)
