"""The port's incremental engine against the JAX package's: the same
operator pipelines, built from the same ``table_from_markdown`` streams
(``__time__``/``__diff__``), run under both packages and must give the same
update stream — every (time, diff, id, values) event, ids included. Events
within one logical time are compared as a multiset (the order of rows in
one tick is not part of the engine's contract: the reference's native
consolidation orders them differently from the pure-Python one).

The JAX side runs with ``PATHWAY_COMPILED_TICK=0``, its byte-identical
interpreter; the port has no compiled ticks. Also checks the port's numpy
``factorize`` (which replaces ``pd.factorize`` in the columnar groupby)
against pandas on the type sets the groupby lets through."""

import numpy as np
import pandas as pd
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.engine.nodes import factorize
from pathway_tpu_torch.internals import parse_graph as port_parse_graph


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    # tests/conftest.py clears only the JAX package's parse graph
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _norm(v):
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    if type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    if type(v).__name__ == "Json":
        return ("json", repr(v.value))
    if isinstance(v, float) and v != v:
        return "nan"
    return v


def _stream(pw, build):
    events = []

    def on_change(key, row, time, is_addition):
        events.append(
            (time, 1 if is_addition else -1, int(key),
             tuple(sorted((k, _norm(v)) for k, v in row.items())))
        )

    pw.io.subscribe(build(pw), on_change=on_change)
    pw.run()
    return sorted(events, key=repr)


NUMS = """
    | k | v  | name | __time__ | __diff__
  1 | a | 1  | x    | 2        | 1
  2 | b | 5  | y    | 2        | 1
  3 | a | 7  | z    | 4        | 1
  4 | c | -2 | x    | 4        | 1
  2 | b | 5  | y    | 6        | -1
  5 | b | 3  | w    | 6        | 1
  6 | a | 7  | q    | 8        | 1
"""

OTHER = """
    | k | label | __time__ | __diff__
 11 | a | alpha | 2        | 1
 12 | b | beta  | 4        | 1
 13 | d | delta | 4        | 1
 12 | b | beta  | 8        | -1
"""


def _nums(pw):
    return pw.debug.table_from_markdown(NUMS)


def _other(pw):
    return pw.debug.table_from_markdown(OTHER)


def p_select(pw):
    t = _nums(pw)
    return t.select(k=t.k, w=t.v * 2 + 1, s=pw.if_else(t.v > 2, "big", "small"))


def p_filter(pw):
    t = _nums(pw)
    return t.filter((t.v >= 1) & (t.k != "c"))


def p_groupby_count_sum(pw):
    t = _nums(pw)
    return t.groupby(t.k).reduce(t.k, n=pw.reducers.count(), s=pw.reducers.sum(t.v))


def p_groupby_min_argmax(pw):
    t = _nums(pw)
    return t.groupby(t.k).reduce(
        t.k, lo=pw.reducers.min(t.v), hi=pw.reducers.max(t.v), am=pw.reducers.argmax(t.v)
    )


def p_groupby_tuple(pw):
    t = _nums(pw)
    return t.groupby(t.k, sort_by=t.v).reduce(t.k, vs=pw.reducers.tuple(t.v))


def p_inner_join(pw):
    a, b = _nums(pw), _other(pw)
    return a.join(b, a.k == b.k).select(a.k, a.v, b.label)


def p_left_join(pw):
    a, b = _nums(pw), _other(pw)
    return a.join_left(b, a.k == b.k).select(a.v, lbl=pw.coalesce(b.label, "none"))


def p_flatten(pw):
    t = _nums(pw)
    w = t.select(t.k, parts=pw.apply(lambda n: tuple(range(abs(n) % 4)), t.v))
    return w.flatten(w.parts)


def p_ix(pw):
    a, b = _nums(pw), _other(pw)
    by_k = b.with_id_from(b.k)
    return a.select(a.v, lbl=by_k.ix(by_k.pointer_from(a.k), optional=True).label)


def p_concat_reindex(pw):
    a, b = _nums(pw), _other(pw)
    return a.select(a.k).concat_reindex(b.select(b.k))


def p_update_rows(pw):
    a = _nums(pw)
    b = pw.debug.table_from_markdown(
        """
        | k | v   | name | __time__
      3 | a | 100 | upd  | 6
      9 | e | 9   | new  | 6
    """
    )
    return a.update_rows(b)


def p_deduplicate(pw):
    t = _nums(pw)
    return t.deduplicate(value=t.v, instance=t.k, acceptor=lambda new, old: new > old)


def p_sort(pw):
    t = _nums(pw)
    s = t.sort(key=t.v)
    return t.select(t.v, prev=s.prev, next=s.next)


def p_udf(pw):
    @pw.udf
    def shout(name: str, v: int) -> str:
        return f"{name.upper()}{v * 3}"

    t = _nums(pw)
    return t.select(out=shout(t.name, t.v))


def p_groupby_bulk(pw):
    # >= 256 rows per tick takes the columnar (factorize) groupby path
    rows = "\n".join(
        f"  {i} | {'g' + str(i % 13) if i % 11 else ''} | {i % 17} | {2 + 2 * (i // 300)}"
        for i in range(600)
    )
    t = pw.debug.table_from_markdown("    | g | v | __time__\n" + rows)
    return t.groupby(t.g).reduce(t.g, n=pw.reducers.count(), s=pw.reducers.sum(t.v))


def p_groupby_two_columns_bulk(pw):
    rows = "\n".join(f"  {i} | {i % 5} | {i % 3 == 0} | {i}" for i in range(300))
    t = pw.debug.table_from_markdown("    | a | b | v\n" + rows)
    return t.groupby(t.a, t.b).reduce(t.a, t.b, hi=pw.reducers.max(t.v))


def p_udf_chain(pw):
    t = _nums(pw)
    doubled = t.select(t.k, d=pw.apply(lambda x: x * 2, t.v))
    return doubled.groupby(doubled.k).reduce(doubled.k, total=pw.reducers.sum(doubled.d))


def p_strings(pw):
    t = pw.debug.table_from_markdown(
        """
        | day        | word  | __time__
      1 | 2024-03-01 | Alpha | 2
      2 | 2023-12-31 | beta  | 4
    """
    )
    d = t.select(y=t.day.str.slice(0, 4), w=t.word.str.upper())
    return d.select(y=d.y, w=d.w, n=d.w.str.len(), low=d.w.str.lower())


PIPELINES = [
    p_select, p_filter, p_groupby_count_sum, p_groupby_min_argmax, p_groupby_tuple,
    p_inner_join, p_left_join, p_flatten, p_ix, p_concat_reindex, p_update_rows,
    p_deduplicate, p_sort, p_udf, p_groupby_bulk, p_groupby_two_columns_bulk,
    p_udf_chain, p_strings,
]


@pytest.mark.parametrize("build", PIPELINES, ids=lambda f: f.__name__[2:])
def test_update_stream_equals_reference(build):
    ref = _stream(jpw, build)
    port = _stream(tpw, build)
    assert ref, "the pipeline produced no events"
    assert port == ref


SAFE_ARRAYS = {
    "str": np.array(["b", "a", "b", "c", "a"], dtype=object),
    "str_none": np.array(["b", None, "a", None, "b"], dtype=object),
    "int": np.array([5, -1, 5, 3, -1, 2**40], dtype=object),
    "int_none": np.array([None, 4, 4, None, 1], dtype=object),
    "float": np.array([0.5, float("nan"), 0.5, -0.0, 0.0, float("nan")], dtype=object),
    "bool": np.array([True, False, True, True], dtype=object),
    "none": np.array([None, None, None], dtype=object),
    "int64": np.array([3, 1, 3, 2, 1], dtype=np.int64),
    "float64": np.array([2.5, np.nan, 2.5, 1.0, np.nan]),
    "bool_": np.array([False, True, False]),
    "unicode": np.array(["x", "yy", "x", "z"]),
}


@pytest.mark.parametrize("name", sorted(SAFE_ARRAYS))
def test_factorize_matches_pandas(name):
    arr = SAFE_ARRAYS[name]
    codes, first = factorize(arr)
    ref_codes, ref_uniques = pd.factorize(arr, use_na_sentinel=False)
    assert codes.tolist() == ref_codes.tolist()
    assert len(first) == len(ref_uniques)
    assert [codes[i] for i in first] == list(range(len(first)))


def test_factorize_refuses_unorderable_values():
    with pytest.raises(TypeError):
        factorize(np.array(["a", 1, "b"], dtype=object))


def _python_stream(make_run, **read_kw):
    """(time, diff, v) events of a one-column ``pw.io.python`` table whose
    subject runs ``make_run(subject, seen)``; ``seen`` is set at every
    event, so a subject can wait for the engine."""
    import threading

    events = []
    seen = threading.Event()

    class Subject(tpw.io.python.ConnectorSubject):
        def run(self):
            make_run(self, seen)

    t = tpw.io.python.read(Subject(), schema=tpw.schema_from_types(v=int), **read_kw)

    def on_change(key, row, time, is_addition):
        events.append((time, 1 if is_addition else -1, row["v"]))
        seen.set()

    tpw.io.subscribe(t, on_change=on_change)
    tpw.run()
    return events


def _push(subject, vs):
    for v in vs:
        subject.next(v=v)


def test_python_commit_is_one_tick():
    def run(s, seen):
        for lo in (0, 40, 80):
            _push(s, range(lo, lo + 40))
            s.commit()
            assert seen.wait(10)
            seen.clear()

    events = _python_stream(run)
    times = sorted({t for t, _d, _v in events})
    assert len(events) == 120 and len(times) == 3
    for i, t in enumerate(times):
        assert sorted(v for tt, _d, v in events if tt == t) == list(range(40 * i, 40 * i + 40))


def test_python_uncommitted_rows_arrive_when_run_returns():
    events = _python_stream(lambda s, _seen: _push(s, range(7)), autocommit_duration_ms=None)
    assert sorted(v for _t, _d, v in events) == list(range(7))
    assert len({t for t, _d, _v in events}) == 1


def test_python_autocommit_takes_uncommitted_rows():
    def run(s, seen):
        _push(s, range(5))
        assert seen.wait(10), "the autocommit never took the staged rows"

    events = _python_stream(run, autocommit_duration_ms=20)
    assert sorted(v for _t, _d, v in events) == list(range(5))


def test_python_removals_commit_together():
    def run(s, seen):
        _push(s, range(6))
        s.commit()
        assert seen.wait(10)
        for v in (1, 3, 5):
            s._remove(tpw.internals.api.ref_scalar(id(s), v + 1), {"v": v})
        s.commit()

    events = _python_stream(run)
    removed = [(t, v) for t, d, v in events if d < 0]
    assert sorted(v for _t, v in removed) == [1, 3, 5]
    assert len({t for t, _v in removed}) == 1
