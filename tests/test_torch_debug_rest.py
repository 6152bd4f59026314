"""The rest of ``pw.debug`` in the port against the JAX package's:
``StreamGenerator``'s ``table_from_list_of_batches`` and
``table_from_list_of_batches_by_workers`` (equal update streams: times,
diffs, keys and values exact), its ``table_from_pandas`` and
``table_from_markdown`` with ``_time``/``_diff`` (odd times doubled), the
module's ``table_from_pandas``/``table_to_pandas`` and
``table_from_parquet``/``table_to_parquet`` round trips (equal keys and
values; pyarrow through pandas), and ``trace``/``trace_tree`` over each
package's tracer (the same span names, nesting and attributes; the same
tree text but for durations). The JAX side runs with
``PATHWAY_COMPILED_TICK=0``."""

import json
import re

import numpy as np
import pandas as pd
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_streams_equal, norm, streams

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _schema(pw):
    class S(pw.Schema):
        word: str
        n: int
        w: float

    return S


def _batches(rng):
    words = ["ant", "bee", "cat", "dog"]
    return [
        [{"word": words[int(rng.integers(4))], "n": int(rng.integers(100)), "w": float(rng.random())}
         for _ in range(int(rng.integers(1, 5)))]
        for _ in range(6)
    ]


def test_stream_generator_list_of_batches():
    batches = _batches(np.random.default_rng(0))

    def build(pw):
        t = pw.debug.StreamGenerator().table_from_list_of_batches(batches, _schema(pw))
        return t.groupby(t.word).reduce(t.word, total=pw.reducers.sum(t.n), w=pw.reducers.max(t.w))

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want, tol=0.0)
    assert len({e[0] for e in got}) > 1  # one time per batch, several ticks


def test_stream_generator_list_of_batches_by_workers():
    rng = np.random.default_rng(1)
    batches = [{w: b for w, b in enumerate(_batches(rng)[:3])} for _ in range(4)]

    def build(pw):
        t = pw.debug.StreamGenerator().table_from_list_of_batches_by_workers(batches, _schema(pw))
        return t.select(t.word, m=t.n * 2)

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want, tol=0.0)
    assert sorted({e[0] for e in got}) == [2, 4, 6, 8]


def test_stream_generator_pandas_and_markdown_with_diffs():
    df = pd.DataFrame(
        {"word": ["a", "b", "a", "c"], "n": [1, 2, 3, 4], "_time": [1, 3, 3, 5], "_diff": [1, 1, 1, 1]},
        index=[10, 20, 30, 40],
    )
    md = """
        | word | n | _time | _diff
      1 | a    | 1 | 2     | 1
      2 | b    | 2 | 2     | 1
      1 | a    | 1 | 4     | -1
      3 | c    | 5 | 6     | 1
    """

    def build(pw):
        gen = pw.debug.StreamGenerator()
        t1 = gen.table_from_pandas(df)
        t2 = gen.table_from_markdown(md)
        assert gen.persistence_config() is None
        return t1.concat_reindex(t2)

    with pytest.warns(UserWarning, match="doubled"):
        got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want, tol=0.0)


def _frame():
    return pd.DataFrame(
        {"word": ["x", "y", "z"], "n": [3, 1, 2], "w": [0.5, 1.5, -2.0], "flag": [True, False, True]},
        index=[7, 8, 9],
    )


def _rows(df):
    return {norm(i): tuple(norm(v) for v in r) for i, r in zip(df.index, df.itertuples(index=False))}


def test_table_from_pandas_to_pandas_round_trip():
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_pandas(_frame())
        out[name] = _rows(pw.debug.table_to_pandas(t.select(t.word, t.w, t.flag, n2=t.n + 1)))
        pw.internals.parse_graph.G.clear()
        keyed = pw.debug.table_from_pandas(_frame(), id_from=["word"])
        out[name + "_id_from"] = _rows(pw.debug.table_to_pandas(keyed))
        pw.internals.parse_graph.G.clear()
        out[name + "_no_id"] = sorted(
            tuple(r) for r in pw.debug.table_to_pandas(keyed, include_id=False).itertuples(index=False)
        )
    assert out["port"] == out["jax"] and len(out["port"]) == 3
    assert out["port_id_from"] == out["jax_id_from"]
    assert out["port_no_id"] == out["jax_no_id"]
    assert sorted(v[3] for v in out["port"].values()) == [2, 3, 4]


def test_table_from_pandas_with_schema_coerces_and_keys():
    df = pd.DataFrame({"k": [1, 2, 3], "v": [1, 2, None]})

    def rows(pw):
        class S(pw.Schema):
            k: int = pw.column_definition(primary_key=True)
            v: float | None

        pw.internals.parse_graph.G.clear()
        return _rows(pw.debug.table_to_pandas(pw.debug.table_from_pandas(df, schema=S)))

    got, want = rows(tpw), rows(jpw)
    assert got == want
    # the missing value is None in the table; pandas shows it as NaN
    assert sorted(v for v in got.values()) == [(1, 1.0), (2, 2.0), (3, "nan")]


def test_parquet_round_trip(tmp_path):
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_pandas(_frame())
        path = tmp_path / f"{name}.parquet"
        pw.debug.table_to_parquet(t.select(t.word, t.n, t.w), path)
        pw.internals.parse_graph.G.clear()
        back = pw.debug.table_from_parquet(path)
        out[name] = _rows(pw.debug.table_to_pandas(back))
        pw.internals.parse_graph.G.clear()
        out[name + "_id_from"] = _rows(pw.debug.table_to_pandas(pw.debug.table_from_parquet(path, id_from=["word"])))
    assert out["port"] == out["jax"] and len(out["port"]) == 3
    assert out["port_id_from"] == out["jax_id_from"]
    # the parquet file holds no ids: rows are keyed by their position again
    assert sorted(out["port"].values()) == sorted(
        (w, n, x) for w, n, x in zip(_frame()["word"], _frame()["n"], _frame()["w"])
    )


def _record_spans(pw):
    from importlib import import_module

    tracer = import_module(f"{pw.__name__}.observability.tracing").get_tracer()
    tracer.clear()
    with tracer.span("ask", root=True, route="/v1/retrieve"):
        with tracer.span("embed", rows=3):
            pass
        with tracer.span("search", k=10):
            with tracer.span("kernel"):
                pass
    return tracer


def _shape(doc):
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["span_id"]: e["name"] for e in spans}
    return sorted(
        (e["name"], by_id.get(e["args"].get("parent_id")),
         tuple(sorted((k, v) for k, v in e["args"].items() if not k.endswith("_id"))))
        for e in spans
    )


def test_trace_and_trace_tree(tmp_path, capsys):
    out = {}
    for name, pw in PACKAGES.items():
        _record_spans(pw)
        path = tmp_path / f"{name}.json"
        doc = pw.debug.trace(path=path)
        assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
        tree = pw.debug.trace_tree()
        assert tree in capsys.readouterr().out
        out[name] = (_shape(doc), re.sub(r"\d+\.\d+ ms", "_ ms", tree))
    assert out["port"] == out["jax"]
    assert out["port"][1].splitlines()[0].startswith("ask _ ms [route=/v1/retrieve]")
    assert [ln.strip().split()[0] for ln in out["port"][1].splitlines()] == ["ask", "embed", "search", "kernel"]


def test_trace_tree_without_spans(capsys):
    for pw in PACKAGES.values():
        _record_spans(pw).clear()
        assert pw.debug.trace_tree() == "(no root spans recorded)"
        assert pw.debug.trace(seconds=60)["traceEvents"][0]["ph"] == "M"
