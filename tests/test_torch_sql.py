"""``pw.sql`` of the port against the JAX package's: each query of the
supported subset runs under both packages over the same seeded streams
(``__time__``/``__diff__``, with retractions) and must give the same update
stream. The ids of the result rows are compared too: ``GROUP BY``,
``DISTINCT``, ``UNION``, ``INTERSECT``, ``EXCEPT`` and the joins set them,
and the port's must be the reference's. ``AVG`` and ``/`` agree within
1e-9; everything else is exact. Queries the parser refuses raise
``ValueError`` in both packages. The queries are those of
``tests/test_sql.py``, over larger seeded inputs. The JAX side runs with
``PATHWAY_COMPILED_TICK=0``."""

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_streams_equal, markdown, streams

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _rows(seed, n, cols, id0):
    """(id, *values, time, diff): n inserts over times 2..8, then a third of
    them retracted two ticks later."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        vals = tuple(gen(rng) for gen in cols.values())
        t = int(rng.integers(1, 5)) * 2
        rows.append((id0 + i, *vals, t, 1))
        if rng.random() < 0.33:
            rows.append((id0 + i, *vals, t + 2, -1))
    return rows


NAMES = ["ana", "bo", "cy", "dee"]
COLS_A = {
    "k": lambda r: int(r.integers(0, 5)),
    "v": lambda r: int(r.integers(-3, 10)),
    "name": lambda r: NAMES[int(r.integers(0, 4))],
}
COLS_B = {"k": lambda r: int(r.integers(0, 6)), "w": lambda r: int(r.integers(0, 4))}


def _tables(pw, seed):
    a = pw.debug.table_from_markdown(markdown(list(COLS_A), _rows(seed, 24, COLS_A, 1)))
    b = pw.debug.table_from_markdown(markdown(list(COLS_B), _rows(seed + 100, 16, COLS_B, 101)))
    return {"a": a, "b": b}


QUERIES = [
    "SELECT v + k AS s, v - k AS d, v * 2 AS m FROM a",
    "SELECT * FROM a WHERE v > 1 AND k <> 0",
    "SELECT v FROM a WHERE v IN (1, 3, 5) OR name = 'bo'",
    "SELECT v FROM a WHERE v NOT IN (1, 3) AND v BETWEEN 0 AND 6",
    "SELECT v, name FROM a WHERE NOT (v = 1 OR k = 4)",
    "SELECT CASE WHEN v > 4 THEN 'big' WHEN v > 0 THEN 'mid' ELSE 'low' END AS size, v FROM a",
    "SELECT k, SUM(v) AS total, COUNT(*) AS n, MIN(v) AS lo, MAX(v) AS hi FROM a GROUP BY k",
    "SELECT k, AVG(v) AS mean FROM a GROUP BY k",
    "SELECT k, COUNT(*) AS n FROM a GROUP BY k HAVING COUNT(*) > 2",
    "SELECT k, name, SUM(v) AS total FROM a GROUP BY k, name",
    "SELECT DISTINCT k FROM a",
    "SELECT DISTINCT name, k FROM a WHERE v >= 0",
    "SELECT a.k, v, w FROM a JOIN b ON a.k = b.k",
    "SELECT x.v, y.w FROM a AS x INNER JOIN b y ON y.k = x.k",
    "SELECT a.k, v, w FROM a LEFT JOIN b ON a.k = b.k",
    "SELECT b.k, v, w FROM a RIGHT JOIN b ON a.k = b.k",
    "SELECT v, w FROM a FULL OUTER JOIN b ON a.k = b.k AND a.v = b.w",
    "SELECT a.k, SUM(w) AS sw FROM a JOIN b ON a.k = b.k GROUP BY a.k",
    "SELECT k FROM a UNION SELECT k FROM b",
    "SELECT k FROM a UNION ALL SELECT k FROM b",
    "SELECT k FROM a INTERSECT SELECT k FROM b",
    "SELECT k FROM a EXCEPT SELECT k FROM b",
    "SELECT v / 2 AS half, v % 3 AS r FROM a WHERE v > 0",
    "SELECT -v AS neg, name FROM a WHERE name IS NOT NULL;",
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("query", QUERIES)
def test_query_stream_equals_reference(query, seed):
    got, want = streams(PACKAGES, lambda pw: pw.sql(query, **_tables(pw, seed)))
    assert want
    assert_streams_equal(got, want)


@pytest.mark.parametrize(
    "query",
    [
        "SELECT nope FROM a",
        "SELECT v FROM missing",
        "SELECT v FROM a HAVING v > 1",
        "SELECT k FROM a JOIN b ON a.k = b.k",
        "SELECT v FROM a WHERE SUM(v) > 1",
        "SELECT v FROM a extra tokens",
        "SELECT UPPER(name) FROM a",
    ],
)
def test_refused_query_raises_like_reference(query):
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
        with pytest.raises(ValueError):
            pw.sql(query, **_tables(pw, 0))
