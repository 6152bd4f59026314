"""``pw.demo`` of the port against the JAX package's: every generator and
``replay_csv``'s coercion give the same consolidated final table (values
exact; ``noisy_linear_stream``'s floats within 1e-12, with the unseeded
``random`` module seeded before each package's run). Keys are exact where
the schema has a primary key; without one, the python connector keys a row
by its subject's ``id()`` and a counter in both packages, so those tables
are compared as sorted rows. Tick boundaries are wall-clock (the python
connector's autocommit), so the tests compare final tables, never ticks.
The JAX side runs with ``PATHWAY_COMPILED_TICK=0``."""

import random

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import norm

PACKAGES = {"jax": jpw, "port": tpw}
FLOAT_TOL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def final(build, seed=None, keyed=True):
    """``build(pw)``'s final table under both packages, as {key: row}, or
    as sorted rows when ``keyed`` is False."""
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        if seed is not None:
            random.seed(seed)
        table = build(pw)
        keys, cols = pw.debug.table_to_dicts(table)
        names = table.column_names()
        rows = {int(k): tuple(norm(cols[n][k]) for n in names) for k in keys}
        out[name] = rows if keyed else sorted(rows.values())
    return out["port"], out["jax"]


def test_generate_custom_stream():
    def build(pw):
        return pw.demo.generate_custom_stream(
            {"i": lambda i: i, "sq": lambda i: float(i * i), "tag": lambda i: f"r{i % 3}"},
            schema=pw.schema_from_types(i=int, sq=float, tag=str),
            nb_rows=40,
            input_rate=0,
            autocommit_duration_ms=10,
        )

    got, want = final(build, keyed=False)
    assert got == want and [r[0] for r in got] == list(range(40))


def test_range_stream():
    got, want = final(lambda pw: pw.demo.range_stream(nb_rows=12, offset=5, input_rate=500), keyed=False)
    assert got == want == [(float(v),) for v in range(5, 17)]


def test_noisy_linear_stream_seeded():
    got, want = final(lambda pw: pw.demo.noisy_linear_stream(nb_rows=16, input_rate=500), seed=1234,
                      keyed=False)
    assert len(got) == len(want) == 16
    for (x, y), (wx, wy) in zip(got, want):
        assert x == wx and abs(y - wy) <= FLOAT_TOL and abs(y - x) <= 1.0


CSV = """id,score,ok,name,maybe
1,0.5,true,ann,3
2,1.25,1,bob,4
3,-2,false,cy,5
4,7,0,dee,6
"""


def _csv_schema(pw):
    class S(pw.Schema):
        id: int = pw.column_definition(primary_key=True)
        score: float
        ok: bool
        name: str
        maybe: int | None

    return S


@pytest.mark.parametrize("with_time", [False, True], ids=["replay_csv", "replay_csv_with_time"])
def test_replay_csv_coerces_each_dtype(tmp_path, with_time):
    path = tmp_path / "rows.csv"
    path.write_text(CSV)

    def build(pw):
        if with_time:
            return pw.demo.replay_csv_with_time(str(path), schema=_csv_schema(pw), time_column="id")
        return pw.demo.replay_csv(str(path), schema=_csv_schema(pw), input_rate=0)

    got, want = final(build)
    assert got == want
    assert sorted(got.values()) == [
        (1, 0.5, True, "ann", 3), (2, 1.25, True, "bob", 4),
        (3, -2.0, False, "cy", 5), (4, 7.0, False, "dee", 6),
    ]


def test_replay_csv_paced_rows_reach_the_engine(tmp_path):
    """At ``input_rate`` > 0 the replay sleeps per row; every row arrives."""
    path = tmp_path / "rows.csv"
    path.write_text(CSV)
    got, want = final(lambda pw: pw.demo.replay_csv(str(path), schema=_csv_schema(pw), input_rate=200))
    assert got == want and len(got) == 4
