"""Helpers shared by the Table-API parity tests of the port
(``test_torch_iterate.py``, ``test_torch_sql.py``,
``test_torch_transformers.py``, ``test_torch_async_transformer.py``,
``test_torch_persistence.py``, ``test_torch_components.py``, the temporal
ones and ``test_torch_cuda.py``): seeded ``table_from_markdown`` streams,
the update stream of a table, recorded with ``pw.io.subscribe`` as (time,
diff, id, values) events, or the exception a package raised instead;
event times of every kind for the temporal tests; connected components
by ``pw.iterate`` (``chip_smoke.cc_components``); the windowed-index
slice's input tables (``wi_tables``). It imports neither package."""

import numpy as np

# the body the smoke's components phase runs on the card, so the parity
# tests hold that very body against the JAX package
from chip_smoke import cc_components as components  # noqa: F401

FLOAT_TOL = 1e-9


def norm(v):
    """A value in a form both packages' values compare equal in."""
    if isinstance(v, tuple):
        return tuple(norm(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    if type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    if type(v).__name__ == "Json":
        return ("json", repr(v.value))
    if isinstance(v, float) and v != v:
        return "nan"
    return v


def stream(pw, table, **run_kwargs):
    """Run the graph and return ``table``'s update stream, sorted."""
    events = []

    def on_change(key, row, time, is_addition):
        events.append(
            (time, 1 if is_addition else -1, int(key),
             tuple(sorted((k, norm(v)) for k, v in row.items())))
        )

    pw.io.subscribe(table, on_change=on_change)
    pw.run(**run_kwargs)
    return sorted(events, key=repr)


def streams(packages, build, **run_kwargs):
    """``build(pw)``'s update stream under the port and under the JAX
    package (``packages``: {"port": ..., "jax": ...}), each on a fresh graph."""
    out = {}
    for name, pw in packages.items():
        pw.internals.parse_graph.G.clear()
        out[name] = stream(pw, build(pw), **run_kwargs)
    return out["port"], out["jax"]


def assert_streams_equal(got, want, tol=FLOAT_TOL):
    """Keys, diffs, times and non-float values exact; floats within ``tol``."""
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert g[:3] == w[:3], (g, w)
        assert [k for k, _ in g[3]] == [k for k, _ in w[3]], (g, w)
        for (_, gv), (_, wv) in zip(g[3], w[3]):
            if isinstance(wv, float) and isinstance(gv, float):
                assert abs(gv - wv) <= tol, (g, w)
            else:
                assert gv == wv, (g, w)


def markdown(columns, rows):
    """A ``table_from_markdown`` text: ``rows`` are (id, *values, time,
    diff) tuples; ``id`` None leaves the id column out."""
    with_id = rows and rows[0][0] is not None
    head = ("    | " if with_id else "") + " | ".join(list(columns) + ["__time__", "__diff__"])
    lines = [head]
    for r in rows:
        cells = [str(x) for x in r[1:]]
        lines.append((f"{r[0]} | " if with_id else "") + " | ".join(cells))
    return "\n".join(lines)


def outcomes(packages, build, **run_kwargs):
    """Like ``streams``, but where a package raises (building the graph or
    running it) its outcome is the exception's type name, so a refusal
    compares like a stream does."""
    out = {}
    for name, pw in packages.items():
        pw.internals.parse_graph.G.clear()
        try:
            out[name] = stream(pw, build(pw), **run_kwargs)
        except Exception as e:  # noqa: BLE001 — the outcome compared
            out[name] = ("raises", type(e).__name__)
    return out["port"], out["jax"]


def assert_outcomes_equal(got, want, tol=FLOAT_TOL):
    """Both raised the same exception type, or both streams are equal."""
    if isinstance(want, tuple) or isinstance(got, tuple):
        assert got == want, (got, want)
        return
    assert_streams_equal(got, want, tol)


# --- event times of the temporal parity tests ---------------------------------
# a time is a number of units after 0: an int, a float a quarter past it, or
# a naive or UTC datetime that many minutes after DT_BASE; the tables carry
# it as markdown text and ``event_time`` turns it into the column's type

TIME_KINDS = ("int", "float", "naive", "utc")
DT_BASE = "2023-05-15T10:00:00"


def time_cell(kind, x):
    """Event time ``x`` (an int) as a markdown cell of ``kind``."""
    import datetime

    if kind == "int":
        return str(int(x))
    if kind == "float":
        return repr(int(x) + 0.25)
    stamp = (datetime.datetime.fromisoformat(DT_BASE) + datetime.timedelta(minutes=int(x))).isoformat()
    return stamp if kind == "naive" else stamp + "+02:00"


def event_time(table, kind, col="t"):
    """``table`` with its ``col`` of markdown cells made event times of ``kind``."""
    if kind in ("int", "float"):
        return table
    fmt = "%Y-%m-%dT%H:%M:%S" + ("%z" if kind == "utc" else "")
    return table.with_columns(**{col: table[col].dt.strptime(fmt)})


def span(kind, x):
    """A duration of ``x`` units in ``kind``'s interval type."""
    import datetime

    if kind == "int":
        return int(x)
    if kind == "float":
        return float(x)
    return datetime.timedelta(minutes=x)


# --- the windowed-index slice of chip_smoke.py --------------------------------


def wi_tables(pw, s):
    """A ``chip_smoke.wi_stream`` as the tables of ``wi_pipeline``: the
    standing queries in the first tick (time 2), the documents of commit c
    in time 2 * c + 4 (``StreamGenerator`` batches)."""

    class Doc(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        t: int
        topic: int
        text: str

    class Query(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        t: int
        topic: int
        text: str

    gen = pw.debug.StreamGenerator()
    asked = [[{"qid": q, "t": int(s["q_t"][q]), "topic": int(s["q_topic"][q]), "text": s["q_text"][q]}
              for q in range(len(s["q_t"]))]]
    batches = [[]] + [
        [{"doc_id": i, "t": int(s["t"][i]), "topic": int(s["topic"][i]), "text": s["text"][i]}
         for i in np.flatnonzero(s["commit"] == c).tolist()]
        for c in range(s["commits"])
    ]
    return gen.table_from_list_of_batches(batches, Doc), gen.table_from_list_of_batches(asked, Query)
