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


# --- the cdc-index slice of chip_smoke.py --------------------------------------


def cdc_run(pw, workdir, s, emb, dim, knn_kw, timeout=60.0):
    """``chip_smoke.cdc_pipeline`` over a ``chip_smoke.cdc_stream`` ``s``:
    the table and its Debezium snapshot are written under ``workdir``, the
    standing queries come from a static table, a writer thread (its own
    SQLite connection) commits each transaction and publishes its
    envelopes. After the initial load and after every transaction, once
    both sources reached the table's state and that tick ended, it records
    (the SQLite table's state, the Debezium table's, the replies) as {key:
    row} dicts, and the vectors by doc_id. Returns those snapshots, the
    query vectors, the replies read back from SQLite and a static read of
    the table."""
    import os
    import sqlite3
    import threading
    import time

    from chip_smoke import (CDC_K, cdc_apply, cdc_create, cdc_pipeline, cdc_publish, debezium_envelopes,
                            sqlite_rows)

    api = __import__(pw.__name__ + ".internals.api", fromlist=["ref_scalar"])
    src_db, reply_db, cdc_dir = (os.path.join(workdir, n) for n in ("documents.db", "replies.db", "cdc"))
    os.makedirs(cdc_dir)
    cdc_create(src_db, s["initial"])
    cdc_publish(cdc_dir, "000000.jsonl", debezium_envelopes(rows=s["initial"]))

    class Query(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        text: str

    queries = pw.debug.table_from_rows(Query, list(enumerate(s["q_text"])))
    tables = cdc_pipeline(pw, src_db, cdc_dir, queries, emb, dim, knn_kw, reply_db)

    def keyed(rows):
        return {int(api.ref_scalar(i)): (i, *r) for i, r in rows.items()}

    lock = threading.Lock()
    states = {"docs": {}, "changes": {}, "pairs": {}}
    goals = {"docs": {"rows": keyed(s["initial"]), "tick": None},
             "changes": {"rows": keyed(s["initial"]), "tick": None}}
    vecs, qvecs, snaps, failure = {}, {}, [], []

    def subscribe(part, values):
        def on_change(key, row, time, is_addition):
            vals = values(row)
            with lock:
                if is_addition:
                    states[part][int(key)] = vals
                elif states[part].get(int(key)) == vals:
                    del states[part][int(key)]

        def on_time_end(_t):
            goal = goals.get(part)
            with lock:
                if goal is not None and goal["tick"] is None and states[part] == goal["rows"]:
                    goal["tick"] = pw.internals.parse_graph.G.runtime.stats.ticks

        pw.io.subscribe(tables[part], on_change=on_change, on_time_end=on_time_end)

    for part in ("docs", "changes"):
        subscribe(part, lambda r: (r["doc_id"], r["topic"], r["body"]))
    subscribe("pairs", lambda r: (r["qid"], r["doc_id"], r["score"]))
    pw.io.subscribe(tables["embedded"], on_change=lambda key, row, time, is_addition:
                    is_addition and vecs.__setitem__(row["doc_id"], np.asarray(row["vec"], dtype=np.float64)))
    pw.io.subscribe(tables["asked"], on_change=lambda key, row, time, is_addition:
                    is_addition and qvecs.__setitem__(row["qid"], np.asarray(row["vec"], dtype=np.float64)))

    def wait(cond, what):
        end = time.time() + timeout
        while not cond():
            if time.time() > end:
                raise AssertionError(f"timed out waiting for {what}")
            time.sleep(0.005)

    def settled():
        rt = pw.internals.parse_graph.G.runtime
        return all(g["tick"] is not None and rt.stats.ticks > g["tick"] for g in goals.values())

    def snapshot():
        with lock:
            snaps.append({**{part: dict(state) for part, state in states.items()}, "vecs": dict(vecs)})

    def drive():
        try:
            wait(lambda: pw.internals.parse_graph.G.runtime is not None, "the run")
            n_replies = len(s["q_text"]) * min(CDC_K, len(s["initial"]))
            wait(lambda: settled() and len(states["pairs"]) == n_replies
                 and all(v[1] is not None for v in list(states["pairs"].values())), "the initial load")
            snapshot()
            writer = sqlite3.connect(src_db)
            for c, txn in enumerate(s["txns"]):
                with lock:
                    for g in goals.values():
                        g.update(rows=keyed(s["live"][c]), tick=None)
                cdc_apply(writer, txn)
                cdc_publish(cdc_dir, f"{c + 1:06d}.jsonl", debezium_envelopes(txn=txn))
                wait(settled, f"transaction {c}")
                snapshot()
            writer.close()
        except BaseException as e:  # noqa: BLE001 — re-raised after pw.run
            failure.append(e)
        finally:
            rt = pw.internals.parse_graph.G.runtime
            if rt is not None:
                rt.stop()  # the SQLite and Debezium sources never end on their own

    threading.Thread(target=drive, daemon=True).start()
    pw.run()
    if failure:
        raise failure[0]
    written = sqlite_rows(reply_db, "replies")
    pw.internals.parse_graph.G.clear()
    static = pw.io.sqlite.read(src_db, "documents", schema=tables["schema"], mode="static")
    keys, cols = pw.debug.table_to_dicts(static)
    read = {int(key): (cols["doc_id"][key], cols["topic"][key], cols["body"][key]) for key in keys}
    return {"snaps": snaps, "qvecs": qvecs, "written": written, "static": read}
