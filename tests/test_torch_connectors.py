"""The port's service connectors against the JAX package's, as parity
tests: the reference's ``tests/test_connectors.py`` (sqlite, debezium,
deltalake, iceberg, elasticsearch over a local stdlib HTTP server, s3 over
fsspec's memory filesystem, null), and one case for each connector it does
not cover (minio, s3_csv, pyfilesystem, gdrive over an in-process fake of
the Drive client, airbyte over a local connector process, sharepoint's
refusal). The same scenario, from the same files, runs through
``pathway_tpu`` (``PATHWAY_COMPILED_TICK=0``) and ``pathway_tpu_torch``:
the update streams equal in keys, diffs and rows (and in times where the
source defines them: a static read ticks at 0, a streaming source at the
wall clock), and every sink writes the same bytes or rows.

Also: the CDC-fed live index of ``chip_smoke.py`` (``cdc_pipeline``: a
SQLite table streamed through the embedder into ``TpuKnn``, standing
queries, the replies written back to SQLite, the table's Debezium stream
read beside it) through both packages at a small size; a store written by
one package resumed by the other for the sqlite, debezium and deltalake
streaming sources, with no row twice and none lost; and the writer fault
both packages share: ``pw.io.sqlite.write`` raises ``OverflowError`` on a
``Pointer`` value of 2^63 or more."""

import json
import os
import sqlite3
import sys
import threading
import time
import types

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import cdc_run, norm, stream

PACKAGES = {"jax": jpw, "port": tpw}
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _kv(pw):
    class KV(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    return KV


def _events_until(pw, table, done, timeout=20.0, **run_kwargs):
    """Run a streaming graph until ``done(events)`` holds; the (key, diff,
    row) events, sorted (streaming times are the wall clock's)."""
    events = []
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            events.append((int(key), 1 if is_addition else -1, tuple(sorted((k, norm(v)) for k, v in row.items()))))

    pw.io.subscribe(table, on_change=on_change)
    th = threading.Thread(target=lambda: pw.run(autocommit_duration_ms=20, **run_kwargs), daemon=True)
    th.start()
    deadline = time.time() + timeout
    ok = False
    while time.time() < deadline:
        with lock:
            ok = done(list(events))
        if ok:
            break
        time.sleep(0.02)
    rt = pw.internals.parse_graph.G.runtime
    if rt is not None:
        rt.stop()
    th.join(timeout=10)
    assert ok, events
    return sorted(events)


def _final(events):
    """The state an event list leaves: {key: row}."""
    state = {}
    for key, diff, row in events:
        if diff > 0:
            state[key] = row
        elif state.get(key) == row:
            del state[key]
    return state


def _by(events, col):
    return {dict(row)[col]: dict(row) for row in _final(events).values()}


# --- sqlite ----------------------------------------------------------------


def _kv_db(path, rows):
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE kv (k TEXT, v INTEGER)")
    conn.executemany("INSERT INTO kv VALUES (?, ?)", rows)
    conn.commit()
    conn.close()


def test_sqlite_static_read(tmp_path):
    _kv_db(tmp_path / "t.db", [("a", 1), ("b", 2)])
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        out[name] = stream(pw, pw.io.sqlite.read(str(tmp_path / "t.db"), "kv", _kv(pw), mode="static"))
    assert out["port"] == out["jax"]
    assert sorted(dict(r)["v"] for _t, d, _k, r in out["port"] if d > 0) == [1, 2]


def test_sqlite_write_roundtrip(tmp_path):
    """Both writers leave the same rows, ``__key__`` (the key's signed
    64-bit form) included."""
    written = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_markdown(
            """
            k | v
            a | 1
            b | 2
            """
        )
        pw.io.sqlite.write(t, str(tmp_path / f"{name}.db"), "out")
        pw.run()
        conn = sqlite3.connect(tmp_path / f"{name}.db")
        written[name] = sorted(conn.execute("SELECT k, v, __key__ FROM out").fetchall())
        conn.close()
    assert written["port"] == written["jax"]
    assert [r[:2] for r in written["port"]] == [("a", 1), ("b", 2)]


def test_sqlite_streaming_picks_up_changes(tmp_path):
    """A late insert, an update and a delete, committed by another
    connection, each reach the table as the reference's reader sends them."""
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        db = tmp_path / f"{name}.db"
        _kv_db(db, [("a", 1), ("c", 3)])
        t = pw.io.sqlite.read(str(db), "kv", _kv(pw), mode="streaming")

        def late():
            time.sleep(0.6)
            conn = sqlite3.connect(db)
            with conn:
                conn.execute("INSERT INTO kv VALUES ('b', 5)")
                conn.execute("UPDATE kv SET v = 10 WHERE k = 'a'")
                conn.execute("DELETE FROM kv WHERE k = 'c'")
            conn.close()

        threading.Thread(target=late, daemon=True).start()
        out[name] = _events_until(pw, t, lambda ev: {k: r["v"] for k, r in _by(ev, "k").items()} == {"a": 10, "b": 5})
    assert out["port"] == out["jax"]


# --- debezium ---------------------------------------------------------------


DEBEZIUM_EVENTS = [
    {"payload": {"op": "r", "after": {"k": "s", "v": 0}, "before": None}},
    {"payload": {"op": "c", "after": {"k": "a", "v": 1}, "before": None}},
    {"payload": {"op": "c", "after": {"k": "b", "v": 2}, "before": None}},
    {"payload": {"op": "u", "before": {"k": "a", "v": 1}, "after": {"k": "a", "v": 10}}},
    {"payload": {"op": "d", "before": {"k": "b", "v": 2}, "after": None}},
    {"op": "c", "after": {"k": "x", "v": 7}, "before": None},  # no "payload" wrapper
]


def test_debezium_dir_cdc(tmp_path):
    msgs = tmp_path / "msgs"
    msgs.mkdir()
    with open(msgs / "m.jsonl", "w") as f:
        f.write("".join(json.dumps(e) + "\n" for e in DEBEZIUM_EVENTS))
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        t = pw.io.debezium.read(input_dir=str(msgs), schema=_kv(pw))
        out[name] = _events_until(
            pw, t, lambda ev: {k: r["v"] for k, r in _by(ev, "k").items()} == {"s": 0, "a": 10, "x": 7})
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("db_type", ["postgres", "mongodb"])
def test_debezium_mongodb_dialect(db_type):
    """The parser over both dialects: string ``after`` and ``filter``
    deletes (MongoDB), ``payload`` unwrapping, FLOAT and JSON coercion."""
    from pathway_tpu.io.debezium import parse_debezium_message as ref_parse
    from pathway_tpu_torch.io.debezium import parse_debezium_message as port_parse

    def schema(pw):
        class S(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            x: float
            j: pw.Json

        return S

    enc = json.dumps if db_type == "mongodb" else (lambda o: o)
    msgs = [
        {"payload": {"op": "u", "before": None, "after": enc({"k": "x", "x": 3, "j": {"a": [1]}})}},
        {"payload": {"op": "c", "after": enc({"k": "y", "x": 1.5, "j": None})}},
        {"op": "r", "after": enc({"k": "z", "x": 2, "j": 4})},
        {"payload": {"op": "d", "before": {"k": "y", "x": 1.5, "j": None}}},
        {"payload": {"op": "d", "filter": json.dumps({"k": "x", "x": 3, "j": {"a": [1]}})}},
        json.dumps({"payload": {"op": "u", "before": enc({"k": "z", "x": 2, "j": 4}),
                                "after": enc({"k": "z", "x": 5, "j": 4})}}),
        None,
    ]
    for msg in msgs:
        got = [(d, norm(v)) for d, v in port_parse(msg, ["k", "x", "j"], schema(tpw), db_type=db_type)]
        want = [(d, norm(v)) for d, v in ref_parse(msg, ["k", "x", "j"], schema(jpw), db_type=db_type)]
        assert got == want, msg
    if db_type == "mongodb":
        dmsg = {"payload": {"op": "d", "filter": json.dumps({"k": "x", "x": 3})}}
        assert port_parse(dmsg, ["k", "x"], None, db_type="mongodb") == [(-1, ("x", 3))]


# --- delta lake and iceberg ---------------------------------------------------


def _kv_table(pw):
    return pw.debug.table_from_markdown(
        """
        k | v
        a | 1
        b | 2
        """
    )


def _parquet_rows(paths):
    import pyarrow.parquet as pq

    return sorted(tuple(sorted(r.items())) for p in paths for r in pq.read_table(p).to_pylist())


def _delta_rows(lake):
    from pathway_tpu.io.deltalake import _replay_log, _Store

    files, _meta = _replay_log(_Store(str(lake)))
    return _parquet_rows([os.path.join(lake, f) for f in files])


def test_deltalake_write_then_static_read(tmp_path):
    """Both writers leave the same rows (with ``time`` and ``diff``) and
    the same log; each package reads each lake with the same stream."""
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        pw.io.deltalake.write(_kv_table(pw), str(tmp_path / name))
        pw.run()
        assert (tmp_path / name / "_delta_log").is_dir()
    assert _delta_rows(tmp_path / "port") == _delta_rows(tmp_path / "jax")
    logs = {n: sorted(os.listdir(tmp_path / n / "_delta_log")) for n in PACKAGES}
    assert logs["port"] == logs["jax"]

    reads = {}
    for lake in PACKAGES:
        for name, pw in PACKAGES.items():
            pw.internals.parse_graph.G.clear()

            class KVD(pw.Schema):
                k: str = pw.column_definition(primary_key=True)
                v: int
                diff: int

            reads[lake, name] = stream(pw, pw.io.deltalake.read(str(tmp_path / lake), schema=KVD, mode="static"))
    assert len({repr(v) for v in reads.values()}) == 1
    assert sorted(dict(r)["v"] for _t, _d, _k, r in reads["port", "port"]) == [1, 2]


def test_deltalake_streaming_tails_new_commits(tmp_path):
    from pathway_tpu_torch.engine.batch import DiffBatch
    from pathway_tpu_torch.io.deltalake import _DeltaWriter, _Store

    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        lake = tmp_path / name
        w = _DeltaWriter(_Store(str(lake)), ["k", "v"])
        w.write_batch(0, DiffBatch.from_rows([(1, 1, ("a", 1))], ["k", "v"]))
        t = pw.io.deltalake.read(str(lake), schema=_kv(pw), mode="streaming")

        def late_commit(w=w):
            time.sleep(0.6)
            w.write_batch(2, DiffBatch.from_rows([(2, 1, ("b", 7))], ["k", "v"]))

        threading.Thread(target=late_commit, daemon=True).start()
        out[name] = _events_until(pw, t, lambda ev: {k: r["v"] for k, r in _by(ev, "k").items()} == {"a": 1, "b": 7})
    assert out["port"] == out["jax"]


def test_iceberg_write_then_read(tmp_path):
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        pw.io.iceberg.write(_kv_table(pw), str(tmp_path / name), namespace=["app"], table_name="kv")
        pw.run()

    def data_files(root):
        return sorted(os.path.join(dp, f) for dp, _d, fs in os.walk(root) for f in fs if f.endswith(".parquet"))

    assert _parquet_rows(data_files(tmp_path / "port")) == _parquet_rows(data_files(tmp_path / "jax"))
    reads = {}
    for lake in PACKAGES:
        for name, pw in PACKAGES.items():
            pw.internals.parse_graph.G.clear()
            t = pw.io.iceberg.read(str(tmp_path / lake), namespace=["app"], table_name="kv", schema=_kv(pw),
                                   mode="static")
            reads[lake, name] = stream(pw, t)
    assert len({repr(v) for v in reads.values()}) == 1
    assert sorted(dict(r)["v"] for _t, _d, _k, r in reads["port", "port"]) == [1, 2]


# --- elasticsearch over a local stdlib HTTP server ------------------------------


class _Capture:
    """A local stdlib HTTP server recording every POST body; ``fail_first``
    requests answer 500 first."""

    def __init__(self, reply=b'{"errors": false, "items": []}', fail_first=0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.bodies: list[tuple[str, bytes]] = []
        self.failures = fail_first
        cap = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if cap.failures > 0:
                    cap.failures -= 1
                    self.send_response(500)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                cap.bodies.append((self.path, body, self.headers.get("Authorization")))
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(reply)))
                self.end_headers()
                self.wfile.write(reply)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_elasticsearch_bulk_writer(tmp_path):
    """The same ``_bulk`` bodies from both packages, with the basic auth
    header, as an insert, an update and a delete go through."""
    bodies = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        cap = _Capture()
        try:
            t = pw.debug.table_from_markdown(
                """
                k | v | __time__ | __diff__
                a | 1 | 2        | 1
                b | 2 | 2        | 1
                a | 1 | 4        | -1
                a | 3 | 4        | 1
                b | 2 | 6        | -1
                """
            )
            pw.io.elasticsearch.write(t, cap.url, auth=pw.io.elasticsearch.ElasticSearchAuth.basic("u", "p"),
                                      index_name="idx")
            pw.run()
        finally:
            cap.close()
        bodies[name] = cap.bodies
    assert bodies["port"] == bodies["jax"]
    assert all(path == "/_bulk" and auth.startswith("Basic ") for path, _b, auth in bodies["port"])
    lines = [json.loads(x) for _p, b, _a in bodies["port"] for x in b.decode().strip().splitlines()]
    assert lines[0]["index"]["_index"] == "idx" and lines[1] == {"k": "a", "v": 1}
    assert sum("delete" in x for x in lines) == 2


# --- s3, minio and s3_csv over fsspec's memory filesystem -----------------------


@pytest.fixture
def memory_bucket():
    fsspec = pytest.importorskip("fsspec")
    fs = fsspec.filesystem("memory")
    root = f"/bucket-{os.getpid()}-{time.time_ns()}"
    yield fs, root
    if fs.exists(root):
        fs.rm(root, recursive=True)


def test_s3_scanner_over_memory_fs(memory_bucket):
    fs, root = memory_bucket
    with fs.open(f"{root}/data/part1.jsonl", "w") as f:
        f.write(json.dumps({"k": "a", "v": 1}) + "\n" + json.dumps({"k": "b", "v": 2}) + "\n")
    with fs.open(f"{root}/data/part2.jsonl", "w") as f:
        f.write(json.dumps({"k": "c", "v": 3}) + "\n")
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        out[name] = stream(pw, pw.io.s3.read(f"memory://{root}/data", format="json", schema=_kv(pw), mode="static"))
    assert out["port"] == out["jax"]
    assert sorted(dict(r)["v"] for _t, _d, _k, r in out["port"]) == [1, 2, 3]


@pytest.mark.parametrize("connector", ["minio", "s3_csv"])
def test_minio_and_s3_csv_over_memory_fs(memory_bucket, connector):
    """``pw.io.minio`` (its settings become the s3 scanner's storage options)
    and ``pw.io.s3_csv`` read the same CSV objects, statically and
    streaming, as the reference's."""
    fs, root = memory_bucket
    with fs.open(f"{root}/csv/a.csv", "w") as f:
        f.write("k,v\na,1\nb,2\n")
    with fs.open(f"{root}/csv/b.csv", "w") as f:
        f.write("k,v\nc,3\n")
    out = {}
    for mode in ("static", "streaming"):
        for name, pw in PACKAGES.items():
            pw.internals.parse_graph.G.clear()
            path = f"memory://{root}/csv"
            if connector == "minio":
                settings = pw.io.minio.MinIOSettings("http://127.0.0.1:9", "bucket", "key", "secret", region="r")
                t = pw.io.minio.read(path, settings, format="csv", schema=_kv(pw), mode=mode)
            else:
                t = pw.io.s3_csv.read(path, schema=_kv(pw), mode=mode)
            if mode == "static":
                out[mode, name] = stream(pw, t)
            else:
                out[mode, name] = _events_until(pw, t, lambda ev: len(_final(ev)) == 3)
        assert out[mode, "port"] == out[mode, "jax"]


def test_pyfilesystem_reads_an_fsspec_filesystem(memory_bucket):
    fs, root = memory_bucket
    for i, data in enumerate([b"alpha", b"beta\x00gamma", b""]):
        with fs.open(f"{root}/files/{i}.bin", "wb") as f:
            f.write(data)
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        out[name] = stream(pw, pw.io.pyfilesystem.read(fs, f"{root}/files"))
    assert out["port"] == out["jax"]
    assert sorted(dict(r)["data"] for _t, _d, _k, r in out["port"]) == [b"", b"alpha", b"beta\x00gamma"]


# --- gdrive over an in-process fake of the Drive client ---------------------------


def _fake_google(monkeypatch, files: dict):
    """``googleapiclient.discovery.build`` and the service-account
    ``Credentials`` as in-process fakes serving ``files`` (id -> (name,
    modifiedTime, bytes))."""

    class _Req:
        def __init__(self, value):
            self.value = value

        def execute(self):
            return self.value

    class _Files:
        def list(self, q, fields):
            assert "'folder' in parents" in q
            return _Req({"files": [{"id": i, "name": n, "modifiedTime": m, "mimeType": "text/plain"}
                                   for i, (n, m, _b) in sorted(files.items())]})

        def get_media(self, fileId):
            return _Req(files[fileId][2])

    class _Service:
        def files(self):
            return _Files()

    discovery = types.ModuleType("googleapiclient.discovery")
    discovery.build = lambda name, version, credentials=None: _Service()
    client = types.ModuleType("googleapiclient")
    client.discovery = discovery
    account = types.ModuleType("google.oauth2.service_account")

    class Credentials:
        @classmethod
        def from_service_account_file(cls, path, scopes=None):
            return cls()

    account.Credentials = Credentials
    oauth2 = types.ModuleType("google.oauth2")
    oauth2.service_account = account
    google = sys.modules.get("google") or types.ModuleType("google")
    monkeypatch.setitem(sys.modules, "google", google)
    monkeypatch.setattr(google, "oauth2", oauth2, raising=False)
    for name, mod in (("googleapiclient", client), ("googleapiclient.discovery", discovery),
                      ("google.oauth2", oauth2), ("google.oauth2.service_account", account)):
        monkeypatch.setitem(sys.modules, name, mod)


def test_gdrive_reads_a_folder_through_the_drive_client(monkeypatch, tmp_path):
    files = {"f1": ("a.txt", "2024-01-01T00:00:00Z", b"one"), "f2": ("b.txt", "2024-01-02T00:00:00Z", b"two")}
    _fake_google(monkeypatch, files)
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        t = pw.io.gdrive.read("folder", service_user_credentials_file=str(tmp_path / "creds.json"),
                              with_metadata=True, refresh_interval=0.05)
        out[name] = _events_until(pw, t, lambda ev: len(_final(ev)) == 2)
    assert out["port"] == out["jax"]
    assert sorted(dict(r)["data"] for r in _final(out["port"]).values()) == [b"one", b"two"]


# --- airbyte over a local connector process ------------------------------------


def test_airbyte_reads_a_local_connector(tmp_path):
    script = tmp_path / "source.py"
    script.write_text(
        "import json\n"
        "for i, stream in enumerate(['users', 'orders', 'users', 'users']):\n"
        "    print(json.dumps({'type': 'RECORD', 'record': {'stream': stream, 'data': {'id': i}}}))\n"
        "print(json.dumps({'type': 'STATE', 'state': {'data': {'cursor': 4}}}))\n"
        "print('not json')\n"
    )
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        t = pw.io.airbyte.read({"command": [sys.executable, str(script)]}, ["users"])
        out[name] = _events_until(pw, t, lambda ev: len(_final(ev)) == 3)
    assert out["port"] == out["jax"]
    assert sorted(dict(r)["data"][1] for r in _final(out["port"]).values()) == [
        repr({"id": 0}), repr({"id": 2}), repr({"id": 3})]
    for pw in PACKAGES.values():
        with pytest.raises(ValueError, match="command"):
            pw.io.airbyte.read({}, ["users"])


# --- sharepoint keeps the reference's refusal ------------------------------------


def test_sharepoint_raises_the_reference_message():
    messages = []
    for pw in PACKAGES.values():
        with pytest.raises(NotImplementedError) as e:
            pw.io.sharepoint.read(url="https://example.invalid", root_path="/")
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "enterprise" in messages[0]


# --- null -------------------------------------------------------------------


def test_null_writer_consumes():
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_markdown(
            """
            v
            1
            """
        )
        pw.io.null.write(t)
        pw.run()


# --- the writer fault both packages share ---------------------------------------


def test_sqlite_write_of_a_pointer_at_or_past_2_63_overflows_in_both(tmp_path):
    """``pw.io.sqlite.write`` converts only the row key to signed 64 bits:
    a ``Pointer`` column (here ``pw.reducers.max(t.id)``) of 2^63 or more
    raises ``OverflowError`` in both packages, with the same message."""
    outcomes = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_markdown(
            """
            g | v
            1 | 10
            1 | 11
            1 | 12
            2 | 13
            """
        )
        top = t.groupby(t.g).reduce(t.g, top=pw.reducers.max(t.id))
        keys, cols = pw.debug.table_to_dicts(top)
        assert max(int(cols["top"][k]) for k in keys) >= 1 << 63  # the case needs such a value
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_markdown(
            """
            g | v
            1 | 10
            1 | 11
            1 | 12
            2 | 13
            """
        )
        pw.io.sqlite.write(t.groupby(t.g).reduce(t.g, top=pw.reducers.max(t.id)), str(tmp_path / f"{name}.db"),
                           "out")
        with pytest.raises(OverflowError) as e:
            pw.run()
        outcomes[name] = str(e.value)
    assert outcomes["port"] == outcomes["jax"]
    assert "too large to convert to SQLite INTEGER" in outcomes["port"]


# --- the cdc-index slice of chip_smoke.py -------------------------------------------


def test_cdc_index_slice_through_both_packages(tmp_path):
    """``chip_smoke.cdc_pipeline`` with a 2-layer, 32-wide float32 encoder
    over 320 rows and 4 transactions (24 inserts, 12 edits, 12 deletes
    each), 6 standing queries, k = 10. After the load and every
    transaction: the SQLite table's, the Debezium table's and the replies'
    states equal across the packages (keys and rows; scores within 1e-5),
    the Debezium table equals the SQLite one, and every reply is the numpy
    top-k over the live rows; the replies read back from each package's
    SQLite file equal its subscribed ones, and a static read of the table
    equals the final state."""
    from chip_smoke import CDC_K, cdc_stream, signed64
    from test_torch_components import DIM, _embedder

    s = cdc_stream(7, 320, 4, 24, 12, 12, 5, 6)
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        os.makedirs(tmp_path / name)
        knn_kw = {"device": "cpu"} if pw is tpw else {}
        out[name] = cdc_run(pw, str(tmp_path / name), s, _embedder(pw), DIM, knn_kw)
    port, ref = out["port"], out["jax"]
    assert len(port["snaps"]) == len(ref["snaps"]) == len(s["txns"]) + 1
    for c, (p, r) in enumerate(zip(port["snaps"], ref["snaps"])):
        live = s["live"][c - 1] if c else s["initial"]
        assert p["docs"] == r["docs"] and p["changes"] == r["changes"] == p["docs"], c
        assert sorted(row[0] for row in p["docs"].values()) == sorted(live)
        assert set(p["pairs"]) == set(r["pairs"]), c
        for key, (q, d, sc) in p["pairs"].items():
            rq, rd, rsc = r["pairs"][key]
            assert (q, d) == (rq, rd) and abs(sc - rsc) <= SCORE_TOL, (c, key)
        ids = np.array(sorted(live))
        m = np.stack([p["vecs"][int(i)] for i in ids])
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        for q, v in port["qvecs"].items():
            sc = m @ (v / np.linalg.norm(v))
            order = np.argsort(-sc, kind="stable")[:CDC_K]
            got = sorted(((d, x) for qq, d, x in p["pairs"].values() if qq == q), key=lambda e: -e[1])
            assert [d for d, _x in got] == [int(ids[j]) for j in order], (c, q)
            assert np.allclose([x for _d, x in got], sc[order] - 1.0, atol=SCORE_TOL)
    for res in (port, ref):
        final = res["snaps"][-1]
        written = {key: (q, d, x) for q, d, x, key in res["written"]}
        assert written == {signed64(key): v for key, v in final["pairs"].items()}
        assert res["static"] == final["docs"]
    pw_rows, ref_rows = (sorted(r["written"], key=lambda row: row[3]) for r in (port, ref))
    assert [(q, d, key) for q, d, _x, key in pw_rows] == [(q, d, key) for q, d, _x, key in ref_rows]
    assert all(abs(a[2] - b[2]) <= SCORE_TOL for a, b in zip(pw_rows, ref_rows))


# --- a store written by one package, resumed by the other ------------------------


def _lines(path):
    try:
        return [json.loads(x) for x in open(path) if x.strip()]
    except OSError:
        return []


def _apply(state, lines):
    state = dict(state)
    for o in lines:
        if o["diff"] > 0:
            state[o["k"]] = o["v"]
        elif state.get(o["k"]) == o["v"]:
            del state[o["k"]]
    return state


def _persisted_run(pw, build, store, out, base, want, timeout=20.0):
    """Run ``build(pw)`` (a streaming table) over a filesystem store until
    ``base`` updated by the jsonlines output equals ``want``; the output's
    (diff, k, v) lines and the run's persistence driver."""
    pw.internals.parse_graph.G.clear()
    pw.io.jsonlines.write(build(pw), str(out))
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(store)), snapshot_every=1)
    th = threading.Thread(target=lambda: pw.run(persistence_config=cfg, autocommit_duration_ms=20), daemon=True)
    th.start()
    deadline = time.time() + timeout
    while time.time() < deadline and _apply(base, _lines(out)) != want:
        time.sleep(0.05)
    time.sleep(0.3)  # a row sent twice would land by now
    rt = pw.internals.parse_graph.G.runtime
    if rt is not None:
        rt.stop()
    th.join(timeout=10)
    lines = _lines(out)
    assert _apply(base, lines) == want, (lines, want)
    return sorted((o["diff"], o["k"], o["v"]) for o in lines), pw.internals.parse_graph.G.last_runtime.persistence_driver


def _sqlite_case(tmp_path):
    db = tmp_path / "t.db"
    _kv_db(db, [("a", 1), ("b", 2)])

    def build(pw):
        return pw.io.sqlite.read(str(db), "kv", _kv(pw), mode="streaming")

    def change():
        conn = sqlite3.connect(db)
        with conn:
            conn.execute("INSERT INTO kv VALUES ('c', 3)")
            conn.execute("UPDATE kv SET v = 20 WHERE k = 'b'")
            conn.execute("DELETE FROM kv WHERE k = 'a'")
        conn.close()

    return build, change


def _debezium_case(tmp_path):
    msgs = tmp_path / "msgs"
    msgs.mkdir()
    with open(msgs / "1.jsonl", "w") as f:
        f.write("".join(json.dumps(e) + "\n" for e in DEBEZIUM_EVENTS[1:3]))

    def build(pw):
        return pw.io.debezium.read(input_dir=str(msgs), schema=_kv(pw))

    def change():
        with open(msgs / "1.jsonl", "a") as f:  # a line appended to a file already read
            f.write(json.dumps({"payload": {"op": "c", "after": {"k": "c", "v": 3}}}) + "\n")
        with open(msgs / "2.jsonl", "w") as f:
            f.write(json.dumps({"payload": {"op": "u", "before": {"k": "b", "v": 2}, "after": {"k": "b", "v": 20}}})
                    + "\n" + json.dumps({"payload": {"op": "d", "before": {"k": "a", "v": 1}}}) + "\n")

    return build, change


def _deltalake_case(tmp_path):
    from pathway_tpu_torch.engine.batch import DiffBatch
    from pathway_tpu_torch.io.deltalake import _DeltaWriter, _Store

    lake = str(tmp_path / "lake")
    _DeltaWriter(_Store(lake), ["k", "v"]).write_batch(
        0, DiffBatch.from_rows([(1, 1, ("a", 1)), (2, 1, ("b", 2))], ["k", "v"]))

    def build(pw):
        return pw.io.deltalake.read(lake, schema=_kv(pw), mode="streaming")

    def change():
        # an overwrite: the resumed reader retracts the rows of the files it removes
        _DeltaWriter(_Store(lake), ["k", "v"], mode="overwrite").write_batch(
            2, DiffBatch.from_rows([(3, 1, ("b", 20)), (4, 1, ("c", 3))], ["k", "v"]))

    return build, change


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("source", ["sqlite", "debezium", "deltalake"])
def test_streaming_source_resumes_across_packages(tmp_path, source, writer, reader):
    """Run A under ``writer`` persists the source's offsets; the source
    then changes (an insert, an update, a delete); run B under ``reader``
    restores A's store and sends exactly those changes: no row twice, none
    lost."""
    build, change = {"sqlite": _sqlite_case, "debezium": _debezium_case, "deltalake": _deltalake_case}[source](
        tmp_path)
    store = tmp_path / "pstorage"
    first = {"a": 1, "b": 2}
    lines_a, _drv = _persisted_run(PACKAGES[writer], build, store, tmp_path / "a.jsonl", {}, first)
    assert lines_a == [(1, "a", 1), (1, "b", 2)]
    change()
    lines_b, drv = _persisted_run(PACKAGES[reader], build, store, tmp_path / "b.jsonl", first, {"b": 20, "c": 3})
    assert lines_b == [(-1, "a", 1), (-1, "b", 2), (1, "b", 20), (1, "c", 3)]
    assert drv.restored_from_snapshot and drv.replayed_events == 0
