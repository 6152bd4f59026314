"""The port's data-lake writers and readers (``pw.io.deltalake``,
``pw.io.iceberg``) against the JAX package's, as parity tests: the
reference's ``tests/test_data_lake.py`` — transactional append and
overwrite, the schema-evolution guards, object storage (fsspec's memory
filesystem), compaction, optimistic concurrency, streaming retractions on
an overwrite, an overwrite committed atomically with its first batch —
run once with each package's writer and reader. Each scenario's outcome
(the tables read back, the active part files, the log or snapshot
metadata, the messages of the refusals) is the same in both packages, the
rows each writer leaves (with ``time`` and ``diff``) are the same, and
each package reads the other's lake as its own."""

import importlib
import os
import threading
import time
import uuid

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _mods(pw):
    base = pw.__name__
    return (importlib.import_module(f"{base}.io.deltalake"), importlib.import_module(f"{base}.io.iceberg"),
            importlib.import_module(f"{base}.engine.batch").DiffBatch)


def _kv(pw, extra=False):
    if extra:
        class KVW(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int
            w: int | None

        return KVW

    class KV(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    return KV


def _write_rows(pw, writer, rows, t=0, cols=("k", "v")):
    DiffBatch = _mods(pw)[2]
    writer.write_batch(t, DiffBatch.from_rows([(i, 1, r) for i, r in enumerate(rows)], list(cols)))


def _read_static(pw, kind, uri, extra=False):
    pw.internals.parse_graph.G.clear()
    t = getattr(pw.io, kind).read(uri, schema=_kv(pw, extra), mode="static")
    keys, cols = pw.debug.table_to_dicts(t)
    return {cols["k"][key]: tuple(cols[c][key] for c in cols if c != "k") for key in keys}, sorted(int(k) for k in keys)


def _both(tmp_path, scenario):
    """``scenario(pw, root)`` under each package in its own folder; then
    every lake read by each package (``reads`` of the scenario's outcome)."""
    out = {}
    for name, pw in PACKAGES.items():
        root = str(tmp_path / name)
        os.makedirs(root, exist_ok=True)
        out[name] = scenario(pw, root)
    return out["port"], out["jax"]


def _delta_rows(pw, root):
    import pyarrow.parquet as pq

    delta = _mods(pw)[0]
    files, _meta = delta._replay_log(delta._Store(root))
    return sorted(tuple(sorted(r.items())) for f in files for r in pq.read_table(os.path.join(root, f)).to_pylist())


def _cross_read(tmp_path, kind, extra=False):
    """Each package's lake read by both packages: one table per lake."""
    for lake in PACKAGES:
        reads = [_read_static(pw, kind, str(tmp_path / lake / "lake"), extra) for pw in PACKAGES.values()]
        assert reads[0] == reads[1], lake


def test_delta_overwrite_mode(tmp_path):
    def scenario(pw, root):
        delta = _mods(pw)[0]
        lake = os.path.join(root, "lake")
        w = delta._DeltaWriter(delta._Store(lake), ["k", "v"])
        _write_rows(pw, w, [("a", 1), ("b", 2)])
        first = _read_static(pw, "deltalake", lake)
        # overwrite: old parts leave the log's active set; only new data remains
        w2 = delta._DeltaWriter(delta._Store(lake), ["k", "v"], mode="overwrite")
        _write_rows(pw, w2, [("c", 3)])
        files, _meta = delta._replay_log(delta._Store(lake))
        return first, _read_static(pw, "deltalake", lake), len(files), _delta_rows(pw, lake)

    port, ref = _both(tmp_path, scenario)
    assert port == ref
    assert port[0][0] == {"a": (1,), "b": (2,)} and port[1][0] == {"c": (3,)} and port[2] == 1
    _cross_read(tmp_path, "deltalake")


def test_delta_schema_evolution_guard(tmp_path):
    def scenario(pw, root):
        delta = _mods(pw)[0]
        lake = os.path.join(root, "lake")
        two = [{"name": "k", "type": "str"}, {"name": "v", "type": "int"}]
        three = two + [{"name": "w", "type": "int"}]
        w = delta._DeltaWriter(delta._Store(lake), ["k", "v"], two)
        _write_rows(pw, w, [("a", 1)])
        refusals = []
        for cols, desc, kw in ((["k"], two[:1], {}), (["k", "v"], [two[0], {"name": "v", "type": "str"}], {}),
                               (["k", "v", "w"], three, {})):
            with pytest.raises(ValueError) as e:
                delta._DeltaWriter(delta._Store(lake), cols, desc, **kw)
            refusals.append(str(e.value))
        w3 = delta._DeltaWriter(delta._Store(lake), ["k", "v", "w"], three, schema_evolution="allow_add")
        _write_rows(pw, w3, [("c", 3, 30)], t=1, cols=("k", "v", "w"))
        _files, meta = delta._replay_log(delta._Store(lake))
        return refusals, meta["fields"], _read_static(pw, "deltalake", lake, extra=True)

    port, ref = _both(tmp_path, scenario)
    assert port == ref
    assert "drops existing" in port[0][0] and "changes type" in port[0][1] and "allow_add" in port[0][2]
    assert {f["name"] for f in port[1]} == {"k", "v", "w"}
    assert port[2][0] == {"a": (1, None), "c": (3, 30)}
    _cross_read(tmp_path, "deltalake", extra=True)


def test_delta_compaction(tmp_path):
    def scenario(pw, root):
        delta = _mods(pw)[0]
        lake = os.path.join(root, "lake")
        w = delta._DeltaWriter(delta._Store(lake), ["k", "v"], compact_every=3)
        for i in range(7):
            _write_rows(pw, w, [(f"k{i}", i)], t=i)
        files, _meta = delta._replay_log(delta._Store(lake))
        return len(files), len(os.listdir(os.path.join(lake, "_delta_log"))), _read_static(pw, "deltalake", lake)

    port, ref = _both(tmp_path, scenario)
    assert port == ref
    assert port[0] <= 3 and port[2][0] == {f"k{i}": (i,) for i in range(7)}
    _cross_read(tmp_path, "deltalake")


def test_delta_optimistic_concurrency(tmp_path):
    """Two writers that believe they own the same next version: the commit
    protocol keeps both batches (exclusive create, then the next version)."""
    def scenario(pw, root):
        delta = _mods(pw)[0]
        lake = os.path.join(root, "lake")
        w1 = delta._DeltaWriter(delta._Store(lake), ["k", "v"])
        w2 = delta._DeltaWriter(delta._Store(lake), ["k", "v"])
        _write_rows(pw, w1, [("a", 1)])
        _write_rows(pw, w2, [("b", 2)])
        return _read_static(pw, "deltalake", lake), (w1.version, w2.version)

    port, ref = _both(tmp_path, scenario)
    assert port == ref and port[0][0] == {"a": (1,), "b": (2,)}


def test_delta_object_store_roundtrip(tmp_path):
    """The same writer and reader over an fsspec object store (memory://;
    s3:// takes the same code path), and each package reads the other's."""
    pytest.importorskip("fsspec")
    uris = {name: f"memory://lake-{name}-{uuid.uuid4().hex}" for name in PACKAGES}
    out = {}
    for name, pw in PACKAGES.items():
        delta = _mods(pw)[0]
        with pytest.warns(UserWarning, match="TOCTOU"):
            w = delta._DeltaWriter(delta._Store(uris[name]), ["k", "v"])
        _write_rows(pw, w, [("a", 1), ("b", 2)])
        out[name] = [_read_static(p, "deltalake", uris[name]) for p in PACKAGES.values()]
    assert out["port"][0] == out["port"][1] == out["jax"][0] == out["jax"][1]
    assert out["port"][0][0] == {"a": (1,), "b": (2,)}


def _streaming_overwrite(pw, kind, root, first, then, make_writer):
    """A streaming read of a lake holding ``first``; then an overwrite
    writes ``then``: the states the subscriber saw reach each in turn."""
    pw.internals.parse_graph.G.clear()
    w = make_writer(pw, root, "append")
    _write_rows(pw, w, first)
    t = getattr(pw.io, kind).read(root, schema=_kv(pw), mode="streaming")
    seen, events = {}, []
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            events.append((int(key), is_addition, row["k"], row["v"]))
            if is_addition:
                seen[row["k"]] = row["v"]
            else:
                seen.pop(row["k"], None)

    pw.io.subscribe(t, on_change)
    th = threading.Thread(target=lambda: pw.run(autocommit_duration_ms=20), daemon=True)
    th.start()
    want = dict(first)
    deadline = time.time() + 15
    while time.time() < deadline and seen != want:
        time.sleep(0.05)
    assert seen == want, seen
    _write_rows(pw, make_writer(pw, root, "overwrite"), then, t=1)
    want = dict(then)
    while time.time() < deadline and seen != want:
        time.sleep(0.05)
    rt = pw.internals.parse_graph.G.runtime
    if rt is not None:
        rt.stop()
    th.join(timeout=10)
    assert seen == want, seen
    return sorted(events)


def _delta_writer(pw, root, mode):
    delta = _mods(pw)[0]
    return delta._DeltaWriter(delta._Store(root), ["k", "v"], mode=mode)


def test_delta_streaming_retracts_on_overwrite(tmp_path):
    port, ref = _both(tmp_path, lambda pw, root: _streaming_overwrite(
        pw, "deltalake", os.path.join(root, "lake"), [("a", 1), ("b", 2)], [("c", 3)], _delta_writer))
    assert port == ref
    assert sum(not add for _k, add, _kk, _v in port) == 2  # both old rows retracted


# --- iceberg ---------------------------------------------------------------

DESC = [{"name": "k", "type": "str"}, {"name": "v", "type": "int"}]


def test_iceberg_roundtrip_append_overwrite(tmp_path):
    def scenario(pw, root):
        ice = _mods(pw)[1]
        lake = os.path.join(root, "lake")
        _write_rows(pw, ice._IcebergWriter(lake, ["k", "v"], DESC), [("a", 1)])
        _write_rows(pw, ice._IcebergWriter(lake, ["k", "v"], DESC), [("b", 2)])  # append continues
        appended = _read_static(pw, "iceberg", lake)
        _write_rows(pw, ice._IcebergWriter(lake, ["k", "v"], DESC, mode="overwrite"), [("c", 3)])
        meta = ice._snapshot_meta(lake, ice._current_version(lake))
        return appended, _read_static(pw, "iceberg", lake), len(meta["snapshots"]), meta["schema"]["fields"]

    port, ref = _both(tmp_path, scenario)
    assert port == ref
    assert port[0][0] == {"a": (1,), "b": (2,)} and port[1][0] == {"c": (3,)}
    assert port[2] >= 3 and port[3] == DESC
    _cross_read(tmp_path, "iceberg")


def test_iceberg_schema_guard(tmp_path):
    def scenario(pw, root):
        ice = _mods(pw)[1]
        lake = os.path.join(root, "lake")
        _write_rows(pw, ice._IcebergWriter(lake, ["k", "v"], DESC), [("a", 1)])
        refusals = []
        for cols, desc in ((["k"], DESC[:1]), (["k", "v", "w"], DESC + [{"name": "w", "type": "int"}])):
            with pytest.raises(ValueError) as e:
                ice._IcebergWriter(lake, cols, desc)
            refusals.append(str(e.value))
        ice._IcebergWriter(lake, ["k", "v", "w"], DESC + [{"name": "w", "type": "int"}], schema_evolution="allow_add")
        return refusals

    port, ref = _both(tmp_path, scenario)
    assert port == ref and "drops existing" in port[0] and "allow_add" in port[1]


def _iceberg_writer(pw, root, mode):
    return _mods(pw)[1]._IcebergWriter(root, ["k", "v"], DESC, mode=mode)


def test_iceberg_streaming_retracts_on_overwrite(tmp_path):
    port, ref = _both(tmp_path, lambda pw, root: _streaming_overwrite(
        pw, "iceberg", os.path.join(root, "lake"), [("a", 1)], [("z", 9)], _iceberg_writer))
    assert port == ref
    assert sum(not add for _k, add, _kk, _v in port) == 1


@pytest.mark.parametrize("kind", ["deltalake", "iceberg"])
def test_overwrite_is_atomic_with_first_batch(tmp_path, kind):
    """Building an overwrite writer empties nothing: its removes commit with
    its first data batch (an aborted pipeline leaves the table intact)."""
    make = _delta_writer if kind == "deltalake" else _iceberg_writer

    def scenario(pw, root):
        lake = os.path.join(root, "lake")
        _write_rows(pw, make(pw, lake, "append"), [("a", 1)])
        w2 = make(pw, lake, "overwrite")
        before = _read_static(pw, kind, lake)
        _write_rows(pw, w2, [("b", 2)])
        return before, _read_static(pw, kind, lake)

    port, ref = _both(tmp_path, scenario)
    assert port == ref and port[0][0] == {"a": (1,)} and port[1][0] == {"b": (2,)}
    _cross_read(tmp_path, kind)
