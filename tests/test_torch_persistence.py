"""The port's persistence (``pw.run(persistence_config=...)``, record/replay,
``pw.debug`` capture with persistence, the stores) against the JAX
package's: the same scripts run under both packages and must give the same
outputs, stores of the same layout, and the same recovery (restored from a
snapshot, the same replayed events).

The cases are those of ``tests/test_persistence.py`` that need no [mesh]
(a sharded engine), the windowby kill/restart case with its stores
crossing the packages both ways among them, plus: a torn snapshot,
record/replay through ``PATHWAY_REPLAY_STORAGE``, debug capture, a small
``VectorStoreServer`` over ``pw.io.fs`` killed (``kill=tick:N``, exit 23)
and restarted, and a store written by each package restored by the other.

Streaming runs tick at wall-clock times, so outputs are compared as final
states (and, where the store is replayed in full, as update multisets).
Keys, counts and texts are exact; ``dist`` within atol 1e-4 (the two
encoders' f32 sums run in another order). The JAX side runs its
interpreter (``PATHWAY_COMPILED_TICK=0``)."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import uuid

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph

PACKAGES = {"jax": jpw, "port": tpw}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _write_words(path, words):
    with open(path, "w") as f:
        for w in words:
            f.write(json.dumps({"word": w}) + "\n")


def _write_rows(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _build_wordcount(pw, input_dir, out_path, mode="streaming"):
    class WordSchema(pw.Schema):
        word: str

    words = pw.io.fs.read(str(input_dir), format="json", schema=WordSchema, mode=mode)
    counts = words.groupby(words.word).reduce(words.word, count=pw.reducers.count())
    pw.io.jsonlines.write(counts, str(out_path))


def _lines(out_path):
    try:
        with open(out_path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except OSError:
        return []


def _final_counts(out_path):
    state: dict[str, int] = {}
    for obj in _lines(out_path):
        if obj["diff"] > 0:
            state[obj["word"]] = obj["count"]
        elif state.get(obj["word"]) == obj["count"]:
            del state[obj["word"]]
    return state


def _final_rows(out_path, key_fields, state=None):
    state = {} if state is None else state
    for obj in _lines(out_path):
        key = tuple(obj[k] for k in key_fields)
        val = tuple(v for k, v in sorted(obj.items()) if k not in ("diff", "time", "id", *key_fields))
        if obj["diff"] > 0:
            state[key] = val
        elif state.get(key) == val:
            del state[key]
    return state


def _run_until(pw, cfg, predicate, timeout=20.0):
    """pw.run in a thread; stop once predicate() holds (or timeout)."""
    t = threading.Thread(
        target=lambda: pw.run(persistence_config=cfg, autocommit_duration_ms=20), daemon=True
    )
    t.start()
    deadline = time.time() + timeout
    ok = False
    while time.time() < deadline:
        if predicate():
            ok = True
            break
        time.sleep(0.05)
    rt = pw.internals.parse_graph.G.runtime
    if rt is not None:
        rt.stop()
    t.join(timeout=10)
    return ok


def _store_files(pdir):
    out = []
    for root, _dirs, files in os.walk(pdir):
        for f in files:
            out.append(os.path.relpath(os.path.join(root, f), pdir).replace(os.sep, "/"))
    return sorted(out)


def _layout(files):
    """Store keys with the per-run parts (offsets sequence) kept: the
    layout both packages must agree on."""
    return sorted({f.split("/")[0] + "/" + ("gen" if f.startswith("states/") else "") for f in files})


# --- wordcount kill/restart (record/replay: the log survives verbatim) ------


@pytest.mark.parametrize("backend", ["filesystem", "fsspec_memory"])
def test_wordcount_kill_restart_full_access(tmp_path, backend):
    results = {}
    for name, pw in PACKAGES.items():
        base = tmp_path / name
        input_dir = base / "in"
        input_dir.mkdir(parents=True)
        be = (
            pw.persistence.Backend.filesystem(str(base / "pstorage"))
            if backend == "filesystem"
            else pw.persistence.Backend.s3(f"memory://pwtest-{uuid.uuid4().hex}")
        )
        cfg = pw.persistence.Config.simple_config(be, snapshot_access="full")
        _write_words(input_dir / "f1.jsonl", ["a", "b", "a", "c", "a"])
        pw.internals.parse_graph.G.clear()
        _build_wordcount(pw, input_dir, base / "a.jsonl")
        assert _run_until(pw, cfg, lambda: _final_counts(base / "a.jsonl").get("a") == 3)
        pw.internals.parse_graph.G.clear()
        _write_words(input_dir / "f2.jsonl", ["b", "d"])
        _build_wordcount(pw, input_dir, base / "b.jsonl")
        assert _run_until(
            pw, cfg, lambda: _final_counts(base / "b.jsonl").get("d") == 1
            and _final_counts(base / "b.jsonl").get("b") == 2,
        )
        drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
        results[name] = (_final_counts(base / "a.jsonl"), _final_counts(base / "b.jsonl"), drv.replayed_events)
    assert results["port"] == results["jax"]
    assert results["port"][1] == {"a": 3, "b": 2, "c": 1, "d": 1}


def test_static_finished_source_not_rerun(tmp_path):
    results = {}
    for name, pw in PACKAGES.items():
        base = tmp_path / name
        (base / "in").mkdir(parents=True)
        _write_words(base / "in" / "f1.jsonl", ["x", "y", "x"])
        cfg = pw.persistence.Config.simple_config(
            pw.persistence.Backend.filesystem(str(base / "pstorage")), snapshot_access="full"
        )
        outs = []
        for run in ("a", "b"):
            pw.internals.parse_graph.G.clear()
            _build_wordcount(pw, base / "in", base / f"{run}.jsonl", mode="static")
            pw.run(persistence_config=cfg)
            outs.append(_lines(base / f"{run}.jsonl"))
        results[name] = (outs, _layout(_store_files(base / "pstorage")))
    assert results["port"] == results["jax"]
    assert _final_counts(tmp_path / "port" / "b.jsonl") == {"x": 2, "y": 1}


# --- the stores ----------------------------------------------------------------


def test_memory_and_filesystem_stores_match_reference(tmp_path):
    from pathway_tpu.persistence import backends as jb
    from pathway_tpu_torch.persistence import backends as tb

    seen = {}
    for name, b in (("jax", jb), ("port", tb)):
        a = b.MemoryStore(f"t-{name}")
        a.put("inputs/x/chunk-00000000.pkl", b"abc")
        a.put("metadata.json", b"{}")
        again = b.MemoryStore(f"t-{name}")
        mem = (again.get("inputs/x/chunk-00000000.pkl"), again.list_keys("inputs/"))
        again.remove("metadata.json")
        mem += (b.MemoryStore(f"t-{name}").get("metadata.json"),)
        fs = b.FilesystemStore(str(tmp_path / name))
        fs.put("a/b/c.bin", b"\x00\x01")
        fs.put("a/d.bin", b"")
        got = (fs.get("a/b/c.bin"), fs.list_keys(), fs.list_keys("a/b"), bytes(fs.get_buffer("a/b/c.bin")),
               bytes(fs.get_buffer("a/d.bin")))
        fs.remove("a/b/c.bin")
        got += (fs.get("a/b/c.bin"), fs.get_buffer("missing"))
        seen[name] = (mem, got)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == (b"abc", ["inputs/x/chunk-00000000.pkl"], None)


def test_fsspec_stores_match_reference(tmp_path):
    from pathway_tpu.persistence import backends as jb
    from pathway_tpu_torch.persistence import backends as tb

    seen = {}
    for name, b, pw in (("jax", jb, jpw), ("port", tb, tpw)):
        url = f"memory://pwtest-{uuid.uuid4().hex}"
        st = b.FsspecStore(url)
        st.put("inputs/a/chunk-00000001.pkl", b"one")
        st.put("inputs/a/chunk-00000002.pkl", b"two")
        st.put("offsets/a.pkl", b"off")
        rec = [st.get("inputs/a/chunk-00000001.pkl"), st.get("missing"), st.list_keys("inputs/")]
        st.remove("inputs/a/chunk-00000001.pkl")
        st.remove("missing")
        rec.append(st.list_keys("inputs/"))
        st2 = b.store_for_backend(pw.persistence.Backend.s3(url))
        rec += [type(st2).__name__, st2.get("offsets/a.pkl")]
        fst = b.FsspecStore(f"file://{tmp_path}/{name}/ckpt")
        fst.put("inputs/a/chunk-00000001.pkl", b"x")  # parents auto-created
        rec.append(fst.get("inputs/a/chunk-00000001.pkl"))
        with pytest.raises(TypeError, match="bucket_settings"):
            b.store_for_backend(pw.persistence.Backend.s3("memory://x", object()))
        seen[name] = rec
    assert seen["port"] == seen["jax"]
    assert seen["port"][3] == ["inputs/a/chunk-00000002.pkl"]


def test_cached_object_storage_matches_reference(tmp_path):
    from pathway_tpu.persistence import backends as jb, cached_object_storage as jc
    from pathway_tpu_torch.persistence import backends as tb, cached_object_storage as tc

    seen = {}
    for name, b, c in (("jax", jb, jc), ("port", tb, tc)):
        store = b.FilesystemStore(str(tmp_path / name))
        cos = c.CachedObjectStorage(store)
        cos.upsert("s3://b/x", b"1", {"etag": "a"})
        cos.upsert("s3://b/y", b"2")
        cos.upsert("s3://b/x", b"3", {"etag": "b"})
        cos.remove("s3://b/y")
        again = c.CachedObjectStorage(b.FilesystemStore(str(tmp_path / name)))
        rec = (again.get("s3://b/x"), again.metadata("s3://b/x"), again.contains("s3://b/y"),
               again.actual_version(), sorted(again.uris()), again.vacuum(), store.list_keys())
        seen[name] = rec
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == b"3" and seen["port"][5] == 3


# --- operator snapshots, compaction, bounded replay -------------------------


def test_operator_snapshot_bounded_replay_and_compaction(tmp_path):
    results = {}
    for name, pw in PACKAGES.items():
        base = tmp_path / name
        input_dir = base / "in"
        input_dir.mkdir(parents=True)
        pdir = base / "pstorage"
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
        _write_words(input_dir / "f1.jsonl", ["a", "b", "a", "c", "a"])
        pw.internals.parse_graph.G.clear()
        _build_wordcount(pw, input_dir, base / "a.jsonl")
        assert _run_until(pw, cfg, lambda: _final_counts(base / "a.jsonl").get("a") == 3)
        files = _store_files(pdir)
        assert not [f for f in files if f.startswith("inputs/")], "uncompacted chunk"
        assert [f for f in files if f.startswith("states/")], "no operator snapshot written"
        pw.internals.parse_graph.G.clear()
        _write_words(input_dir / "f2.jsonl", ["b", "d"])
        _build_wordcount(pw, input_dir, base / "b.jsonl")
        assert _run_until(
            pw, cfg, lambda: _final_counts(base / "b.jsonl").get("b") == 2
            and _final_counts(base / "b.jsonl").get("d") == 1,
        )
        drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
        merged = _final_rows(base / "b.jsonl", ["word"], _final_rows(base / "a.jsonl", ["word"]))
        results[name] = (drv.restored_from_snapshot, drv.replayed_events, merged, _layout(files))
    assert results["port"] == results["jax"]
    assert results["port"][:3] == (True, 0, {("a",): (3,), ("b",): (2,), ("c",): (1,), ("d",): (1,)})


def test_log_stays_bounded_under_churn(tmp_path):
    results = {}
    for name, pw in PACKAGES.items():
        base = tmp_path / name
        input_dir = base / "in"
        input_dir.mkdir(parents=True)
        pdir = base / "pstorage"
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
        for i in range(5):
            _write_words(input_dir / f"f{i}.jsonl", [f"w{i}", "common"])
        pw.internals.parse_graph.G.clear()
        _build_wordcount(pw, input_dir, base / "out.jsonl")
        assert _run_until(pw, cfg, lambda: _final_counts(base / "out.jsonl").get("common") == 5)
        files = _store_files(pdir)
        chunks = [f for f in files if f.startswith("inputs/")]
        gens = {f.split("/")[1] for f in files if f.startswith("states/")}
        results[name] = (chunks, len(gens), _final_counts(base / "out.jsonl"))
    assert results["port"] == results["jax"]
    assert results["port"][:2] == ([], 1)


def _build_groupby_sum(pw, input_dir, out_path):
    class NumSchema(pw.Schema):
        k: str
        t: int
        v: int

    rows = pw.io.fs.read(str(input_dir), format="json", schema=NumSchema, mode="streaming")
    agg = rows.groupby(rows.k).reduce(
        rows.k, s=pw.reducers.sum(rows.v), mx=pw.reducers.max(rows.v), cnt=pw.reducers.count()
    )
    pw.io.jsonlines.write(agg, str(out_path))


def test_groupby_sum_kill_restart_bounded_replay(tmp_path):
    results = {}
    for name, pw in PACKAGES.items():
        base = tmp_path / name
        input_dir = base / "in"
        input_dir.mkdir(parents=True)
        cfg = pw.persistence.Config.simple_config(
            pw.persistence.Backend.filesystem(str(base / "pstorage")), snapshot_every=1
        )
        _write_rows(input_dir / "f1.jsonl", [{"k": "x", "t": 0, "v": 3}, {"k": "y", "t": 1, "v": 5},
                                             {"k": "x", "t": 2, "v": 4}])
        pw.internals.parse_graph.G.clear()
        _build_groupby_sum(pw, input_dir, base / "a.jsonl")
        assert _run_until(pw, cfg, lambda: _final_rows(base / "a.jsonl", ["k"]).get(("x",)) == (2, 4, 7))
        pw.internals.parse_graph.G.clear()
        _write_rows(input_dir / "f2.jsonl", [{"k": "x", "t": 3, "v": 10}, {"k": "z", "t": 4, "v": 1}])
        _build_groupby_sum(pw, input_dir, base / "b.jsonl")
        assert _run_until(
            pw, cfg, lambda: _final_rows(base / "b.jsonl", ["k"]).get(("x",)) == (3, 10, 17)
            and _final_rows(base / "b.jsonl", ["k"]).get(("z",)) == (1, 1, 1),
        )
        drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
        results[name] = (drv.restored_from_snapshot, drv.replayed_events,
                         _final_rows(base / "b.jsonl", ["k"], _final_rows(base / "a.jsonl", ["k"])))
    assert results["port"] == results["jax"]
    assert results["port"][:2] == (True, 0)


def test_knn_index_state_round_trip_and_cross_load():
    from pathway_tpu.stdlib.indexing._index_impls import TpuDenseKnnIndex as JIndex
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex as TIndex

    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(20, 8)).astype(np.float32)
    built = {}
    for name, cls, kw in (("jax", JIndex, {}), ("port", TIndex, {"device": "cpu"})):
        a = cls(dimensions=8, **kw)
        for i in range(20):
            a.upsert(i, vecs[i], {"i": i})
        a.remove(5)
        built[name] = (a, cls, kw)
    replies = {}
    for src in ("jax", "port"):
        state = built[src][0].state_dict()
        for dst in ("jax", "port"):
            _a, cls, kw = built[dst]
            b = cls(dimensions=8, **kw)
            b.load_state(state)
            assert b.metadata[7] == {"i": 7}
            replies[(src, dst)] = [r[0] for r in b.search([(vecs[7], 3, None)])[0]]
    direct = [r[0] for r in built["jax"][0].search([(vecs[7], 3, None)])[0]]
    assert all(v == direct for v in replies.values())
    assert 5 not in direct
    js, ts = built["jax"][0].state_dict(), built["port"][0].state_dict()
    assert js["metadata"] == ts["metadata"]
    for key in ("dim", "capacity", "free", "slot_of", "key_of"):
        assert js["corpus"][key] == ts["corpus"][key]
    np.testing.assert_array_equal(js["corpus"]["host"], ts["corpus"]["host"])
    np.testing.assert_array_equal(js["corpus"]["valid_host"], ts["corpus"]["valid_host"])


# --- record/replay, debug capture -------------------------------------------


def test_replay_storage_env_records_then_replays(tmp_path, monkeypatch):
    """PATHWAY_REPLAY_STORAGE (record/replay debugging): a recorded static
    run's log replays the same output with the source gone."""
    from pathway_tpu.internals.config import get_pathway_config as jcfg
    from pathway_tpu_torch.internals.config import get_pathway_config as tcfg

    results = {}
    for name, pw, cfg in (("jax", jpw, jcfg()), ("port", tpw, tcfg())):
        base = tmp_path / name
        (base / "in").mkdir(parents=True)
        _write_words(base / "in" / "f1.jsonl", ["p", "q", "p", "r"])
        monkeypatch.setattr(cfg, "replay_storage", str(base / "replay"))
        outs = []
        for run, access in (("rec", "record"), ("rep", "full")):
            monkeypatch.setattr(cfg, "snapshot_access", access)
            pw.internals.parse_graph.G.clear()
            _build_wordcount(pw, base / "in", base / f"{run}.jsonl", mode="static")
            pw.run()
            outs.append(_lines(base / f"{run}.jsonl"))
        monkeypatch.setattr(cfg, "replay_storage", None)
        monkeypatch.setattr(cfg, "snapshot_access", None)
        results[name] = (outs, [f for f in _store_files(base / "replay") if not f.startswith("offsets/")])
    assert results["port"] == results["jax"]
    assert _final_counts(tmp_path / "port" / "rep.jsonl") == {"p": 2, "q": 1, "r": 1}
    assert any(f.startswith("inputs/") for f in results["port"][1])  # the log survives


def test_debug_capture_with_persistence(tmp_path):
    """pw.debug.table_to_dicts(persistence_config=...): a deduplicate-style
    accumulator over a transient fixture restores its state on the second
    capture, under both packages alike."""
    seen = {}
    for name, pw in PACKAGES.items():
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(tmp_path / name)))
        got = []
        for rows in (["a 1", "b 2", "a 3"], ["b 5", "c 1"]):
            pw.internals.parse_graph.G.clear()
            t = pw.debug.table_from_markdown("k | v\n" + "\n".join(r.replace(" ", " | ") for r in rows))
            agg = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v), n=pw.reducers.count())
            keys, cols = pw.debug.table_to_dicts(agg, persistence_config=cfg)
            got.append(sorted((cols["k"][k], cols["s"][k], cols["n"][k]) for k in keys))
            drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
            got.append((drv.restored_from_snapshot, drv.replayed_events))
        seen[name] = got
    assert seen["port"] == seen["jax"]


# --- a torn snapshot, in a child process (the fault exits the process) -----

_WORDCOUNT_CHILD = textwrap.dedent(
    """
    import json, os, sys, threading, time
    pkg, base, out = sys.argv[1], sys.argv[2], sys.argv[3]
    import importlib
    pw = importlib.import_module(pkg)

    class WordSchema(pw.Schema):
        word: str

    words = pw.io.fs.read(base + "/in", format="json", schema=WordSchema, mode="streaming")
    counts = words.groupby(words.word).reduce(words.word, count=pw.reducers.count())
    pw.io.jsonlines.write(counts, out)
    cfg = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(base + "/pstorage"), snapshot_every=1)
    want = sys.argv[4]  # stop once this word is in the output

    def stopper():
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                with open(out) as f:
                    if any(json.loads(line)["word"] == want for line in f):
                        break
            except OSError:
                pass
            time.sleep(0.05)
        while pw.internals.parse_graph.G.runtime is None:
            time.sleep(0.01)
        pw.internals.parse_graph.G.runtime.stop()

    threading.Thread(target=stopper, daemon=True).start()
    pw.run(persistence_config=cfg, autocommit_duration_ms=20)
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    print(json.dumps({"restored": drv.restored_from_snapshot, "replayed": drv.replayed_events}))
    """
)


def _child(pkg, script, *args, env=None, timeout=120):
    e = dict(os.environ, PYTHONPATH=REPO, PATHWAY_COMPILED_TICK="0", JAX_PLATFORMS="cpu")
    e.pop("PATHWAY_FAULTS", None)
    e.update(env or {})
    return subprocess.run(
        [sys.executable, "-c", script, pkg, *map(str, args)],
        capture_output=True, text=True, timeout=timeout, env=e, cwd=REPO,
    )


def test_torn_snapshot_restarts_from_previous_cut(tmp_path):
    """torn=nth:2 exits 23 right before the second snapshot's metadata
    commit (the shutdown snapshot): its segments and state blobs are
    durable, the metadata naming them is not. The restart must restore the
    first generation, ignore the torn one, and count every word once."""
    results = {}
    for name, pkg in (("jax", "pathway_tpu"), ("port", "pathway_tpu_torch")):
        base = tmp_path / name
        (base / "in").mkdir(parents=True)
        _write_words(base / "in" / "f1.jsonl", ["a", "b", "a"])
        torn = _child(pkg, _WORDCOUNT_CHILD, base, base / "a.jsonl", "b", env={"PATHWAY_FAULTS": "torn=nth:2"})
        assert torn.returncode == 23, torn.stderr[-2000:]
        meta = json.loads((base / "pstorage" / "metadata.json").read_text())
        _write_words(base / "in" / "f2.jsonl", ["c"])
        again = _child(pkg, _WORDCOUNT_CHILD, base, base / "b.jsonl", "c")
        assert again.returncode == 0, again.stderr[-2000:]
        info = json.loads(again.stdout.strip().splitlines()[-1])
        merged = _final_rows(base / "b.jsonl", ["word"], _final_rows(base / "a.jsonl", ["word"]))
        results[name] = (meta["state"]["gen"], info, merged)
    assert results["port"] == results["jax"]
    assert results["port"][0] == 1  # the torn generation never got named
    assert results["port"][1]["restored"]
    assert results["port"][2] == {("a",): (2,), ("b",): (1,), ("c",): (1,)}


# --- stores across the packages -------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_store_written_by_one_package_restores_in_the_other(tmp_path, writer, reader):
    """Run A under ``writer`` (groupby with its GroupBy ledger segments,
    Json values in the log and state), run B under ``reader`` over the
    same store: B restores A's snapshot, replays nothing, and the merged
    output equals the uninterrupted totals."""
    input_dir = tmp_path / "in"
    input_dir.mkdir()
    pdir = tmp_path / "pstorage"

    def build(pw, out):
        class S(pw.Schema):
            k: str
            v: int
            meta: pw.Json

        rows = pw.io.fs.read(str(input_dir), format="json", schema=S, mode="streaming")
        agg = rows.groupby(rows.k).reduce(
            rows.k, s=pw.reducers.sum(rows.v), tags=pw.reducers.sorted_tuple(rows.meta["tag"].as_str())
        )
        pw.io.jsonlines.write(agg, str(out))

    _write_rows(input_dir / "f1.jsonl", [{"k": "x", "v": 1, "meta": {"tag": "p"}},
                                         {"k": "y", "v": 2, "meta": {"tag": "q"}},
                                         {"k": "x", "v": 3, "meta": {"tag": "r"}}])
    pw = PACKAGES[writer]
    pw.internals.parse_graph.G.clear()
    build(pw, tmp_path / "a.jsonl")
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
    assert _run_until(pw, cfg, lambda: _final_rows(tmp_path / "a.jsonl", ["k"]).get(("x",)) == (4, ["p", "r"]))
    assert any(f.startswith("segments/") for f in _store_files(pdir))
    _write_rows(input_dir / "f2.jsonl", [{"k": "x", "v": 10, "meta": {"tag": "s"}}, {"k": "z", "v": 5, "meta": {"tag": "t"}}])
    pw = PACKAGES[reader]
    pw.internals.parse_graph.G.clear()
    build(pw, tmp_path / "b.jsonl")
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
    assert _run_until(pw, cfg, lambda: _final_rows(tmp_path / "b.jsonl", ["k"]).get(("z",)) == (5, ["t"]))
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    assert drv.restored_from_snapshot and drv.replayed_events == 0
    merged = _final_rows(tmp_path / "b.jsonl", ["k"], _final_rows(tmp_path / "a.jsonl", ["k"]))
    assert merged == {("x",): (14, ["p", "r", "s"]), ("y",): (2, ["q"]), ("z",): (5, ["t"])}


def test_pickles_cross_packages_both_ways():
    import pickle

    from pathway_tpu.internals.api import Pointer as JPointer
    from pathway_tpu.internals.json import Json as JJson
    from pathway_tpu_torch.internals.api import Pointer as TPointer
    from pathway_tpu_torch.internals.json import Json as TJson
    from pathway_tpu_torch.persistence import _pickle

    obj = [TJson({"a": [1, 2]}), TPointer(7), np.array([TJson(1), None], dtype=object), {"k": (TJson("x"),)}]
    ref_view = pickle.loads(_pickle.dumps(obj))  # as the JAX package reads a port store
    assert type(ref_view[0]) is JJson and type(ref_view[1]) is JPointer
    assert type(ref_view[2][0]) is JJson and ref_view[0].value == {"a": [1, 2]} and ref_view[1] == 7
    back = _pickle.loads(pickle.dumps(ref_view))  # as the port reads a JAX store
    assert type(back[0]) is TJson and type(back[1]) is TPointer and type(back[3]["k"][0]) is TJson
    assert back[0].value == {"a": [1, 2]} and int(back[1]) == 7
    assert b"pathway_tpu_torch" not in _pickle.dumps(obj)



# --- windowby + common_behavior across a restart ------------------------------


def _build_windows(pw, input_dir, out_path):
    class NumSchema(pw.Schema):
        k: str
        t: int
        v: int

    rows = pw.io.fs.read(str(input_dir), format="json", schema=NumSchema, mode="streaming")
    win = rows.windowby(
        rows.t,
        window=pw.temporal.tumbling(duration=4),
        instance=rows.k,
        behavior=pw.temporal.common_behavior(delay=2, cutoff=100, keep_results=True),
    ).reduce(
        k=pw.this._pw_instance,
        start=pw.this._pw_window_start,
        cnt=pw.reducers.count(),
        s=pw.reducers.sum(pw.this.v),
    )
    pw.io.jsonlines.write(win, str(out_path))


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_windowby_behavior_kill_restart_matches_uninterrupted(tmp_path, writer, reader):
    """The reference's kill/restart case for windowby + common_behavior
    (``tests/test_persistence.py``; Buffer and Forget state): run A under
    ``writer`` is stopped mid-stream with windows still buffered, run B
    under ``reader`` restores its snapshot, replays nothing, and the merged
    windows equal those of an uninterrupted run over the same input, the
    sentinel windows flushed at shutdown included."""
    f1 = [{"k": "a", "t": t, "v": t} for t in (0, 1, 3, 5, 6)] + [{"k": "b", "t": t, "v": 2 * t} for t in (2, 4, 7)]
    # phase-2 rows end with a high sentinel time so every earlier window
    # crosses the behavior's delay threshold deterministically
    f2 = [{"k": "a", "t": 9, "v": 9}, {"k": "b", "t": 11, "v": 22}, {"k": "a", "t": 40, "v": 0},
          {"k": "b", "t": 41, "v": 0}]

    # the uninterrupted run over f1 + f2, under the reader
    ref_dir = tmp_path / "ref_in"
    ref_dir.mkdir()
    _write_rows(ref_dir / "f1.jsonl", f1)
    _write_rows(ref_dir / "f2.jsonl", f2)
    pw = PACKAGES[reader]
    pw.internals.parse_graph.G.clear()
    _build_windows(pw, ref_dir, tmp_path / "ref.jsonl")
    cfg = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(str(tmp_path / "ref_pstorage")), snapshot_every=1)
    assert _run_until(pw, cfg, lambda: {("a", 8), ("b", 8)} <= set(_final_rows(tmp_path / "ref.jsonl", ["k", "start"])))
    expected = _final_rows(tmp_path / "ref.jsonl", ["k", "start"])
    assert expected.get(("a", 0)) == (3, 4)  # t=0,1,3 -> cnt=3 sum=4
    # the sentinel rows' own windows only flush at shutdown
    live_expected = {k: v for k, v in expected.items() if k[1] < 40}

    input_dir, pdir = tmp_path / "in", tmp_path / "pstorage"
    input_dir.mkdir()
    _write_rows(input_dir / "f1.jsonl", f1)
    pw = PACKAGES[writer]
    pw.internals.parse_graph.G.clear()
    _build_windows(pw, input_dir, tmp_path / "a.jsonl")
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
    # stopped mid-stream with windows still buffered
    assert _run_until(pw, cfg, lambda: len(_final_rows(tmp_path / "a.jsonl", ["k", "start"])) >= 2)
    assert any(f.startswith("segments/") for f in _store_files(pdir))

    _write_rows(input_dir / "f2.jsonl", f2)
    pw = PACKAGES[reader]
    pw.internals.parse_graph.G.clear()
    _build_windows(pw, input_dir, tmp_path / "b.jsonl")
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)

    def merged():
        return _final_rows(tmp_path / "b.jsonl", ["k", "start"], _final_rows(tmp_path / "a.jsonl", ["k", "start"]))

    assert _run_until(pw, cfg, lambda: {k: v for k, v in merged().items() if k[1] < 40} == live_expected), (
        merged(), expected)
    # after shutdown the sentinel windows flushed too: equal to the
    # uninterrupted run, bit for bit
    assert merged() == expected
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    assert drv.restored_from_snapshot and drv.replayed_events == 0


def _build_temporal(pw, kind, input_dir, out_path, mode="streaming"):
    """A pipeline over one stream of rows (``side`` 0 or 1, key ``k``,
    time ``t``, value ``v``) whose state lives in a temporal exec: session
    windows (``SessionAssignNode``), or an interval or asof join of the
    two sides (``IntervalJoinNode``, ``AsofJoinNode``); a count and a sum
    per key."""

    class RowSchema(pw.Schema):
        side: int
        k: str
        t: int
        v: int

    rows = pw.io.fs.read(str(input_dir), format="json", schema=RowSchema, mode=mode)
    if kind == "session":
        out = rows.windowby(rows.t, window=pw.temporal.session(max_gap=2), instance=rows.k).reduce(
            k=pw.this._pw_instance, start=pw.this._pw_window_start, n=pw.reducers.count(),
            s=pw.reducers.sum(pw.this.v))
        pw.io.jsonlines.write(out, str(out_path))
        return ["k", "start"]
    left = rows.filter(rows.side == 0)
    right = rows.filter(rows.side == 1)
    if kind == "interval_join":
        pairs = left.interval_join(right, left.t, right.t, pw.temporal.interval(-2, 1), left.k == right.k).select(
            k=pw.left.k, lt=pw.left.t, v=pw.right.v)
    else:
        pairs = left.asof_join(right, left.t, right.t, left.k == right.k, defaults={right.v: 0}).select(
            k=pw.left.k, lt=pw.left.t, v=pw.right.v)
    out = pairs.groupby(pairs.k, pairs.lt).reduce(pairs.k, pairs.lt, n=pw.reducers.count(),
                                                 s=pw.reducers.sum(pairs.v))
    pw.io.jsonlines.write(out, str(out_path))
    return ["k", "lt"]


def _temporal_rows(seed, n, t0):
    """Rows with distinct times (``t0`` plus even steps): the row keys of
    ``pw.io.fs`` depend on the directory, so a tie in time would be broken
    differently in the uninterrupted run's directory."""
    rng = np.random.default_rng(seed)
    return [{"side": int(rng.integers(0, 2)), "k": "ab"[int(rng.integers(0, 2))],
             "t": t0 + 2 * int(p), "v": int(rng.integers(-5, 9))} for p in rng.permutation(n)]


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("kind", ["session", "interval_join", "asof_join"])
def test_temporal_exec_state_restores_across_packages(tmp_path, kind, writer, reader):
    """A temporal exec's state hooks under the persistence glue: run A
    under ``writer`` over the first file is stopped, run B under
    ``reader`` restores its snapshot (no replay) and reads the second
    file; the merged output equals an uninterrupted run's."""
    f1, f2 = _temporal_rows(7, 24, 0), _temporal_rows(8, 24, 13)  # f2 reaches back into f1's times
    ref_dir = tmp_path / "ref_in"
    ref_dir.mkdir()
    _write_rows(ref_dir / "f1.jsonl", f1)
    _write_rows(ref_dir / "f2.jsonl", f2)
    pw = PACKAGES[reader]
    pw.internals.parse_graph.G.clear()
    keys = _build_temporal(pw, kind, ref_dir, tmp_path / "ref.jsonl", mode="static")
    pw.run()
    expected = _final_rows(tmp_path / "ref.jsonl", keys)
    assert expected

    input_dir, pdir = tmp_path / "in", tmp_path / "pstorage"
    input_dir.mkdir()
    _write_rows(input_dir / "f1.jsonl", f1)
    pw = PACKAGES[writer]
    pw.internals.parse_graph.G.clear()
    _build_temporal(pw, kind, input_dir, tmp_path / "a.jsonl")
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
    first = {}
    assert _run_until(pw, cfg, lambda: bool(first.update(_final_rows(tmp_path / "a.jsonl", keys)) or first))
    time.sleep(0.3)
    _write_rows(input_dir / "f2.jsonl", f2)
    pw = PACKAGES[reader]
    pw.internals.parse_graph.G.clear()
    _build_temporal(pw, kind, input_dir, tmp_path / "b.jsonl")
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)

    def merged():
        return _final_rows(tmp_path / "b.jsonl", keys, _final_rows(tmp_path / "a.jsonl", keys))

    assert _run_until(pw, cfg, lambda: merged() == expected), (merged(), expected)
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    assert drv.restored_from_snapshot and drv.replayed_events == 0


# --- iterate and AsyncTransformer state across a restart -----------------------

_COMPONENTS_CHILD = textwrap.dedent(
    """
    import importlib, sys
    sys.path.insert(0, sys.argv[4])
    from torch_parity import components
    pw = importlib.import_module(sys.argv[1])
    class E(pw.Schema):
        u: int
        w: int
    edges = pw.io.fs.read(sys.argv[2], format="json", schema=E, mode="streaming")
    pw.io.jsonlines.write(components(pw, edges), sys.argv[3])
    cfg = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(sys.argv[5]), snapshot_every=1
    )
    pw.run(persistence_config=cfg, autocommit_duration_ms=20)
    """
)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_iterate_killed_and_restored_across_packages(tmp_path, writer, reader):
    """A components pipeline (``pw.iterate`` over the edges of ``pw.io.fs``)
    runs in a child process under ``writer`` and is SIGKILLed once its
    labels are out and committed; ``reader`` restores its store (the
    iterate exec's ``states``/``emitted``, then a reseed of the depth
    runtimes), replays nothing, and labels the new edges as a run that
    never stopped would."""
    from torch_parity import components

    tests_dir = os.path.dirname(os.path.abspath(__file__))
    input_dir, pdir = tmp_path / "in", tmp_path / "pstorage"
    input_dir.mkdir()
    _write_rows(input_dir / "f1.jsonl", [{"u": 0, "w": 1}, {"u": 1, "w": 2}, {"u": 3, "w": 4},
                                         {"u": 10, "w": 11}])
    first = {(v,): (lab,) for v, lab in [(0, 0), (1, 0), (2, 0), (3, 3), (4, 3), (10, 10), (11, 10)]}
    pkgs = {"jax": "pathway_tpu", "port": "pathway_tpu_torch"}
    env = dict(os.environ, PYTHONPATH=REPO, PATHWAY_COMPILED_TICK="0", JAX_PLATFORMS="cpu")
    env.pop("PATHWAY_FAULTS", None)
    child = subprocess.Popen(
        [sys.executable, "-c", _COMPONENTS_CHILD, pkgs[writer], str(input_dir), str(tmp_path / "a.jsonl"),
         tests_dir, str(pdir)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.time() + 90
        while time.time() < deadline and _final_rows(tmp_path / "a.jsonl", ["v"]) != first:
            assert child.poll() is None, child.stderr.read()[-3000:]
            time.sleep(0.05)
        assert _final_rows(tmp_path / "a.jsonl", ["v"]) == first
        time.sleep(1.0)  # the tick's commit follows its output
    finally:
        child.kill()
        child.wait(timeout=30)
    _write_rows(input_dir / "f2.jsonl", [{"u": 2, "w": 3}, {"u": 11, "w": 12}, {"u": 20, "w": 21}])
    pw = PACKAGES[reader]
    pw.internals.parse_graph.G.clear()

    class E(pw.Schema):
        u: int
        w: int

    edges = pw.io.fs.read(str(input_dir), format="json", schema=E, mode="streaming")
    pw.io.jsonlines.write(components(pw, edges), str(tmp_path / "b.jsonl"))
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
    want = {(v,): (lab,) for v, lab in [(0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (10, 10), (11, 10),
                                         (12, 10), (20, 20), (21, 20)]}
    assert _run_until(
        pw, cfg, lambda: _final_rows(tmp_path / "b.jsonl", ["v"], _final_rows(tmp_path / "a.jsonl", ["v"])) == want
    )
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    assert drv.restored_from_snapshot and drv.replayed_events == 0


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_async_transformer_failed_instances_restore_across_packages(tmp_path, writer, reader):
    """An ``AsyncTransformer`` whose instance 1 failed in the first run
    keeps it failed after a restore in the other package: a new row of
    instance 1 is failed, a new row of instance 2 succeeds."""
    input_dir, pdir = tmp_path / "in", tmp_path / "pstorage"
    input_dir.mkdir()

    def build(pw, out):
        class S(pw.Schema):
            value: int
            group: int

        class Out(pw.Schema):
            ret: int

        class Flaky(pw.AsyncTransformer, output_schema=Out):
            async def invoke(self, value, group) -> dict:
                if value % 7 == 0:
                    raise RuntimeError("boom")
                return {"ret": value * 10}

        rows = pw.io.fs.read(str(input_dir), format="json", schema=S, mode="streaming")
        fin = Flaky(input_table=rows, instance=rows.group).finished
        pw.io.jsonlines.write(fin.select(fin.ret, status=fin._async_status, value=rows.value), str(out))

    def statuses(*paths):
        state = {}
        for path in paths:
            state = _final_rows(path, ["value"], state)
        return sorted(state.values(), key=repr)

    _write_rows(input_dir / "f1.jsonl", [{"value": 14, "group": 1}, {"value": 2, "group": 2}])
    first = [(None, "-FAILURE-"), (20, "-SUCCESS-")]  # (ret, status) of each value
    pw = PACKAGES[writer]
    pw.internals.parse_graph.G.clear()
    build(pw, tmp_path / "a.jsonl")
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
    assert _run_until(pw, cfg, lambda: statuses(tmp_path / "a.jsonl") == sorted(first, key=repr))
    _write_rows(input_dir / "f2.jsonl", [{"value": 3, "group": 1}, {"value": 4, "group": 2}])
    pw = PACKAGES[reader]
    pw.internals.parse_graph.G.clear()
    build(pw, tmp_path / "b.jsonl")
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
    want = sorted(first + [(None, "-FAILURE-"), (40, "-SUCCESS-")], key=repr)
    assert _run_until(pw, cfg, lambda: statuses(tmp_path / "a.jsonl", tmp_path / "b.jsonl") == want)
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    assert drv.restored_from_snapshot and drv.replayed_events == 0


# --- a VectorStoreServer over pw.io.fs, killed and restarted -----------------

_VS_WORDS = [f"w{i}" for i in range(300)]
_VS_FILES = 12


def _vs_embedder(pkg: str):
    """The small seeded embedder (dim 32, depth 2, float32) of ``pkg``,
    with the list of every text it tokenizes."""
    import importlib

    embedders = importlib.import_module(pkg + ".xpacks.llm.embedders")
    kw = dict(dim=32, depth=2, heads=2, max_len=64, batch_size=64)
    if pkg == "pathway_tpu":
        import jax.numpy as jnp

        from pathway_tpu.xpacks.llm._encoder import TransformerEncoder

        emb = embedders.SentenceTransformerEmbedder(**kw)
        emb.runtime.model = TransformerEncoder(
            vocab_size=30522, dim=32, depth=2, heads=2, max_len=64, dtype=jnp.float32
        )
    else:
        import torch

        emb = embedders.SentenceTransformerEmbedder(device="cpu", **kw)
        emb.runtime.model.dtype = torch.float32
    embedded: list = []
    encode = emb.tokenizer.encode_batch

    def counting(texts, *a, **k):
        embedded.extend(texts)
        return encode(texts, *a, **k)

    emb.tokenizer.encode_batch = counting
    return emb, embedded


def _vs_doc(i: int) -> str:
    rng = np.random.default_rng(1000 + i)
    return " ".join(
        " ".join(rng.choice(_VS_WORDS, size=int(rng.integers(6, 16)))) + "."
        for _ in range(int(rng.integers(2, 5)))
    )


def _vs_run(pkg: str, emb, embedded: list, folder: str, store: str, mode: str, first_new: int) -> dict:
    """One run of a persisted ``VectorStoreServer`` over
    ``pw.io.fs.read(folder, format="binary", mode="streaming")``: write
    files ``first_new..`` into the folder (tmp + rename; one tick each in
    ``mode="kill"``), wait until the index holds every chunk, ask 8
    queries copied from documents, then stop. Returns the replies by
    query, the index size, the document texts the embedder saw and the
    driver's recovery facts."""
    import importlib

    pw = importlib.import_module(pkg)
    vs = importlib.import_module(pkg + ".xpacks.llm.vector_store")
    splitters = importlib.import_module(pkg + ".xpacks.llm.splitters")
    parsers = importlib.import_module(pkg + ".xpacks.llm.parsers")
    ExternalIndexExec = importlib.import_module(pkg + ".engine.index_node").ExternalIndexExec
    pw.internals.parse_graph.G.clear()
    embedded.clear()
    splitter = splitters.TokenCountSplitter(min_tokens=10, max_tokens=30)
    docs = [_vs_doc(i) for i in range(_VS_FILES)]
    chunks = [[c for c, _m in splitter.split(d)] for d in docs]
    upto = np.cumsum([len(c) for c in chunks])
    asked = [chunks[(q * 5) % _VS_FILES][0] for q in range(8)]

    def put(i):
        # written beside the watched folder, then renamed into it: the
        # scanner never sees a half-written file
        tmp = folder + f".doc{i:03d}.tmp"
        with open(tmp, "wb") as f:
            f.write(docs[i].encode())
        os.replace(tmp, os.path.join(folder, f"doc{i:03d}.txt"))

    documents = pw.io.fs.read(folder, format="binary", mode="streaming", with_metadata=True)
    dev = {} if pkg == "pathway_tpu" else {"device": "cpu"}
    server = vs.VectorStoreServer(documents, embedder=emb, parser=parsers.Utf8Parser(), splitter=splitter, **dev)

    class Q(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        query: str
        k: int
        metadata_filter: str | None = pw.column_definition(default_value=None, dtype=str)
        filepath_globpattern: str | None = pw.column_definition(default_value=None, dtype=str)

    replies: dict = {}
    failure: list = []
    facts: dict = {}

    class Feeder(pw.io.python.ConnectorSubject):
        def run(self):
            rt = pw.internals.parse_graph.G.runtime
            try:
                ix = [ex for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec)][0].index

                def wait(cond):
                    deadline = time.time() + 60
                    while time.time() < deadline and not cond():
                        time.sleep(0.02)
                    assert cond(), "timed out"

                for i in range(first_new, _VS_FILES):
                    put(i)
                    if mode == "kill":
                        wait(lambda: len(ix) >= upto[i])
                wait(lambda: len(ix) >= upto[-1])
                facts["index_len"] = len(ix)
                # the query log persists too: each run asks under fresh keys
                for q in range(8):
                    self.next(qid=100 * first_new + q, query=asked[q], k=3, metadata_filter=None,
                              filepath_globpattern=None)
                    self.commit()
                    wait(lambda: q in replies)
            except BaseException as e:  # noqa: BLE001 — re-raised after pw.run
                failure.append(e)
            finally:
                rt.stop()

    queries = pw.io.python.read(Feeder(), schema=Q, autocommit_duration_ms=None)
    res = server.retrieve_query(queries)
    got = queries.with_columns(result=res.with_universe_of(queries).result)

    def on_reply(key, row, time, is_addition):
        if is_addition:
            replies[row["qid"] % 100] = [(r["text"], r["dist"]) for r in row["result"].value]

    pw.io.subscribe(got, on_change=on_reply)
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(store), snapshot_every=2)
    pw.run(persistence_config=cfg, autocommit_duration_ms=20)
    if failure:
        raise failure[0]
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    return {
        "replies": {int(q): r for q, r in replies.items()},
        "index_len": facts["index_len"],
        "embedded_docs": sum(1 for t in embedded if t not in set(asked)),
        "restored": drv.restored_from_snapshot,
        "replayed": drv.replayed_events,
    }


_VS_KILLED_CHILD = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, sys.argv[4])
    from test_torch_persistence import _vs_embedder, _vs_run
    pkg = sys.argv[1]
    _vs_run(pkg, *_vs_embedder(pkg), sys.argv[2], sys.argv[3], "kill", 0)
    """
)


@pytest.fixture(scope="module")
def vs_embedders():
    return {pkg: _vs_embedder(pkg) for pkg in ("pathway_tpu", "pathway_tpu_torch")}


def test_vector_store_over_fs_killed_and_restarted(tmp_path, vs_embedders):
    """kill=tick:6 exits 23 at the head of the tick that would ingest the
    sixth of twelve files (one file per tick; snapshots every 2 commits:
    gen 2 covers four files, the log tail the fifth); the restart restores
    the index, replays the tail, seeks the scanner past the five logged
    files, re-reads the sixth and ingests the rest; a second restart with
    no new file embeds no document again. Replies equal an uninterrupted
    run's and the JAX package's."""
    runs = {}
    for name, pkg in (("jax", "pathway_tpu"), ("port", "pathway_tpu_torch")):
        emb, embedded = vs_embedders[pkg]
        base = tmp_path / name
        folder, store = base / "docs", base / "store"
        folder.mkdir(parents=True)
        killed = _child(pkg, _VS_KILLED_CHILD, folder, store, os.path.dirname(os.path.abspath(__file__)),
                        env={"PATHWAY_FAULTS": "kill=tick:6"}, timeout=240)
        assert killed.returncode == 23, killed.stderr[-3000:]
        ingested = len(os.listdir(folder))
        assert 0 < ingested < _VS_FILES
        full_dir = base / "full_docs"
        full_dir.mkdir()
        runs[name] = {
            "ingested": ingested,
            "restart": _vs_run(pkg, emb, embedded, str(folder), str(store), "restart", ingested),
            "second": _vs_run(pkg, emb, embedded, str(folder), str(store), "restart", _VS_FILES),
            "full": _vs_run(pkg, emb, embedded, str(full_dir), str(base / "full_store"), "full", 0),
        }
    for name, r in runs.items():
        assert r["restart"]["restored"] and r["restart"]["replayed"] > 0, (name, r["restart"])
        assert r["second"]["restored"] and r["second"]["replayed"] == 0, name
        assert r["second"]["embedded_docs"] == 0, name
        assert r["restart"]["index_len"] == r["full"]["index_len"] == r["second"]["index_len"], name
        for run in ("restart", "second"):
            assert sorted(r[run]["replies"]) == list(range(8)), (name, run)
            for q, got in r[run]["replies"].items():
                want = r["full"]["replies"][q]
                assert [t for t, _d in got] == [t for t, _d in want], (name, run, q)
                np.testing.assert_allclose([d for _t, d in got], [d for _t, d in want], atol=1e-6)
    assert runs["port"]["ingested"] == runs["jax"]["ingested"] == 6
    for q, got in runs["port"]["restart"]["replies"].items():
        want = runs["jax"]["restart"]["replies"][q]
        assert [t for t, _d in got] == [t for t, _d in want], q
        np.testing.assert_allclose([d for _t, d in got], [d for _t, d in want], atol=1e-4)
