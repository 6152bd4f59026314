"""The port's file connectors (``pw.io.fs``, ``csv``, ``jsonlines``,
``plaintext``, ``null``) against the JAX package's: the same files, made
from a seed, are read under both packages, statically and streaming.

Static runs give the same update stream (time, key, diff, row) and
byte-equal output files from ``write``. Streaming runs tick at wall-clock
times and group rows into ticks as the scanner meets them, so there the
multiset of (key, diff, row) updates and the final rows must be equal;
the update streams include the retraction of a file rewritten while the
run is live. Keys, rows and diffs are exact. The JAX side runs its
interpreter (``PATHWAY_COMPILED_TICK=0``)."""

import csv as _csv
import json
import os
import threading
import time
from collections import Counter

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _clear(pw):
    pw.internals.parse_graph.G.clear()


WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]


def _write_inputs(folder, fmt: str, seed: int = 0, n_files: int = 3, rows: int = 6):
    """Seeded files of one format; returns the path to read."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for f in range(n_files):
        path = os.path.join(folder, f"part-{f}.{fmt}")
        recs = [
            {
                "name": WORDS[int(rng.integers(len(WORDS)))],
                "n": int(rng.integers(-50, 50)),
                "x": float(np.round(rng.normal(), 3)),
                "ok": bool(rng.integers(2)),
            }
            for _ in range(rows)
        ]
        if fmt == "csv":
            with open(path, "w", newline="") as fh:
                w = _csv.DictWriter(fh, fieldnames=["name", "n", "x", "ok"])
                w.writeheader()
                for r in recs:
                    w.writerow(r)
        elif fmt == "jsonl":
            with open(path, "w") as fh:
                for r in recs:
                    r = dict(r, meta={"tags": [r["name"], r["n"]]})
                    fh.write(json.dumps(r) + "\n")
        elif fmt == "txt":
            with open(path, "w") as fh:
                for r in recs:
                    fh.write(f"{r['name']} {r['n']} {r['x']}\n")
        else:  # binary
            with open(path, "wb") as fh:
                fh.write(bytes(rng.integers(0, 256, 40 + f, dtype=np.uint8)))
    return folder


def _read(pw, kind: str, path: str, mode: str):
    if kind == "csv":

        class S(pw.Schema):
            name: str
            n: int
            x: float
            ok: bool

        return pw.io.csv.read(path, schema=S, mode=mode)
    if kind == "jsonlines":

        class J(pw.Schema):
            name: str
            n: int
            x: float
            ok: bool
            meta: pw.Json

        return pw.io.jsonlines.read(path, schema=J, mode=mode)
    if kind == "plaintext":
        return pw.io.plaintext.read(path, mode=mode)
    if kind == "plaintext_by_file":
        return pw.io.fs.read(path, format="plaintext_by_file", mode=mode)
    return pw.io.fs.read(path, format="binary", mode=mode, with_metadata=True)


_EXT = {
    "csv": "csv",
    "jsonlines": "jsonl",
    "plaintext": "txt",
    "plaintext_by_file": "txt",
    "binary": "bin",
}


def _norm(v):
    """A hashable, package-neutral form of a row value (Json as its text)."""
    if type(v).__name__ == "Json":
        return ("json", json.dumps(v.value, sort_keys=True))
    return v


def _subscribe(pw, table, updates: list):
    def on_change(key, row, time, is_addition):
        updates.append(
            (time, int(key), 1 if is_addition else -1, tuple(sorted((k, _norm(v)) for k, v in row.items())))
        )

    pw.io.subscribe(table, on_change=on_change)


def _final(updates):
    state = {}
    for _t, k, d, row in updates:
        if d > 0:
            state[k] = row
        elif state.get(k) == row:
            del state[k]
    return state


def _static_run(pw, kind, folder, out_path, out_fmt):
    _clear(pw)
    t = _read(pw, kind, folder, "static")
    updates: list = []
    _subscribe(pw, t, updates)
    if kind in ("csv", "jsonlines"):
        agg = t.groupby(t.name).reduce(t.name, c=pw.reducers.count(), s=pw.reducers.sum(t.n))
        if out_fmt == "csv":
            pw.io.csv.write(agg, out_path)
        else:
            pw.io.jsonlines.write(agg, out_path)
    else:
        pw.io.jsonlines.write(t, out_path)
    pw.io.null.write(t)
    pw.run()
    return updates


@pytest.mark.parametrize("kind", list(_EXT))
def test_static_read_and_write_match_reference(tmp_path, kind):
    folder = _write_inputs(str(tmp_path / "in"), _EXT[kind], seed=3)
    out_fmt = "csv" if kind == "csv" else "json"
    got = {}
    for name, pw in PACKAGES.items():
        out = str(tmp_path / f"out_{name}.{out_fmt}")
        updates = _static_run(pw, kind, folder, out, out_fmt)
        with open(out, "rb") as fh:
            got[name] = (updates, fh.read())
    (ju, jfile), (tu, tfile) = got["jax"], got["port"]
    assert ju, "no rows read"
    assert sorted(ju) == sorted(tu)
    assert tfile == jfile


def _streaming_run(pw, kind, folder, rewrite, expect_rows):
    """Start a streaming read over ``folder``, wait for ``expect_rows``
    live rows, call ``rewrite()`` and wait until the update stream holds
    the rewritten file's rows, then stop."""
    _clear(pw)
    t = _read(pw, kind, folder, "streaming")
    updates: list = []
    _subscribe(pw, t, updates)
    th = threading.Thread(target=lambda: pw.run(autocommit_duration_ms=20), daemon=True)
    th.start()

    def wait(pred):
        deadline = time.time() + 20
        while time.time() < deadline and not pred():
            time.sleep(0.02)
        assert pred(), "streaming read timed out"

    wait(lambda: len(_final(list(updates))) == expect_rows)
    n_before = len(updates)
    rewrite()
    wait(lambda: any(u[2] < 0 for u in list(updates)[n_before:]))
    time.sleep(0.3)  # let the rewritten file's insertions land
    pw.internals.parse_graph.G.runtime.stop()
    th.join(timeout=10)
    return updates


@pytest.mark.parametrize("kind", ["csv", "jsonlines", "plaintext", "binary"])
def test_streaming_read_matches_reference(tmp_path, kind):
    ext = _EXT[kind]
    results = {}
    for name, pw in PACKAGES.items():
        # one folder per package: the streaming scanner reacts to the
        # rewrite's new mtime, so each run needs its own fresh copy; the
        # row keys hash the file path, so both copies sit at the same path
        folder = str(tmp_path / "in")
        if os.path.exists(folder):
            for f in os.listdir(folder):
                os.remove(os.path.join(folder, f))
        _write_inputs(folder, ext, seed=5)
        expect = 3 if kind == "binary" else 18

        def rewrite():
            os.remove(os.path.join(folder, f"part-1.{ext}"))
            _write_inputs(str(tmp_path / "re"), ext, seed=9, n_files=2)
            os.replace(str(tmp_path / "re" / f"part-1.{ext}"), os.path.join(folder, f"part-1.{ext}"))

        results[name] = _streaming_run(pw, kind, folder, rewrite, expect)
    ju, tu = results["jax"], results["port"]
    strip = lambda us: Counter((k, d, row) for _t, k, d, row in us)  # noqa: E731
    assert strip(ju) == strip(tu)
    assert _final(ju) == _final(tu)
    assert any(d < 0 for _t, _k, d, _r in tu)


def test_streaming_offsets_seek_skips_seen_files(tmp_path):
    """The streaming source's offsets are per file (mtime, size) plus the
    rows it emitted: after ``seek`` a scan re-reads nothing it has seen,
    and a changed file retracts exactly the rows emitted before."""
    folder = _write_inputs(str(tmp_path / "in"), "jsonl", seed=1, n_files=2)
    states = {}
    for name, pw in PACKAGES.items():
        _clear(pw)
        t = _read(pw, "jsonlines", folder, "streaming")
        src = t._node.source
        batches: list = []

        class _Session:
            def insert_batch(self, rows, offsets=None):
                batches.append((sorted((k, d, tuple(map(_norm, v))) for k, d, v in rows), offsets))

        src.session = _Session()
        src._scan_once()
        first = src.offset_state()
        src2 = _read(pw, "jsonlines", folder, "streaming")._node.source
        src2.session = _Session()
        src2.seek(first)
        src2._scan_once()  # nothing new
        n_after_seek = len(batches)
        with open(os.path.join(folder, "part-0.jsonl"), "a") as fh:
            fh.write(json.dumps({"name": "new", "n": 1, "x": 0.5, "ok": True, "meta": {}}) + "\n")
        src2._scan_once()
        states[name] = (batches, n_after_seek, sorted(first["seen"]))
        # restore the file for the other package's pass
        with open(os.path.join(folder, "part-0.jsonl")) as fh:
            lines = fh.readlines()[:-1]
        with open(os.path.join(folder, "part-0.jsonl"), "w") as fh:
            fh.writelines(lines)
        os.utime(os.path.join(folder, "part-0.jsonl"), (1, 1))
    (jb, jn, jseen), (tb, tn, tseen) = states["jax"], states["port"]
    assert jn == tn == 2  # the two files of the first scan, nothing after seek
    assert jseen == tseen
    assert [b for b, _o in jb] == [b for b, _o in tb]
    last = tb[-1][0]
    assert sum(1 for _k, d, _v in last if d < 0) == 6  # the file's old rows
    assert sum(1 for _k, d, _v in last if d > 0) == 7


def test_fs_read_resolves_and_service_connectors_raise(monkeypatch):
    """The file connectors resolve; so do the service connectors now (they
    raised [connectors] until the port carried them): a service connector
    is the port's own module, and a call raises only for its missing client."""
    import sys

    assert tpw.io.fs.read and tpw.io.csv.CsvParserSettings and tpw.io.null.write
    assert tpw.io.kafka.__name__ == "pathway_tpu_torch.io.kafka"
    monkeypatch.setitem(sys.modules, "confluent_kafka", None)
    with pytest.raises(ImportError, match="confluent_kafka"):
        tpw.io.kafka.read({}, topic="t")
