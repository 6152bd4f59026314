"""Key-sharded engine execs of the port against the JAX package's sharded
runs and against unsharded ones, on the same seeded rows: GroupBy (string
and numeric keys), Join, windowby (its Buffer) and an instance Sort, with
the exchange on the host partition and on the mesh's devices. The rows
must be equal (floats within 1e-9), and so must the per-shard key sets,
``frontier_syncs``, the device exchanges and the
``pathway_shard_rows_total`` counts. ``PATHWAY_ENGINE_SHARDS=4`` with
``PATHWAY_MESH_DEVICE=cpu`` runs sharded; a sharded store written by
either package restores in the other at the same shard count (the
reference's kill/restart case for a sharded pipeline). The JAX side runs
its interpreter (``PATHWAY_COMPILED_TICK=0``) on ``tests/conftest.py``'s
8-device virtual CPU mesh; the port's mesh is ``make_mesh(n,
device="cpu")``."""

import os

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import sharded as jsharded
from pathway_tpu.parallel import mesh as jmesh_mod
from pathway_tpu_torch.engine import sharded as tsharded
from pathway_tpu_torch.parallel import mesh as tmesh_mod

FLOAT_TOL = 1e-9
PKG = {"jax": (jpw, jsharded, jmesh_mod), "port": (tpw, tsharded, tmesh_mod)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    for k in ("PATHWAY_ENGINE_SHARDS", "PATHWAY_MESH_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jmesh_mod, "_engine_mesh", None)
    monkeypatch.setattr(jmesh_mod, "_engine_mesh_resolved", True)
    tmesh_mod.reset_engine_mesh()
    for pw in (jpw, tpw):
        pw.internals.parse_graph.G.clear()
    yield
    tmesh_mod.reset_engine_mesh()
    for pw in (jpw, tpw):
        pw.internals.parse_graph.G.clear()


def _mesh(pkg, n):
    if pkg == "jax":
        return jmesh_mod.make_mesh(n, axis_names=("data",))
    return tmesh_mod.make_mesh(n, device="cpu")


# --- the pipelines (the reference's test_parallel.py cases) --------------------


def _groupby_words(pw):
    class S(pw.Schema):
        word: str
        v: int

    t = pw.debug.table_from_rows(S, [(f"w{i % 17}", i % 5) for i in range(300)])
    return t.groupby(t.word).reduce(t.word, s=pw.reducers.sum(t.v), c=pw.reducers.count())


def _groupby_numeric(pw):
    class S(pw.Schema):
        g: int
        v: float

    t = pw.debug.table_from_rows(S, [(i % 13, float(i) / 7.0) for i in range(600)])
    return t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v), c=pw.reducers.count())


def _join(pw):
    class L(pw.Schema):
        k: int
        a: int

    class R(pw.Schema):
        k: int
        b: float

    lt = pw.debug.table_from_rows(L, [(i % 11, i) for i in range(700)])
    rt = pw.debug.table_from_rows(R, [(i % 7, i * 0.5) for i in range(600)])
    return lt.join(rt, lt.k == rt.k).select(lt.k, pw.left.a, pw.right.b)


def _window(pw):
    class S(pw.Schema):
        instance: int
        t: int
        v: int

    t = pw.debug.table_from_rows(S, [(i % 5, i % 40, i) for i in range(800)])
    return t.windowby(
        t.t,
        window=pw.temporal.tumbling(duration=10),
        instance=t.instance,
        behavior=pw.temporal.common_behavior(delay=5),
    ).reduce(pw.this._pw_instance, start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v))


def _sort(pw):
    class S(pw.Schema):
        instance: int
        k: int

    t = pw.debug.table_from_rows(S, [((i * 7) % 6, (i * 13) % 997) for i in range(600)])
    return t.sort(key=t.k, instance=t.instance)


PIPELINES = {
    "groupby": (_groupby_words, "ShardedGroupByExec", "shard_group_keys"),
    "groupby_numeric": (_groupby_numeric, "ShardedGroupByExec", "shard_group_keys"),
    "join": (_join, "ShardedJoinExec", None),
    "windowby": (_window, "ShardedBufferExec", "shard_touched_keys"),
    "sort": (_sort, "ShardedSortExec", "shard_instances"),
}


def _norm(v):
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    if type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    if isinstance(v, np.generic):
        return v.item()
    return v


def _rows(pw, build):
    keys, cols = pw.debug.table_to_dicts(build(pw))
    return {int(k): {c: _norm(vals[k]) for c, vals in cols.items()} for k in keys}


def _shard_rows_counts(pw, n):
    import importlib

    registry = importlib.import_module(pw.__name__ + ".observability").REGISTRY
    fam = registry.get("pathway_shard_rows_total")
    if fam is None:
        return [0.0] * n
    return [fam.labels(str(s)).value for s in range(n)]


def _sharded_run(pkg, build, n, device_min_rows, monkeypatch):
    pw, sharded, mesh_mod = PKG[pkg]
    monkeypatch.setattr(sharded, "DEVICE_EXCHANGE_MIN_ROWS", device_min_rows)
    mesh_mod.set_engine_mesh(_mesh(pkg, n))
    try:
        before = _shard_rows_counts(pw, n)
        rows = _rows(pw, build)
        routed = [a - b for a, b in zip(_shard_rows_counts(pw, n), before)]
    finally:
        if pkg == "port":
            mesh_mod.reset_engine_mesh()
        else:
            monkeypatch.setattr(mesh_mod, "_engine_mesh", None)
    rt = pw.internals.parse_graph.G.last_runtime
    pw.internals.parse_graph.G.clear()
    return rows, rt, routed


def _assert_rows_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, row in want.items():
        for c, w in row.items():
            g = got[k][c]
            if isinstance(w, float):
                assert abs(g - w) <= FLOAT_TOL, (k, c, g, w)
            else:
                assert g == w, (k, c, g, w)


@pytest.mark.parametrize("transport", ["host", "device"])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_sharded_exec_equals_the_reference_and_the_unsharded_run(name, transport, monkeypatch):
    build, cls, keys_of = PIPELINES[name]
    n = 4
    plain = _rows(tpw, build)
    tpw.internals.parse_graph.G.clear()
    min_rows = 1 if transport == "device" else 1 << 30
    got, rt, routed = _sharded_run("port", build, n, min_rows, monkeypatch)
    want, jrt, jrouted = _sharded_run("jax", build, n, min_rows, monkeypatch)
    _assert_rows_equal(got, want)
    _assert_rows_equal(got, plain)
    ex = [e for e in rt.execs.values() if type(e).__name__ == cls]
    jex = [e for e in jrt.execs.values() if type(e).__name__ == cls]
    assert len(ex) == len(jex) == 1, "the engine mesh is set but the operator did not shard"
    ex, jex = ex[0], jex[0]
    assert rt.frontier_syncs == jrt.frontier_syncs > 0
    assert rt.global_frontier == rt.stats.current_time or rt.global_frontier > 0
    assert ex.router.device_exchanges == jex.router.device_exchanges
    # string payloads never take the device exchange, in either package
    assert (ex.router.device_exchanges > 0) == (transport == "device" and name != "groupby")
    assert routed == jrouted and sum(routed) > 0
    if keys_of is not None:
        owned = getattr(ex, keys_of)()
        assert owned == getattr(jex, keys_of)()
        populated = [s for s in owned if s]
        assert len(populated) >= 2, "every key landed on one shard"
        for i in range(n):
            for j in range(i + 1, n):
                assert not (owned[i] & owned[j]), "a key on two shards"


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_groupby_at_other_shard_counts(n, monkeypatch):
    got, rt, routed = _sharded_run("port", _groupby_numeric, n, 1, monkeypatch)
    want, jrt, jrouted = _sharded_run("jax", _groupby_numeric, n, 1, monkeypatch)
    _assert_rows_equal(got, want)
    ex = next(e for e in rt.execs.values() if isinstance(e, tsharded.ShardedGroupByExec))
    jex = next(e for e in jrt.execs.values() if isinstance(e, jsharded.ShardedGroupByExec))
    assert ex.shard_group_keys() == jex.shard_group_keys()
    assert sum(len(s) for s in ex.shard_group_keys()) == 13
    assert routed == jrouted and rt.frontier_syncs == jrt.frontier_syncs


def test_instance_less_sort_stays_unsharded(monkeypatch):
    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int), [(i * 7 % 31,) for i in range(31)])
        return t.sort(key=t.k)

    plain = _rows(tpw, build)
    tpw.internals.parse_graph.G.clear()
    got, rt, _routed = _sharded_run("port", build, 4, 1, monkeypatch)
    assert got == plain
    assert not any(isinstance(e, tsharded.ShardedSortExec) for e in rt.execs.values())
    assert rt.frontier_syncs > 0


def test_engine_shards_env_runs_sharded(monkeypatch):
    """``PATHWAY_ENGINE_SHARDS=4`` (on ``PATHWAY_MESH_DEVICE=cpu``) shards
    the stateful operators of an ordinary run; its rows equal the
    unsharded run's and the reference's under the same env."""
    plain = _rows(tpw, _join)
    tpw.internals.parse_graph.G.clear()
    monkeypatch.setenv("PATHWAY_ENGINE_SHARDS", "4")
    monkeypatch.setenv("PATHWAY_MESH_DEVICE", "cpu")
    monkeypatch.setattr(jmesh_mod, "_engine_mesh_resolved", False)
    got = _rows(tpw, _join)
    rt = tpw.internals.parse_graph.G.last_runtime
    want = _rows(jpw, _join)
    jrt = jpw.internals.parse_graph.G.last_runtime
    _assert_rows_equal(got, plain)
    _assert_rows_equal(got, want)
    assert rt.engine_mesh[0].shape == {"data": 4}
    assert any(isinstance(e, tsharded.ShardedJoinExec) for e in rt.execs.values())
    assert rt.frontier_syncs == jrt.frontier_syncs > 0


def test_pack_helpers_equal_the_reference():
    """The columns the device exchange carries, and their rebuild, are the
    reference's: object scalars, window-id tuples, bools, and the refusals
    (strings, mixed types, ragged tuples)."""
    cols = [
        np.array([1, 2, 3], dtype=object),
        np.array([1.5, 2.5, 3.5], dtype=object),
        np.array([True, False, True], dtype=object),
        np.array([(1, 2.0, True), (3, 4.0, False), (5, 6.0, True)], dtype=object),
        np.arange(3, dtype=np.int16),
        np.arange(3, dtype=np.float16),
        np.array(["a", "b", "c"], dtype=object),
        np.array([1, 2.0, 3], dtype=object),
        np.array([(1, 2), (3,), (4, 5)], dtype=object),
    ]
    cols[3][:] = [(1, 2.0, True), (3, 4.0, False), (5, 6.0, True)]
    cols[8][:] = [(1, 2), (3,), (4, 5)]
    for col in cols:
        pack = tsharded._pack_tuple_column if type(col[0]) is tuple else tsharded._pack_scalar_column
        jpack = jsharded._pack_tuple_column if type(col[0]) is tuple else jsharded._pack_scalar_column
        got, want = pack(col), jpack(col)
        assert (got is None) == (want is None), col
        if got is None:
            continue
        for a, b in zip(got[0], want[0]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        rebuilt, jrebuilt = tsharded._rebuild_column(got[0], got[1]), jsharded._rebuild_column(want[0], want[1])
        assert rebuilt.dtype == jrebuilt.dtype == col.dtype
        assert [(type(v), v) for v in rebuilt] == [(type(v), v) for v in jrebuilt] == [(type(v), v) for v in col]


# --- a sharded store across the packages ---------------------------------------


def _build_sharded_store_graph(pw, input_dir, out_path):
    class NumSchema(pw.Schema):
        k: str
        t: int
        v: int

    rows = pw.io.fs.read(str(input_dir), format="json", schema=NumSchema, mode="streaming")
    agg = rows.groupby(rows.k).reduce(rows.k, s=pw.reducers.sum(rows.v), cnt=pw.reducers.count())
    pw.io.jsonlines.write(agg, str(out_path))


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_sharded_store_restores_across_the_packages(tmp_path, writer, reader, monkeypatch):
    """The reference's kill/restart case for a device-mesh sharded pipeline
    (``tests/test_persistence.py``): run A under ``writer`` on a 2-shard
    engine mesh snapshots incrementally (one ledger per shard, segment
    files on disk); run B under ``reader`` on a 2-shard mesh restores it
    with nothing replayed, and the merged output equals the uninterrupted
    totals."""
    from test_torch_persistence import _final_rows, _run_until, _write_rows

    input_dir, pdir = tmp_path / "in", tmp_path / "pstorage"
    input_dir.mkdir()
    _write_rows(input_dir / "f1.jsonl", [
        {"k": "x", "t": 0, "v": 3}, {"k": "y", "t": 1, "v": 5},
        {"k": "x", "t": 2, "v": 4}, {"k": "z", "t": 3, "v": 9},
    ])

    def run(pkg, out, done):
        pw, sharded, mesh_mod = PKG[pkg]
        pw.internals.parse_graph.G.clear()
        mesh_mod.set_engine_mesh(_mesh(pkg, 2))
        try:
            _build_sharded_store_graph(pw, input_dir, out)
            cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(pdir)), snapshot_every=1)
            assert _run_until(pw, cfg, done)
        finally:
            if pkg == "port":
                mesh_mod.reset_engine_mesh()
            else:
                monkeypatch.setattr(mesh_mod, "_engine_mesh", None)
        rt = pw.internals.parse_graph.G.last_runtime
        ex = [e for e in rt.execs.values() if isinstance(e, sharded.ShardedGroupByExec)]
        assert ex, "the pipeline did not shard under the engine mesh"
        return rt, ex[0]

    def rows(path):
        try:
            return _final_rows(path, ["k"])
        except OSError:
            return {}

    _rt, ex = run(writer, tmp_path / "a.jsonl", lambda: rows(tmp_path / "a.jsonl").get(("x",)) == (2, 7))
    residual, arrs = ex.arranged_state()
    assert set(arrs) == {"s0.ledger", "s1.ledger"} and len(residual["__shard_residuals__"]) == 2
    assert list(pdir.rglob("*.seg")), "the sharded snapshot wrote no segment files"
    _write_rows(input_dir / "f2.jsonl", [{"k": "x", "t": 4, "v": 10}, {"k": "w", "t": 5, "v": 1}])

    def b_done():
        got = rows(tmp_path / "b.jsonl")
        return got.get(("x",)) == (3, 17) and got.get(("w",)) == (1, 1)

    rt, _ex = run(reader, tmp_path / "b.jsonl", b_done)
    drv = rt.persistence_driver
    assert drv.restored_from_snapshot and drv.replayed_events == 0, drv.replayed_events
    merged = _final_rows(tmp_path / "b.jsonl", ["k"], rows(tmp_path / "a.jsonl"))
    assert merged == {("x",): (3, 17), ("y",): (1, 5), ("z",): (1, 9), ("w",): (1, 1)}
    assert os.path.isdir(pdir)
