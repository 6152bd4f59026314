"""The port's Tick Scope (``observability/tickscope.py`` and the runtime's
recorder slot) against the JAX package's: the cases of
``tests/test_tickscope.py`` that need neither the monitoring server
(``/debug/tick``, ROADMAP [observability]) nor a fleet, run under both
packages with the same inputs, plus parity checks between them.

Exact: critical paths and their totals on random DAGs (against a
brute-force oracle and between the packages), the recorded exec names and
rows in/out per tick for one graph, the ring bound, the disabled recorder,
the Chrome trace's tracks, the memory ledger's conservation and the roofline
math. Wall times are only checked for order (a stage sum never exceeds its
tick). ``estimate_program_cost`` counts a plain-torch matmul's FLOPs with
``FlopCounterMode`` (2·n³ for an n×n product). The JAX side runs its
interpreter (``PATHWAY_COMPILED_TICK=0``)."""

import time

import numpy as np
import pytest

import pathway_tpu as jpw  # noqa: F401 — parse-graph fixture parity
from pathway_tpu.observability import tickscope as jts
from pathway_tpu_torch.observability import tickscope as tts

PKGS = {"jax": ("pathway_tpu", jts), "port": ("pathway_tpu_torch", tts)}


@pytest.fixture(autouse=True)
def _tickscope_env(monkeypatch):
    for var in ("PATHWAY_TICKSCOPE", "PATHWAY_TICKSCOPE_RING", "PATHWAY_PEAK_FLOPS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    jts.reset()
    tts.reset()
    yield
    jts.reset()
    tts.reset()


def _mod(pkg: str, name: str):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _obj_col(values):
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _chain_runtime(pkg: str, n=512, per=128, worker_threads=False):
    """input -> rowwise -> filter -> groupby -> output over n seeded rows."""
    nodes = _mod(pkg, "engine.nodes")
    batch = _mod(pkg, "engine.batch")
    ReducerSpec = _mod(pkg, "engine.reducers").ReducerSpec
    runtime = _mod(pkg, "engine.runtime")
    InternalColRef = _mod(pkg, "engine.expression_eval").InternalColRef

    def ref(name):
        return InternalColRef(0, name)

    class _Src(runtime.StaticSource):
        def __init__(self, names, ticks):
            super().__init__(names)
            self._ticks = ticks

        def events(self):
            for i, b in enumerate(self._ticks):
                yield i, b

    rng = np.random.default_rng(7)
    a = [int(v) for v in rng.integers(-100, 100, n)]
    ticks = [
        batch.DiffBatch(
            np.arange(lo, min(n, lo + per), dtype=np.uint64),
            np.ones(min(n, lo + per) - lo, np.int64),
            {"a": _obj_col(a[lo : lo + per])},
        )
        for lo in range(0, n, per)
    ]
    rows = [0]

    def sink(t, b):
        rows[0] += len(b)

    inp = nodes.InputNode(_Src(["a"], ticks), ["a"])
    m = nodes.RowwiseNode([inp], {"g": ref("a") & 7, "v": ref("a") * 2})
    f = nodes.FilterNode(m, ref("v") > -195)
    gb = nodes.GroupByNode(f, ["g"], {"cnt": ReducerSpec(kind="count")})
    rt = runtime.Runtime([nodes.OutputNode(gb, sink)], worker_threads=worker_threads)
    return rt, rows


def _brute_force_longest(durations, edges, edge_weights):
    """Independent oracle: enumerate every path (small DAGs only)."""
    succs = {}
    for s, d in edges:
        succs.setdefault(s, []).append(d)
    nodes = set(durations) | {x for e in edges for x in e}
    best = max((durations.get(n, 0.0) for n in nodes), default=0.0)

    def walk(n, total):
        nonlocal best
        best = max(best, total)
        for d in succs.get(n, ()):
            walk(d, total + edge_weights.get((n, d), 0.0) + durations.get(d, 0.0))

    for n in nodes:
        walk(n, durations.get(n, 0.0))
    return best


# --- critical path ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(25))
def test_critical_path_random_dags_match_brute_force_and_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    durations = {i: float(rng.uniform(0.0, 10.0)) for i in range(n)}
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if rng.uniform() < 0.4]
    weights = {e: float(rng.uniform(0.0, 3.0)) for e in edges} if seed % 2 else {}
    total, path = tts.critical_path(durations, edges, weights or None)
    assert total == pytest.approx(_brute_force_longest(durations, edges, weights))
    resum = durations.get(path[0], 0.0) if path else 0.0
    for s, d in zip(path, path[1:]):
        assert (s, d) in edges
        resum += weights.get((s, d), 0.0) + durations.get(d, 0.0)
    assert resum == pytest.approx(total)
    assert (total, path) == jts.critical_path(durations, edges, weights or None)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_critical_path_cycle_and_empty(pkg):
    ts = PKGS[pkg][1]
    with pytest.raises(ValueError, match="cycle"):
        ts.critical_path({0: 1.0, 1: 1.0}, [(0, 1), (1, 0)])
    assert ts.critical_path({}, []) == (0.0, [])


def test_stitch_ranks_match_reference():
    cases = [
        (
            {0: {"a": 1.0, "b": 2.0}, 1: {"c": 0.5, "d": 0.25}},
            {0: [("a", "b")], 1: [("c", "d")]},
            [((0, "b"), (1, "c"), 0.3)],
        ),
        ({0: {"a": 1.0}, 1: {"c": 5.0}}, {0: [], 1: []}, []),
    ]
    got = [tts.stitch_ranks(*c) for c in cases]
    assert got == [jts.stitch_ranks(*c) for c in cases]
    assert got[0][0] == pytest.approx(1.0 + 2.0 + 0.3 + 0.5 + 0.25)
    assert got[0][1] == [(0, "a"), (0, "b"), (1, "c"), (1, "d")]
    assert got[1] == (pytest.approx(5.0), [(1, "c")])


# --- the flight recorder ------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
def test_recorder_disabled_records_nothing(monkeypatch, pkg):
    monkeypatch.setenv("PATHWAY_TICKSCOPE", "0")
    rt, rows = _chain_runtime(PKGS[pkg][0])
    assert rt._tickscope.enabled is False
    assert rt._tickscope.begin_tick(0) is None
    rt.run()
    assert rows[0] > 0
    assert rt._tickscope.ticks_recorded == 0
    assert rt._tickscope.records() == []


def _renamer(rt):
    """Exec names with the node id (a process-wide counter that differs
    between the packages) replaced by the node's position in the graph."""
    by_name = {rt._tickscope._names[n.id]: f"{type(n).__name__}@{i}" for i, n in enumerate(rt.order)}
    return lambda name: by_name[name]


def _anatomy(rt):
    scope, name = rt._tickscope, _renamer(rt)
    return [
        (rec.t, sorted((name(scope._names[e[0]]), e[3], e[4], e[5]) for e in rec.entries))
        for rec in scope.records()
    ]


def test_recorder_entries_match_reference():
    """One graph, both packages: the same ticks record the same execs with
    the same rows in and out; timings only reconcile with the tick wall."""
    anatomies = {}
    for name, (pkg, _ts) in PKGS.items():
        rt, _rows = _chain_runtime(pkg, n=512, per=128)
        rt.run()
        scope = rt._tickscope
        assert scope.enabled and scope.ticks_recorded >= 4
        for rec in scope.records():
            stage_ns = sum(e[2] - e[1] for e in rec.entries)
            assert stage_ns <= rec.tick_ns
            assert all(e[2] >= e[1] for e in rec.entries)
        rec = scope.records()[0]
        total, path = scope.record_critical_path(rec)
        assert 0 < total <= rec.tick_ns / 1e9 + 1e-9 and path
        snap = scope.snapshot(ticks=4)
        assert snap["last"]["critical_path"]["coverage"] > 0
        assert snap["last"]["edges"] and "rollup" in snap
        rollup = scope.operator_rollup()
        rn = _renamer(rt)
        anatomies[name] = (
            _anatomy(rt),
            {rn(k): (v["rows_in"], v["rows_out"], v["interpreted_ticks"], v["compiled_ticks"])
             for k, v in rollup.items()},
            sorted((rn(a), rn(b)) for a, b in snap["last"]["edges"]),
            [rn(op["node"]) for op in snap["last"]["operators"]],
            [rn(st) for st in snap["last"]["critical_path"]["stages"]],
        )
    jax_a, port_a = anatomies["jax"], anatomies["port"]
    assert port_a[:3] == jax_a[:3]
    assert sorted(port_a[3]) == sorted(jax_a[3])
    names = {n for _t, entries in port_a[0] for n, *_ in entries}
    assert any(n.startswith("InputNode") for n in names) and any(n.startswith("GroupByNode") for n in names)
    assert sum(v[0] for v in port_a[1].values()) > 0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_ring_bound(monkeypatch, pkg):
    monkeypatch.setenv("PATHWAY_TICKSCOPE_RING", "2")
    rt, _ = _chain_runtime(PKGS[pkg][0], n=512, per=64)
    rt.run()
    scope = rt._tickscope
    assert scope.ticks_recorded >= 8
    assert len(scope.records()) == 2


@pytest.mark.parametrize("pkg", list(PKGS))
def test_chrome_trace_one_track_per_exec(pkg):
    validate = _mod(PKGS[pkg][0], "observability.tracing").validate_chrome_trace
    rt, _ = _chain_runtime(PKGS[pkg][0])
    rt.run()
    doc = rt._tickscope.chrome_trace()
    assert validate(doc) == []
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert slices
    assert len(meta) == len({e["tid"] for e in slices})


def test_recorder_is_per_runtime_and_newest_is_the_process_recorder():
    rt1, _ = _chain_runtime("pathway_tpu_torch", n=128, per=64)
    rt2, _ = _chain_runtime("pathway_tpu_torch", n=128, per=64)
    rt1.run()
    assert rt1._tickscope is not rt2._tickscope
    assert tts.recorder() is rt2._tickscope
    assert rt2._tickscope.ticks_recorded == 0 and rt1._tickscope.ticks_recorded > 0


# --- memory ledger ------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
def test_memory_ledger_conservation(pkg):
    ts = PKGS[pkg][1]
    rt, _ = _chain_runtime(PKGS[pkg][0], n=512, per=128)
    gb_execs = [ex for ex in rt.execs.values() if type(ex).__name__ == "GroupByExec"]
    assert gb_execs
    gb_execs[0].enable_state_ledger()
    rt.run()
    snap = ts.memory_snapshot()
    parts = snap["owners"]["runtime"]
    expect = {}
    for nid, ex in rt.execs.items():
        for part, nbytes in ts.exec_memory_ledger(ex).items():
            if nbytes:
                expect[f"{rt._tickscope._names[nid]}/{part}"] = nbytes
    assert parts == expect
    assert snap["total_bytes"] == sum(parts.values())
    assert any("ledger_blobs" in k for k in parts)
    tops = [b for _, b in snap["top"]]
    assert tops == sorted(tops, reverse=True)


def test_memory_ledger_parts_match_reference():
    parts = {}
    for name, (pkg, ts) in PKGS.items():
        rt, _ = _chain_runtime(pkg, n=256, per=64)
        rt.run()  # GroupBy ledger NOT enabled: monolithic state
        shallow = ts.memory_snapshot(deep=False)
        deep = ts.memory_snapshot(deep=True)
        assert any(k.endswith("/monolith_pickle") for k in deep["owners"]["runtime"])
        assert not any(k.endswith("/monolith_pickle") for k in shallow["owners"].get("runtime", {}))
        assert deep["total_bytes"] >= shallow["total_bytes"]
        rn = _renamer(rt)
        parts[name] = sorted(rn(k.split("/")[0]) + "/" + k.split("/", 1)[1] for k in deep["owners"]["runtime"])
    assert parts["port"] == parts["jax"]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_memory_provider_registry_and_errors(pkg):
    ts = PKGS[pkg][1]
    ts.register_memory_provider("good", lambda: {"x": 10})
    ts.register_memory_provider("bad", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    snap = ts.memory_snapshot()
    assert snap["owners"]["good"] == {"x": 10}
    assert "bad" not in snap["owners"]
    ts.unregister_memory_provider("good")
    assert "good" not in ts.memory_snapshot()["owners"]


def test_arrangement_resident_bytes_match_reference():
    got = {}
    for name, (pkg, _ts) in PKGS.items():
        arr = _mod(pkg, "engine.arrangement").Arrangement(n_cols=1)
        n = 64
        arr.append(
            np.arange(n, dtype=np.uint64),
            np.arange(n, dtype=np.uint64),
            np.ones(n, np.int64),
            [_obj_col([float(i) for i in range(n)])],
        )
        got[name] = arr.resident_bytes()
    assert got["port"] == got["jax"] >= 3 * 64 * 8


# --- clock audit, histograms ------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
def test_frozen_wall_clock_durations_unaffected(monkeypatch, pkg):
    Tracer = _mod(PKGS[pkg][0], "observability.tracing").Tracer
    frozen = 1_700_000_000.0
    monkeypatch.setattr(time, "time", lambda: frozen)
    tr = Tracer(capacity=16, enabled=True)
    with tr.span("frozen-op"):
        time.sleep(0.02)
    assert tr.spans()[-1].duration_ns >= 15_000_000
    rt, _ = _chain_runtime(PKGS[pkg][0], n=128, per=64)
    rt.run()
    rec = rt._tickscope.last()
    assert rec is not None and rec.tick_ns > 0
    assert all(e[2] >= e[1] for e in rec.entries)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_histograms_have_sub_ms_buckets(pkg):
    pkgname, ts = PKGS[pkg]
    REGISTRY = _mod(pkgname, "observability.registry").REGISTRY
    rt, _ = _chain_runtime(pkgname)
    fam = REGISTRY._metrics["pathway_operator_tick_seconds"]
    assert fam.bounds[0] <= 2e-6
    assert sum(1 for b in fam.bounds if b < 1e-4) >= 8
    ts.Roofline().observe("topk", "k", 5e-5)
    assert REGISTRY._metrics["pathway_tickscope_kernel_seconds"].bounds[0] <= 2e-6
    del rt


# --- roofline, wire taps, coverage ------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
def test_roofline_mfu_math(monkeypatch, pkg):
    ts = PKGS[pkg][1]
    monkeypatch.setenv("PATHWAY_PEAK_FLOPS", "1e9")
    r = ts.Roofline()
    r.register("fam", "k1", flops=1e6, bytes_accessed=4e6)
    r.observe("fam", "k1", 1e-3)
    r.observe("fam", "k1", 1e-3)
    snap = r.snapshot()["fam"]
    assert snap["calls"] == 2
    assert snap["flops_total"] == pytest.approx(2e6)
    assert snap["achieved_flops_s"] == pytest.approx(1e9, rel=1e-6)
    assert snap["mfu"] == pytest.approx(1.0, rel=1e-6)
    assert r.known("fam", "k1") and not r.known("fam", "nope")
    assert r.samples("fam") == 2


def test_peak_flops_env_override_and_table(monkeypatch):
    monkeypatch.setenv("PATHWAY_PEAK_FLOPS", "123.5e12")
    assert tts.peak_flops() == pytest.approx(123.5e12)
    monkeypatch.delenv("PATHWAY_PEAK_FLOPS")
    assert tts.peak_flops() == pytest.approx((__import__("os").cpu_count() or 1) * 32e9)
    monkeypatch.setattr(tts, "_cuda_device_name", lambda: "NVIDIA H100 80GB HBM3")
    assert tts.peak_flops() == pytest.approx(989e12)
    monkeypatch.setattr(tts, "_cuda_device_name", lambda: "Some Other Card")
    assert tts.peak_flops() == pytest.approx(756e12)


@pytest.mark.parametrize("n", [16, 48])
def test_estimate_program_cost_counts_a_matmul(n):
    """FlopCounterMode counts an n×n×n product as 2·n³ FLOPs; bytes are
    the argument read once and the result written once."""
    import torch

    x = torch.ones(n, n)
    flops, nbytes = tts.estimate_program_cost(lambda a: a @ a, x)
    assert flops == 2 * n**3
    assert nbytes == 2 * n * n * 4
    with pytest.raises(TypeError, match="no counted op"):
        tts.estimate_program_cost(lambda a: a + 1, x)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_wire_tap_accounting(pkg):
    ts = PKGS[pkg][1]
    ts.wire_tap("exch:0", 100, raw_bytes=240, rows=5)
    ts.wire_tap("exch:0", 50, raw_bytes=120, rows=2)
    assert ts.wire_snapshot()["exch:0"] == {"wire_bytes": 150, "raw_bytes": 360, "rows": 7, "frames": 2}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_coverage_status(monkeypatch, pkg):
    ts = PKGS[pkg][1]
    st = ts.coverage_status()
    assert st["recorder_enabled"] is True and st["serving_active"] is False
    assert set(st["roofline_samples"]) == {"compiled_tick", "topk", "paged_attention"}
    ts.register_memory_provider("replica:7", lambda: {"x": 1})
    assert ts.coverage_status()["serving_active"] is True
    ts.unregister_memory_provider("replica:7")
    ts.mark_serving(True)
    assert ts.coverage_status()["serving_active"] is True
    monkeypatch.setenv("PATHWAY_TICKSCOPE", "0")
    assert ts.coverage_status()["recorder_enabled"] is False


def test_index_search_feeds_the_topk_roofline():
    """The port's dense index registers and observes family ``topk`` with
    analytic FLOPs (2·B·N·D per search), as the reference's does."""
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex

    rng = np.random.default_rng(0)
    ix = TpuDenseKnnIndex(dimensions=8, device="cpu")
    vecs = rng.normal(size=(20, 8)).astype(np.float32)
    for i in range(20):
        ix.upsert(i, vecs[i], None)
    ix.search([(vecs[0], 3, None), (vecs[1], 3, None)])
    assert tts.roofline().samples("topk") == 1
    (prog,) = tts.roofline()._programs["topk"].values()
    assert prog["flops"] == 2.0 * 2 * 20 * 8 and prog["source"] == "analytic"
