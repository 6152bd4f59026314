"""The port's Tick Forge (``pathway_tpu_torch/engine/compile.py``) against
the interpreters of both packages: the graphs and seeds of the JAX
package's ``tests/test_compiled_tick.py``, each run three times — the JAX
package's interpreter (``PATHWAY_COMPILED_TICK=0``; its compiled path does
not run under this jax), the port's interpreter, and the port's compiled
segments on the CPU (``PATHWAY_COMPILED_TICK=1
PATHWAY_COMPILED_DEVICE=cpu``). Keys, diffs, ints and bools are exact;
floats are exact in the segments (the same IEEE float64 operations, one
per node) and within ``PARTIALS_TOL`` (relative) in the groupby partials,
whose sums may run in another order. ``classify_expr``'s and
``classify_node``'s reasons and ``plan_segments``' membership equal the
JAX package's on the same graphs. Also the numpy promotion and cast edge
values, a device error that fails the run, and compiled ticks without a
card."""

from __future__ import annotations

import math
import types

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu.engine.batch
import pathway_tpu.engine.compile
import pathway_tpu.engine.expression_eval
import pathway_tpu.engine.nodes
import pathway_tpu.engine.reducers
import pathway_tpu.engine.runtime
import pathway_tpu.internals.api
import pathway_tpu.internals.dtype
import pathway_tpu.internals.expression
import pathway_tpu_torch
import pathway_tpu_torch.engine.batch
import pathway_tpu_torch.engine.compile
import pathway_tpu_torch.engine.expression_eval
import pathway_tpu_torch.engine.nodes
import pathway_tpu_torch.engine.reducers
import pathway_tpu_torch.engine.runtime
import pathway_tpu_torch.internals.api
import pathway_tpu_torch.internals.dtype
import pathway_tpu_torch.internals.expression

PARTIALS_TOL = 1e-12


def _ns(pkg) -> types.SimpleNamespace:
    eng, intl = pkg.engine, pkg.internals
    return types.SimpleNamespace(
        pw=pkg, nodes=eng.nodes, expr=intl.expression, dt=intl.dtype,
        DiffBatch=eng.batch.DiffBatch, Ref=eng.expression_eval.InternalColRef,
        Runtime=eng.runtime.Runtime, StaticSource=eng.runtime.StaticSource,
        ReducerSpec=eng.reducers.ReducerSpec, compile=eng.compile,
        ERROR=intl.api.ERROR,
    )


JAX, PORT = _ns(pathway_tpu), _ns(pathway_tpu_torch)


def _src(ns, names, ticks):
    class Src(ns.StaticSource):
        def events(self):
            for i, b in enumerate(ticks):
                yield i, ns.DiffBatch(b["keys"], b["diffs"], dict(b["cols"]))

    return Src(names)


def _run(monkeypatch, ns, build, ticks, compiled: bool, min_rows: str = "1"):
    """Build ``build(ns, input_node, capture)`` over ``ticks`` (numpy dicts
    shared by both packages) and run it; returns (per-tick rows, runtime)."""
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "1" if compiled else "0")
    monkeypatch.setenv("PATHWAY_COMPILED_DEVICE", "cpu")
    monkeypatch.setenv("PATHWAY_COMPILED_MIN_ROWS", min_rows)
    captured: dict[int, list] = {}

    def capture(t, b):
        rows = captured.setdefault(t, [])
        for k, d, vals in b.iter_rows():
            rows.append((int(k), int(d), tuple(vals)))

    names = list(ticks[0][0]["cols"]) if isinstance(ticks, tuple) else list(ticks[0]["cols"])
    if isinstance(ticks, tuple):  # several inputs
        inputs = [ns.nodes.InputNode(_src(ns, names, tk), names) for tk in ticks]
    else:
        inputs = ns.nodes.InputNode(_src(ns, names, ticks), names)
    out = build(ns, inputs, capture)
    rt = ns.Runtime([out])
    rt.run()
    return captured, rt


def _close(a, b, rel) -> bool:
    if type(a).__name__ == type(b).__name__ == "Error":  # each package's poison singleton
        return True
    if any(isinstance(x, (float, np.floating)) for x in (a, b)):
        fa, fb = float(a), float(b)
        if math.isnan(fa) and math.isnan(fb):
            return True
        return fa == fb if rel == 0 else math.isclose(fa, fb, rel_tol=rel, abs_tol=0)
    if any(isinstance(x, (bool, np.bool_)) for x in (a, b)):
        return bool(a) == bool(b)
    if isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer)):
        return int(a) == int(b)
    return a == b


def _assert_streams_equal(got, want, rel=0.0):
    """Per-tick equality, row by row in order (maps, filters and concat
    keep input order; the bulk groupby factorizes by first occurrence)."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for t in sorted(want):
        g, w = got[t], want[t]
        assert len(g) == len(w), f"tick {t}: {len(g)} rows vs {len(w)}"
        for (gk, gd, gv), (wk, wd, wv) in zip(g, w):
            assert gk == wk and gd == wd, f"tick {t}: {gk, gd} vs {wk, wd}"
            assert len(gv) == len(wv)
            for x, y in zip(gv, wv):
                assert _close(x, y, rel), f"tick {t} key {gk}: {x!r} != {y!r}"


def _three(monkeypatch, build, ticks, min_rows="1", rel=0.0):
    """The JAX interpreter's, the port's interpreter's and the port's
    compiled streams; asserts they agree and returns the compiled runtime."""
    want, rt_j = _run(monkeypatch, JAX, build, ticks, compiled=False, min_rows=min_rows)
    assert rt_j.compiled_plan is None
    interp, rt_i = _run(monkeypatch, PORT, build, ticks, compiled=False, min_rows=min_rows)
    assert rt_i.compiled_plan is None  # escape hatch: no planning at all
    got, rt = _run(monkeypatch, PORT, build, ticks, compiled=True, min_rows=min_rows)
    _assert_streams_equal(interp, want, rel)
    _assert_streams_equal(got, want, rel)
    _assert_streams_equal(got, interp, rel)
    return rt


def _segments(rt):
    assert rt.compiled_plan is not None, "expected a compiled plan"
    return rt.compiled_plan.segments


def _compiled_ticks(rt) -> int:
    return sum(s.compiled_ticks for s in _segments(rt))


def _random_ticks(rng, n_ticks=6, rows_per_tick=40, with_floats=True, with_str=False):
    """The reference suite's randomized insert/retract/update sequence over
    int/float/bool (and optionally string) columns, as numpy dicts."""
    names = ["a", "b", "flag"] + (["tag"] if with_str else [])
    live: list[tuple[int, tuple]] = []
    ticks = []
    next_key = 0
    for _ in range(n_ticks):
        keys, diffs, rows = [], [], []
        for _ in range(rows_per_tick):
            ins = not live or rng.random() < 0.7
            if ins:
                k = next_key
                next_key += 1
                vals = (
                    int(rng.integers(-1000, 1000)),
                    float(rng.normal()) if with_floats else float(0),
                    bool(rng.integers(0, 2)),
                ) + ((f"tag{int(rng.integers(0, 7))}",) if with_str else ())
                live.append((k, vals))
                keys.append(k)
                diffs.append(1)
                rows.append(vals)
            else:
                i = int(rng.integers(0, len(live)))
                k, vals = live.pop(i)
                keys.append(k)
                diffs.append(-1)
                rows.append(vals)
                if rng.random() < 0.5:
                    nv = (vals[0] + 1, vals[1] * 2.0, not vals[2]) + vals[3:]
                    live.append((k, nv))
                    keys.append(k)
                    diffs.append(1)
                    rows.append(nv)
        cols = {}
        for ci, name in enumerate(names):
            vals = [r[ci] for r in rows]
            if name == "a":
                cols[name] = np.array(vals, dtype=np.int64)
            elif name == "b":
                cols[name] = np.array(vals, dtype=np.float64)
            elif name == "flag":
                cols[name] = np.array(vals, dtype=bool)
            else:
                col = np.empty(len(vals), dtype=object)
                col[:] = vals
                cols[name] = col
        ticks.append({"keys": np.array(keys, dtype=np.uint64),
                      "diffs": np.array(diffs, dtype=np.int64), "cols": cols})
    return ticks


def _ticks(cols_per_tick: list[dict], base: int = 0) -> list[dict]:
    out, k = [], base
    for cols in cols_per_tick:
        n = len(next(iter(cols.values())))
        out.append({"keys": np.arange(k, k + n, dtype=np.uint64),
                    "diffs": np.ones(n, dtype=np.int64), "cols": cols})
        k += n
    return out


# ---------------------------------------------------------------------------
# graphs (the reference suite's), built in either package


def g_map_filter_map(ns, inp, capture):
    R, e, n = ns.Ref, ns.expr, ns.nodes
    m1 = n.RowwiseNode([inp], {"x": R(0, "a") * 2 + 1, "y": R(0, "b") - R(0, "a"), "flag": R(0, "flag")})
    f = n.FilterNode(m1, (R(0, "x") > 0) & R(0, "flag") | (R(0, "y") <= 0.0))
    m2 = n.RowwiseNode([f], {
        "z": e.IfElseExpression(R(0, "flag"), R(0, "x"), -R(0, "x")),
        "w": e.CastExpression(ns.dt.FLOAT, R(0, "x")) * R(0, "y"),
    })
    return n.OutputNode(m2, capture)


def g_bare_refs(ns, inp, capture):
    R, n = ns.Ref, ns.nodes
    m = n.RowwiseNode([inp], {"x": R(0, "a") * 2, "flag": R(0, "flag"), "k": R(0, "a")})
    f = n.FilterNode(m, R(0, "flag"))  # bare bool column predicate
    r = n.ReindexNode(f, R(0, "k"))  # bare int64 column keys
    return n.OutputNode(r, capture)


def g_lone_bare_filter(ns, inp, capture):
    return ns.nodes.OutputNode(ns.nodes.FilterNode(inp, ns.Ref(0, "flag")), capture)


def g_reindex(ns, inp, capture):
    R, n = ns.Ref, ns.nodes
    m1 = n.RowwiseNode([inp], {"a": R(0, "a"), "k2": abs(R(0, "a")) * 11 + 5})
    ri = n.ReindexNode(m1, R(0, "k2"))
    m2 = n.RowwiseNode([ri], {"v": R(0, "a") + R(0, "k2")})
    return n.OutputNode(m2, capture)


def g_concat(ns, inputs, capture):
    R, n = ns.Ref, ns.nodes
    cc = n.ConcatNode(inputs)
    m = n.RowwiseNode([cc], {"s": R(0, "a") + 1, "b": R(0, "b"), "flag": R(0, "flag")})
    f = n.FilterNode(m, R(0, "s") >= 0)
    return n.OutputNode(f, capture)


def g_object_column(ns, inp, capture):
    R, n = ns.Ref, ns.nodes
    m = n.RowwiseNode([inp], {"x": R(0, "a") * 3, "tag": R(0, "tag")})
    f = n.FilterNode(m, R(0, "x") > -600)
    return n.OutputNode(f, capture)


def g_udf(ns, inp, capture):
    R, n, e = ns.Ref, ns.nodes, ns.expr
    m1 = n.RowwiseNode([inp], {"x": R(0, "a") + 7, "b": R(0, "b")})
    udf = n.RowwiseNode([m1], {
        "x": R(0, "x"),
        "u": e.ApplyExpression(lambda x: x % 97, ns.dt.INT, False, True, (R(0, "x"),), {}),
    })
    m2 = n.RowwiseNode([udf], {"y": R(0, "u") * 2 - R(0, "x")})
    f = n.FilterNode(m2, R(0, "y") != 0)
    return n.OutputNode(f, capture)


def g_floordiv(ns, inp, capture):
    R, n = ns.Ref, ns.nodes
    return n.OutputNode(n.RowwiseNode([inp], {"q": R(0, "a") // R(0, "d")}), capture)


def g_object_dtype(ns, inp, capture):
    R, n = ns.Ref, ns.nodes
    m = n.RowwiseNode([inp], {"x": R(0, "a") * 2})
    return n.OutputNode(n.FilterNode(m, R(0, "x") != 4), capture)


def g_tiny(ns, inp, capture):
    R, n = ns.Ref, ns.nodes
    m = n.RowwiseNode([inp], {"x": R(0, "a") + 1})
    return n.OutputNode(n.FilterNode(m, R(0, "x") > 0), capture)


def g_bucket(ns, inp, capture):
    R, n = ns.Ref, ns.nodes
    m = n.RowwiseNode([inp], {"x": R(0, "a") * 2 + 1, "y": R(0, "b") * 0.5})
    return n.OutputNode(n.FilterNode(m, R(0, "x") >= 0), capture)


def g_groupby(ns, inp, capture):
    R, n, S = ns.Ref, ns.nodes, ns.ReducerSpec
    m = n.RowwiseNode([inp], {"g": R(0, "a") & 15, "v": R(0, "a"), "b": R(0, "b")})
    gb = n.GroupByNode(m, ["g"], {
        "cnt": S(kind="count"),
        "tot": S(kind="sum", arg_cols=("v",)),
        "mean": S(kind="avg", arg_cols=("b",)),
    })
    return n.OutputNode(gb, capture)


# ---------------------------------------------------------------------------
# differential: map / filter / reindex / concat chains


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_filter_map_chain_differential(monkeypatch, seed):
    rt = _three(monkeypatch, g_map_filter_map, _random_ticks(np.random.default_rng(seed)))
    assert _compiled_ticks(rt) > 0, "compiled path never dispatched"
    assert all(s.device.type == "cpu" for s in _segments(rt))


def test_bare_column_predicate_and_keys_compile(monkeypatch):
    rng = np.random.default_rng(11)
    ticks = _ticks([{"a": rng.integers(0, 1000, size=32).astype(np.int64),
                     "flag": rng.integers(0, 2, size=32).astype(bool)} for _ in range(4)])
    rt = _three(monkeypatch, g_bare_refs, ticks)
    assert _compiled_ticks(rt) > 0, "bare-ref chain never compiled"
    rt2 = _three(monkeypatch, g_lone_bare_filter, ticks)
    assert _compiled_ticks(rt2) > 0, "lone bare-ref filter never compiled"


@pytest.mark.parametrize("seed", [3, 4])
def test_reindex_chain_differential(monkeypatch, seed):
    rt = _three(monkeypatch, g_reindex, _random_ticks(np.random.default_rng(seed), with_floats=False))
    assert _compiled_ticks(rt) > 0


def test_concat_fanin_differential(monkeypatch):
    rng = np.random.default_rng(7)
    ta = _random_ticks(rng, n_ticks=4)
    tb = _random_ticks(rng, n_ticks=4)
    for b in tb:  # disjoint key spaces
        b["keys"] = b["keys"] + np.uint64(1 << 32)
    rt = _three(monkeypatch, g_concat, (ta, tb))
    assert _compiled_ticks(rt) > 0
    assert all(s.concat_head for s in _segments(rt))


def test_object_column_passes_through_host_side(monkeypatch):
    rt = _three(monkeypatch, g_object_column, _random_ticks(np.random.default_rng(11), with_str=True))
    assert _compiled_ticks(rt) > 0


# ---------------------------------------------------------------------------
# differential: fallback boundaries


def test_udf_boundary_splits_chain_differential(monkeypatch):
    rt = _three(monkeypatch, g_udf, _random_ticks(np.random.default_rng(13)))
    plan = rt.compiled_plan
    udf_nodes = [n for n in rt.order if isinstance(n, PORT.nodes.RowwiseNode)
                 and any(isinstance(e, PORT.expr.ApplyExpression) for e in n.exprs.values())]
    assert udf_nodes and all(plan.segment_of(n.id) is None for n in udf_nodes)
    assert _compiled_ticks(rt) > 0


def test_error_poison_operator_falls_back(monkeypatch):
    ticks = _ticks([{"a": np.array([10, 20, 30, 40], dtype=np.int64),
                     "d": np.array([2, 0, 5, 0], dtype=np.int64)}])
    rt = _three(monkeypatch, g_floordiv, ticks)
    assert rt.compiled_plan is None  # the whole chain is uncompilable
    got, _ = _run(monkeypatch, PORT, g_floordiv, ticks, compiled=True)
    by_key = {k: v for k, d, v in next(iter(got.values()))}
    assert by_key[0] == (5,) and by_key[2] == (6,)
    assert by_key[1] == (PORT.ERROR,) and by_key[3] == (PORT.ERROR,)


def test_runtime_dtype_fallback_is_negative_cached(monkeypatch):
    col = np.empty(8, dtype=object)
    col[:] = [1, 2, None, 4, 5, 6, 7, 8]  # None keeps the column object
    ticks = _ticks([{"a": col}] * 3)
    rt = _three(monkeypatch, g_object_dtype, ticks)
    (seg,) = _segments(rt)
    assert seg.compiled_ticks == 0 and seg.fallback_ticks == 3
    assert seg._FALLBACK in seg._cache.values()


def test_min_rows_keeps_tiny_ticks_on_the_interpreter(monkeypatch):
    ticks = _ticks([{"a": np.array([i], dtype=np.int64)} for i in range(3)])
    rt = _three(monkeypatch, g_tiny, ticks, min_rows="64")
    (seg,) = _segments(rt)
    assert seg.compiled_ticks == 0 and seg.fallback_ticks == 3


# ---------------------------------------------------------------------------
# shape-bucketed cache and the escape hatch


def test_shape_bucket_cache_reuses_programs(monkeypatch):
    def tick(n):
        return {"a": np.arange(n, dtype=np.int64), "b": np.linspace(0.0, 1.0, n)}

    # 6 ticks in the 64-bucket (33..64 rows), then 2 in the 128-bucket
    ticks = _ticks([tick(40 + i) for i in range(6)] + [tick(100 + i) for i in range(2)])
    rt = _three(monkeypatch, g_bucket, ticks)
    (seg,) = _segments(rt)
    assert seg.compiled_ticks == 8 and seg.fallback_ticks == 0
    assert {k[0] for k in seg._cache} == {64, 128}
    assert len(seg._cache) == 2  # one program per bucket, none negative


def test_escape_hatch_env_zero_means_no_planning(monkeypatch):
    c = PORT.compile
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    assert not c.compiled_tick_enabled()
    assert c.plan_segments([], {}) is None
    monkeypatch.delenv("PATHWAY_COMPILED_TICK")
    assert not c.compiled_tick_enabled()  # the port's default is the interpreter


# ---------------------------------------------------------------------------
# groupby semigroup partials


@pytest.mark.parametrize("force_device,rows", [("0", 120), ("1", 120), ("0", 400), ("1", 400)],
                         ids=["0", "1", "0-bulk", "1-bulk"])
def test_groupby_semigroup_partials_differential(monkeypatch, force_device, rows):
    """The reference's case (120 rows a tick: below the bulk groupby's 256,
    so no partials run) and ticks of 400, where they run on the device
    when forced on."""
    monkeypatch.setenv("PATHWAY_COMPILED_GROUPBY", force_device)
    calls = PORT.compile.semigroup_partials.calls
    _three(monkeypatch, g_groupby, _random_ticks(np.random.default_rng(17), n_ticks=5, rows_per_tick=rows),
           rel=PARTIALS_TOL)
    ran = PORT.compile.semigroup_partials.calls - calls
    assert (ran > 0) == (force_device == "1" and rows > 256), ran


def test_semigroup_partials_equal_np_add_at(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_DEVICE", "cpu")
    rng = np.random.default_rng(5)
    n, nu = 1000, 37
    codes = rng.integers(0, nu, n).astype(np.int64)
    diffs = rng.choice(np.array([-1, 1, 2], dtype=np.int64), n)
    ints = rng.integers(-(2**40), 2**40, n).astype(np.int64)
    floats = rng.standard_normal(n)
    dcounts, (p_none, p_int, p_float) = PORT.compile.semigroup_partials(codes, diffs, [None, ints, floats], nu)
    want_c = np.zeros(nu, np.int64)
    np.add.at(want_c, codes, diffs)
    want_i = np.zeros(nu, np.int64)
    np.add.at(want_i, codes, ints * diffs)
    want_f = np.zeros(nu)
    np.add.at(want_f, codes, floats * diffs)
    assert p_none is None
    assert dcounts.tolist() == want_c.tolist() and p_int.tolist() == want_i.tolist()
    np.testing.assert_allclose(p_float, want_f, rtol=PARTIALS_TOL, atol=1e-12)
    with pytest.raises(PORT.compile.NotCompilable):
        PORT.compile.semigroup_partials(codes, diffs, [ints.astype(np.int32)], nu)


# ---------------------------------------------------------------------------
# the structure: classification and planning equal the reference's


@pytest.mark.parametrize("graph", [g_map_filter_map, g_bare_refs, g_lone_bare_filter, g_reindex,
                                   g_object_column, g_udf, g_floordiv, g_bucket, g_groupby, g_concat],
                         ids=lambda g: g.__name__)
def test_classification_and_plan_equal_reference(monkeypatch, graph):
    """Every node's (eligible, reason) and every expression's reason equal
    the JAX package's, and both planners cut the same segments (by node
    position in the runtime's order)."""
    monkeypatch.setenv("PATHWAY_COMPILED_DEVICE", "cpu")
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "1")
    names = ["a", "b", "flag", "tag", "d"]
    ticks = _ticks([{c: np.zeros(1, np.int64) for c in names}])
    out = {}
    for label, ns in (("jax", JAX), ("port", PORT)):
        srcs = (ticks, ticks) if graph is g_concat else ticks
        inputs = ([ns.nodes.InputNode(_src(ns, names, t), names) for t in srcs] if graph is g_concat
                  else ns.nodes.InputNode(_src(ns, names, ticks), names))
        rt = ns.Runtime([graph(ns, inputs, lambda t, b: None)])
        pos = {n.id: i for i, n in enumerate(rt.order)}
        plan = rt.compiled_plan
        exprs = []
        for node in rt.order:
            for e in list(getattr(node, "exprs", {}).values()) + [getattr(node, "predicate", None),
                                                                  getattr(node, "key_expr", None)]:
                if e is not None:
                    exprs.append(ns.compile.classify_expr(e))
        out[label] = (
            [ns.compile.classify_node(n) for n in rt.order],
            exprs,
            None if plan is None else [[pos[n.id] for n in s.nodes] for s in plan.segments],
            [ns.compile._has_compute(n) for n in rt.order],
        )
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# numpy promotion and cast edge values (the interpreter is the oracle)


def _edge_ticks():
    f = np.array([np.nan, np.inf, -np.inf, 1e300, -1e300, 2.0**63, -(2.0**63), 2.0**63 - 1024, -0.5, 0.5,
                  -1.5, 2.5, -0.0, 9.007199254740993e15, 1e-310, 3.0], dtype=np.float64)
    i = np.array([0, 1, -1, 2**62, -(2**63), 2**63 - 1, 2**53 + 1, -(2**53) - 1, 7, -7, 3, 2**31, -(2**31),
                  123456789, -5, 9], dtype=np.int64)
    b = np.array([True, False] * 8)
    s = np.arange(16, dtype=np.int32) - 8
    return _ticks([{"f": f, "i": i, "b": b, "s": s}, {"f": f[::-1].copy(), "i": i[::-1].copy(),
                                                      "b": ~b, "s": s[::-1].copy()}])


def g_edges(ns, inp, capture):
    R, e, n, dt = ns.Ref, ns.expr, ns.nodes, ns.dt
    m = n.RowwiseNode([inp], {
        "f2i": e.CastExpression(dt.INT, R(0, "f")),  # NaN, +-inf, out of range: INT64_MIN in numpy
        "f2b": e.CastExpression(dt.BOOL, R(0, "f")),  # NaN is True
        "i2f": e.CastExpression(dt.FLOAT, R(0, "i")),  # rounds 2**53 + 1
        "b2i": e.CastExpression(dt.INT, R(0, "b")),
        "s2f": e.CastExpression(dt.FLOAT, R(0, "s")),
        "i_x_f": R(0, "i") * 0.5,  # int64 * float literal: float64, not float32
        "i_p_s": R(0, "i") + R(0, "s"),  # int64 + int32: int64
        "wrap_add": R(0, "i") + 9223372036854775807,  # int64 wraps as in numpy
        "wrap_mul": R(0, "i") * 3,
        "neg": -R(0, "i"),
        "absi": abs(R(0, "i")),  # abs(INT64_MIN) stays INT64_MIN
        "absf": abs(R(0, "f")),
        "i_eq_f": R(0, "i") == R(0, "f"),  # compared as float64
        "i_lt_f": R(0, "i") < 9.007199254740992e15,
        "nan_ne": R(0, "f") != R(0, "f"),
        "band": R(0, "b") & (R(0, "i") > 0),
        "bxor": R(0, "b") ^ True,
        "ibits": (R(0, "i") & 255) | (R(0, "s") ^ 3),
        "inv_b": ~R(0, "b"),
        "inv_i": ~R(0, "i"),
        "sel": e.IfElseExpression(R(0, "b"), R(0, "i"), R(0, "f")),  # mixed branches promote
        "sel_s": e.IfElseExpression(R(0, "b"), R(0, "s"), R(0, "s") * 2),
        "const_col": R(0, "s") * 0 + 1.25,
    })
    return n.OutputNode(m, capture)


def g_bool_arith(ns, inp, capture):
    R, n = ns.Ref, ns.nodes
    return n.OutputNode(n.RowwiseNode([inp], {"x": R(0, "b") + R(0, "b"), "y": R(0, "i") + 1}), capture)


def test_promotion_and_cast_edge_values(monkeypatch):
    rt = _three(monkeypatch, g_edges, _edge_ticks())
    assert _compiled_ticks(rt) == 2
    got, rt = _run(monkeypatch, PORT, g_edges, _edge_ticks(), compiled=True)
    names = _segments(rt)[0].tail.column_names
    rows = [dict(zip(names, vals)) for _k, _d, vals in got[0]]
    # the float literal promotes to float64 (torch would give float32 for
    # a Python float): 123456789 * 0.5 needs 27 bits of mantissa
    assert rows[13]["i_x_f"] == 61728394.5
    assert [r["f2i"] for r in rows[:3]] == [-(2**63)] * 3  # NaN, inf, -inf -> INT64_MIN on x86
    assert rows[0]["f2b"] and rows[4]["absi"] == -(2**63)


def test_bool_arithmetic_stays_on_the_interpreter(monkeypatch):
    """numpy's bool + is a logical or and bool - raises; the lowering
    refuses bool arithmetic, so the tick falls back and matches."""
    rt = _three(monkeypatch, g_bool_arith, _edge_ticks())
    (seg,) = _segments(rt)
    assert seg.compiled_ticks == 0 and seg.fallback_ticks == 2


def test_negative_reindex_key_falls_back_like_the_interpreter(monkeypatch):
    ticks = _ticks([{"a": np.array([1, -2, 3] * 4, dtype=np.int64), "b": np.zeros(12), "flag": np.ones(12, bool)}])

    def build(ns, inp, capture):
        R, n = ns.Ref, ns.nodes
        return n.OutputNode(n.ReindexNode(n.RowwiseNode([inp], {"k": R(0, "a") * 5}), R(0, "k")), capture)

    for ns in (JAX, PORT):
        with pytest.raises(OverflowError):
            _run(monkeypatch, ns, build, ticks, compiled=ns is PORT)


# ---------------------------------------------------------------------------
# errors and the device


def test_device_error_inside_a_segment_fails_the_run(monkeypatch):
    """An error that is not NotCompilable (here: the program's own) is not
    swallowed: the tick fails as any operator's failure does."""
    c = PORT.compile
    real = c._build_program

    def broken(*args):
        prog = real(*args)

        def fn(*tensors):
            raise RuntimeError("device fault")

        prog.fn = fn
        return prog

    monkeypatch.setattr(c, "_build_program", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        _run(monkeypatch, PORT, g_bucket, _ticks([{"a": np.arange(40, dtype=np.int64),
                                                   "b": np.zeros(40)}]), compiled=True)


def test_compiled_ticks_without_a_card_raise(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "1")
    monkeypatch.delenv("PATHWAY_COMPILED_DEVICE", raising=False)
    ticks = _ticks([{"a": np.arange(8, dtype=np.int64), "b": np.zeros(8)}])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PORT.Runtime([g_bucket(PORT, PORT.nodes.InputNode(_src(PORT, ["a", "b"], ticks), ["a", "b"]),
                               lambda t, b: None)])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PORT.compile.semigroup_partials(np.zeros(4, np.int64), np.ones(4, np.int64), [None], 1)
    monkeypatch.delenv("PATHWAY_COMPILED_GROUPBY", raising=False)
    assert PORT.compile.compiled_groupby_enabled()  # auto: on for cuda
    monkeypatch.setenv("PATHWAY_COMPILED_DEVICE", "cpu")
    assert not PORT.compile.compiled_groupby_enabled()
    monkeypatch.setenv("PATHWAY_COMPILED_GROUPBY", "1")
    assert PORT.compile.compiled_groupby_enabled()


# ---------------------------------------------------------------------------
# observability of the compiled path: Tick Scope tags, roofline, metrics


def test_tickscope_tags_and_roofline(monkeypatch):
    from pathway_tpu_torch.observability import REGISTRY, tickscope

    ticks = _ticks([{"a": np.arange(n, dtype=np.int64), "b": np.linspace(0, 1, n)} for n in (40, 41, 100)])
    before = tickscope.roofline().samples("compiled_tick")
    _, rt = _run(monkeypatch, PORT, g_bucket, ticks, compiled=True)
    (seg,) = _segments(rt)
    entries = [e for rec in rt._tickscope.records() for e in rec.entries if e[0] == seg.tail.id]
    assert entries and all(e[5] for e in entries)  # tagged compiled
    assert all(e[0] not in {n.id for n in seg.nodes[:-1]} for rec in rt._tickscope.records()
               for e in rec.entries)  # members produce nothing of their own
    assert tickscope.roofline().samples("compiled_tick") - before == 3
    snap = tickscope.roofline().snapshot()["compiled_tick"]
    assert snap["flops_total"] > 0
    text = REGISTRY.render()
    for name in ("pathway_engine_compile_cache_hits_total", "pathway_engine_compile_cache_misses_total",
                 "pathway_engine_compile_seconds"):
        assert name in text


# ---------------------------------------------------------------------------
# public API end to end


def _public(pw):
    class NumSchema(pw.Schema):
        a: int
        b: float

    rng = np.random.default_rng(23)
    rows = [(int(rng.integers(-500, 500)), float(rng.normal())) for _ in range(200)]
    pw.internals.parse_graph.G.clear()
    t = pw.debug.table_from_rows(NumSchema, rows)
    r = t.select(x=t.a * 2 + 1, y=t.b - t.a).filter(pw.this.x > 0).select(z=pw.this.x + 1, y=pw.this.y)
    keys, cols = pw.debug.table_to_dicts(r)
    return keys, cols, pw.internals.parse_graph.G.last_runtime


def test_public_api_differential(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_MIN_ROWS", "1")
    monkeypatch.setenv("PATHWAY_COMPILED_DEVICE", "cpu")
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    keys_j, cols_j, _ = _public(pathway_tpu)
    keys_i, cols_i, rt_i = _public(pathway_tpu_torch)
    assert rt_i.compiled_plan is None
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "1")
    keys_c, cols_c, rt_c = _public(pathway_tpu_torch)
    pathway_tpu_torch.internals.parse_graph.G.clear()
    assert rt_c.compiled_plan is not None
    assert sum(s.compiled_ticks for s in rt_c.compiled_plan.segments) > 0
    assert sorted(map(int, keys_c)) == sorted(map(int, keys_i)) == sorted(map(int, keys_j))
    for k in cols_j["z"]:
        assert int(cols_c["z"][k]) == int(cols_i["z"][k]) == int(cols_j["z"][k])
        assert float(cols_c["y"][k]) == float(cols_i["y"][k]) == float(cols_j["y"][k])
