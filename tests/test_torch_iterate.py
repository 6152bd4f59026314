"""``pw.iterate`` of the port against the JAX package's: the same bodies
over the same seeded ``table_from_markdown`` streams give the same update
stream (keys, diffs and times exact; floats within 1e-9).

Cases: the fixed points of ``tests/test_ported_common*.py`` (Collatz with a
UDF, ``iteration_limit``, a shrinking universe through
``iterate_universe``, a body that reorders its columns, limits below 1), a
body that returns several tables, and connected components by minimum-label
propagation over a seeded edge stream. The components body reads an outer
table (the edges), which ``iterate`` cuts out of the body into an extra
input; the stream inserts edges that merge components and deletes edges
that split them, so the fixpoint is retracted and re-derived tick by tick.
The incremental engine's inner work per tick (rows moved by the depth
runtimes) is the reference's, and a small delta costs far less than the
first tick. A depth's inner runtime runs no worker threads, does not
replace the outer runtime's published Tick Scope recorder (not even when it
fails to build), and is not woken
by a connector's commit (each commit is one outer tick). Temporal buffers
inside a body are refused by exec class name, and the multi-process engine
raises naming [mesh]. The JAX side runs with ``PATHWAY_COMPILED_TICK=0``."""

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_streams_equal, components, markdown, stream, streams

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


# --- the fixed points of the reference's tests ------------------------------


def b_collatz(pw):
    def step(iterated):
        def collatz(x: float) -> float:
            if x == 1:
                return 1
            return x / 2 if x % 2 == 0 else 3 * x + 1

        return iterated.select(val=pw.apply(collatz, iterated.val))

    tab = pw.debug.table_from_markdown(
        "val\n" + "\n".join(str(v) for v in range(1, 13))
    ).select(val=pw.cast(float, pw.this.val))
    return pw.iterate(step, iterated=tab)


def _limit(n):
    def build(pw):
        def step(iterated):
            return iterated.select(foo=iterated.foo + 1)

        t = pw.debug.table_from_markdown("   | foo\n 1 | 0\n 2 | 5")
        return pw.iterate(step, iteration_limit=n, iterated=t)

    build.__name__ = f"b_limit_{n}"
    return build


def b_rows_fixpoint(pw):
    # drop the least id while more than two rows are left
    def step(iterated):
        low = iterated.reduce(min_id=pw.reducers.min(iterated.id), n=pw.reducers.count())
        return iterated.filter((iterated.id != low.ix_ref().min_id) | (low.ix_ref().n <= 2))

    t = pw.debug.table_from_markdown("   | foo\n" + "\n".join(f" {i} | {i}" for i in range(1, 7)))
    return pw.iterate(step, iterated=pw.iterate_universe(t))


def b_column_order(pw):
    def step(iterated):
        return iterated.select(bar=iterated.bar, foo=iterated.foo - iterated.foo)

    t = pw.debug.table_from_markdown(
        "   | foo | bar\n 1 | 1 | None\n 2 | 2 | None\n 3 | 3 | None"
    )
    return pw.iterate(step, iterated=t)


def b_two_tables(pw):
    # a namespace of results: ``a`` halves towards 1, ``b`` counts the steps
    def step(a, b):
        pw.universes.promise_are_equal(a, b)
        a2 = a.select(x=pw.if_else(a.x > 1, a.x // 2, a.x))
        return {"a": a2, "b": b.select(n=pw.if_else(a.x > 1, b.n + 1, b.n))}

    a = pw.debug.table_from_markdown("   | x\n 1 | 40\n 2 | 7\n 3 | 1")
    b = pw.debug.table_from_markdown("   | n\n 1 | 0\n 2 | 0\n 3 | 0")
    res = pw.iterate(step, a=a, b=b)
    return res.a.join(res.b, res.a.id == res.b.id).select(x=res.a.x, n=res.b.n)


FIXPOINTS = [b_collatz, _limit(1), _limit(2), _limit(10), b_rows_fixpoint, b_column_order, b_two_tables]


@pytest.mark.parametrize("build", FIXPOINTS, ids=lambda f: f.__name__[2:])
def test_fixpoint_equals_reference(build):
    got, want = streams(PACKAGES, build)
    assert want
    assert_streams_equal(got, want)


@pytest.mark.parametrize("limit", [-1, 0])
def test_limit_below_one_raises_like_reference(limit):
    for pw in PACKAGES.values():
        t = pw.debug.table_from_markdown("   | foo\n 1 | 0")
        with pytest.raises(ValueError, match="wrong iteration limit"):
            pw.iterate(lambda iterated: iterated, iteration_limit=limit, iterated=t)


# --- connected components over a seeded edge stream ---------------------------


def edge_stream(seed, families=6, size=5):
    """(id, u, w, time, diff) rows: chains of ``size`` vertices at time 2,
    bridges between families at time 4 (merges), deleted chain links and
    bridges at time 6 (splits), new links at time 8."""
    rng = np.random.default_rng(seed)
    rows, next_id = [], 1
    live = []
    for f in range(families):
        for i in range(size - 1):
            rows.append((next_id, f * size + i, f * size + i + 1, 2, 1))
            live.append(rows[-1])
            next_id += 1
    bridges = []
    for _ in range(families // 2 + 1):
        a, b = rng.choice(families, 2, replace=False)
        u, w = int(a * size + rng.integers(size)), int(b * size + rng.integers(size))
        rows.append((next_id, u, w, 4, 1))
        bridges.append(rows[-1])
        next_id += 1
    for idx in rng.choice(len(live), families // 2, replace=False):
        r = live[int(idx)]
        rows.append((r[0], r[1], r[2], 6, -1))
    r = bridges[0]
    rows.append((r[0], r[1], r[2], 6, -1))
    for _ in range(3):
        u, w = (int(x) for x in rng.choice(families * size, 2, replace=False))
        rows.append((next_id, u, w, 8, 1))
        next_id += 1
    return rows


def _components_build(seed):
    def build(pw):
        return components(pw, pw.debug.table_from_markdown(markdown(["u", "w"], edge_stream(seed))))

    return build


def _final(events):
    state = {}
    for _t, d, k, row in sorted(events, key=lambda e: (e[0], e[1])):
        if d > 0:
            state[k] = dict(row)
        else:
            state.pop(k, None)
    return state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_components_stream_equals_reference(seed):
    got, want = streams(PACKAGES, _components_build(seed))
    assert_streams_equal(got, want)
    assert any(d < 0 for _t, d, _k, _r in want)  # the splits retract labels
    # the final labels are the components of the final edge set
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    live = {}
    for r in edge_stream(seed):
        if r[4] > 0:
            live[r[0]] = (r[1], r[2])
        else:
            live.pop(r[0])
    u, w = np.array(list(live.values())).T
    n = int(max(u.max(), w.max())) + 1
    _, lab = connected_components(sp.coo_matrix((np.ones(len(u)), (u, w)), shape=(n, n)), directed=False)
    labels = {row["v"]: row["label"] for row in _final(got).values()}
    least = {}
    for v in sorted(labels):
        least.setdefault(lab[v], v)
    assert labels == {v: least[lab[v]] for v in labels}


def _inner_rows_per_tick(pw, iterate_mod, build, monkeypatch):
    per_tick = []
    orig = iterate_mod.IterateExec.process

    def wrapped(self, t, inputs):
        before = sum(sum(d.runtime.stats.node_rows.values()) for d in self._depths)
        out = orig(self, t, inputs)
        after = sum(sum(d.runtime.stats.node_rows.values()) for d in self._depths)
        n_in = sum(len(b) for bs in inputs for b in bs)
        if n_in:
            per_tick.append((t, n_in, after - before, len(self._depths)))
        return out

    monkeypatch.setattr(iterate_mod.IterateExec, "process", wrapped)
    pw.internals.parse_graph.G.clear()
    stream(pw, build(pw))
    monkeypatch.setattr(iterate_mod.IterateExec, "process", orig)
    return per_tick


def test_inner_work_per_tick_equals_reference(monkeypatch):
    from pathway_tpu.internals import iterate as jiterate
    from pathway_tpu_torch.internals import iterate as titerate

    def build(pw):
        rows = [(i + 1, i, i + 1, 2, 1) for i in range(39)]  # a 40-vertex chain
        rows += [(100, 50, 51, 2, 1), (101, 51, 52, 2, 1), (102, 50, 52, 4, 1), (101, 51, 52, 6, -1)]
        return components(pw, pw.debug.table_from_markdown(markdown(["u", "w"], rows)))

    got = _inner_rows_per_tick(tpw, titerate, build, monkeypatch)
    want = _inner_rows_per_tick(jpw, jiterate, build, monkeypatch)
    assert got == want
    bulk = got[0][2]
    assert len(got) == 3 and all(rows < bulk / 5 for _t, _n, rows, _d in got[1:])


def test_depth_runtimes_stay_out_of_the_outer_runtime():
    from pathway_tpu_torch.internals.iterate import IterateExec
    from pathway_tpu_torch.observability import tickscope

    stream(tpw, _components_build(0)(tpw))
    rt = port_parse_graph.G.last_runtime
    assert tickscope.recorder() is rt._tickscope
    ex = next(e for e in rt.execs.values() if isinstance(e, IterateExec))
    assert ex._depths
    outer_ids = set(rt.execs)
    for depth in ex._depths:
        assert depth.runtime._pool is None and depth.runtime._tickscope is not rt._tickscope
        assert not set(depth.runtime.execs) & outer_ids
    # the outer recorder holds the outer ticks' operators only
    records = rt._tickscope.records()
    recorded = {e[0] for rec in records for e in rec.entries}
    assert recorded and recorded <= outer_ids
    # one record per outer data tick (times 2, 4, 6, 8), none of the depths'
    assert rt._tickscope.ticks_recorded == 4
    assert sum(d.runtime.stats.ticks for d in ex._depths) > 4


@pytest.mark.parametrize("where", ["exec", "after_recorder"])
def test_a_depth_that_fails_to_build_republishes_the_outer_recorder(where, monkeypatch):
    """A depth's runtime that raises while it is built, either in a body
    operator's exec or after its own recorder was attached: the error
    reaches pw.run, and the recorder the process publishes is still the
    outer runtime's, not the half-built depth's."""
    from pathway_tpu_torch.observability import tickscope

    def refuse(*_args):
        raise RuntimeError("a body operator refused to build")

    def step(iterated):
        out = iterated.select(a=iterated.a)
        if where == "exec":
            out._node.make_exec = refuse
        return out

    if where == "after_recorder":
        made = []
        real = tickscope.make_recorder

        def make_recorder(runtime):  # the outer runtime's first, then a depth's
            scope = real(runtime)
            made.append(scope)
            if len(made) > 1:
                refuse()
            return scope

        monkeypatch.setattr(tickscope, "make_recorder", make_recorder)
    res = tpw.iterate(step, iterated=tpw.debug.table_from_markdown("   | a\n 1 | 1"))
    with pytest.raises(RuntimeError, match="a body operator refused to build"):
        stream(tpw, res)
    assert tickscope.recorder() is port_parse_graph.G.last_runtime._tickscope


def test_temporal_buffer_in_a_body_is_refused_like_reference():
    for pw in PACKAGES.values():
        from importlib import import_module

        nodes = import_module(pw.__name__ + ".engine.nodes")
        universe = import_module(pw.__name__ + ".internals.universe")
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_markdown("   | a\n 1 | 1")

        def step(iterated, pw=pw):
            node = nodes.BufferNode(iterated._node, "a", "a")
            return pw.Table._from_node(node, {"a": iterated._schema["a"].dtype}, universe.Universe())

        res = pw.iterate(step, iterated=t)
        with pytest.raises(NotImplementedError, match="buffer/forget/freeze"):
            stream(pw, res)


def test_iterate_under_the_multi_process_engine_raises_mesh():
    t = tpw.debug.table_from_markdown("   | a\n 1 | 1")
    res = tpw.iterate(lambda iterated: iterated.select(a=iterated.a), iterated=t)
    res._node._dcn = True
    with pytest.raises(NotImplementedError, match=r"\[mesh\]"):
        res._node.make_exec()


def test_streaming_commits_wake_the_outer_runtime_only():
    """Edges arrive through ``pw.io.python`` in three commits: each commit
    is one outer tick (the session wakes the outer runtime), the labels
    follow, and no depth's runtime was woken, stopped or given a session."""
    from pathway_tpu_torch.internals.iterate import IterateExec

    batches = [[(0, 1), (1, 2)], [(5, 6)], [(2, 5)]]
    seen = []

    class Edges(tpw.io.python.ConnectorSubject):
        def run(self):
            for rows in batches:
                for u, w in rows:
                    self.next(u=u, w=w)
                n = len(seen)
                self.commit()
                for _ in range(2000):  # each commit's labels before the next
                    if len(seen) > n:
                        break
                    __import__("time").sleep(0.005)

    edges = tpw.io.python.read(Edges(), schema=tpw.schema_from_types(u=int, w=int), autocommit_duration_ms=None)
    comps = components(tpw, edges)
    state = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            state[row["v"]] = row["label"]
        seen.append(time)

    tpw.io.subscribe(comps, on_change=on_change)
    tpw.run()
    rt = port_parse_graph.G.last_runtime
    assert state == {0: 0, 1: 0, 2: 0, 5: 0, 6: 0}
    assert rt.stats.ticks == len(batches) + 1  # one tick per commit and the closing one
    ex = next(e for e in rt.execs.values() if isinstance(e, IterateExec))
    for depth in ex._depths:
        assert not depth.runtime._wake.is_set() and not depth.runtime._stop.is_set()
        assert depth.runtime._pool is None
