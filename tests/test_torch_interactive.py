"""``pw.live``/``LiveTable`` of the port against the JAX package's: the
cases of ``tests/test_interactive.py`` and ``tests/test_stdlib_misc.py:47``,
each run under both packages on the same rows, with equal snapshots (keys
and values exact), equal replayed subscriber streams, equal results of the
re-imported table, and the same failure contract. A run's frontier ends at
``END_OF_TIME``; ``live()`` mirrors only its own table, so a sink declared
beside it does not run; a subscriber that raises does not stop the
deliveries to the others. The JAX side runs with
``PATHWAY_COMPILED_TICK=0``."""

import time

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


def _schema(pw):
    class S(pw.Schema):
        v: int

    return S


def _each(build):
    """``build(pw)`` under both packages, each on a fresh graph."""
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        out[name] = build(pw)
    return out["port"], out["jax"]


def test_live_snapshot_and_frontier():
    def build(pw):
        from importlib import import_module

        t = pw.debug.table_from_rows(_schema(pw), [(1,), (2,), (3,)])
        res = t.reduce(s=pw.reducers.sum(t.v))
        lt = pw.live(res)
        assert lt.wait(10) and lt.done and not lt.failed
        end = import_module(f"{pw.__name__}.engine.batch").END_OF_TIME
        assert lt.frontier() == end
        frontier, rows = lt.snapshot()
        out = (frontier, rows, len(lt), list(lt.to_pandas()["s"]))
        lt.stop()
        return out

    got, want = _each(build)
    assert got == want
    assert list(got[1].values()) == [(6,)] and got[3] == [6]


def test_live_subscribe_replays_state():
    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), [(5,), (7,)])
        lt = pw.live(t)
        assert lt.wait(10)
        seen = []
        lt.subscribe(lambda k, row, t_, add: seen.append((int(k), row["v"], add)))
        lt.stop()
        return sorted(seen)

    got, want = _each(build)
    assert got == want and [v for _k, v, _a in got] == [5, 7]


def test_live_table_reimport_composes():
    """The import half: a LiveTable feeds a NEW graph as a source."""

    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), [(1,), (2,), (3,), (4,)])
        lt = pw.live(t)
        assert lt.wait(10)
        pw.internals.parse_graph.G.clear()
        t2 = lt.table()
        res = t2.filter(t2.v >= 3).reduce(s=pw.reducers.sum(t2.v))
        _k, cols = pw.debug.table_to_dicts(res)
        lt.stop()
        return list(cols["s"].values())

    got, want = _each(build)
    assert got == want == [7]


def test_live_failure_is_observable():
    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), [(1,)])
        lt = pw.live(t)
        lt.wait(10)
        lt._done.clear()
        lt.error = RuntimeError("injected")
        lt._done.set()
        with pytest.raises(RuntimeError, match="injected"):
            lt.wait(1)
        out = lt.failed
        lt.stop()
        return out

    got, want = _each(build)
    assert got is want is True


def test_live_table_background_updates():
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
            v
            1
            2
            3
            """
        )
        agg = t.groupby().reduce(total=pw.reducers.sum(t.v))
        lt = pw.live(agg)
        deadline = time.time() + 10
        while time.time() < deadline and len(lt) == 0:
            time.sleep(0.05)
        out = list(lt.to_pandas()["total"])
        lt.stop()
        return out

    got, want = _each(build)
    assert got == want == [6]


def test_live_runs_its_table_only_and_survives_a_raising_subscriber():
    """A sink declared beside the live table does not run, and a subscriber
    that raises leaves the others their deliveries, in both packages."""

    def build(pw):
        t = pw.debug.table_from_rows(_schema(pw), [(1,), (2,)])
        sunk = []
        pw.io.subscribe(t, on_change=lambda **kw: sunk.append(kw))
        lt = pw.live(t.select(w=t.v * 10))
        assert lt.wait(10)
        seen = []

        def bad(k, row, t_, add):
            raise ValueError("a subscriber's fault")

        lt.subscribe(bad)
        lt.subscribe(lambda k, row, t_, add: seen.append(row["w"]))
        lt.unsubscribe(bad)
        lt.stop()
        return sunk, sorted(seen), lt.failed

    got, want = _each(build)
    assert got == want == ([], [10, 20], False)


def test_live_over_a_streaming_source_follows_every_commit():
    """A LiveTable over ``pw.io.python``: the subscriber's stream, replayed
    state then every diff, ends equal to the snapshot in both packages."""

    def build(pw):
        class Subject(pw.io.python.ConnectorSubject):
            def run(self):
                for i in range(6):
                    self.next(g=i % 2, v=i)
                    self.commit()

        class G(pw.Schema):
            g: int
            v: int

        t = pw.io.python.read(Subject(), schema=G, autocommit_duration_ms=None)
        lt = pw.live(t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v)))
        state = {}

        def follow(k, row, t_, add):
            if add:
                state[int(k)] = (row["g"], row["s"])
            elif state.get(int(k)) == (row["g"], row["s"]):
                del state[int(k)]

        lt.subscribe(follow)
        assert lt.wait(30)
        _f, rows = lt.snapshot()
        lt.stop()
        assert state == {int(k): v for k, v in rows.items()}
        return sorted(rows.values())

    got, want = _each(build)
    assert got == want == [(0, 6), (1, 9)]
