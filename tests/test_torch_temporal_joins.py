"""The temporal joins of the port against the JAX package's: the interval
joins (``interval_join`` and its ``_inner``/``_left``/``_right``/
``_outer`` forms, as ``Table`` methods and as ``pw.temporal`` functions),
the asof joins (every mode and ``Direction``, with ``defaults``), the
asof-now joins and the window joins (tumbling, sliding and session
windows, every mode). Each case builds one graph under both packages over
the same seeded streams (``__time__``/``__diff__``, with retractions),
over int, float, naive and UTC datetime times, and pins the update stream
of the join's ``select``: keys, diffs, times, ints and strings exact,
floats within ``FLOAT_TOL``; a refusal (the same exception type in both)
is an outcome too. The results' classes are the root names
``pw.IntervalJoinResult``, ``pw.AsofJoinResult`` and
``pw.WindowJoinResult``. The JAX side runs with
``PATHWAY_COMPILED_TICK=0``."""

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import (
    TIME_KINDS,
    assert_outcomes_equal,
    assert_streams_equal,
    event_time,
    markdown,
    outcomes,
    span,
    streams,
    time_cell,
)

PACKAGES = {"jax": jpw, "port": tpw}
MODES = ["inner", "left", "right", "outer"]


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _side(pw, kind, seed, n, col, id0):
    """(id, t, k, <col>, __time__, __diff__): times 0..15 arriving over
    ticks 2..12, a sixth retracted two ticks later."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        t, tick = int(rng.integers(0, 16)), 2 * int(rng.integers(1, 7))
        k, v = int(rng.integers(0, 3)), int(rng.integers(-9, 30))
        rows.append((id0 + i, time_cell(kind, t), k, v, tick, 1))
        if rng.random() < 0.17:
            rows.append((id0 + i, time_cell(kind, t), k, v, tick + 2, -1))
    return event_time(pw.debug.table_from_markdown(markdown(["t", "k", col], rows)), kind)


def _sides(pw, kind, seed):
    return _side(pw, kind, seed, 14, "a", 1), _side(pw, kind, seed + 50, 12, "b", 101)


def _mode_method(t, family, mode):
    return getattr(t, family if mode is None else f"{family}_{mode}")


# --- interval joins -----------------------------------------------------------


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("mode", [None, *MODES])
@pytest.mark.parametrize("kind", TIME_KINDS)
def test_interval_join(kind, mode, on):
    def build(pw):
        left, right = _sides(pw, kind, 21)
        cond = [left.k == right.k] if on else []
        res = _mode_method(left, "interval_join", mode)(
            right, left.t, right.t, pw.temporal.interval(span(kind, -2), span(kind, 1)), *cond)
        assert isinstance(res, pw.IntervalJoinResult)
        return res.select(lt=pw.left.t, a=pw.left.a, rt=pw.right.t, b=pw.right.b,
                          s=pw.coalesce(pw.left.a, 0) + pw.coalesce(pw.right.b, 0))

    got, want = streams(PACKAGES, build)
    assert got, "the join emitted nothing"
    assert_streams_equal(got, want)


@pytest.mark.parametrize("behavior", ["delay", "cutoff", "cutoff_forget"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["int", "naive"])
def test_interval_join_with_behavior(kind, mode, behavior):
    def build(pw):
        left, right = _sides(pw, kind, 22)
        b = {
            "delay": pw.temporal.common_behavior(delay=span(kind, 2)),
            "cutoff": pw.temporal.common_behavior(cutoff=span(kind, 4)),
            "cutoff_forget": pw.temporal.common_behavior(cutoff=span(kind, 3), keep_results=False),
        }[behavior]
        fn = getattr(pw.temporal, f"interval_join_{mode}")
        return fn(left, right, left.t, right.t, pw.temporal.interval(span(kind, -3), span(kind, 0)),
                  left.k == right.k, behavior=b).select(a=pw.left.a, b=pw.right.b)

    got, want = outcomes(PACKAGES, build)
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("bad", ["reversed_bounds", "mixed_kinds", "exactly_once"])
def test_interval_join_refusals_alike(bad):
    def build(pw):
        left, right = _sides(pw, "int", 23)
        kw = {}
        if bad == "reversed_bounds":
            iv = pw.temporal.interval(2, -2)
        elif bad == "mixed_kinds":
            iv = pw.temporal.interval(span("naive", -1), span("naive", 1))
        else:
            iv = pw.temporal.interval(-1, 1)
            kw["behavior"] = pw.temporal.exactly_once_behavior()
        return left.interval_join(right, left.t, right.t, iv, **kw).select(a=pw.left.a)

    got, want = outcomes(PACKAGES, build)
    assert isinstance(want, tuple), want
    assert_outcomes_equal(got, want)


# --- asof joins ---------------------------------------------------------------


@pytest.mark.parametrize("direction", ["BACKWARD", "FORWARD", "NEAREST"])
@pytest.mark.parametrize("mode", [None, "left", "right", "outer"])
@pytest.mark.parametrize("kind", TIME_KINDS)
def test_asof_join(kind, mode, direction):
    def build(pw):
        left, right = _sides(pw, kind, 31)
        res = _mode_method(left, "asof_join", mode)(
            right, left.t, right.t, left.k == right.k,
            direction=getattr(pw.temporal.Direction, direction),
            defaults={right.b: -1, left.a: -2},
        )
        assert isinstance(res, pw.AsofJoinResult)
        return res.select(pw.this.t, pw.this.instance, a=pw.left.a, b=pw.right.b)

    got, want = outcomes(PACKAGES, build)
    assert not isinstance(want, tuple), want
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("how", ["LEFT", "RIGHT", "OUTER"])
def test_asof_join_function_with_expression_times(how):
    def build(pw):
        left, right = _sides(pw, "int", 32)
        return pw.temporal.asof_join(
            left, right, left.t * 2, right.t * 2 + 1, left.k == right.k,
            how=getattr(pw.JoinMode, how), defaults={left.a: 0, right.b: 0},
        ).select(pw.this.t, a=pw.left.a, b=pw.right.b, ab=pw.left.a * 2 + pw.right.b)

    got, want = streams(PACKAGES, build)
    assert got
    assert_streams_equal(got, want)


# --- asof-now joins -----------------------------------------------------------


def _asof_now_inputs(pw):
    data = pw.debug.table_from_markdown(markdown(["value", "instance"], [
        (2, 4, 1, 2, 1), (2, 4, 1, 8, -1), (5, 5, 1, 10, 1), (7, 2, 2, 14, 1),
        (7, 2, 2, 22, -1), (11, 3, 2, 24, 1), (5, 5, 1, 30, -1), (14, 9, 1, 32, 1),
    ]))
    queries = pw.debug.table_from_markdown(markdown(["value", "instance"], [
        (None, v, inst, tick, 1) for v, inst, tick in
        ((1, 1, 0), (2, 1, 4), (3, 1, 6), (4, 1, 12), (5, 2, 16), (6, 1, 18), (7, 2, 20), (8, 1, 26),
         (9, 2, 28))
    ]))
    return data, queries


@pytest.mark.parametrize("set_id", [False, True])
@pytest.mark.parametrize("form", ["asof_now_join", "asof_now_join_inner", "asof_now_join_left"])
def test_asof_now_join(form, set_id):
    def build(pw):
        data, queries = _asof_now_inputs(pw)
        kw = {"id": pw.left.id} if set_id else {}
        return getattr(queries, form)(data, pw.left.instance == pw.right.instance, **kw).select(
            query=pw.left.value, ans=pw.right.value)

    got, want = streams(PACKAGES, build)
    assert got
    assert_streams_equal(got, want)


def test_asof_now_join_function_refuses_outer_alike():
    def build(pw):
        data, queries = _asof_now_inputs(pw)
        return pw.temporal.asof_now_join(queries, data, how=pw.JoinMode.OUTER).select(q=pw.left.value)

    got, want = outcomes(PACKAGES, build)
    assert isinstance(want, tuple), want
    assert_outcomes_equal(got, want)


# --- window joins -------------------------------------------------------------

JOIN_WINDOWS = {
    "tumbling": lambda pw, kind: pw.temporal.tumbling(duration=span(kind, 3)),
    "sliding": lambda pw, kind: pw.temporal.sliding(hop=span(kind, 2), duration=span(kind, 4)),
    "session": lambda pw, kind: pw.temporal.session(max_gap=span(kind, 1)),
}


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("mode", [None, *MODES])
@pytest.mark.parametrize("window", list(JOIN_WINDOWS))
@pytest.mark.parametrize("kind", TIME_KINDS)
def test_window_join(kind, window, mode, on):
    def build(pw):
        left, right = _sides(pw, kind, 41)
        cond = [left.k == right.k] if on else []
        res = _mode_method(left, "window_join", mode)(
            right, left.t, right.t, JOIN_WINDOWS[window](pw, kind), *cond)
        assert isinstance(res, pw.WindowJoinResult)
        return res.select(a=pw.left.a, b=pw.right.b, lt=pw.left.t, rt=pw.right.t)

    got, want = outcomes(PACKAGES, build)
    assert not isinstance(want, tuple), want
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_window_join_function_with_this(mode):
    def build(pw):
        left, right = _sides(pw, "float", 42)
        fn = getattr(pw.temporal, f"window_join_{mode}")
        return fn(left, right, left.t, right.t, pw.temporal.tumbling(duration=2.5),
                  left.k == right.k).select(pw.this.k, a=pw.left.a, b=pw.right.b)

    got, want = outcomes(PACKAGES, build)
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("bad", ["intervals_over", "mixed_kinds"])
def test_window_join_refusals_alike(bad):
    def build(pw):
        left, right = _sides(pw, "int", 43)
        if bad == "intervals_over":
            w = pw.temporal.intervals_over(at=left.t, lower_bound=-1, upper_bound=1)
        else:
            w = pw.temporal.tumbling(duration=span("naive", 2))
        return left.window_join(right, left.t, right.t, w).select(a=pw.left.a)

    got, want = outcomes(PACKAGES, build)
    assert isinstance(want, tuple), want
    assert_outcomes_equal(got, want)
