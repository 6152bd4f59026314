"""Windows of the port (``pw.temporal``: ``tumbling``, ``sliding``,
``session``, ``intervals_over`` and ``windowby``, as a function and as a
``Table`` method) against the JAX package's. Each case builds one graph
under both packages over the same seeded stream (``__time__``/``__diff__``,
late rows and retractions) and pins the update stream of the windows'
``reduce``: keys, diffs, times, ints and strings exact, floats within
``FLOAT_TOL``. Every window runs with every behavior (none, common with
delay, cutoff and ``keep_results``, exactly-once) over int times, and with
three of them over float, naive and UTC datetime times; a refusal (the
same exception type in both) is an outcome too. The reference's
``test_windows_stream.py`` cases (sliding windows under common_behavior
and exactly_once_behavior over a stream with repeated and late times)
become update-stream parity cases. The JAX side runs with
``PATHWAY_COMPILED_TICK=0``."""

import datetime

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import (
    DT_BASE,
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


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _events(kind, seed, n=28):
    """(id, t, k, v, __time__, __diff__): event times rising with the
    processing time, some up to 4 units late, a fifth retracted later."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        t = max(0, i // 2 - int(rng.integers(0, 5)) * (rng.random() < 0.3))
        tick = 2 * (1 + i // 3)
        k, v = int(rng.integers(0, 3)), int(rng.integers(-5, 20))
        rows.append((i + 1, time_cell(kind, t), k, v, tick, 1))
        if rng.random() < 0.2:
            rows.append((i + 1, time_cell(kind, t), k, v, tick + 4, -1))
    return rows


def _table(pw, kind, seed):
    return event_time(pw.debug.table_from_markdown(markdown(["t", "k", "v"], _events(kind, seed))), kind)


def _probes(pw, kind):
    rows = [(None, time_cell(kind, x), tick, 1) for x, tick in ((2, 2), (5, 4), (9, 8), (14, 12))]
    return event_time(pw.debug.table_from_markdown(markdown(["t"], rows)), kind)


WINDOWS = {
    "tumbling": lambda pw, kind: pw.temporal.tumbling(duration=span(kind, 3)),
    "tumbling_origin": lambda pw, kind: pw.temporal.tumbling(duration=span(kind, 4), origin=_at(kind, 1)),
    "sliding": lambda pw, kind: pw.temporal.sliding(hop=span(kind, 2), duration=span(kind, 5)),
    "sliding_ratio": lambda pw, kind: pw.temporal.sliding(hop=span(kind, 1), ratio=3),
    "session_gap": lambda pw, kind: pw.temporal.session(max_gap=span(kind, 2)),
    "session_predicate": lambda pw, kind: pw.temporal.session(
        predicate=lambda a, b: abs(b - a) <= span(kind, 1)),
    "intervals_over": lambda pw, kind: pw.temporal.intervals_over(
        at=_probes(pw, kind).t, lower_bound=span(kind, -2), upper_bound=span(kind, 1), is_outer=False),
    "intervals_over_outer": lambda pw, kind: pw.temporal.intervals_over(
        at=_probes(pw, kind).t, lower_bound=span(kind, -1), upper_bound=span(kind, 2)),
}

BEHAVIORS = {
    "none": lambda pw, kind: None,
    "delay": lambda pw, kind: pw.temporal.common_behavior(delay=span(kind, 2)),
    "cutoff": lambda pw, kind: pw.temporal.common_behavior(cutoff=span(kind, 3)),
    "delay_cutoff_forget": lambda pw, kind: pw.temporal.common_behavior(
        delay=span(kind, 1), cutoff=span(kind, 4), keep_results=False),
    "cutoff_keep": lambda pw, kind: pw.temporal.common_behavior(
        delay=span(kind, 0), cutoff=span(kind, 2), keep_results=True),
    "exactly_once": lambda pw, kind: pw.temporal.exactly_once_behavior(),
    "exactly_once_shift": lambda pw, kind: pw.temporal.exactly_once_behavior(shift=span(kind, 1)),
}


def _at(kind, x):
    """Event time ``x`` of ``kind`` as a value (a window's origin)."""
    if kind == "int":
        return x
    if kind == "float":
        return x + 0.25
    base = datetime.datetime.fromisoformat(DT_BASE) + datetime.timedelta(minutes=x)
    return base if kind == "naive" else base.replace(tzinfo=datetime.timezone(datetime.timedelta(hours=2)))


def _windowed(window, behavior, kind, seed, instance=True, function=False):
    def build(pw):
        t = _table(pw, kind, seed)
        w = WINDOWS[window](pw, kind)
        b = BEHAVIORS[behavior](pw, kind)
        kw = {"window": w, "behavior": b}
        if instance:
            kw["instance"] = t.k
        grouped = pw.temporal.windowby(t, t.t, **kw) if function else t.windowby(t.t, **kw)
        cols = dict(
            n=pw.reducers.count(),
            lo=pw.reducers.min(pw.this.v),
            hi=pw.reducers.max(pw.this.t),
            total=pw.reducers.sum(pw.this.v),
        )
        if window.startswith("intervals_over"):
            return grouped.reduce(pw.this._pw_window_location, **cols)
        return grouped.reduce(pw.this._pw_window_start, pw.this._pw_window_end,
                              pw.this._pw_instance, **cols)

    return build


@pytest.mark.parametrize("behavior", list(BEHAVIORS))
@pytest.mark.parametrize("window", list(WINDOWS))
def test_window_with_behavior_over_int_times(window, behavior):
    got, want = outcomes(PACKAGES, _windowed(window, behavior, "int", 11))
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("behavior", ["none", "delay_cutoff_forget", "exactly_once"])
@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("kind", TIME_KINDS[1:])
def test_window_with_behavior_over_float_and_datetime_times(kind, window, behavior):
    got, want = outcomes(PACKAGES, _windowed(window, behavior, kind, 12))
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("window", ["tumbling", "sliding", "session_gap", "intervals_over"])
@pytest.mark.parametrize("kind", TIME_KINDS)
def test_windowby_function_without_instance(kind, window):
    got, want = outcomes(PACKAGES, _windowed(window, "none", kind, 13, instance=False, function=True))
    assert_outcomes_equal(got, want)


def test_window_reduce_sees_the_hidden_columns_and_this():
    def build(pw):
        t = _table(pw, "int", 14)
        return t.windowby(t.t, window=pw.temporal.sliding(hop=2, duration=4), instance=t.k).reduce(
            pw.this._pw_instance,
            start=pw.this._pw_window_start,
            width=pw.this._pw_window_end - pw.this._pw_window_start,
            ts=pw.reducers.sorted_tuple(pw.this.t),
            vs=pw.reducers.tuple(pw.this.v),
            mean=pw.reducers.avg(pw.this.v),
        )

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want)


@pytest.mark.parametrize("bad", ["duration_over_int", "session_both", "session_neither",
                                 "string_time"])
def test_refused_windows_are_refused_alike(bad):
    def build(pw):
        t = _table(pw, "int", 15)
        if bad == "duration_over_int":
            w = pw.temporal.tumbling(duration=span("naive", 1))
        elif bad == "session_both":
            w = pw.temporal.session(predicate=lambda a, b: True, max_gap=1)
        elif bad == "session_neither":
            w = pw.temporal.session()
        else:
            t = t.select(t=pw.apply(str, t.t), v=t.v)
            w = pw.temporal.tumbling(duration=2)
        return t.windowby(t.t, window=w).reduce(n=pw.reducers.count())

    got, want = outcomes(PACKAGES, build)
    assert_outcomes_equal(got, want)
    assert isinstance(want, tuple), want


# --- the reference's test_windows_stream.py as update-stream parity -----------


def _stream_rows(n=68):
    """The reference's generated stream: value i at time (i // 2) % 17,
    one row per tick, so times repeat and fall back after 16."""
    return [(None, (i // 2) % 17, i, 2 * (i + 1), 1) for i in range(n)]


STREAM_CASES = {
    "keep_results": dict(delay=0, cutoff=0, keep_results=True),
    "remove_results": dict(delay=0, cutoff=0, keep_results=False),
    "non_zero_delay_keep_results": dict(delay=1, cutoff=0, keep_results=True),
    "non_zero_delay_remove_results": dict(delay=1, cutoff=0, keep_results=False),
    "non_zero_buffer_keep_results": dict(delay=0, cutoff=1, keep_results=True),
    "non_zero_buffer_remove_results": dict(delay=0, cutoff=1, keep_results=False),
    "non_zero_delay_non_zero_buffer_keep_results": dict(delay=1, cutoff=1, keep_results=True),
    "non_zero_delay_non_zero_buffer_remove_results": dict(delay=1, cutoff=1, keep_results=False),
    "high_delay_high_buffer_keep_results": dict(delay=5, cutoff=6, keep_results=True),
    "exactly_once": None,
    "exactly_once_shift": 2,
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_windows_stream_case(case):
    def build(pw):
        t = pw.debug.table_from_markdown(markdown(["time", "value"], _stream_rows()))
        params = STREAM_CASES[case]
        if case.startswith("exactly_once"):
            behavior = pw.temporal.exactly_once_behavior(shift=params)
        else:
            behavior = pw.temporal.common_behavior(**params)
        gb = t.windowby(t.time, window=pw.temporal.sliding(duration=5, hop=3), behavior=behavior)
        return gb.reduce(pw.this._pw_window_end, max_time=pw.reducers.max(pw.this.time),
                         max_value=pw.reducers.max(pw.this.value))

    got, want = streams(PACKAGES, build)
    assert got, "the windows emitted nothing"
    assert_streams_equal(got, want)
