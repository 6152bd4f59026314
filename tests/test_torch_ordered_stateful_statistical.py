"""``pw.ordered`` (``diff``, and ``Table.diff`` on it), ``pw.stateful``
(``deduplicate``) and ``pw.statistical`` (``interpolate``,
``InterpolateMode``) of the port against the JAX package's: one graph
under both packages over the same seeded streams (``__time__``/
``__diff__``, with retractions), the update streams pinned (keys, diffs,
times, ints exact; floats within ``FLOAT_TOL``). The names resolve from
the root and from ``pw.stdlib`` alike. The JAX side runs with
``PATHWAY_COMPILED_TICK=0``."""

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_streams_equal, markdown, streams

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _series(pw, seed, n=20, gaps=False, retract=True):
    """(id, ts, k, a, b, __time__, __diff__): distinct timestamps in a
    shuffled order, two instances; ``gaps`` leaves some values empty."""
    rng = np.random.default_rng(seed)
    ts = rng.permutation(np.arange(1, 3 * n, 3))[:n]
    rows = []
    for i, t in enumerate(ts.tolist()):
        a = int(rng.integers(-50, 50))
        b = round(float(rng.normal() * 10), 3)
        if gaps and rng.random() < 0.3:
            a = None
        if gaps and rng.random() < 0.3:
            b = None
        tick = 2 * (1 + i // 4)
        rows.append((i + 1, t, i % 2, a, b, tick, 1))
        if retract and rng.random() < 0.15:
            rows.append((i + 1, t, i % 2, a, b, tick + 4, -1))
    return pw.debug.table_from_markdown(markdown(["ts", "k", "a", "b"], rows))


@pytest.mark.parametrize("form", ["method", "ordered", "stdlib"])
@pytest.mark.parametrize("instance", [False, True])
@pytest.mark.parametrize("seed", [81, 82])
def test_diff(seed, instance, form):
    def build(pw):
        t = _series(pw, seed)
        kw = {"instance": t.k} if instance else {}
        if form == "method":
            return t.diff(t.ts, t.a, t.b, **kw)
        fn = pw.ordered.diff if form == "ordered" else pw.stdlib.ordered.diff
        return fn(t, t.ts, t.a, **kw)

    got, want = streams(PACKAGES, build)
    assert got
    assert_streams_equal(got, want)


ACCEPTORS = {
    "greater": lambda new, old: new > old,
    "by_two": lambda new, old: new >= old + 2,
    "always": lambda new, old: True,
}


@pytest.mark.parametrize("instance", [False, True])
@pytest.mark.parametrize("acceptor", list(ACCEPTORS))
def test_deduplicate(acceptor, instance):
    def build(pw):
        t = _series(pw, 83, retract=False)
        kw = {"instance": t.k} if instance else {}
        return pw.stateful.deduplicate(t, value=t.a, acceptor=ACCEPTORS[acceptor], **kw)

    got, want = streams(PACKAGES, build)
    assert got
    assert_streams_equal(got, want)


@pytest.mark.parametrize("cols", ["a", "b", "ab"])
@pytest.mark.parametrize("seed", [84, 85, 86])
def test_interpolate(seed, cols):
    def build(pw):
        t = _series(pw, seed, gaps=True, retract=False)
        values = [t[c] for c in cols]
        return pw.statistical.interpolate(t, t.ts, *values, mode=pw.statistical.InterpolateMode.LINEAR)

    got, want = streams(PACKAGES, build)
    assert got
    assert_streams_equal(got, want)


def test_names_resolve_alike():
    for pw in PACKAGES.values():
        assert pw.ordered is pw.stdlib.ordered
        assert pw.stateful is pw.stdlib.stateful
        assert pw.statistical is pw.stdlib.statistical
        assert pw.temporal is pw.stdlib.temporal
        assert [m.value for m in pw.statistical.InterpolateMode] == ["linear"]
