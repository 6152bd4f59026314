"""``pw.stdlib.ml.hmm`` and ``pw.stdlib.ml.datasets`` of the port against
the JAX package's. The HMM reducer: the case of
``tests/test_stdlib_misc.py:10`` and a seeded observation stream with
several groups over several ticks and a beam cut, with equal update streams
(states and beams exact: both packages do the same ``math`` on Python
floats). The datasets:
``sklearn.datasets.fetch_openml`` is replaced in both packages by a
function returning seeded arrays, so nothing is downloaded; the four
tables of ``load_mnist_sample`` (and its alias ``load_mnist_stream``)
are equal, keys and values exact. Without scikit-learn the loader raises
the reference's ``ImportError``. The JAX side runs with
``PATHWAY_COMPILED_TICK=0``."""

import sys

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_streams_equal, markdown, norm, streams

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def hmm_module(pw):
    from importlib import import_module

    return import_module(f"{pw.__name__}.stdlib.ml.hmm")


def weather(pw):
    h = hmm_module(pw)
    return h.DenseHMM(
        states=["rain", "sun"],
        initial={"rain": 0.5, "sun": 0.5},
        transitions={("rain", "rain"): 0.7, ("rain", "sun"): 0.3, ("sun", "rain"): 0.3, ("sun", "sun"): 0.7},
        emission=lambda s, o: 0.9 if (s == "rain") == (o == "umbrella") else 0.1,
    )


def test_hmm_reducer_viterbi_filtering():
    def build(pw):
        h = hmm_module(pw)
        t = pw.debug.table_from_markdown(
            """
            g | obs      | __time__
            1 | umbrella | 2
            1 | umbrella | 4
            1 | shades   | 6
            1 | shades   | 8
            """
        )
        res = t.groupby(t.g).reduce(t.g, beam=h.create_hmm_reducer(weather(pw))(t.obs))
        return res.select(res.g, state=pw.apply(h.most_likely_state, res.beam))

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want, tol=0.0)
    assert got[-1][3] == (("g", 1), ("state", "sun"))


def _three_state(pw):
    h = hmm_module(pw)
    states = ["a", "b", "c"]
    trans = {(s0, s1): (0.6 if s0 == s1 else 0.2) for s0 in states for s1 in states}
    trans[("c", "a")] = 0.0  # a forbidden move: -inf in the beam
    return h.DenseHMM(states=states, initial={"a": 0.5, "b": 0.3, "c": 0.2}, transitions=trans,
                      emission=lambda s, o: {"a": 0.7, "b": 0.2, "c": 0.1}[s] if o == "x"
                      else {"a": 0.1, "b": 0.3, "c": 0.6}[s])


@pytest.mark.parametrize("beam_size", [None, 2])
def test_hmm_seeded_stream_over_groups(beam_size):
    """Observations arrive over several ticks into three groups (stateful
    reducers take append-only input in both packages)."""
    rng = np.random.default_rng(3)
    rows, t = [], 2
    for i in range(40):
        rows.append((100 + i, int(rng.integers(3)), "x" if rng.random() < 0.5 else "y", t, 1))
        t += 2 * int(rng.random() < 0.5)

    def build(pw):
        h = hmm_module(pw)
        obs = pw.debug.table_from_markdown(markdown(["g", "obs"], rows))
        res = obs.groupby(obs.g).reduce(obs.g, beam=h.create_hmm_reducer(_three_state(pw), beam_size)(obs.obs))
        return res.select(res.g, res.beam, state=pw.apply(h.most_likely_state, res.beam))

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want, tol=0.0)
    assert len({dict(e[3])["g"] for e in got}) == 3
    if beam_size is not None:
        assert all(len(dict(e[3])["beam"]) <= beam_size for e in got)


def _fake_openml(n=60_010, d=4, seed=5):
    """MNIST's layout at a narrow width: the loader's test split starts at
    row 60,000."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n, d)).astype(np.float64)
    y = np.array([str(v) for v in rng.integers(0, 10, size=n)], dtype=object)

    def fetch_openml(name, version=1, return_X_y=False, as_frame=True, **kw):
        assert name == "mnist_784" and return_X_y and not as_frame
        return x, y

    return fetch_openml


@pytest.mark.parametrize("loader", ["load_mnist_sample", "load_mnist_stream"])
def test_datasets_mnist_with_openml_replaced(monkeypatch, loader):
    import sklearn.datasets

    monkeypatch.setattr(sklearn.datasets, "fetch_openml", _fake_openml())
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        tables = getattr(pw.stdlib.ml.datasets.classification, loader)(sample_size=70)
        got = []
        for t in tables:
            keys, cols = pw.debug.table_to_dicts(t)
            col = t.column_names()[0]
            got.append((col, {int(k): norm(tuple(np.asarray(cols[col][k]).ravel().tolist()))
                              if col == "data" else norm(cols[col][k]) for k in keys}))
        out[name] = got
    assert out["port"] == out["jax"]
    sizes = [len(rows) for _c, rows in out["port"]]
    assert sizes == [60, 60, 10, 10]
    assert all(0.0 <= v <= 1.0 for vec in out["port"][0][1].values() for v in vec)


def test_datasets_without_sklearn_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match="requires scikit-learn"):
        tpw.stdlib.ml.datasets.classification.load_mnist_sample(70)
