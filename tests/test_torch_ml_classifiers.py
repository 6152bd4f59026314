"""The kNN classifiers, the LSH bucketers and LSH clustering
(``pw.stdlib.ml.classifiers``) of the port against the JAX package's, on
the CPU (``device="cpu"`` on the port's side; the JAX trainer reads only
``d`` of its keyword arguments).

Cases: those of ``tests/test_stdlib_misc.py:96, :134, :160, :193`` under
both packages (bucket ids, ``lsh``'s rows, cluster labels and predicted
labels exact), every trainer alias with the euclidean and the cosine
metric on seeded vectors with a stated score margin at rank k (so the
top-k sets, and with them the majority votes, cannot hang on rounding),
and the slice as a whole: a ``pw.demo.replay_csv`` of labelled documents →
a 2-layer, 32-wide seeded encoder (float32 on both sides) → the cosine
classifier → queries from ``pw.debug.StreamGenerator`` → ``pw.live``, the
very graph ``chip_smoke.py``'s live classify phase runs on the card
(``chip_smoke.lc_pipeline``). Its snapshot's labels equal the JAX
package's, keys exact, query vectors within 1e-5; the subscriber's final
state equals the snapshot; every label equals the majority over a numpy
top-k (at a near tie at rank k, within 1e-4, over one of the tied sets).
The JAX side runs with ``PATHWAY_COMPILED_TICK=0``."""

from itertools import combinations

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from chip_smoke import LC_K, lc_docs, lc_majority, lc_pipeline, lc_write_csv
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from test_torch_components import DIM, _embedder
from torch_parity import norm

PACKAGES = {"jax": jpw, "port": tpw}
VEC_TOL = 1e-5
MARGIN = 1e-4  # least score gap at rank k in the seeded data


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def cls(pw):
    from importlib import import_module

    return import_module(f"{pw.__name__}.stdlib.ml.classifiers")


def _vec_schema(pw, keyed=False):
    if keyed:
        class V(pw.Schema):
            i: int = pw.column_definition(primary_key=True)
            data: pw.internals.dtype.ANY  # type: ignore[valid-type]

        return V

    class U(pw.Schema):
        data: pw.internals.dtype.ANY  # type: ignore[valid-type]

    return U


def final(build):
    """``build(pw)``'s final table under both packages, as {key: row}."""
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        table = build(pw)
        keys, cols = pw.debug.table_to_dicts(table)
        names = table.column_names()
        out[name] = {int(k): tuple(norm(_plain(cols[n][k])) for n in names) for k in keys}
    return out["port"], out["jax"]


def _plain(v):
    return tuple(np.asarray(v).ravel().tolist()) if isinstance(v, np.ndarray) else v


def test_lsh_bucketers_equal_and_locality_sensitive():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8))
    for args in ({"d": 8, "M": 4, "L": 5, "A": 2.0}, {"d": 8, "M": 3, "L": 7, "A": 0.5, "seed": 3}):
        port, ref = (cls(pw).generate_euclidean_lsh_bucketer(**args) for pw in (tpw, jpw))
        for v in x:
            assert port(v).tolist() == ref(v).tolist() and len(port(v)) == args["L"]
    port, ref = (cls(pw).generate_cosine_lsh_bucketer(d=8, M=6, L=3, seed=1) for pw in (tpw, jpw))
    for v in x:
        assert port(v).tolist() == ref(v).tolist()
        assert (port(v) == port(2.5 * v)).all()  # scale-invariant
    buck = cls(tpw).generate_euclidean_lsh_bucketer(d=8, M=4, L=5, A=2.0)
    ones = np.ones(8)
    assert (buck(ones) == buck(ones + 0.01)).sum() >= (buck(ones) == buck(ones + 100.0)).sum()


@pytest.mark.parametrize("include_data", [True, False])
def test_lsh_flatten(include_data):
    rng = np.random.default_rng(1)
    rows = [(v,) for v in rng.normal(size=(6, 8))] + [(np.ones(8),), (np.zeros(8) + 5,)]

    def build(pw):
        t = pw.debug.table_from_rows(_vec_schema(pw), rows)
        buck = cls(pw).generate_euclidean_lsh_bucketer(d=8, M=4, L=5, A=2.0)
        return cls(pw).lsh(t, buck, origin_id="oid", include_data=include_data)

    got, want = final(build)
    assert got == want and len(got) == 8 * 5


def test_clustering_via_lsh():
    rng = np.random.default_rng(0)
    a = rng.normal(0, 0.1, size=(10, 4)) + np.array([10, 0, 0, 0])
    b = rng.normal(0, 0.1, size=(10, 4)) + np.array([-10, 0, 0, 0])

    def build(pw):
        t = pw.debug.table_from_rows(_vec_schema(pw), [(v,) for v in np.vstack([a, b])])
        buck = cls(pw).generate_euclidean_lsh_bucketer(d=4, M=3, L=4, A=4.0)
        return cls(pw).clustering_via_lsh(t, buck, k=2)

    got, want = final(build)
    assert got == want
    labels = [r[0] for r in got.values()]
    assert len(labels) == 20 and sorted([labels.count(0), labels.count(1)]) == [10, 10]


def test_knn_lsh_classify_with_separate_labels():
    vecs = [np.array([10.0, 0]), np.array([11.0, 0]), np.array([-10.0, 0]), np.array([-11.0, 0])]

    def build(pw):
        class L(pw.Schema):
            i: int = pw.column_definition(primary_key=True)
            label: str

        data = pw.debug.table_from_rows(_vec_schema(pw, keyed=True), list(enumerate(vecs)))
        labels = pw.debug.table_from_rows(L, [(0, "right"), (1, "right"), (2, "left"), (3, "left")])
        model = cls(pw).knn_lsh_train(data, d=2, device="cpu")
        queries = pw.debug.table_from_rows(
            _vec_schema(pw, keyed=True), [(100, np.array([9.0, 0])), (101, np.array([-9.0, 0]))])
        return cls(pw).knn_lsh_classify(model, labels, queries, k=2)

    got, want = final(build)
    assert got == want
    assert sorted(r[0] for r in got.values()) == ["left", "right"]


def test_groupby_reduce_majority_is_a_real_majority():
    def build(pw):
        from importlib import import_module

        col = import_module(f"{pw.__name__}.stdlib.utils.col")

        class S(pw.Schema):
            g: int
            v: str

        t = pw.debug.table_from_rows(S, [(1, "a"), (1, "a"), (1, "b"), (2, "x")])
        return col.groupby_reduce_majority(t.g, t.v)

    got, want = final(build)
    assert got == want and sorted(got.values()) == [(1, "a"), (2, "x")]


def _clusters(seed, n, d=6, labels=4):
    """Seeded points around ``labels`` centres (label i at axis i)."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(labels, size=n)
    pts = np.eye(d)[lab] * 3.0 + rng.normal(0, 0.9, size=(n, d))
    return pts, lab


def _margin_ok(train, queries, k, metric):
    """Every query's k-th and (k+1)-th scores differ by more than MARGIN."""
    if metric == "cosine":
        t = train / np.linalg.norm(train, axis=1, keepdims=True)
        s = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ t.T
    else:
        s = -((queries[:, None, :] - train[None, :, :]) ** 2).sum(-1)
    top = -np.sort(-s, axis=1)
    return bool((top[:, k - 1] - top[:, k] > MARGIN).all())


TRAINERS = {
    "knn_lsh_classifier_train": lambda c, t, metric: c.knn_lsh_classifier_train(t, type=metric, d=6, device="cpu"),
    "knn_lsh_train": lambda c, t, metric: c.knn_lsh_train(t, type=metric, d=6, device="cpu"),
    "knn_lsh_generic_classifier_train": lambda c, t, metric: c.knn_lsh_generic_classifier_train(
        t, L=5, type=metric, d=6, device="cpu"),
    "knn_lsh_euclidean_classifier_train": lambda c, t, metric: c.knn_lsh_euclidean_classifier_train(
        t, d=6, M=3, L=5, A=1.0, device="cpu"),
}
# the euclidean trainer has no metric argument
TRAINER_CASES = [(t, m) for t in TRAINERS for m in ("euclidean", "cosine")
                 if not (t == "knn_lsh_euclidean_classifier_train" and m == "cosine")]


@pytest.mark.parametrize("trainer,metric", TRAINER_CASES)
def test_trainers_label_like_the_jax_package(trainer, metric):
    train, lab = _clusters(11, 96)
    queries, qlab = _clusters(12, 24)
    k = 5
    assert _margin_ok(train, queries, k, metric)

    def build(pw):
        t = pw.debug.table_from_rows(
            _train_schema(pw), [(i, v, int(lb)) for i, (v, lb) in enumerate(zip(train, lab))])
        model = TRAINERS[trainer](cls(pw), t, metric)
        q = pw.debug.table_from_rows(_vec_schema(pw, keyed=True), [(1000 + i, v) for i, v in enumerate(queries)])
        return model(q, k=k)

    got, want = final(build)
    assert got == want and len(got) == len(queries)
    # each label is the majority over the numpy top-k of the same rows
    if metric == "cosine":
        s = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ (
            train / np.linalg.norm(train, axis=1, keepdims=True)).T
    else:
        s = -((queries[:, None, :] - train[None, :, :]) ** 2).sum(-1)
    keys = {int(tpw.internals.api.ref_scalar(1000 + i)): i for i in range(len(queries))}
    for key, (pred,) in got.items():
        top = np.argsort(-s[keys[key]], kind="stable")[:k]
        assert pred == lc_majority([int(x) for x in lab[top]])


def _train_schema(pw):
    class T(pw.Schema):
        i: int = pw.column_definition(primary_key=True)
        data: pw.internals.dtype.ANY  # type: ignore[valid-type]
        label: int

    return T


def test_distance_types():
    for pw in PACKAGES.values():
        c = cls(pw)
        assert [m.value for m in c.DistanceTypes] == ["euclidean", "cosine"]


# --- the slice as a whole: a live document classifier -------------------------


def _live_run(pw, csv_path, queries):
    pw.internals.parse_graph.G.clear()
    out = lc_pipeline(pw, csv_path, queries, _embedder(pw), DIM, "cpu")
    lt = pw.live(out)
    state = {}

    def follow(key, row, time, is_addition):
        vals = (row["query"], row["predicted"], row["topic"])
        if is_addition:
            state[int(key)] = vals
        elif state.get(int(key)) == vals:
            del state[int(key)]

    lt.subscribe(follow)
    assert lt.wait(300) and not lt.failed
    _frontier, rows = lt.snapshot()
    lt.stop()
    return rows, state


def test_live_document_classifier_slice(tmp_path):
    docs = lc_docs(101, 192)
    queries = lc_docs(102, 48, first=10**6)
    path = str(tmp_path / "train.csv")
    lc_write_csv(path, docs)
    got, got_state = _live_run(tpw, path, queries)
    want, _ = _live_run(jpw, path, queries)
    assert got.keys() == want.keys() and len(got) == len(queries)
    for k, (q, vec, pred, topic) in got.items():
        wq, wvec, wpred, wtopic = want[k]
        assert (q, pred, topic) == (wq, wpred, wtopic)
        assert np.abs(np.asarray(vec) - np.asarray(wvec)).max() <= VEC_TOL
    assert got_state == {k: (r[0], r[2], r[3]) for k, r in got.items()}
    # every label is the majority over a numpy top-k of the port's own
    # vectors (near ties at rank k, within MARGIN, allow either order)
    emb = _embedder(tpw)
    train = np.stack(emb.embed_batch([t for _d, _l, t in docs]))
    train /= np.linalg.norm(train, axis=1, keepdims=True)
    label_of = np.array([lb for _d, lb, _t in docs])
    near_ties = 0
    for q, vec, pred, topic in got.values():
        s = train @ (np.asarray(vec) / np.linalg.norm(vec))
        order = np.argsort(-s, kind="stable")
        kth = s[order[LC_K - 1]]
        # at a near tie at rank k any of the tied documents may take the
        # last place: the label is the majority of one of those top-k sets
        sure = [j for j in order[:LC_K] if s[j] > kth + MARGIN]
        tied = [j for j in order if abs(s[j] - kth) <= MARGIN]
        allowed = {lc_majority([int(label_of[j]) for j in sure + list(pick)])
                   for pick in combinations(tied, LC_K - len(sure))}
        assert pred in allowed and topic == f"topic-{pred}", (q, pred, allowed)
        near_ties += len(tied) > LC_K - len(sure)
    # the seeded data leaves most top-k sets clear of near ties
    assert near_ties <= len(queries) // 8
