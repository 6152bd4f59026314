"""The port's other index kinds against the JAX package's, op by op and
index object by index object, on the same seeded numpy inputs
(``device="cpu"`` on the port side):

* ``ops/segment.py``: ``segment_sum``/``_count``/``_mean``/``_max``/``_min``
  with empty segments and ids out of range — exact for int32, atol 1e-6 for
  f32 (the sums run in another order);
* ``ops/lsh.py``: the same planes and offsets; bucket ids exact on
  small-integer inputs and planes (every f32 projection exact), and on
  random data exact except where a projection lies within 1e-4 x
  ``bucket_length`` of a cell edge;
* ``ops/ivf.py``: ``assign_clusters`` ids exact on data with clear margins,
  ``train_centroids`` within 1e-5, ``IvfDeviceIndex.query`` the same ids
  (scores within 1e-5) on a seeded 20k mixture;
* ``Bm25Index``, ``LshKnnIndex`` and ``IvfKnnIndex`` over seeded streams of
  upserts, removes, filtered queries and ``k <= 0``: the same replies, keys
  exact and scores within 1e-5; ``IvfKnnIndex`` below ``min_train``, across
  its training point and across a retrain; ``state_dict``/``load_state``
  (and ``Bm25Index``'s whole pickle) across the packages both ways;
* the reference's own cases of ``tests/test_ivf.py`` on the index objects,
  as parity cases.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import ivf as jivf
from pathway_tpu.ops import lsh as jlsh
from pathway_tpu.ops import segment as jseg
from pathway_tpu.stdlib.indexing import _index_impls as jimpl
from pathway_tpu_torch.ops import ivf as tivf
from pathway_tpu_torch.ops import lsh as tlsh
from pathway_tpu_torch.ops import segment as tseg
from pathway_tpu_torch.persistence import _pickle
from pathway_tpu_torch.stdlib.indexing import _index_impls as timpl

CPU = {"device": "cpu"}
F32_ATOL = 1e-6  # segment sums / means of N(0, 1) values, another sum order
SCORE_ATOL = 1e-5  # index scores and IVF scores, f32 sums in another order
CENTROID_ATOL = 1e-5
LSH_EDGE = 1e-4  # of bucket_length


# --- segment ops ---------------------------------------------------------------

SEG_OPS = ["segment_sum", "segment_mean", "segment_max", "segment_min"]


def _segment_inputs(dtype, n=4000, s=64, trailing=()):
    rng = np.random.default_rng(3)
    ids = rng.integers(-4, s + 4, size=n).astype(np.int32)  # some out of range
    ids[np.isin(ids, [5, 17, 40])] = 6  # segments 5, 17 and 40 stay empty
    if dtype == np.int32:
        vals = rng.integers(-1000, 1000, size=(n, *trailing)).astype(np.int32)
    else:
        vals = rng.normal(size=(n, *trailing)).astype(np.float32)
    return vals, ids, s


@pytest.mark.parametrize("trailing", [(), (3,)], ids=["1d", "2d"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("op", SEG_OPS)
def test_segment_op_equals_reference(op, dtype, trailing):
    vals, ids, s = _segment_inputs(dtype, trailing=trailing)
    ref = np.asarray(getattr(jseg, op)(jnp.asarray(vals), jnp.asarray(ids), s))
    got = getattr(tseg, op)(torch.from_numpy(vals), torch.from_numpy(ids), s).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype.kind == "i" or op in ("segment_max", "segment_min"):
        np.testing.assert_array_equal(got, ref)  # ints, and the identities of empty segments
    else:
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)
    empty = ~np.isin(np.arange(s), ids)
    assert empty[[5, 17, 40]].all()


def test_segment_count_equals_reference():
    _vals, ids, s = _segment_inputs(np.int32)
    ref = np.asarray(jseg.segment_count(jnp.asarray(ids), s))
    got = tseg.segment_count(torch.from_numpy(ids), s).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_segment_ops_are_exported_as_in_the_reference():
    import pathway_tpu.ops as jops
    import pathway_tpu_torch.ops as tops

    for name in ("segment_sum", "segment_count", "segment_mean"):
        assert name in jops.__all__ and name in tops.__all__
        assert getattr(tops, name) is getattr(tseg, name)


# --- LSH -------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 8, 4, 4.0), (384, 20, 10, 10.0)], ids=["small", "defaults"])
def test_make_projections_draws_the_reference_planes(shape):
    dim, n_or, n_and, w = shape
    jp, jo = jlsh.make_projections(dim, n_or, n_and, w, seed=42)
    tp, to = tlsh.make_projections(dim, n_or, n_and, w, seed=42, **CPU)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("n_and", [1, 4, 10])
def test_lsh_buckets_exact_on_small_integers(n_and):
    """Small-integer vectors, planes and offsets: every projection and the
    division by a power-of-two bucket length are exact in f32, so the bucket
    ids (with the uint32 wraparound of the AND-combine) must be equal."""
    rng = np.random.default_rng(n_and)
    x = rng.integers(-9, 10, size=(500, 16)).astype(np.float32)
    planes = rng.integers(-3, 4, size=(6, n_and, 16)).astype(np.float32)
    offsets = rng.integers(0, 4, size=(6, n_and)).astype(np.float32)
    ref = np.asarray(jlsh.lsh_buckets(jnp.asarray(x), jnp.asarray(planes), jnp.asarray(offsets), 4.0))
    got = tlsh.lsh_buckets(torch.from_numpy(x), torch.from_numpy(planes), torch.from_numpy(offsets), 4.0).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (ref < 0).any() and (ref >= 0).any()  # both halves of the uint32 range


def test_lsh_buckets_random_data_differ_only_at_cell_edges():
    planes, offsets = tlsh.make_projections(64, 20, 10, 10.0, seed=42, **CPU)
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3000, 64)) * 3).astype(np.float32)
    ref = np.asarray(jlsh.lsh_buckets(jnp.asarray(x), jnp.asarray(planes.numpy()), jnp.asarray(offsets.numpy()), 10.0))
    xt = torch.from_numpy(x)
    got = tlsh.lsh_buckets(xt, planes, offsets, 10.0).numpy()
    cells = (torch.einsum("nd,oad->noa", xt, planes) + offsets[None]) / 10.0
    edge = ((cells - torch.round(cells)).abs() < LSH_EDGE).flatten(1).any(dim=1).numpy()
    differ = (got != ref).any(axis=1)
    assert not (differ & ~edge).any()


# --- IVF ops ---------------------------------------------------------------------


def _clustered(n, dim, n_centers, noise, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, dim)).astype(np.float32) * 5
    asn = rng.integers(0, n_centers, size=n)
    return (centers[asn] + noise * rng.normal(size=(n, dim))).astype(np.float32), centers


@pytest.mark.parametrize("n", [1, 7, 1000, 3000])
def test_assign_clusters_equals_reference(n):
    x, centers = _clustered(n, 16, 12, 0.05, seed=n)
    ref = jivf.assign_clusters(x, centers)
    got = tivf.assign_clusters(x, centers, **CPU)
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)


def test_assign_clusters_empty_and_first_index_on_ties():
    assert tivf.assign_clusters(np.zeros((0, 4), np.float32), np.eye(4, dtype=np.float32), **CPU).shape == (0,)
    c = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)  # centroids 0 and 1 tie
    x = np.array([[2.0, 0.0], [0.0, 3.0]], np.float32)
    np.testing.assert_array_equal(tivf.assign_clusters(x, c, **CPU), jivf.assign_clusters(x, c))
    assert tivf.assign_clusters(x, c, **CPU)[0] == 0


def _lloyd_margin(sample, n_clusters, n_iters, seed):
    """The smallest gap between a point's nearest and second-nearest
    centroid over every iteration of the reference's Lloyd loop, in f64 and
    relative to the largest distance: above ~100 f32 epsilons no assignment
    depends on the sum order (the test data's "clear margins")."""
    rng = np.random.default_rng(seed)
    n = len(sample)
    c = sample[rng.choice(n, size=n_clusters, replace=False)].astype(np.float64)
    x, gap = sample.astype(np.float64), np.inf
    for _ in range(n_iters):
        d = np.sum(c * c, axis=1)[None] - 2 * x @ c.T
        s = np.sort(d, axis=1)
        gap = min(gap, float(np.min(s[:, 1] - s[:, 0]) / np.abs(s).max()))
        a = d.argmin(axis=1)
        sums = np.zeros_like(c)
        np.add.at(sums, a, x)
        cnt = np.bincount(a, minlength=n_clusters).astype(np.float64)
        empty = cnt == 0
        cnt[empty] = 1
        c = sums / cnt[:, None]
        if empty.any():
            c[empty] = sample[rng.choice(n, size=int(empty.sum()), replace=False)]
    return gap


# (clusters, iterations, blobs, blob noise, data seed): more blobs than
# clusters, so no initial draw splits a blob (a split blob has points on the
# bisector of two centroids, where f32 sum order decides)
TRAIN_CASES = [(4, 10, 16, 0.05, 8), (8, 10, 32, 0.05, 4), (8, 3, 32, 0.05, 9), (8, 10, 64, 0.05, 5),
               (16, 10, 128, 0.02, 10)]


@pytest.mark.parametrize("n_clusters,n_iters,blobs,noise,data_seed", TRAIN_CASES)
def test_train_centroids_equals_reference(n_clusters, n_iters, blobs, noise, data_seed):
    x, _c = _clustered(2000, 16, blobs, noise, seed=data_seed)
    assert _lloyd_margin(x, n_clusters, n_iters, seed=4) > 1e-5
    ref = jivf.train_centroids(x, n_clusters, n_iters=n_iters, seed=4)
    got = tivf.train_centroids(x, n_clusters, n_iters=n_iters, seed=4, **CPU)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=CENTROID_ATOL, rtol=0)


@pytest.fixture(scope="module")
def mixture_20k():
    rng = np.random.default_rng(0)
    n, dim = 20_000, 64
    centers = rng.normal(size=(200, dim)).astype(np.float32)
    asn = rng.integers(0, 200, size=n)
    corpus = (centers[asn] + 0.35 * rng.normal(size=(n, dim))).astype(np.float32)
    qs = corpus[rng.choice(n, 10)] + 0.1 * rng.normal(size=(10, dim)).astype(np.float32)
    return corpus, qs


@pytest.fixture(scope="module")
def ivf_device_pair(mixture_20k):
    corpus, _qs = mixture_20k
    return (jivf.IvfDeviceIndex(corpus, n_probe=16, spill=2),
            tivf.IvfDeviceIndex(corpus, n_probe=16, spill=2, **CPU))


def test_ivf_device_index_layout_equals_reference(ivf_device_pair):
    ref, got = ivf_device_pair
    assert (got.n_clusters, got.n_probe, got.spill) == (ref.n_clusters, ref.n_probe, ref.spill)
    np.testing.assert_allclose(got.centroids, ref.centroids, atol=CENTROID_ATOL, rtol=0)
    np.testing.assert_array_equal(got.order, ref.order)
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.ends, ref.ends)


@pytest.mark.parametrize("k", [1, 10, 100])
def test_ivf_device_index_query_equals_reference(ivf_device_pair, mixture_20k, k):
    ref, got = ivf_device_pair
    _corpus, qs = mixture_20k
    for q in qs:
        rs, ri = ref.query(q, k)
        gs, gi = got.query(q, k)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gs, rs, atol=SCORE_ATOL, rtol=0)


def test_ivf_device_index_recall_and_dedupe(ivf_device_pair, mixture_20k):
    """The reference's ``test_ivf_device_index_recall_and_speed`` on the
    port: recall@10 >= 0.95 on the mixture, spilled replicas deduped."""
    _ref, got = ivf_device_pair
    corpus, qs = mixture_20k
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    hits = 0
    for q in qs:
        _s, ids = got.query(q, 10)
        assert len(set(ids.tolist())) == 10
        exact = np.argpartition(-(cn @ (q / np.linalg.norm(q))), 9)[:10]
        hits += len(set(ids.tolist()) & set(exact.tolist()))
    assert hits / 100 >= 0.95


def test_ivf_device_index_small_corpus_drops_padding():
    x, _c = _clustered(40, 8, 4, 0.1, seed=9)
    ref = jivf.IvfDeviceIndex(x, n_clusters=8, n_probe=1, spill=1)
    got = tivf.IvfDeviceIndex(x, n_clusters=8, n_probe=1, spill=1, **CPU)
    for q in x[:5]:
        rs, ri = ref.query(q, 50)  # k past the probed lists: padding is dropped
        gs, gi = got.query(q, 50)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gs, rs, atol=SCORE_ATOL, rtol=0)
        assert np.isfinite(gs).all()


# --- index objects over seeded streams -------------------------------------------

WORDS = [f"w{i}" for i in range(40)]
FILTERS = [None, "lang == 'fr'", "n > `20`"]


def _vec(rng, dim=8, scale=1.0):
    return (rng.normal(size=dim) * scale).astype(np.float32)


def _text(rng):
    return " ".join(rng.choice(WORDS, size=int(rng.integers(1, 9))))


def _stream(seed, make_data, n_ops=400, n_keys=160, p_upsert=0.6):
    """(op, ...) tuples: upserts (new and existing keys, metadata with a
    ``lang`` and an ``n``), removes (live and absent keys), and search
    batches with k in {-1, 0, 1, 3, 10} and a filter or none."""
    rng = np.random.default_rng(seed)
    ops, live = [], set()
    for _ in range(n_ops):
        r = rng.random()
        if r < p_upsert or not live:
            key = int(rng.integers(0, n_keys))
            ops.append(("upsert", key, make_data(rng), {"lang": ("en", "fr")[key % 2], "n": key}))
            live.add(key)
        elif r < p_upsert + 0.15:
            key = int(rng.choice(sorted(live))) if rng.random() < 0.8 else n_keys + 7
            ops.append(("remove", key))
            live.discard(key)
        else:
            batch = [(make_data(rng), int(rng.choice([-1, 0, 1, 3, 10])), FILTERS[int(rng.integers(0, 3))])
                     for _ in range(int(rng.integers(1, 5)))]
            ops.append(("search", batch))
    return ops


def _replay(index, ops):
    out = []
    for op in ops:
        if op[0] == "upsert":
            index.upsert(op[1], op[2], op[3])
        elif op[0] == "remove":
            index.remove(op[1])
        else:
            out.append(index.search(op[1]))
    return out


def _assert_replies_equal(got, ref):
    assert len(got) == len(ref)
    for g_batch, r_batch in zip(got, ref):
        assert len(g_batch) == len(r_batch)
        for g, r in zip(g_batch, r_batch):
            assert [k for k, _s in g] == [k for k, _s in r]
            np.testing.assert_allclose([s for _k, s in g], [s for _k, s in r], atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k1,b", [(1.2, 0.75), (2.0, 0.3)])
def test_bm25_index_stream_equals_reference(seed, k1, b):
    ops = _stream(seed, _text)
    ref = _replay(jimpl.Bm25Index(k1=k1, b=b), ops)
    got = _replay(timpl.Bm25Index(k1=k1, b=b), ops)
    assert sum(len(r) for batch in ref for r in batch) > 0
    _assert_replies_equal(got, ref)


LSH_CASES = {
    "l2sq": dict(dimensions=8, metric="l2sq"),
    "cosine": dict(dimensions=8, metric="cosine"),
    "wide_buckets": dict(dimensions=8, n_or=20, n_and=10, bucket_length=10.0),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(LSH_CASES))
def test_lsh_knn_index_stream_equals_reference(case, seed):
    ops = _stream(seed, _vec)
    ref = _replay(jimpl.LshKnnIndex(**LSH_CASES[case]), ops)
    got = _replay(timpl.LshKnnIndex(**LSH_CASES[case], **CPU), ops)
    assert sum(len(r) for batch in ref for r in batch) > 0
    _assert_replies_equal(got, ref)


IVF_CASES = {
    "cosine": dict(dimensions=8, metric="cosine", min_train=48, n_clusters=8),
    "dot": dict(dimensions=8, metric="dot", min_train=48, n_clusters=8, n_probe=3),
    "l2sq": dict(dimensions=8, metric="l2sq", min_train=48),
    "untrained": dict(dimensions=8, metric="cosine", min_train=10**9),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(IVF_CASES))
def test_ivf_knn_index_stream_equals_reference(case, seed):
    ops = _stream(seed, _vec, p_upsert=0.7)
    ref_ix, got_ix = jimpl.IvfKnnIndex(**IVF_CASES[case]), timpl.IvfKnnIndex(**IVF_CASES[case], **CPU)
    ref, got = _replay(ref_ix, ops), _replay(got_ix, ops)
    _assert_replies_equal(got, ref)
    assert got_ix.key_cluster == ref_ix.key_cluster
    assert (got_ix.centroids is None) == (ref_ix.centroids is None) == (case == "untrained")


def test_ivf_knn_index_below_across_training_and_retrain():
    """Below ``min_train`` the index scores everything; the first search
    past it trains; a search past 4x the trained size retrains and
    reassigns every key. Both packages take each step at the same search,
    with the same centroids (1e-5) and assignments (exact)."""
    rng = np.random.default_rng(11)
    x, _c = _clustered(400, 8, 6, 0.4, seed=11)
    ref_ix = jimpl.IvfKnnIndex(dimensions=8, min_train=64, n_clusters=8)
    got_ix = timpl.IvfKnnIndex(dimensions=8, min_train=64, n_clusters=8, **CPU)
    trained_at = []
    for hi in (40, 70, 200, 290, 400):
        for i in range(len(ref_ix.vecs), hi):
            ref_ix.upsert(i, x[i], {"n": i})
            got_ix.upsert(i, x[i], {"n": i})
        qs = [(x[int(j)] + 0.01 * rng.normal(size=8).astype(np.float32), 5, None) for j in rng.integers(0, hi, 4)]
        _assert_replies_equal([got_ix.search(qs)], [ref_ix.search(qs)])
        assert got_ix._trained_size == ref_ix._trained_size
        trained_at.append(ref_ix._trained_size)
        if ref_ix.centroids is not None:
            np.testing.assert_allclose(got_ix.centroids, ref_ix.centroids, atol=CENTROID_ATOL, rtol=0)
            assert got_ix.key_cluster == ref_ix.key_cluster
    assert trained_at == [0, 70, 70, 290, 290]


def test_ivf_knn_index_rejects_a_wrong_width_and_metric():
    with pytest.raises(ValueError, match="metric"):
        timpl.IvfKnnIndex(metric="hamming", **CPU)
    ix = timpl.IvfKnnIndex(dimensions=4, **CPU)
    with pytest.raises(ValueError, match="4-dim"):
        ix.upsert(1, [1.0, 2.0], None)


def test_ivf_remove_and_update_as_in_reference():
    """``tests/test_ivf.py::test_ivf_remove_and_update`` on both packages."""
    out = []
    for ix in (jimpl.IvfKnnIndex(dimensions=2, metric="cosine", min_train=10**9),
               timpl.IvfKnnIndex(dimensions=2, metric="cosine", min_train=10**9, **CPU)):
        ix.upsert(1, [1.0, 0.0], None)
        ix.upsert(2, [0.0, 1.0], None)
        a = ix.search([([1.0, 0.0], 1, None)])
        ix.remove(1)
        b = ix.search([([1.0, 0.0], 1, None)])
        ix.upsert(2, [1.0, 0.0], None)
        c = ix.search([([1.0, 0.0], 1, None)])
        assert a[0][0][0] == 1 and b[0][0][0] == 2 and c[0][0][0] == 2 and c[0][0][1] > -1e-6
        out.append((a, b, c))
    _assert_replies_equal(list(out[1]), list(out[0]))


def test_ivf_recall_as_in_reference():
    """``tests/test_ivf.py::test_ivf_recall_at_scale`` at 30k rows on both
    packages: the same replies, and recall@10 >= 0.95 against exact."""
    rng = np.random.default_rng(1)
    n, dim = 30_000, 16
    centers = rng.normal(size=(64, dim)).astype(np.float32) * 3
    data = centers[rng.integers(0, 64, size=n)] + rng.normal(size=(n, dim)).astype(np.float32) * 0.3
    queries = data[rng.choice(n, size=20, replace=False)]
    res = []
    for ix in (jimpl.IvfKnnIndex(dimensions=dim, min_train=4096),
               timpl.IvfKnnIndex(dimensions=dim, min_train=4096, **CPU)):
        for i in range(n):
            ix.upsert(i, data[i], None)
        res.append(ix.search([(q, 10, None) for q in queries]))
        assert ix.centroids is not None
    _assert_replies_equal([res[1]], [res[0]])
    dn = data / np.linalg.norm(data, axis=1, keepdims=True)
    hits = sum(
        len(set(np.argpartition(-(dn @ (q / np.linalg.norm(q))), 10)[:10].tolist()) & {k for k, _s in res[1][i]})
        for i, q in enumerate(queries)
    )
    assert hits / (10 * len(queries)) >= 0.95


# --- snapshots across the packages --------------------------------------------------


def _filled(pair, make_data, n=120, seed=4):
    rng = np.random.default_rng(seed)
    for i in range(n):
        data, meta = make_data(rng), {"lang": ("en", "fr")[i % 2], "n": i}
        for ix in pair:
            ix.upsert(i, data, meta)
    for i in range(0, n, 9):
        for ix in pair:
            ix.remove(i)
    return [(make_data(rng), 5, f) for f in FILTERS]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["lsh", "ivf"])
def test_index_state_crosses_the_packages(kind, writer):
    """``state_dict`` of one package's index, pickled, loads into the other's
    (the reference's keys: LSH ``buckets``/``vectors``/``metadata``; IVF
    ``vecs``/``metadata``/``centroids``/``key_cluster``/``trained_size``), and
    both answer alike."""
    if kind == "lsh":
        make = lambda: (jimpl.LshKnnIndex(dimensions=8), timpl.LshKnnIndex(dimensions=8, **CPU))  # noqa: E731
        keys = {"buckets", "vectors", "metadata"}
    else:
        make = lambda: (jimpl.IvfKnnIndex(dimensions=8, min_train=32, n_clusters=8),  # noqa: E731
                        timpl.IvfKnnIndex(dimensions=8, min_train=32, n_clusters=8, **CPU))
        keys = {"vecs", "metadata", "centroids", "key_cluster", "trained_size"}
    src_pair, dst_pair = make(), make()
    qs = _filled(src_pair, _vec)
    for ix in src_pair:
        ix.search(qs[:1])  # trains the IVF index
    src = src_pair[0] if writer == "jax" else src_pair[1]
    dst = dst_pair[1] if writer == "jax" else dst_pair[0]
    state = src.state_dict()
    assert set(state) == keys
    blob = pickle.dumps(state) if writer == "jax" else _pickle.dumps(state)
    dst.load_state(_pickle.loads(blob) if writer == "jax" else pickle.loads(blob))
    _assert_replies_equal([dst.search(qs)], [src.search(qs)])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bm25_index_pickle_crosses_the_packages(writer):
    """``Bm25Index`` has no ``state_dict``: the index exec pickles it whole,
    so the port's class sits at the reference's path with its attributes."""
    pair = (jimpl.Bm25Index(), timpl.Bm25Index())
    qs = [(q, 5, f) for q, _k, f in _filled(pair, _text)]
    if writer == "jax":
        restored = _pickle.loads(pickle.dumps(pair[0]))
        assert type(restored) is timpl.Bm25Index
    else:
        restored = pickle.loads(_pickle.dumps(pair[1]))
        assert type(restored) is jimpl.Bm25Index
    assert type(restored.postings).__name__ == "defaultdict"
    assert vars(restored).keys() == vars(pair[0]).keys() == vars(pair[1]).keys()
    _assert_replies_equal([restored.search(qs)], [pair[0].search(qs)])


def test_ivf_snapshot_roundtrip_as_in_reference():
    """``tests/test_ivf.py::test_ivf_snapshot_roundtrip`` on the port."""
    rng = np.random.default_rng(2)
    index = timpl.IvfKnnIndex(dimensions=4, metric="cosine", min_train=32, **CPU)
    for i in range(64):
        index.upsert(i, rng.normal(size=4).astype(np.float32), None)
    index.search([(rng.normal(size=4).astype(np.float32), 3, None)])
    restored = timpl.IvfKnnIndex(dimensions=4, metric="cosine", min_train=32, **CPU)
    restored.load_state(pickle.loads(pickle.dumps(index.state_dict())))
    q = rng.normal(size=4).astype(np.float32)
    assert index.search([(q, 5, None)]) == restored.search([(q, 5, None)])


# --- the device ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "make",
    [
        lambda: timpl.LshKnnIndex(dimensions=4),
        lambda: timpl.IvfKnnIndex(dimensions=4),
        lambda: tlsh.make_projections(4, 2, 2, 1.0),
        lambda: tivf.assign_clusters(np.ones((2, 4), np.float32), np.ones((1, 4), np.float32)),
        lambda: tivf.train_centroids(np.ones((8, 4), np.float32), 2),
        lambda: tivf.IvfDeviceIndex(np.ones((16, 4), np.float32)),
    ],
    ids=["LshKnnIndex", "IvfKnnIndex", "make_projections", "assign_clusters", "train_centroids",
         "IvfDeviceIndex"],
)
def test_default_device_is_cuda(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
