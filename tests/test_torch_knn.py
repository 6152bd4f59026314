"""Port parity: pathway_tpu_torch.ops (knn + block top-k) against
pathway_tpu.ops (knn + the Pallas block top-k in interpret mode).

Inputs are made with numpy from a seed and handed to both packages. Top-k
indices must be exactly equal, ties included. Scores: the two frameworks sum
the D products in different orders, so float32 scores agree within 1e-5;
tie tests use integer-grid data whose products and sums are exact in f32,
so there the scores must be bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import knn as jknn
from pathway_tpu.ops import pallas_topk as jpt
from pathway_tpu_torch.ops import block_topk as tbt
from pathway_tpu_torch.ops import knn as tknn

F32_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _random(n, d, b, seed):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    valid = rng.random(n) > 0.1
    return corpus, queries, valid


def _grid_with_ties(n, d, b, seed):
    """Integer-grid vectors (exact dot products at any summation order),
    duplicated rows (exact ties), invalid rows and one fully invalid
    1024-row block."""
    rng = np.random.default_rng(seed)
    corpus = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    dup = rng.choice(n, size=n // 4, replace=False)
    corpus[dup] = corpus[rng.choice(n, size=n // 4)]
    corpus[: n // 8] = corpus[0]  # a long run of identical rows
    queries = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
    valid = rng.random(n) > 0.2
    if n >= 2048:
        valid[1024:2048] = False
    return corpus, queries, valid


def _assert_topk_equal(s_j, i_j, s_t, i_t, atol):
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    assert i_j.shape == i_t.shape
    assert (i_j == i_t).all()
    s_j, s_t = np.asarray(s_j), s_t.float().numpy()
    fin = np.isfinite(s_j)
    assert (fin == np.isfinite(s_t)).all()
    assert np.allclose(s_j[fin], s_t[fin], atol=atol, rtol=0)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2sq"])
@pytest.mark.parametrize("bf16", [False, True])
def test_dense_topk_matches_jax(metric, bf16):
    corpus, queries, valid = _random(3000, 32, 5, seed=1)
    s_j, i_j = jknn.dense_topk(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(valid), 7,
        metric=metric, bf16=bf16,
    )
    s_t, i_t = tknn.dense_topk(_t(queries), _t(corpus), _t(valid), 7, metric=metric, bf16=bf16)
    # l2sq scores are ~2*D in size: relative f32 tolerance of the same order
    atol = F32_ATOL * (100 if metric == "l2sq" else 1)
    _assert_topk_equal(s_j, i_j, s_t, i_t, atol)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2sq"])
@pytest.mark.parametrize("bf16", [False, True])
def test_prepare_corpus_matches_jax(metric, bf16):
    corpus, _q, _v = _random(2048, 16, 1, seed=2)
    p_j, c2_j = jknn.prepare_corpus(jnp.asarray(corpus), metric, bf16)
    p_t, c2_t = tknn.prepare_corpus(_t(corpus), metric, bf16)
    assert p_t.dtype == (torch.bfloat16 if bf16 else torch.float32)
    # bf16 casts round the same f32 value the same way (RNE); the f32
    # normalisation itself may differ by an ulp, which bf16 rounding can
    # turn into one bf16 ulp (2**-8 relative)
    atol = 2**-8 if bf16 else 1e-6
    assert np.allclose(np.asarray(p_j, dtype=np.float32), p_t.float().numpy(), atol=atol)
    assert np.allclose(np.asarray(c2_j), c2_t.numpy(), rtol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2sq"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [4096, 64 * 1024])
def test_dense_topk_prepared_matches_jax(metric, bf16, n):
    """n = 64*1024 takes the two-stage block path of _masked_topk."""
    corpus, queries, valid = _random(n, 16, 3, seed=3)
    p_j, c2_j = jknn.prepare_corpus(jnp.asarray(corpus), metric, bf16)
    s_j, i_j = jknn.dense_topk_prepared(
        jnp.asarray(queries), p_j, c2_j, jnp.asarray(valid), 10, metric=metric, bf16=bf16
    )
    p_t, c2_t = tknn.prepare_corpus(_t(corpus), metric, bf16)
    s_t, i_t = tknn.dense_topk_prepared(
        _t(queries), p_t, c2_t, _t(valid), 10, metric=metric, bf16=bf16
    )
    atol = F32_ATOL * (100 if metric == "l2sq" else 1)
    _assert_topk_equal(s_j, i_j, s_t, i_t, atol)


def test_two_stage_topk_with_ties_matches_one_stage():
    corpus, queries, valid = _grid_with_ties(64 * 1024, 8, 4, seed=4)
    s = tknn._dots(_t(queries), _t(corpus))
    s = torch.where(_t(valid)[None, :], s, -float("inf"))
    s2, i2 = tknn._masked_topk(s, 50)  # two-stage
    s1, i1 = tknn.stable_topk(s, 50)  # one-stage
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    s_j, i_j = jknn._masked_topk(jnp.asarray(s.numpy()), 50)
    assert (np.asarray(i_j) == i2.numpy()).all()


@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_topk_ref_matches_pallas_interpret_with_ties(k, dtype):
    corpus, queries, valid = _grid_with_ties(4096, 16, 3, seed=5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    sc_j, ix_j = jpt.pallas_block_topk(
        jnp.asarray(queries, jdt), jnp.asarray(corpus, jdt), jnp.asarray(valid), k,
        interpret=True,
    )
    sc_t, ix_t = tbt.block_topk(_t(queries).to(tdt), _t(corpus).to(tdt), _t(valid), k)
    assert sc_t.shape == (3, 4, k) and ix_t.dtype == torch.int32
    sc_j, ix_j = np.asarray(sc_j), np.asarray(ix_j)
    fin = np.isfinite(sc_j)
    assert (fin == np.isfinite(sc_t.numpy())).all()
    # grid data: exact scores; finite candidates match exactly (the TPU
    # kernel's indices for -inf slots are unspecified)
    assert (sc_j[fin] == sc_t.numpy()[fin]).all()
    assert (ix_j[fin] == ix_t.numpy()[fin]).all()


@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_dense_topk_kernel_matches_pallas_and_xla_with_ties(k, metric):
    corpus, queries, valid = _grid_with_ties(4096, 16, 3, seed=6)
    if metric == "cosine":
        queries = np.concatenate([queries, corpus[:1]])  # a query equal to row 0
    p_j, c2_j = jknn.prepare_corpus(jnp.asarray(corpus), metric, False)
    s_p, i_p = jpt.pallas_dense_topk(
        jnp.asarray(queries), p_j, jnp.asarray(valid), k, metric=metric, interpret=True
    )
    s_x, i_x = jknn.dense_topk_prepared(
        jnp.asarray(queries), p_j, c2_j, jnp.asarray(valid), k, metric=metric, bf16=False
    )
    p_t, _c2 = tknn.prepare_corpus(_t(corpus), metric, False)
    s_t, i_t = tbt.dense_topk_kernel(_t(queries), p_t, _t(valid), k, metric=metric)
    _assert_topk_equal(s_p, i_p, s_t, i_t, F32_ATOL)
    _assert_topk_equal(s_x, i_x, s_t, i_t, F32_ATOL)


def test_dense_topk_kernel_random_and_wide_k_match_xla():
    """Random floats at k up to 1024 (the kernel's limit) against the XLA
    path (the interpret-mode kernel is too slow at k=1024)."""
    corpus, queries, valid = _random(8192, 32, 4, seed=7)
    p_j, c2_j = jknn.prepare_corpus(jnp.asarray(corpus), "cosine", False)
    p_t, _c2 = tknn.prepare_corpus(_t(corpus), "cosine", False)
    for k in (10, 1024):
        s_x, i_x = jknn.dense_topk_prepared(
            jnp.asarray(queries), p_j, c2_j, jnp.asarray(valid), k, metric="cosine",
            bf16=False,
        )
        s_t, i_t = tbt.dense_topk_kernel(_t(queries), p_t, _t(valid), k, metric="cosine")
        _assert_topk_equal(s_x, i_x, s_t, i_t, F32_ATOL)


def test_block_topk_ranks_every_column_at_k_1024():
    corpus, queries, valid = _grid_with_ties(2048, 8, 2, seed=8)
    sc, ix = tbt.block_topk(_t(queries), _t(corpus), _t(valid), 1024)
    for b in range(2):
        for blk in range(2):
            cols = ix[b, blk].numpy()
            assert sorted(cols.tolist()) == list(range(blk * 1024, (blk + 1) * 1024))
            key = [(-s, c) for s, c in zip(sc[b, blk].tolist(), cols.tolist())]
            assert key == sorted(key)  # score desc, then index asc


def test_block_topk_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 8)
    c = torch.zeros(1024, 8)
    v = torch.ones(1024, dtype=torch.bool)
    with pytest.raises(ValueError):
        tbt.block_topk(q, torch.zeros(1000, 8), torch.ones(1000, dtype=torch.bool), 1)
    with pytest.raises(ValueError):
        tbt.block_topk(q, c, v, 1025)
    with pytest.raises(TypeError):
        tbt.block_topk(q.double(), c.double(), v, 1)
    with pytest.raises(TypeError):
        tbt.block_topk(q, c.bfloat16(), v, 1)
    with pytest.raises(TypeError):
        tbt.block_topk(q, c, v.int(), 1)
    with pytest.raises(ValueError):
        tbt.block_topk(torch.zeros(8, 2).T, c, v, 1)
    with pytest.raises(ValueError):
        tbt.block_topk(q, c, v, -1)
    assert tbt.supported(2048, 1024) and not tbt.supported(2048, 1025)
    assert not tbt.supported(1000, 1)


@pytest.mark.parametrize(
    "b,d,k,qt",
    [
        # one pass over the corpus for B <= 32
        (1, 37, 10, 1), (3, 37, 10, 4), (16, 37, 10, 16), (32, 37, 10, 32), (64, 37, 10, 32),
        (1, 384, 10, 1), (3, 384, 10, 4), (16, 384, 10, 16), (32, 384, 10, 32),
        (64, 384, 10, 32),
        # 145 KB of ring and merge buffer + QT x 4096 f32 queries fit 227 KB up to QT = 4
        (1, 4096, 10, 1), (3, 4096, 10, 4), (16, 4096, 10, 4), (32, 4096, 10, 4),
        (64, 4096, 10, 4),
        # k > 32 keeps [QT, 1024] keys in shared memory as well
        (16, 384, 40, 8), (32, 384, 1024, 8), (64, 4096, 40, 4),
        (None, 60000, 10, None),  # too wide even for one query
    ],
)
def test_query_tile_fits_shared_memory(b, d, k, qt):
    if qt is None:
        with pytest.raises(ValueError):
            tbt._query_tile(1, d, k)
        return
    assert tbt._query_tile(b, d, k) == qt
    assert tbt._smem_bytes(qt, d, k) <= tbt._SMEM_LIMIT
    # the largest power of two that fits: doubling would overflow or exceed B or 32
    assert 2 * qt > min(b, 32) or tbt._smem_bytes(2 * qt, d, k) > tbt._SMEM_LIMIT


def test_block_topk_cpu_path_counts_no_launch():
    before = tbt.block_topk.launches
    corpus, queries, valid = _random(1024, 8, 2, seed=9)
    tbt.block_topk(_t(queries), _t(corpus), _t(valid), 3)
    assert tbt.block_topk.launches == before


def _drive(corpus, ops):
    for op, key in ops:
        if op == "up":
            corpus.upsert(key, np.full(4, key, np.float32))
        else:
            corpus.remove(key)


def test_device_corpus_grow_remove_slot_order_matches_jax():
    rng = np.random.default_rng(10)
    ops = [("up", int(k)) for k in rng.permutation(1500)]
    ops += [("rm", int(k)) for k in rng.choice(1500, 300, replace=False)]
    ops += [("up", int(k)) for k in rng.integers(0, 4000, 1500)]
    cj = jknn.DeviceCorpus(4, capacity=1000)
    ct = tknn.DeviceCorpus(4, capacity=1000, device="cpu")
    _drive(cj, ops)
    _drive(ct, ops)
    assert ct.capacity == cj.capacity and ct.capacity % 1024 == 0
    assert ct.free == cj.free
    assert ct.slot_of == cj.slot_of and ct.key_of == cj.key_of
    assert np.array_equal(ct.host, cj.host)
    assert np.array_equal(ct.valid_host, cj.valid_host)
    dev, valid = ct.device_arrays()
    assert np.array_equal(dev.numpy(), ct.host) and np.array_equal(valid.numpy(), ct.valid_host)
    p1 = ct.prepared_arrays("cosine", False)
    assert ct.prepared_arrays("cosine", False)[0] is p1[0]  # cached until a change
    ct.upsert(5, np.ones(4, np.float32))
    assert ct.prepared_arrays("cosine", False)[0] is not p1[0]
    assert ct.keys_for_slots(np.array([ct.slot_of[5], -1])) == [5, None]


def test_device_corpus_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tknn.DeviceCorpus(4)


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    from pathway_tpu_torch import _build

    assert _build.sources() == ["block_topk", "paged_attention"]
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "k.cu").write_text("// v1\n")
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "k.cu").write_text("// v2\n")
    assert _build._target("k") != first and _build._target("k").parent == tmp_path / "out"
    # without nvcc a build raises instead of falling back
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all(["k"])
    assert _build.build_log("k") == ""
