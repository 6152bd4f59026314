"""The in-process device mesh of the port against the JAX package's, on the
same numpy inputs made from a seed. The JAX side runs on
``tests/conftest.py``'s 8-device virtual CPU mesh; the port side on
``make_mesh(n, device="cpu")`` (n CPU shards).

Held, with the tolerance each test states: ``make_mesh`` (shape, placement,
no silent CPU shards without a card), the engine mesh from the env;
``ragged_all_to_all``/``exchange_rows``/``exchange_by_shard`` block for
block and in the same order, the capacity ``ValueError`` included;
``frontier_allreduce``; ``sharded_topk`` at 2, 4 and 8 shards over every
metric with and without bf16 (indices exact, scores within 1e-5, l2sq's
~2·D-sized scores within 1e-3), ties included, and its plain version;
``TpuDenseKnnIndex(mesh=)`` replies and snapshots across the packages;
``TpuKnn(mesh=)`` through ``DataIndex``; ``EncoderRuntime(mesh=)`` at 2
layers and hidden 64 on the converter's weights, the embedder and the
reranker with a mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pathway_tpu.ops import knn as jknn
from pathway_tpu.parallel import collectives as jcoll
from pathway_tpu.parallel import exchange as jex
from pathway_tpu.parallel import mesh as jmesh_mod
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.parallel import collectives as tcoll
from pathway_tpu_torch.parallel import exchange as tex
from pathway_tpu_torch.parallel import mesh as tmesh_mod

F32_ATOL = 1e-5
# l2sq scores are -(|q|^2 - 2 q.c + |c|^2), ~2*D in size
L2_ATOL = 1e-3
SHARDS = [2, 4, 8]


def jmesh(n):
    return jmesh_mod.make_mesh(n, axis_names=("data",))


def tmesh(n):
    return tmesh_mod.make_mesh(n, device="cpu")


@pytest.fixture(autouse=True)
def _engine_mesh_env(monkeypatch):
    """Both packages' engine meshes read the env afresh and are restored."""
    for k in ("PATHWAY_ENGINE_SHARDS", "PATHWAY_MESH_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jmesh_mod, "_engine_mesh", None)
    monkeypatch.setattr(jmesh_mod, "_engine_mesh_resolved", False)
    tmesh_mod.reset_engine_mesh()
    yield
    tmesh_mod.reset_engine_mesh()


# --- the mesh ------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("axes", [("data",), ("data", "model")])
def test_make_mesh_shape_and_placement(n, axes):
    j = jmesh_mod.make_mesh(n, axis_names=axes)
    t = tmesh_mod.make_mesh(n, axis_names=axes, device="cpu")
    assert t.shape == dict(j.shape)
    assert t.axis_names == tuple(j.axis_names)
    assert t.devices.shape == j.devices.shape
    assert [d.type for d in t.devices.flat] == ["cpu"] * n
    assert tmesh_mod._factor_shape(n, len(axes)) == jmesh_mod._factor_shape(n, len(axes))
    assert t.shard_devices("data") == [torch.device("cpu")] * n
    # the reference's backend= keyword maps onto device=
    assert tmesh_mod.make_mesh(n, axis_names=axes, backend="cpu").shape == t.shape


def test_make_mesh_without_a_card_raises_rather_than_build_cpu_shards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh_mod.make_mesh(2)
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh_mod.make_mesh(2, backend="gpu")
    with pytest.raises(ValueError):
        tmesh_mod.make_mesh(0, device="cpu")


def test_default_mesh_round_trip():
    m = tmesh(2)
    tmesh_mod.set_default_mesh(m)
    try:
        assert tmesh_mod.get_mesh() is m
    finally:
        tmesh_mod.set_default_mesh(None)
    assert tmesh_mod.get_mesh() is None


def test_engine_mesh_from_env_and_its_device(monkeypatch):
    import pathway_tpu.parallel as jpar
    import pathway_tpu_torch.parallel as tpar

    assert tmesh_mod.get_engine_mesh() is None
    assert tpar.exchange_topology() == jpar.exchange_topology()
    monkeypatch.setenv("PATHWAY_ENGINE_SHARDS", "4")
    monkeypatch.setenv("PATHWAY_MESH_DEVICE", "cpu")
    # the reference resolves its env once per process: let it read again
    monkeypatch.setattr(jmesh_mod, "_engine_mesh_resolved", False)
    mesh, axis = tmesh_mod.get_engine_mesh()
    assert axis == "data" and mesh.shape == {"data": 4}
    assert tmesh_mod.get_engine_mesh()[0] is mesh  # built once per env value
    assert tpar.exchange_topology() == jpar.exchange_topology() == {
        "engine_shards": 4, "dcn_processes": 1, "sharding_active": True,
    }
    # set_engine_mesh overrides the env until reset
    tmesh_mod.set_engine_mesh(None)
    assert tmesh_mod.get_engine_mesh() is None
    tmesh_mod.reset_engine_mesh()
    assert tmesh_mod.get_engine_mesh()[0].shape == {"data": 4}


def test_engine_mesh_that_cannot_be_built_raises_naming_the_device(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("PATHWAY_ENGINE_SHARDS", "4")
    with pytest.raises(RuntimeError, match="PATHWAY_MESH_DEVICE='cuda'"):
        tmesh_mod.get_engine_mesh()


# --- the exchange ----------------------------------------------------------------


def _dest(n, n_shards, seed, padding=True):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, n_shards, size=n).astype(np.int32)
    if padding:
        dest[rng.random(n) < 0.05] = -1  # rows addressed to no shard are dropped
    return dest


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("n", [1, 100, 1000])
def test_ragged_all_to_all_matches_jax_block_for_block(n_shards, n):
    rng = np.random.default_rng(n + n_shards)
    words = rng.integers(-(2**31), 2**31, size=(n, 3), dtype=np.int64).astype(np.int32)
    dest = _dest(n, n_shards, seed=n)
    got = tex.ragged_all_to_all(words, dest, tmesh(n_shards))
    want = jex.ragged_all_to_all(words, dest, jmesh(n_shards))
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_ragged_all_to_all_capacity(n_shards):
    n = 512
    words = np.arange(n * 2, dtype=np.int32).reshape(n, 2)
    dest = _dest(n, n_shards, seed=3, padding=False)
    per = 1 << (-(-n // n_shards) - 1).bit_length()
    src = np.arange(n) // per
    need = max(int(((src == s) & (dest == r)).sum()) for s in range(n_shards) for r in range(n_shards))
    for pkg, mesh in ((tex, tmesh(n_shards)), (jex, jmesh(n_shards))):
        with pytest.raises(ValueError, match="would drop rows"):
            pkg.ragged_all_to_all(words, dest, mesh, capacity=need - 1)
    got = tex.ragged_all_to_all(words, dest, tmesh(n_shards), capacity=need)
    want = jex.ragged_all_to_all(words, dest, jmesh(n_shards), capacity=need)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _typed_columns(n, seed):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 2**63, size=n).astype(np.uint64) * np.uint64(2) + np.uint64(1),
        rng.normal(size=n),
        rng.choice([-1, 1], size=n).astype(np.int64),
        rng.normal(size=n).astype(np.float32),
        rng.integers(-5, 5, size=n).astype(np.int32),
        rng.random(n) > 0.5,
    ]


@pytest.mark.parametrize("n_shards", SHARDS)
def test_exchange_rows_typed_columns_bit_exact(n_shards):
    cols = _typed_columns(700, seed=n_shards)
    w_t, spec_t = tex.pack_columns(cols)
    w_j, spec_j = jex.pack_columns(cols)
    np.testing.assert_array_equal(w_t, w_j)
    assert spec_t == spec_j
    for a, b in zip(tex.unpack_columns(w_t, spec_t), cols):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert [tex.packable(c) for c in cols] == [jex.packable(c) for c in cols] == [True] * 6
    assert not tex.packable(np.array(["x"], dtype=object))
    dest = (cols[0] % np.uint64(n_shards)).astype(np.int32)
    got = tex.exchange_rows(cols, dest, tmesh(n_shards))
    want = jex.exchange_rows(cols, dest, jmesh(n_shards))
    for s, (g, w) in enumerate(zip(got, want)):
        assert ((g[0] % np.uint64(n_shards)) == s).all(), f"shard {s} received foreign rows"
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_exchange_by_shard_matches_jax(n_shards, dtype):
    rng = np.random.default_rng(7)
    vals = rng.normal(size=(300, 3)).astype(dtype)
    dest = (np.arange(300) * 7 % n_shards).astype(np.int32)
    got, got_counts = tcoll.exchange_by_shard(vals, dest, tmesh(n_shards))
    want, want_counts = jcoll.exchange_by_shard(vals, dest, jmesh(n_shards))
    np.testing.assert_array_equal(got_counts, want_counts)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    with pytest.raises(TypeError):
        tcoll.exchange_by_shard(np.zeros((2, 2), np.int16), [0, 1], tmesh(n_shards))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_frontier_allreduce_matches_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    local = rng.integers(0, 1 << 30, size=n_shards).astype(np.int32)
    mesh = jmesh(n_shards)
    want = np.asarray(
        jcoll.frontier_allreduce(jax.device_put(jnp.asarray(local), NamedSharding(mesh, P("data"))), mesh)
    )
    tm = tmesh(n_shards)
    got = tcoll.frontier_allreduce(local, tm)
    assert [int(t) for t in got] == want.tolist() == [int(local.min())] * n_shards
    assert [t.device for t in got] == tm.shard_devices()
    on_shards = [torch.tensor(int(v), dtype=torch.int32) for v in local]
    assert [int(t) for t in tcoll.frontier_allreduce(on_shards, tm)] == want.tolist()


def test_placements_name_their_mesh_and_axis():
    m = tmesh(4)
    rows, rep = tcoll.sharded_rows(m), tcoll.replicated(m)
    assert rows.mesh is m and rows.axis == "data" and rows.spec == ("data",)
    assert rep.mesh is m and rep.axis is None and rep.spec == ()


# --- sharded top-k ---------------------------------------------------------------


def _random(n, d, b, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, d)).astype(np.float32),
        rng.normal(size=(n, d)).astype(np.float32),
        rng.random(n) > 0.1,
    )


def _assert_topk_equal(s_j, i_j, s_t, i_t, atol):
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    assert i_j.shape == i_t.shape
    np.testing.assert_array_equal(i_t, i_j)
    s_j, s_t = np.asarray(s_j), s_t.float().numpy()
    fin = np.isfinite(s_j)
    assert (fin == np.isfinite(s_t)).all()
    np.testing.assert_allclose(s_t[fin], s_j[fin], atol=atol, rtol=0)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2sq"])
@pytest.mark.parametrize("bf16", [True, False])
def test_sharded_topk_matches_jax(n_shards, metric, bf16):
    """4096 rows: 512 rows per shard at 8 shards, padded to 1024 on the
    device for the kernel's local step."""
    q, c, v = _random(4096, 16, 5, seed=n_shards)
    s_j, i_j = jknn.sharded_topk(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(v), 10, mesh=jmesh(n_shards), metric=metric, bf16=bf16
    )
    m = tmesh(n_shards)
    s_t, i_t = tknn.sharded_topk(q, c, v, 10, mesh=m, metric=metric, bf16=bf16)
    atol = L2_ATOL if metric == "l2sq" else F32_ATOL
    _assert_topk_equal(s_j, i_j, s_t, i_t, atol)
    s_r, i_r = tknn.sharded_topk_ref(q, c, v, 10, mesh=m, metric=metric, bf16=bf16)
    _assert_topk_equal(s_r.numpy(), i_r.numpy(), s_t, i_t, atol)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_topk_ties_follow_the_reference(n_shards):
    """Integer-grid vectors (exact scores): duplicated rows across shards
    and a run of identical rows tie exactly; the lower shard, then the
    lower row wins, as lax.top_k over the tiled all-gather; an all-invalid
    shard and k past the valid rows give -1."""
    rng = np.random.default_rng(11)
    n, d = 2048, 8
    c = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    c[n // 2 :] = c[: n // 2]  # every row repeats in the other half
    c[:64] = c[0]
    q = np.concatenate([c[:1], rng.integers(-3, 4, size=(3, d)).astype(np.float32)])
    v = rng.random(n) > 0.2
    v[: n // n_shards] = False  # shard 0 holds no valid row
    for k in (1, 16, 100):
        s_j, i_j = jknn.sharded_topk(
            jnp.asarray(q), jnp.asarray(c), jnp.asarray(v), k, mesh=jmesh(n_shards), metric="dot", bf16=False
        )
        s_t, i_t = tknn.sharded_topk(q, c, v, k, mesh=tmesh(n_shards), metric="dot", bf16=False)
        _assert_topk_equal(s_j, i_j, s_t, i_t, 0.0)
    sparse = np.zeros(n, bool)
    sparse[[5, n - 3]] = True
    s_t, i_t = tknn.sharded_topk(q, c, sparse, 4, mesh=tmesh(n_shards), metric="dot", bf16=False)
    assert (i_t[:, 2:] == -1).all() and not torch.isfinite(s_t[:, 2:]).any()


def test_sharded_topk_takes_per_shard_slices_and_checks_the_split():
    q, c, v = _random(2048, 8, 2, seed=5)
    m = tmesh(4)
    whole = tknn.sharded_topk(q, c, v, 7, mesh=m)
    slices = tknn.shard_rows(c, m)
    assert [s.shape[0] for s in slices] == [512] * 4
    parts = tknn.sharded_topk(q, slices, tknn.shard_rows(v, m), 7, mesh=m)
    assert torch.equal(whole[1], parts[1]) and torch.equal(whole[0], parts[0])
    prepared = [tknn.prepare_corpus(s, "cosine", True) for s in slices]
    again = tknn.sharded_topk(q, c, v, 7, mesh=m, prepared=prepared)
    assert torch.equal(whole[1], again[1])
    with pytest.raises(ValueError, match="multiple of the shard count"):
        tknn.sharded_topk(q, c[:2047], v[:2047], 7, mesh=m)


def test_sharded_topk_counts_no_kernel_launch_on_the_cpu():
    from pathway_tpu_torch.ops import block_topk as bt

    before = bt.block_topk.launches
    q, c, v = _random(4096, 8, 2, seed=6)
    tknn.sharded_topk(q, c, v, 5, mesh=tmesh(4))
    assert bt.block_topk.launches == before


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sharded_device_corpus_aligns_capacity_like_the_reference(n_shards):
    from pathway_tpu.parallel.collectives import sharded_rows as jrows

    jm, tm = jmesh_mod.make_mesh(n_shards), tmesh(n_shards)
    for cap in (1, 1000, 5000):
        jc = jknn.DeviceCorpus(4, cap, sharding=jrows(jm), valid_sharding=NamedSharding(jm, P("data")))
        tc = tknn.DeviceCorpus(4, cap, sharding=tcoll.sharded_rows(tm), valid_sharding=tcoll.sharded_rows(tm))
        assert tc.capacity == jc.capacity and tc._align == jc._align
        tc.upsert(3, np.ones(4, np.float32))
        corpus, valid = tc.device_arrays()
        assert len(corpus) == len(valid) == n_shards
        assert sum(x.shape[0] for x in corpus) == tc.capacity
        preps, c2s, valids = tc.prepared_arrays("cosine", bf16=True)
        assert [p.dtype for p in preps] == [torch.bfloat16] * n_shards and len(c2s) == len(valids) == n_shards


# --- the index -------------------------------------------------------------------


def _index_pair(n_shards, metric, reserved=16, dim=8):
    from pathway_tpu.stdlib.indexing._index_impls import TpuDenseKnnIndex as J
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex as T

    return (
        J(dimensions=dim, metric=metric, mesh=jmesh(n_shards), reserved_space=reserved),
        T(dimensions=dim, metric=metric, mesh=tmesh(n_shards), reserved_space=reserved, device="cpu"),
    )


def _assert_replies_equal(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [k for k, _s in g] == [k for k, _s in w]
        np.testing.assert_allclose([s for _k, s in g], [s for _k, s in w], atol=atol, rtol=0)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2sq"])
def test_sharded_index_replies_equal_the_reference(n_shards, metric):
    """Upserts past the reservation (the corpus grows), removals, updates,
    k of 0, 1 and 5, a filter; the replies' keys exact, scores within
    1e-5 (l2sq 1e-3)."""
    j, t = _index_pair(n_shards, metric)
    rng = np.random.default_rng(n_shards)
    vecs = rng.normal(size=(1100, 8)).astype(np.float32)
    for i in range(1100):
        meta = {"g": i % 3}
        j.upsert(i, vecs[i], meta)
        t.upsert(i, vecs[i], meta)
    for i in range(0, 1100, 7):
        j.remove(i)
        t.remove(i)
    for i in range(1, 40, 9):
        j.upsert(i, -vecs[i], {"g": 1})
        t.upsert(i, -vecs[i], {"g": 1})
    assert t.corpus.capacity == j.corpus.capacity and len(t) == len(j)
    asks = [(vecs[12], 3, None), (vecs[8], 5, "g == `1`"), (vecs[9], 0, None), (rng.normal(size=8), 1, None)]
    atol = L2_ATOL if metric == "l2sq" else F32_ATOL
    _assert_replies_equal(t.search(asks), j.search(asks), atol)
    if metric != "dot":  # a row is its own nearest neighbour
        assert t.search(asks[:1])[0][0][0] == 12
    # a snapshot of either package loads into the other's sharded index
    for src, dst in ((t, _index_pair(n_shards, metric)[0]), (j, _index_pair(n_shards, metric)[1])):
        dst.load_state(src.state_dict())
        _assert_replies_equal(dst.search(asks), src.search(asks), atol)
    # compaction keeps the sharding
    t.filter_keys(lambda k: k % 2 == 0)
    j.filter_keys(lambda k: k % 2 == 0)
    assert t.corpus.sharding is not None and t.corpus.capacity == j.corpus.capacity
    _assert_replies_equal(t.search(asks), j.search(asks), atol)


def test_sharded_index_snapshot_of_an_unsharded_index_reupserts():
    """The reference's capacity rule: a snapshot whose capacity differs from
    this index's aligned reservation is re-upserted row by row."""
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex as T

    plain = T(dimensions=4, reserved_space=2048, device="cpu")
    for i in range(10):
        plain.upsert(i, np.full(4, i + 1.0, np.float32), None)
    sharded = T(dimensions=4, mesh=tmesh(3), reserved_space=16, device="cpu")
    sharded.load_state(plain.state_dict())
    assert sharded.corpus.capacity == 3072 and sorted(sharded.keys()) == list(range(10))
    assert [k for k, _s in sharded.search([(np.ones(4, np.float32), 3, None)])[0]] == [0, 1, 2]


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("live", [False, True], ids=["as_of_now", "live"])
def test_tpu_knn_mesh_through_data_index_equals_the_reference(n_shards, live, monkeypatch):
    """``DataIndex(docs, TpuKnn(..., mesh=))`` in both packages over the
    seeded document and query streams of ``test_torch_data_index``: times,
    diffs, ids and matched ids exact, scores within 1e-5."""
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw
    from pathway_tpu.stdlib.indexing import DataIndex as JD, TpuKnn as JK
    from pathway_tpu_torch.stdlib.indexing import DataIndex as TD, TpuKnn as TK
    from test_torch_data_index import _run

    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    for pw in (jpw, tpw):
        pw.internals.parse_graph.G.clear()
    ref = _run(jpw, JD, JK, live, 4, mesh=jmesh(n_shards))
    port = _run(tpw, TD, TK, live, 4, mesh=tmesh(n_shards), device="cpu")
    tpw.internals.parse_graph.G.clear()
    assert [e[:3] for e in port] == [e[:3] for e in ref]
    for (*_a, p), (*_b, r) in zip(port, ref):
        assert p["qname"] == r["qname"] and p["names"] == r["names"] and p["ids"] == r["ids"]
        np.testing.assert_allclose(p["scores"], r["scores"], atol=F32_ATOL, rtol=0)


def test_tpu_knn_factory_passes_the_mesh():
    import pathway_tpu_torch as tpw
    from pathway_tpu_torch.stdlib.indexing import TpuKnnFactory

    tpw.internals.parse_graph.G.clear()
    docs = tpw.debug.table_from_rows(tpw.schema_from_types(vec=np.ndarray), [(np.ones(4, np.float32),)])
    m = tmesh(2)
    inner = TpuKnnFactory(dimensions=4, mesh=m, device="cpu").build_inner_index(docs.vec)
    ix = inner.index_factory()
    assert ix.mesh is m and ix.device == torch.device("cpu")
    tpw.internals.parse_graph.G.clear()


# --- the encoder -----------------------------------------------------------------

DIM, DEPTH, HEADS, VOCAB, MAXLEN = 64, 2, 4, 100, 32
# bf16 compute in both frameworks rounds at other places: each row's
# embedding must have cosine >= 0.999 with the JAX one (unit vectors)
BF16_MIN_COS = 0.999


def _ids(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, size=(n, 16)).astype(np.int32)
    mask = np.ones((n, 16), np.float32)
    lens = rng.integers(1, 17, size=n)
    mask[np.arange(16)[None, :] >= lens[:, None]] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("n_shards", [2, 3, 8])
@pytest.mark.parametrize("n", [1, 5, 13])
def test_encoder_runtime_mesh_matches_jax(n_shards, n):
    from pathway_tpu.xpacks.llm import _encoder as jenc
    from pathway_tpu_torch.convert import flax_to_torch
    from pathway_tpu_torch.xpacks.llm import _encoder as tenc

    kw = dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN)
    jr = jenc.EncoderRuntime(mesh=jmesh(n_shards), **kw)
    tr = tenc.EncoderRuntime(mesh=tmesh(n_shards), device="cpu", **kw)
    plain = tenc.EncoderRuntime(device="cpu", **kw)
    flax_to_torch(jr.params, tr.model)
    flax_to_torch(jr.params, plain.model)
    # the parameters once per distinct device, not once per shard
    assert len(tr._replicas) == 1
    ids, mask = _ids(n, seed=n)
    a, b = jr.forward_ids(ids, mask), tr.forward_ids(ids, mask)
    assert a.shape == b.shape == (n, DIM) and b.dtype == np.float32
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert (cos >= BF16_MIN_COS).all(), cos.min()
    # each row's embedding does not depend on its batch (f32 on the CPU)
    tr.model.dtype = plain.model.dtype = torch.float32
    np.testing.assert_allclose(tr.forward_ids(ids, mask), plain.forward_ids(ids, mask), atol=F32_ATOL, rtol=0)


def test_embedder_and_reranker_take_a_mesh():
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    small = dict(dim=32, depth=1, heads=2, max_len=64)
    m = tmesh(4)
    sharded = SentenceTransformerEmbedder(mesh=m, device="cpu", **small)
    plain = SentenceTransformerEmbedder(device="cpu", **small)
    assert sharded.runtime.mesh is m
    texts = [f"a seeded sentence number {i}" for i in range(11)]
    got, want = np.stack(sharded.embed_batch(texts)), np.stack(plain.embed_batch(texts))
    assert (np.sum(got * want, axis=-1) >= BF16_MIN_COS).all()
    rr = CrossEncoderReranker(mesh=m, device="cpu", dim=32, depth=1, heads=2)
    plain_rr = CrossEncoderReranker(device="cpu", dim=32, depth=1, heads=2)
    assert rr.runtime.mesh is m
    for r in (rr, plain_rr):  # f32 on the CPU: the same sums on any batch split
        r.runtime.model.encoder.dtype = torch.float32
    docs, queries = ["doc a", "doc b", "doc c"], ["q", "q", "q"]
    np.testing.assert_allclose(rr._score_batch(docs, queries), plain_rr._score_batch(docs, queries),
                               atol=F32_ATOL, rtol=0)
