"""The hand-written CUDA kernels on the card: ``block_topk`` against its
plain version ``block_topk_ref`` and the index's default path through it;
``paged_attention`` against ``paged_attention_ref``, ``decode_step`` with
``kernel="cuda"`` against ``"ref"``, and the decode scheduler's default path
through the kernel; the pipelines of ``chip_smoke.py`` at small sizes, the
windowed index among them (its replies against the plain top-k over the
live documents of ``chip_smoke.wi_oracle``) and the CDC-fed index (a
SQLite table streamed into ``TpuKnn``, its replies against the plain
top-k over the table's rows after every transaction); the launch ledger's
shared memory and split counts against what the built kernels launch with,
a ``/debug/profile`` capture of the card naming ``block_topk``'s kernel, a
supervised two-rank gloo group restarted on the card, a standby
writer's takeover followed by a replica that answers through
``block_topk``, and the live resizes: a KV split ferried to two owners
that decode on the card, a serving plane resized 1 -> 2 shards by the
autoscaler, and a gloo group resized 2 -> 3 ranks by a
``SupervisorActuator``.

These tests need an NVIDIA card (marker ``cuda``) and skip without one. On
the card they run without the JAX package, so this file imports no JAX and
is run with ``python -m pytest --noconftest tests/test_torch_cuda.py``.
For block_topk the data are small integers, so every dot product is exact
in f32 and the kernel must match the plain version bit for bit, ties
included. Paged attention sums random floats in another order than the
plain version: outputs within 1e-5, logits within 1e-4 (as in
``chip_smoke.py``), and empty rows exactly 0."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _grid(n, d, b, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.randint(-2, 3, (n, d), generator=g, device=dev).to(dtype)
    c[: n // 4] = c[0]  # exact ties
    q = torch.randint(-2, 3, (b, d), generator=g, device=dev).to(dtype)
    q[0] = c[0]
    valid = torch.rand(n, generator=g, device=dev) > 0.2
    if n >= 2048:
        valid[1024:2048] = False
    return q, c.contiguous(), valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 16, 32, 40, 64])
@pytest.mark.parametrize("k", [1, 10, 1024])
@pytest.mark.parametrize("d", [384, 37])
def test_block_topk_kernel_matches_plain(dev, dtype, b, k, d):
    from pathway_tpu_torch.ops import block_topk as bt

    q, c, valid = _grid(4096, d, b, dtype, dev)
    before = bt.block_topk.launches
    sc, ix = bt.block_topk(q, c, valid, k)
    torch.cuda.synchronize()
    assert bt.block_topk.launches == before + 1
    sr, ir = bt.block_topk_ref(q, c, valid, k)
    assert torch.equal(ix, ir) and torch.equal(sc, sr)


def test_wrapper_raises_on_bad_cuda_inputs(dev):
    from pathway_tpu_torch.ops import block_topk as bt

    q, c, valid = _grid(2048, 64, 2, torch.float32, dev)
    with pytest.raises(ValueError):
        bt.block_topk(q, c[:1000], valid[:1000], 5)
    with pytest.raises(ValueError):
        bt.block_topk(q.T.contiguous().T, c, valid, 5)
    with pytest.raises(ValueError):
        bt.block_topk(q.cpu(), c, valid, 5)
    with pytest.raises(TypeError):
        bt.block_topk(q.half(), c.half(), valid, 5)


def test_index_default_path_launches_kernel(dev):
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex

    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(3000, 64)).astype(np.float32)
    ix_k = TpuDenseKnnIndex(dimensions=64)
    ix_t = TpuDenseKnnIndex(dimensions=64, kernel="torch")
    for i, v in enumerate(vecs):
        ix_k.upsert(i, v, {"even": i % 2 == 0})
        ix_t.upsert(i, v, {"even": i % 2 == 0})
    queries = [(vecs[i], 5, None) for i in range(7)] + [(vecs[8], 3, "even == `true`")]
    before = bt.block_topk.launches
    got = ix_k.search(queries)
    assert bt.block_topk.launches == before + 1
    ref = ix_t.search(queries)
    assert bt.block_topk.launches == before + 1
    for a, b in zip(got, ref):
        assert [k for k, _s in a] == [k for k, _s in b]
        assert np.allclose([s for _k, s in a], [s for _k, s in b], atol=1e-5)
    assert [r[0][0] for r in got[:7]] == list(range(7))


@pytest.mark.parametrize("dp", [128, 256, 384, 512])
@pytest.mark.parametrize("b,h,p,max_pages", [(1, 1, 8, 3), (8, 4, 16, 16), (5, 3, 4, 40)])
def test_paged_attention_kernel_matches_plain(dev, dp, b, h, p, max_pages):
    from pathway_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(dp + b)
    n_pages = 50
    q = torch.randn(b, h, dp, generator=g, device=dev)
    k = torch.randn(n_pages, h, p, dp, generator=g, device=dev)
    v = torch.randn(n_pages, h, p, dp, generator=g, device=dev)
    pt = torch.randint(0, n_pages, (b, max_pages), generator=g, device=dev, dtype=torch.int32)
    sl = torch.randint(0, max_pages * p + 1, (b,), generator=g, device=dev, dtype=torch.int32)
    sl[0] = 0
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, pt, sl, sm_scale=32**-0.5)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_ref(q, k, v, pt, sl, sm_scale=32**-0.5)
    assert float((got - ref).abs().max()) <= 1e-5
    assert (got[0] == 0).all()


@pytest.mark.parametrize("p", [8, 16])
def test_paged_attention_split_kernel_with_empty_splits(dev, p):
    """S > 1 splits per (b, h) on a 16-page table, with lengths that leave
    every split, all but the first, or none empty; run twice, so the
    arrival counters must have been reset by the first launch."""
    from pathway_tpu_torch.ops import paged_attention as pa

    b, h, dp, max_pages, n_pages = 4, 2, 128, 16, 70
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert pa.split_count(b * h, max_pages, p, dp, sms) > 1
    g = torch.Generator(device=dev).manual_seed(p)
    q = torch.randn(b, h, dp, generator=g, device=dev)
    k = torch.randn(n_pages, h, p, dp, generator=g, device=dev)
    v = torch.randn(n_pages, h, p, dp, generator=g, device=dev)
    pt = torch.randint(0, n_pages, (b, max_pages), generator=g, device=dev, dtype=torch.int32)
    sl = torch.tensor([0, p, p + 1, max_pages * p], dtype=torch.int32, device=dev)
    ref = pa.paged_attention_ref(q, k, v, pt, sl, sm_scale=32**-0.5)
    for _ in range(2):
        got = pa.paged_attention(q, k, v, pt, sl, sm_scale=32**-0.5)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-5
        assert (got[0] == 0).all()


def test_paged_attention_wrapper_raises_on_bad_cuda_inputs(dev):
    from pathway_tpu_torch.ops import paged_attention as pa

    q = torch.randn(2, 2, 128, device=dev)
    k = torch.randn(4, 2, 8, 128, device=dev)
    pt = torch.zeros(2, 3, dtype=torch.int32, device=dev)
    sl = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # a lane width the kernel is not built for
        pa.paged_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                           k[..., :96].contiguous(), pt, sl, sm_scale=1.0)
    with pytest.raises(ValueError):
        pa.paged_attention(q, k, k, pt.cpu(), sl, sm_scale=1.0)
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), k.half(), k.half(), pt, sl, sm_scale=1.0)


def test_decode_step_kernel_matches_ref(dev):
    from pathway_tpu_torch.convert import decoder_params_to_torch
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    cfg = dec.DecoderConfig(max_len=64, page_size=8)
    params = decoder_params_to_torch(dec.init_params(cfg, seed=3), dev)
    pools = {kern: dec.empty_pools(cfg, 10, device=dev) for kern in ("ref", "cuda")}
    pt = torch.zeros(4, cfg.max_pages, dtype=torch.int32, device=dev)
    pt[0, :4] = torch.tensor([1, 2, 3, 4])
    pt[1, :4] = torch.tensor([5, 6, 7, 8])
    toks = [dec.encode_text("paged attention on the card"), dec.encode_text("second row, longer!")]
    for i in range(min(len(t) for t in toks)):
        tok = torch.tensor([toks[0][i], toks[1][i], 0, 0], dtype=torch.int32, device=dev)
        pos = torch.tensor([i, i, 0, 0], dtype=torch.int32, device=dev)
        sl = torch.tensor([i + 1, i + 1, 0, 0], dtype=torch.int32, device=dev)
        out = {}
        for kern, (k, v) in pools.items():
            out[kern], *_ = dec.decode_step(params, tok, pos, k, v, pt, sl, cfg=cfg, kernel=kern)
        assert float((out["cuda"] - out["ref"]).abs().max()) <= 1e-4
    assert float((pools["cuda"][0] - pools["ref"][0]).abs().max()) <= 1e-4


def test_scheduler_default_path_launches_kernel(dev):
    import time

    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, GenerationRequest
    from pathway_tpu_torch.ops import paged_attention as pa
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    s = DecodeScheduler(GenerateConfig())
    try:
        assert s.kernel == "cuda"
        before = pa.paged_attention.launches
        reqs = [
            GenerationRequest(f"r{i}", dec.encode_text(f"ask {i}"), deadline=time.monotonic() + 60,
                              max_new_tokens=8)
            for i in range(3)
        ]
        for r in reqs:
            s.submit(r)
        assert all(r.wait(60)["status"] == 200 for r in reqs)
        assert pa.paged_attention.launches - before == s.stats()["decode_steps"] * 2
        assert s.pool.in_use == 0
    finally:
        s.stop()


def _freeze_mid_decode(s, req, steps):
    import time

    s.submit(req)
    deadline = time.monotonic() + 60
    while s.stats()["decode_steps"] < steps and time.monotonic() < deadline:
        time.sleep(0.002)
    s._step = lambda: time.sleep(0.05)  # the in-process kill: the loop stops
    time.sleep(0.2)


def test_snapshot_round_trip_and_restore_bit_equal_on_the_card(dev, tmp_path, monkeypatch):
    """A scheduler on the card snapshots mid-decode and is frozen; a new one
    restores the store with pages bit-equal to the ledger's bytes, and then
    finishes with the uninterrupted run's tokens."""
    import time

    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, GenerationRequest, KvLedger
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    prompt = dec.encode_text("durable decode on the card")
    kw = dict(max_new_tokens=24, temperature=0.7, top_k=20, seed=3)

    def request(rid):
        return GenerationRequest(rid, list(prompt), deadline=time.monotonic() + 60, **kw)

    s0 = DecodeScheduler(GenerateConfig(max_batch=1))
    try:
        r0 = request("u")
        s0.submit(r0)
        res0 = r0.wait(60)
    finally:
        s0.stop()
    root = str(tmp_path / "kv")
    cfg = GenerateConfig(max_batch=1, snapshot_every=4, store_root=root)
    s1 = DecodeScheduler(cfg)
    try:
        _freeze_mid_decode(s1, request("k"), 32)
        led = KvLedger.restore(root)
        (meta,) = led.live_seqs().values()
        assert meta["n_generated"] > 0
        real_step = DecodeScheduler._step
        monkeypatch.setattr(DecodeScheduler, "_step", lambda self: time.sleep(0.05))
        s2 = DecodeScheduler(cfg)
        try:
            assert s2.restored_seqs == 1 and s2.k_pool.is_cuda
            (seq,) = s2._active
            for (_sid, page_idx), (k, v, _i) in led.live_pages().items():
                pid = seq.pages[page_idx]
                assert s2.k_pool[:, pid].cpu().numpy().tobytes() == k.tobytes()
                assert s2.v_pool[:, pid].cpu().numpy().tobytes() == v.tobytes()
            s2._step = real_step.__get__(s2)  # resume decoding
            deadline = time.monotonic() + 60
            while not s2.finished and time.monotonic() < deadline:
                time.sleep(0.01)
            (res2,) = s2.finished.values()
            assert res2["tokens"] == res0["tokens"]
            assert s2.pool.in_use == 0
        finally:
            s2.stop()
    finally:
        s1.stop()


def test_out_of_thread_snapshot_on_the_card(dev, tmp_path):
    """snapshot() from another thread runs at a step boundary and mirrors
    float32 pages of the decoder's [L, H, P, Dp] shape."""
    import threading
    import time

    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, GenerationRequest
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    s = DecodeScheduler(GenerateConfig(store_root=str(tmp_path / "kv")))
    try:
        hold, go = threading.Event(), threading.Event()
        r = GenerationRequest(
            "bg", dec.encode_text("w" * 40), deadline=time.monotonic() + 60, max_new_tokens=32,
            on_token=lambda _t, _d: (hold.set(), go.wait(30)),
        )
        s.submit(r)
        assert hold.wait(30)  # the decode thread holds at its first token
        go.set()
        out = s.snapshot()
        assert out is not None and out["bytes_written"] > 0 and out["segments_written"] > 0
        for (_sid, _pidx), (k, _v, _i) in s.ledger.live_pages().items():
            assert k.dtype.name == "float32" and k.shape == (2, 4, 16, 128)
        assert r.wait(60)["status"] == 200
    finally:
        s.stop()


# --- the engine path: DataIndex over TpuKnn in a pw pipeline on the card ----


@pytest.fixture
def fresh_graph():
    from pathway_tpu_torch.internals import parse_graph

    parse_graph.G.clear()
    yield
    parse_graph.G.clear()


def _engine_replies(device, live=False, seed=0, n_docs=3000, dim=64):
    """A small pipeline: seeded unit vectors as documents (t=2), one late
    document (t=6) that copies query 0, queries at t=4; replies as
    {qname: (matched ids, scores)} per (time, qname) in emission order."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn

    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n_docs + 8, dim)).astype(np.float32)

    class Doc(pw.Schema):
        name: str = pw.column_definition(primary_key=True)
        vec: np.ndarray

    class Q(pw.Schema):
        qname: str = pw.column_definition(primary_key=True)
        vec: np.ndarray

    rows = [(f"d{i}", vecs[i], 2, 1) for i in range(n_docs)]
    rows.append(("late", vecs[n_docs] * 3.0, 6, 1))
    docs = pw.debug.table_from_rows(Doc, rows, is_stream=True)
    queries = pw.debug.table_from_rows(
        Q, [(f"q{j}", vecs[n_docs + j], 4, 1) for j in range(8)], is_stream=True
    )
    index = DataIndex(docs, TpuKnn(docs.vec, dimensions=dim, device=device))
    ask = index.query if live else index.query_as_of_now
    res = ask(queries.vec, number_of_matches=5).select(
        qname=pw.left.qname, names=pw.right.name, scores=pw.right._pw_index_reply_score
    )
    out = []
    pw.io.subscribe(
        res,
        on_change=lambda key, row, time, is_addition: is_addition
        and out.append((time, row["qname"], row["names"], row["scores"])),
    )
    pw.run()
    return sorted(out, key=lambda e: (e[0], e[1]))


@pytest.mark.parametrize("live", [False, True], ids=["as_of_now", "live"])
def test_engine_pipeline_on_the_card_matches_cpu(dev, fresh_graph, live):
    from pathway_tpu_torch.ops import block_topk as bt

    before = bt.block_topk.launches
    got = _engine_replies("cuda", live)
    assert bt.block_topk.launches > before  # the kernel answered the ticks
    from pathway_tpu_torch.internals import parse_graph

    parse_graph.G.clear()
    ref = _engine_replies("cpu", live)
    assert [e[:3] for e in got] == [e[:3] for e in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[3], r[3], atol=1e-4, rtol=0)


def test_engine_live_update_visible_next_tick(dev, fresh_graph):
    replies = _engine_replies("cuda", live=True)
    first = {q: names for t, q, names, _s in replies if t == 4}
    later = {q: names for t, q, names, _s in replies if t == 6}
    assert "late" not in first["q0"] and later["q0"][0] == "late"


# --- the RAG layer on the card ------------------------------------------------


def _store_replies(device, n_docs=400):
    """A small ``VectorStoreServer`` (f32 embedder, dim 32) over seeded
    documents; plain and filtered ``retrieve_query`` replies by query key."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(500)]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(12, 60)))) + "." for _ in range(n_docs)]

    class Doc(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        data: bytes
        _metadata: pw.Json

    docs = pw.debug.table_from_rows(
        Doc, [(i, t.encode(), {"path": f"d{i % 4}/{i}.txt"}) for i, t in enumerate(texts)]
    )
    emb = SentenceTransformerEmbedder(dim=32, depth=2, heads=2, max_len=64, device=device)
    emb.runtime.model.dtype = torch.float32
    store = VectorStoreServer(
        docs, embedder=emb, splitter=TokenCountSplitter(min_tokens=8, max_tokens=24), device=device
    )
    queries = pw.debug.table_from_rows(
        store.RetrieveQuerySchema,
        [(" ".join(texts[i].split()[:8]), 5, "path == 'd1/%d.txt' || contains(path, 'd2')" % i if i % 2 else None, None)
         for i in range(0, 64, 4)],
    )
    out = {}
    pw.io.subscribe(
        store.retrieve_query(queries),
        on_change=lambda key, row, time, is_addition: is_addition
        and out.__setitem__(int(key), row["result"].value),
    )
    pw.run()
    return out


def test_vector_store_on_the_card_replies_as_on_cpu(dev, fresh_graph):
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.ops import block_topk as bt

    before = dict(bt.block_topk.shapes)
    got = _store_replies("cuda")
    launched = {s: n - before.get(s, 0) for s, n in bt.block_topk.shapes.items() if n > before.get(s, 0)}
    assert launched  # the kernel answered the store's queries
    parse_graph.G.clear()
    ref = _store_replies("cpu")
    assert sorted(got) == sorted(ref) and len(got) == 16
    for key in ref:
        assert [(d["text"], d["metadata"]) for d in got[key]] == [(d["text"], d["metadata"]) for d in ref[key]]
        np.testing.assert_allclose(
            [d["dist"] for d in got[key]], [d["dist"] for d in ref[key]], atol=1e-4, rtol=0
        )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_encoder_on_the_card_scores_as_on_cpu(dev, dtype):
    """Seeded weights are the same on every device: f32 scores within 1e-4,
    bf16 within 2e-2 (the two devices' bf16 kernels round differently)."""
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(300)]
    docs = [" ".join(rng.choice(words, size=int(rng.integers(5, 80)))) for _ in range(40)]
    queries = [" ".join(rng.choice(words, size=4)) for _ in range(40)]
    scores = []
    for device in ("cuda", "cpu"):
        rr = CrossEncoderReranker(device=device)
        rr.runtime.model.encoder.dtype = dtype
        scores.append(np.asarray(rr._score_batch(docs, queries)))
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(scores[0], scores[1], atol=atol, rtol=0)


def test_rest_retrieve_on_the_card_matches_direct_search(dev, fresh_graph):
    """One ``/v1/retrieve`` round trip through the port's REST server with
    the store on the card; the reply against a direct search of the
    store's rows on a plain-torch index (keys exact, scores within 1e-5)."""
    import http.client
    import json
    import socket
    import time

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in range(500)]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(12, 60)))) + "." for _ in range(200)]

    class Doc(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        data: bytes
        _metadata: pw.Json

    docs = pw.debug.table_from_rows(Doc, [(i, t.encode(), {"path": f"d{i}.txt"}) for i, t in enumerate(texts)])
    emb = SentenceTransformerEmbedder(dim=32, depth=2, heads=2, max_len=64, device="cuda")
    emb.runtime.model.dtype = torch.float32
    store = VectorStoreServer(docs, embedder=emb, splitter=TokenCountSplitter(min_tokens=8, max_tokens=24),
                              device="cuda")
    text_of = {}
    pw.io.subscribe(store._graph["chunked_docs"],
                    on_change=lambda key, row, time, is_addition: text_of.__setitem__(int(key), row["text"]))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    thread = store.run_server("127.0.0.1", port, threaded=True)
    query = " ".join(texts[7].split()[:8])
    try:
        reply = None
        for _ in range(600):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                before = bt.block_topk.launches
                conn.request("POST", "/v1/retrieve", body=json.dumps({"query": query, "k": 5}))
                resp = conn.getresponse()
                status, reply = resp.status, json.loads(resp.read())
                conn.close()
                if status == 200 and reply:
                    break
            except ConnectionRefusedError:
                pass
            time.sleep(0.1)
        assert status == 200 and len(reply) == 5
        assert bt.block_topk.launches == before + 1  # the kernel answered it
        (ex,) = [e for e in parse_graph.G.runtime.execs.values() if isinstance(e, ExternalIndexExec)]
        state = ex.index.state_dict()
        plain = TpuDenseKnnIndex(dimensions=32, metric="cosine", reserved_space=state["corpus"]["capacity"],
                                 kernel="torch", device="cuda")
        plain.load_state(state)
        (ref,) = plain.search([(emb.embed_batch([query])[0], 5, None)])
        assert [d["text"] for d in reply] == [text_of[key] for key, _s in ref]
        np.testing.assert_allclose([-d["dist"] for d in reply], [s for _k, s in ref], atol=1e-5, rtol=0)
    finally:
        parse_graph.G.runtime.stop()
        thread.join(timeout=30)
    assert not thread.is_alive()


# --- persistence: a DataIndex on the card restored from its store -----------


def _persisted_index_replies(folder, store, qid_base, n_docs=2000, dim=48, device="cuda"):
    """A persisted ``DataIndex`` over ``TpuKnn(device="cuda")`` fed by
    ``pw.io.fs`` (seeded vectors in a jsonlines file); 8 queries asked once
    the index holds every document, then a clean stop. Returns the replies
    by query, the run's persistence state, and the kernel's launches."""
    import json
    import os
    import threading
    import time

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn

    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((n_docs, dim)).astype(np.float32)
    path = os.path.join(folder, "docs.jsonl")
    if not os.path.exists(path):
        with open(path, "w") as f:
            for i in range(n_docs):
                f.write(json.dumps({"name": f"d{i}", "v": vecs[i].tolist()}) + "\n")

    class Doc(pw.Schema):
        name: str
        v: list

    class Q(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        q: int

    raw = pw.io.jsonlines.read(folder, schema=Doc, mode="streaming")
    docs = raw.select(name=raw.name, vec=pw.apply_with_type(lambda v: np.asarray(v, np.float32), np.ndarray, raw.v))
    index = DataIndex(docs, TpuKnn(docs.vec, dimensions=dim, device=device))
    done = threading.Event()

    class Asker(pw.io.python.ConnectorSubject):
        def run(self):
            rt = pw.internals.parse_graph.G.runtime
            ix = next(ex for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec)).index
            deadline = time.time() + 120
            while len(ix) < n_docs and time.time() < deadline:
                time.sleep(0.02)
            for j in range(8):
                self.next(qid=qid_base + j, q=j * 97)
            self.commit()
            done.wait(120)
            rt.stop()

    asks = pw.io.python.read(Asker(), schema=Q, autocommit_duration_ms=None)
    qv = asks.select(qid=asks.qid, vec=pw.apply_with_type(lambda j: vecs[j] + 0.01, np.ndarray, asks.q))
    res = index.query_as_of_now(qv.vec, number_of_matches=5).select(
        qid=pw.left.qid, names=pw.right.name, scores=pw.right._pw_index_reply_score
    )
    out = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            out[row["qid"] - qid_base] = (row["names"], row["scores"])
            if len(out) == 8:
                done.set()

    pw.io.subscribe(res, on_change=on_change)
    before = bt.block_topk.launches
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(store))
    pw.run(persistence_config=cfg, autocommit_duration_ms=20)
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    return out, drv, bt.block_topk.launches - before


def test_persisted_index_on_the_card_restores_and_replies_as_before(dev, fresh_graph, tmp_path):
    from pathway_tpu_torch.internals import parse_graph

    folder, store = tmp_path / "docs", tmp_path / "store"
    folder.mkdir()
    before, drv0, launched0 = _persisted_index_replies(str(folder), str(store), 0)
    assert not drv0.restored_from_snapshot and launched0 > 0 and len(before) == 8
    parse_graph.G.clear()
    after, drv1, launched1 = _persisted_index_replies(str(folder), str(store), 100)
    assert drv1.restored_from_snapshot and drv1.replayed_events == 0
    assert launched1 > 0  # the restored corpus was searched by the kernel
    assert sorted(after) == sorted(before)
    for j in before:
        assert after[j][0] == before[j][0]
        np.testing.assert_allclose(after[j][1], before[j][1], atol=1e-5, rtol=0)


# --- the other index kinds' device ops (plain torch, no hand kernel) -----------------


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max", "segment_min", "segment_count",
                                "lsh_buckets", "assign_clusters", "ivf_fine"])
def test_index_kind_device_op_on_the_card_matches_cpu(dev, op):
    """Each device op under the IVF/LSH/segment indexes on the card against
    the same call on the CPU: ints and ids exactly (small-integer LSH inputs
    keep every f32 projection exact; the IVF data have clear margins), float
    sums and means within 1e-5 of the segment's sum (mean) of |v| (the
    card's atomics add in another order), IVF scores within 1e-5."""
    from pathway_tpu_torch.ops import ivf, lsh, segment

    rng = np.random.default_rng(0)
    if op.startswith("segment"):
        ids = torch.from_numpy(rng.integers(-3, 260, size=50_000).astype(np.int32))
        ids[ids == 17] = 18  # an empty segment
        for vals in (torch.from_numpy(rng.normal(size=50_000).astype(np.float32)),
                     torch.from_numpy(rng.integers(-500, 500, size=50_000).astype(np.int32))):
            args = (ids, 256) if op == "segment_count" else (vals, ids, 256)
            cpu = getattr(segment, op)(*args)
            card = getattr(segment, op)(*(a.to(dev) if torch.is_tensor(a) else a for a in args)).cpu()
            if cpu.is_floating_point() and op in ("segment_sum", "segment_mean"):
                scale = getattr(segment, op)(vals.abs(), ids, 256).clamp(min=1.0)
                assert ((card - cpu).abs() <= 1e-5 * scale).all()
            else:
                assert torch.equal(card, cpu)
    elif op == "lsh_buckets":
        x = torch.from_numpy(rng.integers(-9, 10, size=(4096, 64)).astype(np.float32))
        planes = torch.from_numpy(rng.integers(-3, 4, size=(20, 10, 64)).astype(np.float32))
        offsets = torch.from_numpy(rng.integers(0, 8, size=(20, 10)).astype(np.float32))
        cpu = lsh.lsh_buckets(x, planes, offsets, 8.0)
        card = lsh.lsh_buckets(x.to(dev), planes.to(dev), offsets.to(dev), 8.0).cpu()
        assert torch.equal(card, cpu)
    elif op == "assign_clusters":
        centers = rng.normal(size=(64, 32)).astype(np.float32) * 5
        x = centers[rng.integers(0, 64, size=20_000)] + 0.05 * rng.normal(size=(20_000, 32)).astype(np.float32)
        np.testing.assert_array_equal(ivf.assign_clusters(x, centers, device=dev),
                                      ivf.assign_clusters(x, centers, device="cpu"))
    else:
        centers = rng.normal(size=(40, 32)).astype(np.float32)
        corpus = centers[rng.integers(0, 40, size=8000)] + 0.35 * rng.normal(size=(8000, 32)).astype(np.float32)
        on_card = ivf.IvfDeviceIndex(corpus, n_probe=6, spill=2, device=dev)
        on_cpu = ivf.IvfDeviceIndex(corpus, n_probe=6, spill=2, device="cpu")
        np.testing.assert_array_equal(on_card.order, on_cpu.order)
        for q in corpus[:8] + 0.1:
            s_card, i_card = on_card.query(q, 10)
            s_cpu, i_cpu = on_cpu.query(q, 10)
            np.testing.assert_array_equal(i_card, i_cpu)
            np.testing.assert_allclose(s_card, s_cpu, atol=1e-5, rtol=0)


# --- the components pipeline: live kNN graph -> pw.iterate -> pw.sql -----------


def _components_run(device, seed=0, families=40, size=6, dim=48):
    """Seeded clustered vectors as documents (families at t=2 and t=4, the
    middle two of some families deleted at t=6); every document asks the
    live index for its 7 nearest; pairs scoring at least -0.5 are edges;
    labels and sizes per time."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn
    from torch_parity import components

    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((families, dim)).astype(np.float32)
    rows = []
    for f in range(families):
        for v in range(size):
            vec = centres[f] + 0.05 * rng.standard_normal(dim).astype(np.float32) * (1 + v)
            t = 2 if f < families * 3 // 4 else 4
            rows.append((f * size + v, vec, t, 1))
            if f % 5 == 0 and v in (2, 3):
                rows.append((f * size + v, vec, 6, -1))

    class Doc(pw.Schema):
        doc: int = pw.column_definition(primary_key=True)
        vec: np.ndarray

    docs = pw.debug.table_from_rows(Doc, rows, is_stream=True)
    index = DataIndex(docs, TpuKnn(docs.vec, dimensions=dim, device=device))
    hits = index.query(docs.vec, number_of_matches=7, collapse_rows=False)
    pairs = hits.select(u=pw.left.doc, w=pw.right.doc, score=pw.right._pw_index_reply_score)
    edges = pairs.filter((pairs.score >= -0.5) & (pairs.u != pairs.w))
    comps = components(pw, edges)
    sizes = pw.sql("SELECT label, COUNT(*) AS size FROM comps GROUP BY label", comps=comps)
    out = {"edges": [], "comps": [], "sizes": []}
    for name, t in (("edges", edges.select(edges.u, edges.w)), ("comps", comps), ("sizes", sizes)):
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition, name=name:
                        out[name].append((time, is_addition, int(key), tuple(sorted(row.items())))))
    pw.run()
    return {k: sorted(v) for k, v in out.items()}


def test_components_pipeline_on_the_card_matches_cpu_and_scipy(dev, fresh_graph):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.ops import block_topk as bt

    before = bt.block_topk.launches
    got = _components_run("cuda")
    assert bt.block_topk.launches >= before + 3  # one live search per tick
    parse_graph.G.clear()
    assert got == _components_run("cpu")
    state: dict = {}
    for t in sorted({e[0] for e in got["edges"]}):
        for _t, add, k, row in (e for e in got["edges"] if e[0] == t):
            state.pop(k, None) if not add else state.__setitem__(k, dict(row))
        labels = {}
        for _t, add, k, row in (e for e in got["comps"] if e[0] <= t):
            labels.pop(k, None) if not add else labels.__setitem__(k, dict(row))
        uw = np.array([(e["u"], e["w"]) for e in state.values()])
        _, lab = connected_components(sp.coo_matrix((np.ones(len(uw)), (uw[:, 0], uw[:, 1]))), directed=False)
        least = {}
        for v in np.unique(uw).tolist():
            least.setdefault(lab[v], v)
        assert {r["v"]: r["label"] for r in labels.values()} == {v: least[lab[v]] for v in np.unique(uw).tolist()}


def _classifier_run(device):
    """A cosine kNN classifier (``pw.stdlib.ml.classifiers``) over seeded
    clusters whose top-k sets are clear of near ties; queries in three
    ticks; pw.live's final snapshot as {key: label}."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.ml.classifiers import knn_lsh_classifier_train

    rng = np.random.default_rng(21)
    dim, labels = 64, 6
    centres = rng.standard_normal((labels, dim)).astype(np.float32)
    lab = rng.integers(labels, size=2000)
    train = centres[lab] + 0.6 * rng.standard_normal((2000, dim)).astype(np.float32)
    qlab = rng.integers(labels, size=48)
    queries = centres[qlab] + 0.6 * rng.standard_normal((48, dim)).astype(np.float32)

    class Doc(pw.Schema):
        doc: int = pw.column_definition(primary_key=True)
        data: np.ndarray
        label: int

    class Q(pw.Schema):
        q: int = pw.column_definition(primary_key=True)
        data: np.ndarray

    docs = pw.debug.table_from_rows(Doc, [(i, v, int(lb)) for i, (v, lb) in enumerate(zip(train, lab))])
    asked = pw.debug.table_from_rows(Q, [(1000 + i, v, 2 + 2 * (i % 3), 1) for i, v in enumerate(queries)],
                                     is_stream=True)
    model = knn_lsh_classifier_train(docs, type="cosine", d=dim, device=device)
    lt = pw.live(model(asked, k=5))
    assert lt.wait(300) and not lt.failed
    _f, rows = lt.snapshot()
    lt.stop()
    return {k: v[0] for k, v in rows.items()}, qlab


def test_knn_classifier_on_the_card_labels_as_on_cpu(dev, fresh_graph):
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.ops import block_topk as bt

    before = bt.block_topk.launches
    got, qlab = _classifier_run("cuda")
    assert bt.block_topk.launches > before  # cosine searches with the kernel
    parse_graph.G.clear()
    want, _ = _classifier_run("cpu")
    assert got == want and len(got) == len(qlab)


def test_live_table_over_a_cuda_index_follows_each_tick(dev, fresh_graph):
    """pw.live over a DataIndex on the card: the run's thread builds and
    launches the kernel; the subscriber's final state equals the
    snapshot, which equals the CPU run's."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn

    def run(device):
        rng = np.random.default_rng(5)
        vecs = rng.standard_normal((300, 32)).astype(np.float32)

        class Doc(pw.Schema):
            doc: int = pw.column_definition(primary_key=True)
            vec: np.ndarray

        docs = pw.debug.table_from_rows(Doc, [(i, v, 2 + 2 * (i % 4), 1) for i, v in enumerate(vecs)],
                                        is_stream=True)
        index = DataIndex(docs, TpuKnn(docs.vec, dimensions=32, device=device))
        hits = index.query(docs.vec, number_of_matches=3, collapse_rows=False)
        lt = pw.live(hits.select(u=pw.left.doc, w=pw.right.doc))
        state = {}
        lt.subscribe(lambda k, row, t, add: state.__setitem__(int(k), (row["u"], row["w"])) if add
                     else state.pop(int(k), None))
        assert lt.wait(300) and not lt.failed
        _f, rows = lt.snapshot()
        lt.stop()
        assert state == {int(k): v for k, v in rows.items()}
        return sorted(rows.values())

    got = run("cuda")
    parse_graph.G.clear()
    assert got == run("cpu") and len(got) == 300 * 3


# --- the windowed index: windows and a behavior decide what the index holds ---


def _windowed_index_run(device):
    """``chip_smoke.wi_pipeline`` at a small size (768 documents in 8
    commits, 4 topics, 12 standing queries, a 2-layer 32-wide float32
    encoder) on ``device``: each part's update stream and the vectors."""
    import pathway_tpu_torch as pw
    from chip_smoke import wi_pipeline, wi_stream
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from torch_parity import wi_tables

    s = wi_stream(5, 768, 8, 4, 12)
    emb = SentenceTransformerEmbedder(dim=32, depth=2, heads=2, max_len=64, device=device)
    emb.runtime.model.dtype = torch.float32
    docs, queries = wi_tables(pw, s)
    tables = wi_pipeline(pw, docs, queries, emb, 32, {"device": device})
    out = {part: [] for part in tables}
    for part, t in tables.items():
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition, into=out[part]:
                        into.append((time, 1 if is_addition else -1, int(key), dict(row))))
    pw.run()
    return s, out


def test_windowed_index_on_the_card_matches_the_plain_topk(dev, fresh_graph):
    """After every commit each standing query's reply equals the plain
    top-k (an f32 matmul and torch.topk on the card) over the live
    documents of ``chip_smoke.wi_oracle``, the interval-join counts equal
    numpy's, and the windows' and counts' streams equal a CPU run's."""
    from chip_smoke import WI_K, wi_counts, wi_oracle
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.ops import block_topk as bt

    before = bt.block_topk.launches
    s, got = _windowed_index_run("cuda")
    assert bt.block_topk.launches >= before + s["commits"]  # one search of every query per change
    lives, _frozen = wi_oracle(s["t"], s["commit"], s["commits"])
    vecs = {r["doc_id"]: np.asarray(r["vec"], dtype=np.float32) for _t, d, _k, r in got["embedded"] if d > 0}
    qvecs = {r["qid"]: np.asarray(r["vec"], dtype=np.float32) for _t, d, _k, r in got["asked"] if d > 0}
    qs = sorted(qvecs)
    q = torch.tensor(np.stack([qvecs[x] for x in qs]), device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    for c in range(s["commits"]):
        tick = 2 * c + 4
        state: dict = {}
        counts: dict = {}
        for t, d, k, r in sorted(got["pairs"], key=lambda e: (e[0], e[1])):
            if t <= tick:
                if d > 0:
                    state[k] = (r["qid"], r["doc_id"], r["score"])
                elif state.get(k) == (r["qid"], r["doc_id"], r["score"]):
                    del state[k]
        for t, d, _k, r in sorted(got["counts"], key=lambda e: (e[0], e[1])):
            if t <= tick:
                if d > 0:
                    counts[r["qid"]] = r["n"]
                elif counts.get(r["qid"]) == r["n"]:
                    del counts[r["qid"]]
        assert counts == wi_counts(s, c)
        live = lives[c]
        m = torch.tensor(np.stack([vecs[int(x)] for x in live]), device=dev)
        m = m / m.norm(dim=-1, keepdim=True)
        sc, ix = torch.topk(q @ m.T, min(WI_K, len(live)), dim=-1)
        sc, ix = sc.cpu().numpy() - 1.0, ix.cpu().numpy()
        for r, qq in enumerate(qs):
            reply = sorted(((dd, ss) for qid, dd, ss in state.values() if qid == qq and dd is not None),
                           key=lambda p: -p[1])
            assert [dd for dd, _ss in reply] == [int(live[j]) for j in ix[r]], (c, qq)
            np.testing.assert_allclose([ss for _dd, ss in reply], sc[r], atol=1e-5, rtol=0)
    parse_graph.G.clear()
    _s, cpu = _windowed_index_run("cpu")

    def plain(events):
        return sorted((t, d, k, tuple(sorted(r.items()))) for t, d, k, r in events)

    assert plain(got["windows"]) == plain(cpu["windows"]) and plain(got["counts"]) == plain(cpu["counts"])


# --- the CDC-fed index: a SQLite table streamed into TpuKnn on the card ---------


def test_cdc_index_on_the_card_matches_the_plain_topk(dev, fresh_graph, tmp_path):
    """``chip_smoke.cdc_pipeline`` at a small size (320 rows, 4
    transactions of 24 inserts, 12 body edits and 12 deletes, 6 standing
    queries, k = 10, a 2-layer 32-wide float32 encoder) with TpuKnn on the
    card: after the load and every transaction each reply equals the plain
    top-k (an f32 matmul and torch.topk on the card) over the table's rows,
    no reply names a deleted row, the Debezium table equals the SQLite
    reader's; the replies read back from SQLite equal the subscribed ones,
    and a static read equals the final table."""
    from chip_smoke import CDC_K, cdc_stream, signed64
    from torch_parity import cdc_run

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    s = cdc_stream(7, 320, 4, 24, 12, 12, 5, 6)
    emb = SentenceTransformerEmbedder(dim=32, depth=2, heads=2, max_len=64, device="cuda")
    emb.runtime.model.dtype = torch.float32
    before = bt.block_topk.launches
    got = cdc_run(pw, str(tmp_path), s, emb, 32, {"device": "cuda"})
    assert bt.block_topk.launches >= before + len(s["txns"])  # every standing query again per change
    qs = sorted(got["qvecs"])
    q = torch.tensor(np.stack([got["qvecs"][x] for x in qs]), dtype=torch.float32, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    for c, snap in enumerate(got["snaps"]):
        live = np.array(sorted(s["live"][c - 1] if c else s["initial"]))
        assert snap["changes"] == snap["docs"] and sorted(r[0] for r in snap["docs"].values()) == live.tolist()
        m = torch.tensor(np.stack([snap["vecs"][int(i)] for i in live]), dtype=torch.float32, device=dev)
        m = m / m.norm(dim=-1, keepdim=True)
        sc, ix = torch.topk(q @ m.T, CDC_K, dim=-1)
        sc, ix = sc.double().cpu().numpy() - 1.0, ix.cpu().numpy()
        for r, qq in enumerate(qs):
            reply = sorted(((d, x) for qid, d, x in snap["pairs"].values() if qid == qq), key=lambda p: -p[1])
            assert [d for d, _x in reply] == [int(live[j]) for j in ix[r]], (c, qq)
            np.testing.assert_allclose([x for _d, x in reply], sc[r], atol=1e-5, rtol=0)
    final = got["snaps"][-1]
    assert {key: (qq, d, x) for qq, d, x, key in got["written"]} == {
        signed64(key): v for key, v in final["pairs"].items()}
    assert got["static"] == final["docs"]


def _replica_child(env_extra: dict):
    """``python -m pathway_tpu_torch.serving.replica`` on the card; returns
    the process and its HTTP port once it prints REPLICA-READY."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root), PATHWAY_REPLICA_DEVICE="cuda", **env_extra)
    proc = subprocess.Popen([sys.executable, "-m", "pathway_tpu_torch.serving.replica"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(root))
    lines = []
    for ln in proc.stdout:
        lines.append(ln)
        if ln.startswith("REPLICA-READY "):
            return proc, int(ln.split()[1])
    raise AssertionError("the replica never became ready: " + "".join(lines[-20:]))


def test_replica_child_on_the_card_answers_as_block_topk_ref(dev, monkeypatch):
    """A replica process on the card follows an in-process delta stream and
    answers ``vec`` reads with the keys and scores of ``block_topk_ref``
    over the same corpus, merged as the index merges (scores within 1e-5:
    the kernel and the plain matmul sum the 64 products in another order)."""
    import http.client
    import json

    from pathway_tpu_torch.engine.batch import DiffBatch
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import _normalize, stable_topk
    from pathway_tpu_torch.parallel.replicate import DeltaStreamServer

    monkeypatch.setenv("PATHWAY_DCN_SECRET", "card-replica-test")
    rng = np.random.default_rng(7)
    n, d, k = 3000, 64, 5
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    keys = [10_000 + i for i in range(n)]
    srv = DeltaStreamServer(0)
    srv.publish(0, [DiffBatch.from_rows([(key, 1, (v, None)) for key, v in zip(keys, vecs)], ("_data", "_meta"))])
    proc, port = _replica_child({"PATHWAY_REPL_PORT": str(srv.port), "PATHWAY_REPLICA_DIM": str(d)})
    try:
        prep = torch.zeros(4096, d, device=dev)
        prep[:n] = _normalize(torch.from_numpy(vecs).to(dev))
        valid = torch.zeros(4096, dtype=torch.bool, device=dev)
        valid[:n] = True
        queries = rng.standard_normal((6, d)).astype(np.float32)
        sc, ix = bt.block_topk_ref(_normalize(torch.from_numpy(queries).to(dev)), prep, valid, k)
        s, pos = stable_topk(sc.reshape(len(queries), -1), k)
        idx = torch.gather(ix.reshape(len(queries), -1), 1, pos)
        for qi, q in enumerate(queries):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/query", json.dumps({"vec": q.tolist(), "k": k}),
                         {"content-type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            assert resp.status == 200
            got = body["matches"]
            assert [m[0] for m in got] == [keys[int(j)] for j in idx[qi]]
            assert np.allclose([m[1] for m in got], (s[qi].double() - 1.0).cpu().numpy(), atol=1e-5)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/replica/kernels")
        launched = json.loads(conn.getresponse().read())
        conn.close()
        assert launched["block_topk_by_shape"] == {f"B=1,k={k}": len(queries)}
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        srv.close()


_BUILD_AND_LAUNCH = """
import sys
from pathlib import Path
import torch
from pathway_tpu_torch import _build
from pathway_tpu_torch.ops import block_topk as bt
_build.BUILD_DIR = Path(sys.argv[1])
g = torch.Generator(device="cuda").manual_seed(3)
c = torch.randint(-2, 3, (2048, 384), generator=g, device="cuda").float()
q = c[:4].clone()
valid = torch.ones(2048, dtype=torch.bool, device="cuda")
sc, ix = bt.block_topk(q, c, valid, 10)
sr, ir = bt.block_topk_ref(q, c, valid, 10)
assert torch.equal(sc, sr) and torch.equal(ix, ir)
print("LAUNCHED", bt.block_topk.launches)
"""


def test_two_processes_build_the_kernel_concurrently(dev, tmp_path):
    """Two processes that find no library start their nvcc together into
    one build directory: each compiles to its own temporary file and
    renames it into place, so both load a whole ``.so`` and launch, and a
    third process loads the one left on disk without building."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LAUNCH, str(build)], cwd=str(root),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 and "LAUNCHED 1" in o for p, o in zip(procs, outs)), outs
    libs = sorted(build.glob("libblock_topk-*.so"))
    assert len(libs) == 1 and not list(build.glob("*.tmp"))
    third = subprocess.run([sys.executable, "-c", _BUILD_AND_LAUNCH + "from pathway_tpu_torch._build import stats\n"
                            "assert stats['builds'] == 0, stats\n", str(build)],
                           cwd=str(root), capture_output=True, text=True, timeout=600)
    assert third.returncode == 0, third.stdout + third.stderr


def _ct_rows(n, seed):
    rng = np.random.default_rng(seed)
    return {"doc_id": np.arange(n, dtype=np.int64), "topic": rng.integers(0, 8, n),
            "ts": 1_700_000_000 + rng.integers(0, 86_400, n), "quality": rng.random(n),
            "flags": rng.integers(0, 16, n)}


def _ct_edges(s):
    """numpy float64 edge values for the lowered cast: NaN, infinities and
    out-of-range values go to int64 as numpy gives them."""
    s["quality"][:6] = [np.nan, np.inf, -np.inf, 1e300, -1e300, 2.0**63]
    return s


def _same_float(g, w, rel) -> bool:
    g, w = float(g), float(w)
    return g == w or abs(g - w) <= rel * abs(w) or (np.isnan(g) and np.isnan(w))


def _ct_graph(pw, rows):
    """A compiled chain and a groupby over one pw.debug table; returns the
    survivors and the groupby as dicts, and the runtime."""
    import pathway_tpu_torch as tpw

    tpw.internals.parse_graph.G.clear()
    cols = list(rows)
    t = pw.debug.table_from_rows(
        pw.schema_from_types(**{c: (float if c == "quality" else int) for c in cols}),
        list(zip(*[rows[c].tolist() for c in cols])))
    scored = t.select(t.doc_id, t.topic, t.flags,
                      score=pw.if_else((t.flags & 4) == 4, t.quality * 1.25, t.quality)
                      - pw.cast(float, abs(t.ts - 1_700_043_200)) * 1e-7,
                      bucket=pw.cast(int, t.quality * 16.0) + t.topic * 16)
    kept = scored.filter(((scored.flags & 3) == 3) | (scored.score > 0.5))
    stats = kept.groupby(kept.topic).reduce(kept.topic, n=pw.reducers.count(), total=pw.reducers.sum(kept.bucket),
                                             mean=pw.reducers.avg(kept.score))
    _k, surv = pw.debug.table_to_dicts(kept)
    rt = tpw.internals.parse_graph.G.last_runtime
    _k, st = pw.debug.table_to_dicts(stats)
    return surv, st, rt


def test_compiled_chain_on_the_card_equals_the_interpreter(dev, fresh_graph, monkeypatch):
    """The compiled segment on cuda gives the interpreter's rows: keys,
    ints and bools exactly, floats within 1e-12 (relative); numpy's casts
    of NaN, infinities and out-of-range floats to int kept; the groupby's
    partials on the card: counts and sums exact, means within 1e-9."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import compile as ct

    rows = _ct_edges(_ct_rows(4096, 0))
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "1")
    monkeypatch.setenv("PATHWAY_COMPILED_DEVICE", "cuda")
    # the interpreter over the same typed ingest: every tick below the
    # segment's minimum, the partials on the host
    monkeypatch.setenv("PATHWAY_COMPILED_MIN_ROWS", str(1 << 30))
    monkeypatch.setenv("PATHWAY_COMPILED_GROUPBY", "0")
    want, want_stats, _rt = _ct_graph(pw, rows)
    monkeypatch.setenv("PATHWAY_COMPILED_MIN_ROWS", "1")
    monkeypatch.delenv("PATHWAY_COMPILED_GROUPBY")
    calls = ct.semigroup_partials.calls
    got, got_stats, rt = _ct_graph(pw, rows)
    (seg,) = [s for s in rt.compiled_plan.segments if s.compiled_ticks]
    assert seg.device.type == "cuda" and seg.fallback_ticks == 0
    assert ct.semigroup_partials.calls > calls
    assert set(got["score"]) == set(want["score"])
    for k in want["score"]:
        assert int(got["bucket"][k]) == int(want["bucket"][k])
        assert _same_float(got["score"][k], want["score"][k], 1e-12)
    for k in want_stats["n"]:
        assert (got_stats["n"][k], got_stats["total"][k]) == (want_stats["n"][k], want_stats["total"][k])
        assert _same_float(got_stats["mean"][k], want_stats["mean"][k], 1e-9)


def test_semigroup_partials_on_the_card_equal_np_add_at(dev, monkeypatch):
    from pathway_tpu_torch.engine import compile as ct

    monkeypatch.setenv("PATHWAY_COMPILED_DEVICE", "cuda")
    rng = np.random.default_rng(9)
    n, nu = 70_000, 300
    codes = rng.integers(0, nu, n).astype(np.int64)
    diffs = rng.choice(np.array([-1, 1, 3], dtype=np.int64), n)
    ints = rng.integers(-(2**40), 2**40, n).astype(np.int64)
    floats = rng.standard_normal(n)
    dcounts, (p_none, p_int, p_float) = ct.semigroup_partials(codes, diffs, [None, ints, floats], nu)
    want_c, want_i, want_f = np.zeros(nu, np.int64), np.zeros(nu, np.int64), np.zeros(nu)
    np.add.at(want_c, codes, diffs)
    np.add.at(want_i, codes, ints * diffs)
    np.add.at(want_f, codes, floats * diffs)
    assert p_none is None and dcounts.tolist() == want_c.tolist() and p_int.tolist() == want_i.tolist()
    np.testing.assert_allclose(p_float, want_f, rtol=1e-9, atol=1e-9)


def test_native_hasher_is_live_on_the_card_machine():
    """The port's native hasher builds with the machine's g++ and Python
    headers and gives the pure-Python keys."""
    from pathway_tpu_torch.internals import api, native

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mod = native.get_native()
    assert mod is not None, native.build_log
    values = (None, True, 7, 2.5, "x", b"y", (1, "z"), api.Pointer(3))
    assert int(api.ref_scalar(*values)) == api._hash_bytes(api._value_bytes(values))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 16, 32, 256, 2048])
@pytest.mark.parametrize("k", [1, 3, 10, 40, 1024])
def test_launch_ledger_smem_is_the_launch(dev, dtype, b, k):
    """What ``analysis/lowering.py`` proves without a GPU is what the built
    kernel sets with cudaFuncSetAttribute and launches with: its shared
    memory and threads, and a grid within the ledger's largest."""
    from pathway_tpu_torch.analysis import lowering
    from pathway_tpu_torch.ops import block_topk as bt

    n, d = 8192, 384
    c = torch.nn.functional.normalize(torch.randn(n, d, device=dev), dim=-1).to(dtype).contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q = c[torch.arange(b, device=dev) % n].contiguous()
    bt.block_topk(q, c, valid, k)
    torch.cuda.synchronize()
    want = lowering.block_topk_launch(b, d, n, k, dtype == torch.bfloat16)
    got = bt.last_launch()
    assert got["smem_bytes"] == want["smem_bytes"] and got["threads"] == want["threads"]
    (gx, gy, gz), (mx, my, mz) = got["grid"], want["grid_max"]
    assert 1 <= gx <= mx and gy == my and gz == mz == 1
    assert want["query_tile"] == bt._query_tile(b, d, k, dtype == torch.bfloat16)


@pytest.mark.parametrize("b,h,p,dp,max_pages", [(8, 4, 16, 128, 16), (1, 4, 16, 128, 16),
                                                 (64, 32, 8, 256, 256), (1, 32, 16, 128, 4096)])
def test_launch_ledger_paged_splits_and_smem_are_the_launch(dev, b, h, p, dp, max_pages):
    from pathway_tpu_torch.analysis import lowering
    from pathway_tpu_torch.ops import paged_attention as pa

    n_pages = max_pages + 1
    q = torch.randn(b, h, dp, device=dev)
    k = torch.randn(n_pages, h, p, dp, device=dev)
    v = torch.randn_like(k)
    pt = torch.randint(0, n_pages, (b, max_pages), device=dev, dtype=torch.int32)
    sl = torch.full((b,), max_pages * p, device=dev, dtype=torch.int32)
    pa.paged_attention(q, k, v, pt, sl, sm_scale=0.1)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = lowering.paged_attention_launch(b, h, p, dp, max_pages, sms)
    got = pa.last_launch()
    assert got["smem_bytes"] == want["smem_bytes"] and got["threads"] == want["threads"]
    assert got["grid"] == want["grid"]
    assert want["splits"] == pa.split_count(b * h, max_pages, p, dp, sms)


def test_debug_profile_on_the_card_names_block_topk(dev):
    """/debug/profile of a monitoring server (default device: the card)
    while block_topk runs: 200, CUDA activity in the capture and the
    kernel's symbol among its kernel events; a concurrent capture 409."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from pathway_tpu_torch.internals.monitoring_server import start_http_server
    from pathway_tpu_torch.observability import debug
    from pathway_tpu_torch.ops import block_topk as bt

    c = torch.nn.functional.normalize(torch.randn(16384, 384, device=dev), dim=-1).contiguous()
    valid = torch.ones(16384, dtype=torch.bool, device=dev)
    q = c[:16].contiguous()
    srv = start_http_server(port=0)
    port = srv.server_address[1]
    out = {}

    def get(target, key):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{target}", timeout=60) as r:
                out[key] = (r.status, r.read())
        except urllib.error.HTTPError as e:
            out[key] = (e.code, e.read())

    try:
        th = threading.Thread(target=get, args=("/debug/profile?seconds=1", "first"))
        th.start()
        while not debug._profile_lock.locked() and th.is_alive():
            pass
        get("/debug/profile?seconds=1", "second")
        while th.is_alive():
            bt.block_topk(q, c, valid, 10)
            torch.cuda.synchronize()
        th.join()
    finally:
        srv.shutdown()
    assert out["second"][0] == 409
    status, body = out["first"]
    assert status == 200, body
    doc = json.loads(body)
    assert doc["device"] == "cuda" and "CUDA" in doc["activities"] and doc["device_events"] > 0
    with open(doc["trace_file"]) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"] if str(e.get("cat", "")).lower() == "kernel"}
    assert any("block_topk_kernel" in n for n in names), sorted(names)[:5]


# --- the in-process device mesh on the card ------------------------------------


def test_mesh_shards_share_the_card(dev):
    """make_mesh(4) on one card: four shards on cuda:0, none on the CPU."""
    from pathway_tpu_torch.parallel import make_mesh

    m = make_mesh(4)
    assert m.shape == {"data": 4}
    assert m.shard_devices() == [torch.device("cuda", i % torch.cuda.device_count()) for i in range(4)]
    assert all(d.type == "cuda" for d in m.devices.flat)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("rows", [4096, 4 * 3000])
def test_sharded_topk_kernel_per_shard_equals_plain(dev, metric, bf16, rows):
    """Each shard's local step launches block_topk once (a slice of 3000
    rows padded to 3072 on the card); integer-grid vectors make every score
    exact, so the merge equals sharded_topk_ref bit for bit, ties included."""
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import sharded_topk, sharded_topk_ref
    from pathway_tpu_torch.parallel import make_mesh

    m = make_mesh(4)
    q, c, valid = _grid(rows, 64, 5, torch.float32, dev)
    if metric == "cosine":  # +-1 rows: norms of 8, so cosine scores stay exact
        c = (torch.sign(c) + (c == 0)).contiguous()
        q = torch.sign(q) + (q == 0)
    before = bt.block_topk.launches, bt.block_topk.corpus_rows.copy()
    sc, ix = sharded_topk(q, c, valid, 10, mesh=m, metric=metric, bf16=bf16)
    torch.cuda.synchronize()
    assert bt.block_topk.launches == before[0] + 4
    per = rows // 4
    assert bt.block_topk.corpus_rows - before[1] == {per + (-per % 1024): 4}
    sr, ir = sharded_topk_ref(q, c, valid, 10, mesh=m, metric=metric, bf16=bf16)
    assert sc.device == dev and torch.equal(ix, ir)
    assert torch.allclose(sc, sr, atol=1e-5, rtol=0)


def test_sharded_index_on_the_card_launches_once_per_shard(dev):
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.parallel import make_mesh
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex

    m = make_mesh(4)
    ix = TpuDenseKnnIndex(dimensions=32, mesh=m, reserved_space=8192)
    plain = TpuDenseKnnIndex(dimensions=32, reserved_space=8192, device="cpu", mesh=make_mesh(4, device="cpu"))
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(5000, 32)).astype(np.float32)
    for i, v in enumerate(vecs):
        ix.upsert(i, v, None)
        plain.upsert(i, v, None)
    before = bt.block_topk.launches
    got = ix.search([(vecs[7], 5, None), (vecs[9], 5, None)])
    assert bt.block_topk.launches == before + 4
    assert [p.device for p in ix.corpus.device_arrays()[0]] == [dev] * 4
    want = plain.search([(vecs[7], 5, None), (vecs[9], 5, None)])
    for g, w in zip(got, want):
        assert g[0][0] == w[0][0]
        np.testing.assert_allclose([s for _k, s in g], [s for _k, s in w], atol=1e-5)


def test_exchange_on_the_card_equals_the_cpu_mesh(dev):
    """ragged_all_to_all and exchange_rows with the shards on the card give
    the CPU mesh's blocks bit for bit; the frontier min lands on every shard."""
    from pathway_tpu_torch.parallel import collectives, exchange, make_mesh

    card, cpu = make_mesh(4), make_mesh(4, device="cpu")
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2**63, size=5000).astype(np.uint64)
    vals = rng.normal(size=5000)
    dest = (keys % np.uint64(4)).astype(np.int32)
    dest[::97] = -1
    for got, want in zip(exchange.exchange_rows([keys, vals], dest, card),
                         exchange.exchange_rows([keys, vals], dest, cpu)):
        for a, b in zip(got, want):
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    low = collectives.frontier_allreduce(np.array([5, 3, 9, 4], np.int32), card)
    assert [int(t) for t in low] == [3] * 4 and all(t.device == dev for t in low)


def test_engine_shards_on_the_card(dev, monkeypatch):
    """PATHWAY_ENGINE_SHARDS=4 (the engine mesh on cuda): a numeric groupby
    shards, takes the device exchange and equals the unsharded run."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import sharded
    from pathway_tpu_torch.parallel import mesh

    def run():
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(g=int, v=float),
                                     [(i % 13, i / 7) for i in range(2000)])
        out = pw.debug.table_to_dicts(t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v)))
        return out, pw.internals.parse_graph.G.last_runtime

    plain, _rt = run()
    monkeypatch.setenv("PATHWAY_ENGINE_SHARDS", "4")
    monkeypatch.delenv("PATHWAY_MESH_DEVICE", raising=False)
    mesh.reset_engine_mesh()
    try:
        got, rt = run()
    finally:
        mesh.reset_engine_mesh()
    # the same rows; the key order of the dicts is the shards'
    assert sorted(got[0]) == sorted(plain[0]) and got[1] == plain[1]
    ex = next(e for e in rt.execs.values() if isinstance(e, sharded.ShardedGroupByExec))
    assert ex.router.device_exchanges > 0 and rt.frontier_syncs > 0
    assert rt.engine_mesh[0].shard_devices()[0].type == "cuda"


# --- the device group on the card: sharded_topk_global --------------------------


def test_sharded_topk_global_one_rank_launches_the_kernel(dev):
    """Outside a group (one rank) sharded_topk_global is the block top-k
    kernel once over the rank's corpus on the card: integer-grid scores
    are exact, so the ids equal the plain dense top-k's, ties included."""
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import dense_topk
    from pathway_tpu_torch.parallel.distributed import sharded_topk_global

    q, c, valid = _grid(8192, 64, 4, torch.float32, dev)
    before = bt.block_topk.launches, bt.block_topk.corpus_rows.copy()
    sc, ix = sharded_topk_global(q.cpu().numpy(), c, valid, 10, metric="dot", bf16=False)
    assert bt.block_topk.launches == before[0] + 1
    assert bt.block_topk.corpus_rows - before[1] == {8192: 1}
    sr, ir = dense_topk(q, c, valid, 10, metric="dot", bf16=False)
    assert ix.tolist() == ir.cpu().tolist()
    np.testing.assert_allclose(sc, sr.cpu().numpy(), atol=1e-5)


_GLOBAL_RANK = """
import json, os, sys
import numpy as np
import torch
from pathway_tpu_torch.ops import block_topk as bt
from pathway_tpu_torch.parallel import distributed as dist
assert dist.maybe_initialize(device="cuda")
import torch.distributed as td
assert td.get_backend() == "gloo" and td.get_world_size() == 2
pid = td.get_rank()
g = np.random.default_rng(3)
corpus = g.integers(-2, 3, size=(2 * 4096, 64)).astype(np.float32)
corpus[5000] = corpus[10]  # a tie across the two shards
q = g.integers(-2, 3, size=(3, 64)).astype(np.float32)
q[0] = corpus[10]
valid = np.ones(2 * 4096, bool)
valid[4096 + 7] = False
lo, hi = pid * 4096, (pid + 1) * 4096
sc, ix = dist.sharded_topk_global(q, corpus[lo:hi], valid[lo:hi], 10, metric="dot", bf16=False)
# one write of the whole line: the ranks share spawn's stdout
sys.stdout.write("RESULT " + json.dumps({"pid": pid, "ids": ix.tolist(), "scores": sc.tolist(),
                                         "launches": bt.block_topk.launches, "rows": dict(bt.block_topk.corpus_rows),
                                         "device": str(torch.cuda.current_device())}) + "\\n")
sys.stdout.flush()
"""


def test_sharded_topk_global_two_gloo_ranks_on_one_card(dev, tmp_path):
    """Two ranks spawned with the gloo backend share the card: each launches
    block_topk once on its 4096-row shard there, the candidates gather on
    the host, and both ranks' merged ids equal the plain dense top-k over
    the whole corpus, the lower global id first on the tie."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from pathway_tpu_torch.ops.knn import dense_topk
    from pathway_tpu_torch.testing.chaos import free_dcn_port

    script = tmp_path / "rank.py"
    script.write_text(_GLOBAL_RANK)
    root = Path(__file__).resolve().parent.parent
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {**os.environ, "PYTHONPATH": str(root), "PATHWAY_DCN_PORT": str(free_dcn_port(2))}
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "-n", "2", "--backend", "gloo",
                        "--first-port", str(port), "--timeout", "240", "--", sys.executable, str(script)],
                       capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    got = [json.loads(ln[7:]) for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert sorted(x["pid"] for x in got) == [0, 1]
    g = np.random.default_rng(3)
    corpus = g.integers(-2, 3, size=(2 * 4096, 64)).astype(np.float32)
    corpus[5000] = corpus[10]
    q = g.integers(-2, 3, size=(3, 64)).astype(np.float32)
    q[0] = corpus[10]
    valid = np.ones(2 * 4096, bool)
    valid[4096 + 7] = False
    sr, ir = dense_topk(torch.from_numpy(q).to(dev), torch.from_numpy(corpus).to(dev),
                        torch.from_numpy(valid).to(dev), 10, metric="dot", bf16=False)
    for x in got:
        assert x["launches"] == 1 and x["rows"] == {"4096": 1}, x
        assert x["ids"] == ir.cpu().tolist()
        np.testing.assert_allclose(x["scores"], sr.cpu().numpy(), atol=1e-5)
    assert got[0]["ids"][0][:2] == [10, 5000]


def test_nccl_refuses_two_ranks_on_one_card(dev, monkeypatch):
    """NCCL cannot place two ranks on one card: the device group raises
    naming the cause and the gloo way before NCCL would fail opaquely."""
    from pathway_tpu_torch.parallel import distributed as dist

    if torch.cuda.device_count() > 1:
        pytest.skip("more than one card: two ranks get a card each")
    monkeypatch.setenv("PATHWAY_PROCESSES", "2")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "0")
    for k in ("LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one card"):
        dist.maybe_initialize(device="cuda")
    assert not dist.is_multiprocess()


_SUPERVISED_RANK = """
import json, os, sys
import numpy as np
import torch
from pathway_tpu_torch.ops import block_topk as bt
from pathway_tpu_torch.parallel import distributed as dist
inc = int(os.environ["PATHWAY_MESH_INCARNATION"])
assert dist.maybe_initialize(device="cuda")
import torch.distributed as td
pid = td.get_rank()
if inc == 0 and pid == 1:
    os._exit(23)  # dies after joining: rank 0's all-gather loses its peer
g = np.random.default_rng(5)
corpus = g.integers(-2, 3, size=(2 * 4096, 64)).astype(np.float32)
q = g.integers(-2, 3, size=(3, 64)).astype(np.float32)
valid = np.ones(2 * 4096, bool)
lo, hi = pid * 4096, (pid + 1) * 4096
sc, ix = dist.sharded_topk_global(q, corpus[lo:hi], valid[lo:hi], 10, metric="dot", bf16=False)
# one write of the whole line: the ranks share spawn's stdout
sys.stdout.write("RESULT " + json.dumps({"pid": pid, "inc": inc, "ids": ix.tolist(), "launches": bt.block_topk.launches,
                                         "world": [os.environ["WORLD_SIZE"], os.environ["LOCAL_WORLD_SIZE"]]}) + "\\n")
sys.stdout.flush()
"""


def test_supervised_two_gloo_ranks_on_one_card(dev, tmp_path):
    """``spawn -n 2 --backend gloo --supervise`` on the card: rank 1 of
    incarnation 0 dies after joining the device group; the supervisor
    restarts the whole group, whose ranks rejoin the same rendezvous port
    and each launch block_topk once on its shard; the merged ids equal the
    plain dense top-k over the whole corpus; spawn exits 0."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from pathway_tpu_torch.ops.knn import dense_topk
    from pathway_tpu_torch.testing.chaos import free_dcn_port

    script = tmp_path / "rank.py"
    script.write_text(_SUPERVISED_RANK)
    root = Path(__file__).resolve().parent.parent
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {**os.environ, "PYTHONPATH": str(root), "PATHWAY_DCN_PORT": str(free_dcn_port(2)),
           "PATHWAY_DCN_TIMEOUT": "60"}
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "-n", "2", "--backend", "gloo",
                        "--supervise", "--max-restarts", "1", "--first-port", str(port), "--timeout", "240", "--",
                        sys.executable, str(script)], capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    got = [json.loads(ln[7:]) for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert sorted((x["inc"], x["pid"]) for x in got) == [(1, 0), (1, 1)], got
    g = np.random.default_rng(5)
    corpus = g.integers(-2, 3, size=(2 * 4096, 64)).astype(np.float32)
    q = g.integers(-2, 3, size=(3, 64)).astype(np.float32)
    valid = np.ones(2 * 4096, bool)
    _sr, ir = dense_topk(torch.from_numpy(q).to(dev), torch.from_numpy(corpus).to(dev),
                         torch.from_numpy(valid).to(dev), 10, metric="dot", bf16=False)
    for x in got:
        assert x["launches"] == 1 and x["world"] == ["2", "2"], x
        assert x["ids"] == ir.cpu().tolist()


def test_standby_takeover_replica_answers_through_block_topk(dev, monkeypatch):
    """A standby shadows an in-process writer's delta stream; the writer
    dies; the standby takes over at incarnation 1 and republishes the
    corpus, plus one new row, on the same port; a replica process on the
    card follows the new writer and answers every read through block_topk
    with the keys and scores of block_topk_ref over the same rows (within
    1e-5), the new row at rank 1 for its own vector."""
    import http.client
    import json
    import time

    from pathway_tpu_torch.engine.batch import DiffBatch
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import _normalize, stable_topk
    from pathway_tpu_torch.parallel.replicate import DeltaStreamServer
    from pathway_tpu_torch.parallel.standby import StandbyWriter
    from pathway_tpu_torch.testing.chaos import free_dcn_port

    monkeypatch.setenv("PATHWAY_DCN_SECRET", "card-standby-test")
    rng = np.random.default_rng(11)
    n, d, k = 2000, 64, 5
    vecs = rng.standard_normal((n + 1, d)).astype(np.float32)
    keys = [20_000 + i for i in range(n + 1)]

    def batch(rows):
        return DiffBatch.from_rows([(keys[i], 1, (vecs[i], None)) for i in rows], ("_data", "_meta"))

    port = free_dcn_port(1)
    primary = DeltaStreamServer(port, incarnation=0)
    primary.publish(0, [batch(range(n))])
    taken: list = []

    def on_takeover(standby):
        srv = DeltaStreamServer(port, incarnation=standby.next_incarnation())
        srv.set_floor(99)
        srv.publish(100, [batch(range(n))])
        taken.append(srv)

    standby = StandbyWriter("127.0.0.1", port, on_takeover=on_takeover, grace_s=0.5, poll_s=0.05).start()
    proc, http_port = _replica_child({"PATHWAY_REPL_PORT": str(port), "PATHWAY_REPLICA_DIM": str(d)})

    def get(path):
        conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=60)
        conn.request("GET", path)
        body = json.loads(conn.getresponse().read())
        conn.close()
        return body

    def read(q):
        conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=60)
        conn.request("POST", "/query", json.dumps({"vec": q.tolist(), "k": k}), {"content-type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, body
        return body["matches"]

    def until(pred, what, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not pred():
            assert time.monotonic() < deadline, what
            time.sleep(0.05)

    try:
        until(lambda: standby.applied_tick == 0 and standby._client.connected, "the standby's first contact")
        until(lambda: get("/replica/health")["corpus_docs"] == n, "the replica's corpus")
        time.sleep(0.2)
        primary.close()  # the writer dies
        assert standby.wait_takeover(timeout=30) and standby.takeover_incarnation == 1
        taken[0].publish(101, [batch([n])])
        until(lambda: get("/replica/health")["writer_incarnation"] == 1 and
              get("/replica/health")["corpus_docs"] == n + 1, "the replica following incarnation 1")
        prep = torch.zeros(4096, d, device=dev)
        prep[: n + 1] = _normalize(torch.from_numpy(vecs).to(dev))
        valid = torch.zeros(4096, dtype=torch.bool, device=dev)
        valid[: n + 1] = True
        queries = np.concatenate([rng.standard_normal((5, d)).astype(np.float32), vecs[n:]])
        sc, ix = bt.block_topk_ref(_normalize(torch.from_numpy(queries).to(dev)), prep, valid, k)
        s, pos = stable_topk(sc.reshape(len(queries), -1), k)
        idx = torch.gather(ix.reshape(len(queries), -1), 1, pos)
        for qi, q in enumerate(queries):
            got = read(q)
            assert [m[0] for m in got] == [keys[int(j)] for j in idx[qi]]
            assert np.allclose([m[1] for m in got], (s[qi].double() - 1.0).cpu().numpy(), atol=1e-5)
        assert read(vecs[n])[0][0] == keys[n]
        launched = get("/replica/kernels")
        assert launched["block_topk_by_shape"] == {f"B=1,k={k}": len(queries) + 1}
        assert get("/replica/health")["fenced_writers"] == 0
    finally:
        standby.stop()
        proc.terminate()
        proc.wait(timeout=60)
        primary.close()
        for srv in taken:
            srv.close()


def test_ferried_kv_split_owners_decode_on_the_card(dev, tmp_path, monkeypatch):
    """A scheduler on the card snapshots mid-decode and is frozen;
    ``split_kv_store`` sends its store to two FerryReceivers on 127.0.0.1;
    the owner of the sequence restores it on the card and finishes through
    the paged-attention kernel with the uninterrupted run's tokens."""
    import time

    from pathway_tpu_torch.elastic.ferry import FerryReceiver
    from pathway_tpu_torch.elastic.kv import split_kv_store
    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, GenerationRequest
    from pathway_tpu_torch.ops import paged_attention as pa
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    monkeypatch.setenv("PATHWAY_DCN_SECRET", "card-ferry-test")
    prompt = dec.encode_text("a ferried decode on the card")

    def request(rid):
        return GenerationRequest(rid, list(prompt), deadline=time.monotonic() + 60, max_new_tokens=24)

    s0 = DecodeScheduler(GenerateConfig(max_batch=1))
    try:
        r0 = request("u")
        s0.submit(r0)
        res0 = r0.wait(60)
    finally:
        s0.stop()
    root = str(tmp_path / "kv")
    s1 = DecodeScheduler(GenerateConfig(max_batch=1, snapshot_every=4, store_root=root))
    try:
        _freeze_mid_decode(s1, request("k"), 12)
    finally:
        s1.stop()
    owners = [str(tmp_path / "owner0"), str(tmp_path / "owner1")]
    receivers = [FerryReceiver(o) for o in owners]
    try:
        split = split_kv_store(root, [(r.host, r.port) for r in receivers])
    finally:
        for r in receivers:
            r.close()
    assert split["total_seqs"] == 1 and split["bytes_ferried"] > 0
    assert all(d["ferry"]["committed"] for d in split["destinations"])
    before = pa.paged_attention.launches
    scheds = [DecodeScheduler(GenerateConfig(max_batch=1, store_root=o)) for o in owners]
    try:
        assert sorted(s.restored_seqs for s in scheds) == [0, 1]
        owner = next(s for s in scheds if s.restored_seqs)
        deadline = time.monotonic() + 60
        while not owner.finished and time.monotonic() < deadline:
            time.sleep(0.01)
        (res,) = owner.finished.values()
        assert res["tokens"] == res0["tokens"]
        steps = owner.stats()["decode_steps"]
        assert steps > 0 and pa.paged_attention.launches - before == steps * GenerateConfig().n_layers
    finally:
        for s in scheds:
            s.stop()


def test_serving_plane_resized_on_the_card_answers_as_plain(dev, monkeypatch):
    """A delta stream's corpus on two replicas on the card behind a router;
    an AutoscaleController with a ServingPlaneActuator resizes the plane
    1 -> 2 shards under a surge; every read after the swap is one
    block_topk launch a shard and equals the plain top-10 over the whole
    corpus (small integers: exact)."""
    import http.client
    import json
    import time

    from pathway_tpu_torch.autoscale import AutoscaleConfig, AutoscaleController, ServingPlaneActuator
    from pathway_tpu_torch.engine.batch import DiffBatch
    from pathway_tpu_torch.observability.registry import MetricsRegistry
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.parallel.replicate import DeltaStreamServer
    from pathway_tpu_torch.serving.replica import ReplicaServer
    from pathway_tpu_torch.serving.router import FailoverRouter
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex

    monkeypatch.setenv("PATHWAY_DCN_SECRET", "card-serving-resize")
    g = np.random.default_rng(11)
    n, d = 6000, 64
    corpus = g.integers(-2, 3, size=(n, d)).astype(np.float32)
    corpus[corpus.sum(1) == 0, 0] = 1.0
    keys = np.arange(1, n + 1, dtype=np.uint64)
    q = g.integers(-2, 3, size=(4, d)).astype(np.float32)

    class Burn:
        burn = 3.0

        def burn_rates(self):
            return {"shed_rate": {"target": 0.01, "direction": "max", "window_avg": 0.03, "burn": self.burn}}

    def ask(port, vec):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c.request("POST", "/query", body=json.dumps({"vec": vec.tolist(), "k": 10}),
                  headers={"content-type": "application/json"})
        r = c.getresponse()
        out = (r.status, r.getheader("x-pathway-shards"), json.loads(r.read()))
        c.close()
        return out

    srv = DeltaStreamServer(0, ring_ticks=16, n_shards=1)
    data = np.empty(n, dtype=object)
    data[:] = list(corpus)
    srv.publish(0, [DiffBatch(keys, np.ones(n, np.int64), {"_data": data, "_meta": np.full(n, None, object)})])
    reps = [ReplicaServer(replica_id=i, index_factory=lambda: TpuDenseKnnIndex(dimensions=d, device=dev),
                          writer_port=srv.port, dim=d, device="cuda").start() for i in range(2)]
    router = None
    try:
        deadline = time.monotonic() + 60
        while not all(r.ready and len(r.index) == n for r in reps) and time.monotonic() < deadline:
            time.sleep(0.05)
        urls = [f"http://127.0.0.1:{r.http_port}" for r in reps]
        router = FailoverRouter(urls, health_interval_ms=100, cache=None).start()

        def adopt(m):
            for i, r in enumerate(reps):
                r.adopt_shard_map(i, m)

        ctrl = AutoscaleController(
            ServingPlaneActuator(srv, router=router, members_for=lambda m: [[urls[i]] for i in range(m)],
                                 adopt=adopt),
            ranks=1, config=AutoscaleConfig(min_ranks=1, max_ranks=2, up_window_s=1.0), sampler=Burn(),
            registry=MetricsRegistry())
        t0 = time.monotonic()
        for s in range(5):
            ctrl.step(t0 + s)
        assert ctrl.ranks == 2 and ctrl.resizes == 1
        deadline = time.monotonic() + 60
        while not all(r.ready and r.n_shards == 2 for r in reps) and time.monotonic() < deadline:
            time.sleep(0.05)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        sims = qn @ cn.T
        plain = np.argsort(-sims, axis=1, kind="stable")[:, :10] + 1
        deadline = time.monotonic() + 30
        while ask(router.port, q[0])[1] != "2" and time.monotonic() < deadline:
            time.sleep(0.1)
        before = bt.block_topk.launches
        for i, vec in enumerate(q):
            status, shards, body = ask(router.port, vec)
            assert status == 200 and shards == "2"
            got = [k for k, _s in body["matches"]]
            # the index answers cosine as -(1 - cos); a key may differ from
            # the plain order only where two cosines tie
            np.testing.assert_allclose([sc + 1.0 for _k, sc in body["matches"]], sims[i, plain[i] - 1], atol=1e-5)
            assert all(abs(sims[i, k - 1] - sims[i, p - 1]) <= 1e-5 for k, p in zip(got, plain[i])), (got, plain[i])
        assert bt.block_topk.launches - before == 2 * len(q)
        assert sorted(len(r.index) for r in reps) == sorted(
            [int((keys % 2 == 0).sum()), int((keys % 2 == 1).sum())])
    finally:
        if router is not None:
            router.stop()
        for r in reps:
            r.stop()
        srv.close()


_ACTUATED_RANK = """
import json, os, signal, sys, time
import numpy as np
from pathway_tpu_torch.ops import block_topk as bt
from pathway_tpu_torch.parallel import distributed as dist
inc = int(os.environ["PATHWAY_MESH_INCARNATION"])
assert dist.maybe_initialize(device="cuda", backend="gloo")
import torch.distributed as td
pid, n = td.get_rank(), td.get_world_size()
g = np.random.default_rng(7)
corpus = g.integers(-2, 3, size=(6 * 2048, 64)).astype(np.float32)
q = g.integers(-2, 3, size=(3, 64)).astype(np.float32)
per = len(corpus) // n
lo, hi = pid * per, (pid + 1) * per
sc, ix = dist.sharded_topk_global(q, corpus[lo:hi], np.ones(hi - lo, bool), 10, metric="dot", bf16=False)
out = os.environ["PW_OUT"]
with open(os.path.join(out, f"r{inc}_{pid}.json"), "w") as f:
    json.dump({"pid": pid, "n": n, "inc": inc, "ids": ix.tolist(), "launches": bt.block_topk.launches}, f)
if inc == 0:  # serve until the resize stops the group
    signal.signal(signal.SIGTERM, lambda *_a: sys.exit(0))
    while True:
        time.sleep(0.1)
"""


def test_supervisor_actuator_resizes_a_gloo_group_on_the_card(dev, tmp_path):
    """An in-process GroupSupervisor runs two gloo ranks on the card; an
    AutoscaleController with a SupervisorActuator resizes the group to
    three ranks under a surge; each incarnation's ranks search their shard
    with sharded_topk_global (one block_topk launch each) and return the
    plain dense top-10 over the whole corpus."""
    import json
    import socket
    import sys
    import threading
    import time
    from pathlib import Path

    from pathway_tpu_torch.autoscale import AutoscaleConfig, AutoscaleController, SupervisorActuator
    from pathway_tpu_torch.observability.registry import MetricsRegistry
    from pathway_tpu_torch.ops.knn import dense_topk
    from pathway_tpu_torch.parallel.supervisor import GroupSupervisor

    script = tmp_path / "rank.py"
    script.write_text(_ACTUATED_RANK)
    root = Path(__file__).resolve().parent.parent
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {"PYTHONPATH": str(root), "PW_OUT": str(tmp_path), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "PATHWAY_DCN_TIMEOUT": "60"}
    sup = GroupSupervisor([sys.executable, str(script)], 2, env=env, max_restarts=0, grace_s=30.0)
    rc: list = []
    runner = threading.Thread(target=lambda: rc.append(sup.run()), daemon=True)
    runner.start()

    class Burn:
        def burn_rates(self):
            return {"shed_rate": {"target": 0.01, "direction": "max", "window_avg": 0.03, "burn": 3.0}}

    try:
        deadline = time.monotonic() + 120
        while not all((tmp_path / f"r0_{p}.json").exists() for p in range(2)) and time.monotonic() < deadline:
            time.sleep(0.1)
        calls: list = []
        ctrl = AutoscaleController(
            SupervisorActuator(sup, lambda old, new: (lambda: calls.append((old, new))), timeout_s=120),
            ranks=2, config=AutoscaleConfig(min_ranks=2, max_ranks=3, up_window_s=1.0), sampler=Burn(),
            registry=MetricsRegistry())
        t0 = time.monotonic()
        for i in range(5):
            ctrl.step(t0 + i)
        assert ctrl.ranks == 3 and calls == [(2, 3)]
        runner.join(180)
        assert not runner.is_alive() and rc == [0], sup.events
    finally:
        if runner.is_alive():
            sup.stop()
            runner.join(30)
    kinds = [k for _t, k, _d in sup.events]
    assert "group-resize" in kinds and "resize-rollback" not in kinds, kinds
    g = np.random.default_rng(7)
    corpus = g.integers(-2, 3, size=(6 * 2048, 64)).astype(np.float32)
    q = g.integers(-2, 3, size=(3, 64)).astype(np.float32)
    _sr, ir = dense_topk(torch.from_numpy(q).to(dev), torch.from_numpy(corpus).to(dev),
                         torch.ones(len(corpus), dtype=torch.bool, device=dev), 10, metric="dot", bf16=False)
    for inc, n in ((0, 2), (1, 3)):
        for p in range(n):
            x = json.loads((tmp_path / f"r{inc}_{p}.json").read_text())
            assert x["n"] == n and x["launches"] == 1 and x["ids"] == ir.cpu().tolist(), x
