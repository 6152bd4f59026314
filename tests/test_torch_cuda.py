"""The hand-written CUDA kernels on the card: ``block_topk`` against its
plain version ``block_topk_ref`` and the index's default path through it;
``paged_attention`` against ``paged_attention_ref``, ``decode_step`` with
``kernel="cuda"`` against ``"ref"``, and the decode scheduler's default path
through the kernel.

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
