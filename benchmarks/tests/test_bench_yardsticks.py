"""The benchmark's arithmetic: FLOPs, bytes, the roofline, rates and
percentiles over every request."""

import math

import pytest

from benchmarks import roofline
from benchmarks.harness import stats, textgen


def test_encoder_flops_match_the_minilm_formula():
    # 6 layers x (24 n d^2 + 4 n^2 d) when the feed-forward is 4 d wide
    for n in (1, 13, 172, 256):
        assert roofline.encoder_flops(n, 384, 6, 1536) == 6 * (24 * n * 384**2 + 4 * n * n * 384)


def test_scoring_and_bytes_count_each_byte_once():
    assert roofline.scoring_flops(32, 1 << 20, 384) == 2 * 32 * (1 << 20) * 384
    n, d = 1 << 20, 384
    got = roofline.block_topk_bytes(32, n, d, 10, 4)
    assert got == 32 * d * 4 + n * d * 4 + n + 32 * (n // 1024) * 10 * 8


def test_block_topk_bound_is_the_larger_of_compute_and_bytes():
    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    # B = 1 at 1M x 384 f32 is bound by bytes: 1.61 GB at 3.35 TB/s
    b1 = roofline.block_topk_bound_s(1, 1 << 20, 384, 10, "float32", peaks)
    assert b1 == pytest.approx(roofline.block_topk_bytes(1, 1 << 20, 384, 10, 4) / 3.35e12)
    assert 0.48e-3 < b1 < 0.49e-3
    # a wide batch is bound by f32 FLOPs
    b512 = roofline.block_topk_bound_s(512, 1 << 20, 384, 10, "float32", peaks)
    assert b512 == pytest.approx(2 * 512 * (1 << 20) * 384 / 67e12)
    assert roofline.peaks_for("cpu") is None


@pytest.mark.parametrize("values, q, want", [
    ([5.0], 95, 5.0),
    (list(range(1, 101)), 95, 95),
    (list(range(1, 101)), 90, 90),
    ([1.0, 2.0, math.inf, 3.0], 95, math.inf),  # a missing request counts as the longest
    (list(range(1, 21)), 95, 19),
])
def test_percentile_is_nearest_rank_over_all_samples(values, q, want):
    assert stats.percentile(values, q) == want


def test_word_counts_are_one_multiset_for_every_seed():
    lengths = {"mean_words": 102.5, "sigma": 0.5, "min_words": 8, "max_words": 255}
    a = textgen.TextStream(textgen.seed_seq(1, 3), lengths, 512)
    b = textgen.TextStream(textgen.seed_seq(2**31 + 9, 3), lengths, 512)
    ta, ca = a.take(512)
    tb, cb = b.take(512)
    assert sorted(ca) == sorted(cb) and ca != cb
    assert abs(sum(ca) / 512 - 102.5) < 3
    assert all(len(t.split()) == c for t, c in zip(ta, ca))
    again = textgen.TextStream(textgen.seed_seq(1, 3), lengths, 512).take(512)
    assert again == (ta, ca)


def test_metric_readers_compute_rates_and_tails_over_all_requests():
    from types import SimpleNamespace

    from benchmarks.harness import spec

    reqs = [(0.0, 0.010)] * 18 + [(0.0, 0.200), (0.0, None)]
    ctx = SimpleNamespace(requests=reqs, query_tokens_answered=[12] * 19, window_s=2.0,
                          probes=[(0.0, 0.3)] * 9 + [(0.0, None)], passage_tokens_reached=[100] * 512)
    assert spec.reader("queries_per_s")(ctx) == 9.5
    assert spec.reader("reply_p95_ms.host")(ctx) == pytest.approx(200.0)  # 19th of 20
    assert spec.reader("visible_p90_ms")(ctx) == pytest.approx(300.0)
    assert spec.reader("ingest_docs_per_s")(ctx) == 256.0
    ctx.requests = reqs[:-2] + [(0.0, None), (0.0, None)]
    assert spec.reader("reply_p95_ms.host")(ctx) is None  # the 95th falls on a missing reply


def test_per_layer_readers_return_nothing_without_their_readings():
    from types import SimpleNamespace

    from benchmarks.harness import spec

    ctx = SimpleNamespace(device=None, peaks=None, query_tokens_answered=[], passage_tokens_reached=[],
                          spans=[], ticks=0, index_ticks=0, node_ns={}, embed_nodes=set(),
                          index_nodes=set())
    for name in ("block_topk_roofline", "query_mfu", "ingest_mfu", "device_idle.query",
                 "device_idle.ingest", "embed_ms_per_doc", "engine_host_ms_per_tick",
                 "search_ms_per_tick"):
        assert spec.reader(name)(ctx) is None, name


def test_roofline_reader_sums_bounds_over_the_kernels_device_time():
    from types import SimpleNamespace

    from benchmarks.harness import spec

    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    config = {"encoder": {"hidden_size": 384}, "index": {"dtype": "float32"}}
    n = 1 << 20
    ctx = SimpleNamespace(device={"block_topk_s": 0.05}, peaks=peaks, config=config,
                          topk_shapes={(32, 10): 40, (16, 10): 10}, topk_rows={n: 50})
    bound = (40 * roofline.block_topk_bound_s(32, n, 384, 10, "float32", peaks)
             + 10 * roofline.block_topk_bound_s(16, n, 384, 10, "float32", peaks))
    reader = spec.reader("block_topk_roofline")
    assert reader(ctx) == pytest.approx(100 * bound / 0.05)
    # one (B, k) at two corpus sizes pairs too
    ctx.topk_shapes, ctx.topk_rows = {(32, 10): 50}, {n: 20, n // 2: 30}
    bound = (20 * roofline.block_topk_bound_s(32, n, 384, 10, "float32", peaks)
             + 30 * roofline.block_topk_bound_s(32, n // 2, 384, 10, "float32", peaks))
    assert reader(ctx) == pytest.approx(100 * bound / 0.05)
    # several of each cannot be paired: nothing is read
    ctx.topk_shapes, ctx.topk_rows = {(32, 10): 25, (16, 10): 25}, {n: 20, n // 2: 30}
    assert reader(ctx) is None
