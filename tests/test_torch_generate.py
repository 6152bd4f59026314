"""The port's generation stage on the CPU: page-pool accounting, the
continuous-batching ``DecodeScheduler`` (completion and page reclaim,
batching beyond ``max_batch``, deadline drops mid-decode and before decode,
explicit sheds, the page-starved wait, the queue bound), its serving pieces,
and the same greedy requests through the JAX package's scheduler and the
port's giving the same tokens.

Timing: every wait is on an event with a timeout; deadlines are as loose as
the JAX tests' (60 s), and the mid-decode drop is forced by holding the
decode thread in the request's own token callback past its deadline."""

import threading
import time

import pytest

from pathway_tpu.generate.scheduler import DecodeScheduler as JaxScheduler
from pathway_tpu.generate.scheduler import GenerateConfig as JaxConfig
from pathway_tpu.generate.scheduler import GenerationRequest as JaxRequest
from pathway_tpu.generate.serving import assemble_prompt as jax_assemble_prompt
from pathway_tpu.generate.serving import is_generate_route as jax_is_generate_route
from pathway_tpu.serving.config import QoSConfig as JaxQoS
from pathway_tpu.serving.config import default_bucket_ladder as jax_ladder
from pathway_tpu_torch.generate import (
    NULL_PAGE,
    DecodeScheduler,
    GenerateConfig,
    GenerationRequest,
    PagePool,
    assemble_prompt,
)
from pathway_tpu_torch.generate.serving import GENERATE_ROUTE, is_generate_route
from pathway_tpu_torch.serving import MicroBatcher, QoSConfig, ShedError, default_bucket_ladder
from pathway_tpu_torch.xpacks.llm import decoder as dec

_SMALL = dict(dim=64, n_layers=1, n_heads=2, head_dim=32, ffn_dim=128)


def _cfg(**kw) -> GenerateConfig:
    base = dict(n_pages=32, page_size=8, max_batch=4, max_len=96, max_new_tokens=8, **_SMALL)
    base.update(kw)
    return GenerateConfig(**base)


def _req(rid: str, text: str, *, budget_s: float = 60.0, **kw):
    kw.setdefault("max_new_tokens", 6)
    return GenerationRequest(rid, dec.encode_text(text), deadline=time.monotonic() + budget_s, **kw)


@pytest.fixture
def sched_factory():
    made = []

    def make(cfg=None, **kw):
        s = DecodeScheduler(cfg or _cfg(), device="cpu", **kw)
        made.append(s)
        return s

    yield make
    for s in made:
        s.stop()


# --- page pool -------------------------------------------------------------


def test_page_pool_accounting():
    pool = PagePool(8)
    assert pool.capacity == 7 and NULL_PAGE == 0  # page 0 is the null page
    got = pool.try_alloc(3)
    assert got is not None and len(got) == 3 and 0 not in got
    assert pool.in_use == 3
    assert pool.try_alloc(5) is None  # never a partial grant
    assert pool.in_use == 3 and pool.occupancy() == 3 / 7
    pool.free(got)
    assert pool.in_use == 0
    with pytest.raises(ValueError):
        pool.free([0])  # the null page is not freeable
    with pytest.raises(ValueError):
        pool.free([8])  # outside the pool
    got = pool.try_alloc(1)
    pool.free(got)
    with pytest.raises(ValueError):
        pool.free(got)  # double free
    with pytest.raises(ValueError):
        PagePool(1)


# --- scheduler -------------------------------------------------------------


def test_generate_completes_and_reclaims_pages(sched_factory):
    s = sched_factory()
    reqs = [_req(f"r{i}", f"hello {i}", seed=i) for i in range(3)]
    for r in reqs:
        s.submit(r)
    for r in reqs:
        res = r.wait(60)
        assert res is not None and res["status"] == 200
        assert res["token_count"] == 6 == len(res["tokens"])
        assert res["text"] == dec.decode_tokens(res["tokens"])
    assert s.pool.in_use == 0  # finished sequences freed every page
    st = s.stats()
    assert st["active_seqs"] == 0 and st["kernel"] == "ref" and st["decode_steps"] > 0
    assert len(s.step_seconds) == st["decode_steps"]
    assert set(s.finished) == {"r0", "r1", "r2"}


def test_continuous_batching_beyond_max_batch(sched_factory):
    """More requests than max_batch: sequences join BETWEEN steps as slots
    free, and everyone completes."""
    s = sched_factory(_cfg(max_batch=2))
    reqs = [_req(f"r{i}", f"word {i}") for i in range(6)]
    for r in reqs:
        s.submit(r)
    for r in reqs:
        res = r.wait(120)
        assert res is not None and res["status"] == 200, res
    assert s.pool.in_use == 0


def test_deadline_drops_mid_decode_and_reclaims(sched_factory):
    """An expired deadline 504s MID-decode, the pages return at once, and
    the sequence never takes another step."""
    s = sched_factory(_cfg(max_len=160))
    seen = []
    budget_s = 2.0

    def hold_past_deadline(tok, _done):
        seen.append(tok)
        if len(seen) == 1:  # hold the decode thread until the deadline passed
            threading.Event().wait(max(r.deadline - time.monotonic(), 0.0) + 0.05)

    r = _req("drop", "x" * 50, budget_s=budget_s, max_new_tokens=64, on_token=hold_past_deadline)
    s.submit(r)
    res = r.wait(60)
    assert res is not None and res["status"] == 504
    assert "mid-decode" in res["error"]
    assert 1 <= res["tokens"] < 64  # dropped after its first token
    assert s.pool.in_use == 0  # pages freed before the answer
    # a later request runs more steps; the dropped one is never fed again
    after = _req("after", "y")
    s.submit(after)
    assert after.wait(60)["status"] == 200
    assert len(seen) == res["tokens"]


def test_expired_before_decode_never_dispatched(sched_factory):
    """A dead deadline is 504'd at the batcher flush, not by a step."""
    s = sched_factory()
    r = _req("late", "hello", budget_s=-0.5)
    s.submit(r)
    res = r.wait(15)
    assert res is not None and res["status"] == 504
    assert "before decode" in res["error"]
    assert s.stats()["decode_steps"] == 0


def test_oversized_and_unservable_requests_shed_explicitly(sched_factory):
    s = sched_factory()
    with pytest.raises(ShedError) as ei:
        s.submit(_req("big", "x" * 500, max_new_tokens=64))
    assert ei.value.status == 400
    small_pool = sched_factory(_cfg(n_pages=4))
    with pytest.raises(ShedError) as ei:
        small_pool.submit(_req("pages", "x" * 40, max_new_tokens=8))  # 6 pages > 3
    assert ei.value.status == 503


def test_page_starved_request_waits_then_runs(sched_factory):
    """A request the pool cannot cover YET waits and joins when pages
    free, instead of shedding."""
    s = sched_factory(_cfg(n_pages=8, max_batch=3))
    events = []

    def note(name):
        return lambda _tok, done: events.append((name, done))

    # a and b take 3 of the 7 pages each; c needs 5 and must wait for both
    a = _req("a", "aaaaaa", max_new_tokens=16, on_token=note("a"))
    b = _req("b", "bbbbbb", max_new_tokens=16, on_token=note("b"))
    c = _req("c", "c" * 16, max_new_tokens=16, on_token=note("c"))
    assert [s.pages_needed(r) for r in (a, b, c)] == [3, 3, 5]
    for r in (a, b, c):
        s.submit(r)
    for r in (a, b, c):
        assert r.wait(60)["status"] == 200
    assert s.pool.in_use == 0
    c_first = events.index(("c", False))
    assert {("a", True), ("b", True)} <= set(events[:c_first])


def test_queue_bound_sheds_429_with_active_set_full(sched_factory):
    """The queue-full 429 counts the EDF heap too: with the active set
    saturated the batcher never dispatches."""
    s = sched_factory(
        _cfg(max_batch=1, max_len=160),
        qos=QoSConfig(max_batch_size=1, max_queue=2, max_wait_ms=2.0),
    )
    active, release = threading.Event(), threading.Event()

    def gate(_tok, _done):
        active.set()
        release.wait(30)

    long = _req("long", "x" * 40, max_new_tokens=64, on_token=gate)
    s.submit(long)
    assert active.wait(30)  # the single slot is taken and held
    for i in range(2):
        s.submit(_req(f"q{i}", "y"))
    with pytest.raises(ShedError) as ei:
        s.submit(_req("overflow", "z"))
    assert ei.value.status == 429 and "queue full" in ei.value.reason
    release.set()
    assert long.wait(60)["status"] == 200


def test_stop_answers_everything_503(sched_factory):
    s = sched_factory(_cfg(max_batch=1))
    hold, go = threading.Event(), threading.Event()

    def gate(_tok, _done):
        hold.set()
        go.wait(30)

    a = _req("a", "aaaa", max_new_tokens=20, on_token=gate)
    b = _req("b", "bbbb")
    s.submit(a)
    assert hold.wait(30)
    s.submit(b)
    go.set()
    s.stop()
    assert a.wait(30)["status"] in (200, 503)
    assert b.wait(30)["status"] == 503
    assert s.pool.in_use == 0
    with pytest.raises(ShedError):
        s.submit(_req("late", "x"))


def test_snapshot_options_not_ported_yet(tmp_path):
    with pytest.raises(NotImplementedError, match="KvLedger"):
        DecodeScheduler(_cfg(store_root=str(tmp_path)), device="cpu")
    with pytest.raises(NotImplementedError):
        DecodeScheduler(_cfg(snapshot_every=3), device="cpu")


def test_kernel_selection(monkeypatch, sched_factory):
    assert sched_factory(_cfg(kernel="auto")).kernel == "ref"  # CPU pools
    assert sched_factory(_cfg(kernel="cuda")).kernel == "cuda"
    monkeypatch.setenv("PATHWAY_GENERATE_KERNEL", "cuda")
    assert GenerateConfig.from_env().kernel == "cuda"
    monkeypatch.setenv("PATHWAY_GENERATE_KERNEL", "pallas")
    with pytest.raises(ValueError):
        GenerateConfig.from_env()
    with pytest.raises(ValueError):
        DecodeScheduler(_cfg(kernel="pallas"), device="cpu")


def test_cuda_kernel_option_on_cpu_gives_ref_tokens(sched_factory):
    """kernel="cuda" on CPU pools runs the wrapper's plain version: the same
    tokens as kernel="ref"."""
    out = {}
    for kernel in ("ref", "cuda"):
        s = sched_factory(_cfg(kernel=kernel))
        reqs = [_req(f"{kernel}{i}", f"same {i}", temperature=0.7, seed=i) for i in range(3)]
        for r in reqs:
            s.submit(r)
        out[kernel] = [r.wait(60)["tokens"] for r in reqs]
    assert out["ref"] == out["cuda"]


# --- across the packages ---------------------------------------------------


def test_same_greedy_tokens_as_the_jax_scheduler():
    """The same greedy requests through JAX's DecodeScheduler(kernel="ref")
    and the port's: the same tokens per request."""
    shape = dict(n_pages=32, page_size=8, max_batch=4, max_len=96, max_new_tokens=8, **_SMALL)
    prompts = [f"question {i}: what is {i * 7}?" for i in range(6)]
    out = {}
    for name, make, request in (
        ("jax", lambda: JaxScheduler(JaxConfig(**shape, kernel="ref"), replica_label="tg"), JaxRequest),
        ("torch", lambda: DecodeScheduler(GenerateConfig(**shape), device="cpu"), GenerationRequest),
    ):
        s = make()
        try:
            reqs = [
                request(f"q{i}", dec.encode_text(p), deadline=time.monotonic() + 60, max_new_tokens=7)
                for i, p in enumerate(prompts)
            ]
            for r in reqs:
                s.submit(r)
            out[name] = [r.wait(120) for r in reqs]
        finally:
            s.stop()
    for j, t in zip(out["jax"], out["torch"]):
        assert j["status"] == t["status"] == 200
        assert j["tokens"] == t["tokens"] and j["text"] == t["text"]


def test_serving_pieces_match_jax(monkeypatch):
    for n in (1, 3, 8, 32):
        assert default_bucket_ladder(n) == jax_ladder(n)
    monkeypatch.setenv("PATHWAY_SERVING_MAX_QUEUE", "5")
    monkeypatch.setenv("PATHWAY_SERVING_RPS", "")
    assert QoSConfig.from_env() == QoSConfig(max_queue=5)
    assert QoSConfig.from_env().max_queue == JaxQoS.from_env().max_queue == 5
    q = QoSConfig(max_batch_size=8)
    assert [q.bucket_for(n) for n in range(1, 10)] == [JaxQoS(max_batch_size=8).bucket_for(n) for n in range(1, 10)]
    for path in (GENERATE_ROUTE, "/v1/generate", "/generate/", "/regenerate", "/query"):
        assert is_generate_route(path) == jax_is_generate_route(path)
    matches = [(3, -0.25), (10000017, -0.5)]
    for m in (matches, []):
        assert assemble_prompt("why?", m) == jax_assemble_prompt("why?", m)


def test_micro_batcher_releases_earliest_deadline_first():
    released, rejected = [], []
    got = threading.Event()

    class R:
        def __init__(self, name, deadline):
            self.name, self.deadline = name, deadline

    def dispatch(batch):
        released.extend(r.name for r in batch)
        if len(released) >= 3:
            got.set()

    b = MicroBatcher(
        QoSConfig(max_batch_size=8, max_wait_ms=50.0),
        dispatch=dispatch,
        reject=lambda r, e: rejected.append(r.name),
    )
    try:
        now = time.monotonic()
        for name, d in (("late", now + 30), ("soon", now + 10), ("mid", now + 20), ("dead", now - 1)):
            b.put(R(name, d))
        assert got.wait(30)
        assert released == ["soon", "mid", "late"] and rejected == ["dead"]
    finally:
        b.close()
