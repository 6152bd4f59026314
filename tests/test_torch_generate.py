"""The port's generation stage on the CPU: page-pool accounting, the
continuous-batching ``DecodeScheduler`` (completion and page reclaim,
batching beyond ``max_batch``, deadline drops mid-decode and before decode,
explicit sheds, the page-starved wait, the queue bound), its serving pieces,
the same greedy requests through the JAX package's scheduler and the port's
giving the same tokens, and durability: kill/restore, out-of-thread
snapshots and the KV handoff to a new owner, within the port and across the
packages (a snapshot of either scheduler restored by the other).

Tolerance: tokens are compared exactly. A "kill" freezes the decode loop
(as the JAX tests do): only what the periodic snapshot committed survives.

Timing: every wait is on an event with a timeout; deadlines are as loose as
the JAX tests' (60 s), and the mid-decode drop is forced by holding the
decode thread in the request's own token callback past its deadline."""

import threading
import time
from dataclasses import replace

import numpy as np
import pytest

from pathway_tpu.generate.scheduler import DecodeScheduler as JaxScheduler
from pathway_tpu.generate.scheduler import GenerateConfig as JaxConfig
from pathway_tpu.generate.scheduler import GenerationRequest as JaxRequest
from pathway_tpu.elastic.kv import split_kv_store as jax_split_kv_store
from pathway_tpu.generate.kv_cache import KvLedger as JaxLedger
from pathway_tpu.generate.serving import assemble_prompt as jax_assemble_prompt
from pathway_tpu.generate.serving import is_generate_route as jax_is_generate_route
from pathway_tpu.serving.config import QoSConfig as JaxQoS
from pathway_tpu.serving.config import default_bucket_ladder as jax_ladder
from pathway_tpu_torch.elastic.handover import HandoverError
from pathway_tpu_torch.elastic.kv import seq_owner, split_kv_store
from pathway_tpu_torch.generate import (
    NULL_PAGE,
    DecodeScheduler,
    GenerateConfig,
    GenerationRequest,
    KvLedger,
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


# --- durability ------------------------------------------------------------

_PROMPT = "the quick brown fox"
_SAMPLED = dict(max_new_tokens=12, temperature=0.7, top_k=20, seed=5)
_DURABLE = dict(n_pages=16, max_batch=1, max_len=64)


def _run_one(make, request, rid, kw):
    """One request through a fresh scheduler to completion."""
    s = make()
    try:
        r = request(rid, dec.encode_text(_PROMPT), deadline=time.monotonic() + 60, **kw)
        s.submit(r)
        res = r.wait(120)
    finally:
        s.stop()
    assert res["status"] == 200
    return res


def _freeze_after(s, steps: int, request, kw):
    """Submit the request, let ``steps`` decode steps run, then freeze the
    loop mid-flight (the in-process SIGKILL stand-in: no drain, no stop, no
    final snapshot)."""
    r = request("k", dec.encode_text(_PROMPT), deadline=time.monotonic() + 60, **kw)
    s.submit(r)
    deadline = time.monotonic() + 60
    while s.stats()["decode_steps"] < steps and not r.done.is_set() and time.monotonic() < deadline:
        time.sleep(0.005)
    s._step = lambda: time.sleep(0.05)
    time.sleep(0.2)
    return r


def _finish_restored(s, timeout=120.0) -> dict:
    deadline = time.monotonic() + timeout
    while not s.finished and time.monotonic() < deadline:
        time.sleep(0.02)
    assert s.finished, "restored sequence never completed"
    (rid, res), = s.finished.items()
    assert rid.startswith("restored-") and res["status"] == 200
    return res


def _port(cfg, label):
    return DecodeScheduler(cfg, device="cpu", replica_label=label)


@pytest.mark.parametrize("kw", [_SAMPLED, dict(max_new_tokens=12)], ids=["seeded", "greedy"])
def test_kill_restore_decode_equals_uninterrupted(tmp_path, kw):
    """A kill/restart restores in-flight KV-cache state from the arrangement
    snapshot, and the restored decode EQUALS the uninterrupted run."""
    res0 = _run_one(lambda: _port(_cfg(**_DURABLE), "u"), GenerationRequest, "u", kw)
    cfg1 = _cfg(**_DURABLE, snapshot_every=3, store_root=str(tmp_path / "kv"))
    s1 = _port(cfg1, "k")
    s2 = None
    try:
        _freeze_after(s1, 9, GenerationRequest, kw)
        s2 = _port(cfg1, "r")
        assert s2.restored_seqs == 1
        res2 = _finish_restored(s2)
        assert res2["tokens"] == res0["tokens"] and res2["text"] == res0["text"]
        assert s2.pool.in_use == 0
        # the finished sequence left the ledger: the next snapshot says so
        assert s2.snapshot() is not None and not KvLedger.restore(cfg1.store_root).live_seqs()
    finally:
        if s2 is not None:
            s2.stop()
        s1.stop()


def test_restore_false_ignores_the_store(tmp_path):
    root = str(tmp_path / "kv")
    led = KvLedger()
    led.put_seq(1, {"seq_id": 1, "tokens": [1, 2], "prompt_len": 2, "max_new": 2,
                    "temperature": 0.0, "top_k": 1, "seed": 0, "n_fed": 0,
                    "n_generated": 0, "remaining_ms": 1e6, "tenant": None, "n_pages": 1})
    led.snapshot(root)
    s = DecodeScheduler(_cfg(store_root=root), device="cpu", restore=False, replica_label="nr")
    try:
        assert s.restored_seqs == 0 and s.stats()["active_seqs"] == 0
    finally:
        s.stop()
    s = DecodeScheduler(_cfg(store_root=root), device="cpu", restore=True, replica_label="yr")
    try:
        assert s.restored_seqs == 1
        assert _finish_restored(s)["token_count"] == 2
    finally:
        s.stop()


def test_restored_pages_bit_equal_the_ledger(tmp_path, monkeypatch):
    cfg1 = _cfg(**_DURABLE, snapshot_every=2, store_root=str(tmp_path / "kv"))
    s1 = _port(cfg1, "bk")
    try:
        _freeze_after(s1, 12, GenerationRequest, dict(max_new_tokens=20))
        # hold the restored state still: no step may write the pools
        monkeypatch.setattr(DecodeScheduler, "_step", lambda self: time.sleep(0.05))
        s2 = _port(replace(cfg1, snapshot_every=0), "br")
        try:
            led = KvLedger.restore(cfg1.store_root)
            (seq,) = s2._active
            assert len(led.live_pages()) >= 2
            for (seq_id, page_idx), (k, v, _ident) in led.live_pages().items():
                pid = seq.pages[page_idx]
                assert s2.k_pool[:, pid].numpy().tobytes() == k.tobytes()
                assert s2.v_pool[:, pid].numpy().tobytes() == v.tobytes()
        finally:
            s2.stop()
    finally:
        s1.stop()


def test_out_of_thread_snapshot_runs_at_step_boundary(tmp_path):
    """snapshot() from a non-decode thread is executed AT the next step
    boundary by the decode thread, and the caller gets the result."""
    root = str(tmp_path / "snap")
    s = _port(_cfg(max_len=160, store_root=root), "snapth")
    try:
        r = _req("bg", "w" * 40, max_new_tokens=32)
        s.submit(r)
        deadline = time.monotonic() + 30
        while s.stats()["active_seqs"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        out = s.snapshot()  # test thread != decode thread
        assert out is not None and out["bytes_written"] > 0
        led = KvLedger.restore(root)
        assert led is not None and len(led.live_seqs()) == 1
        assert r.wait(60)["status"] == 200
        # an idle scheduler still serves out-of-thread snapshots (the loop
        # wakes on the waiter, not only on work)
        assert s.snapshot() is not None
        assert not KvLedger.restore(root).live_seqs()  # the finished one left
    finally:
        s.stop()
    assert _port(_cfg(), "nostore").snapshot() is None


def test_kv_handoff_resumes_on_new_owner(tmp_path):
    """A member's in-flight KV ledger splits by the jk-hash ownership into
    local stores; the owner's scheduler resumes the decode with the
    uninterrupted run's tokens, the other owner has nothing to resume."""
    res0 = _run_one(lambda: _port(_cfg(**_DURABLE), "hu"), GenerationRequest, "hu", _SAMPLED)
    root = str(tmp_path / "kv-src")
    s1 = _port(_cfg(**_DURABLE, snapshot_every=3, store_root=root), "hk")
    try:
        _freeze_after(s1, 9, GenerationRequest, _SAMPLED)
        owner = seq_owner(1, 2)
        roots = [str(tmp_path / "kv-p0"), str(tmp_path / "kv-p1")]
        stats = split_kv_store(root, roots)
        assert stats["total_seqs"] == 1 and stats["bytes_ferried"] == 0
        assert [d["seqs"] for d in stats["destinations"]] == [int(owner == 0), int(owner == 1)]
        s2 = _port(_cfg(**_DURABLE, store_root=roots[owner]), "ho")
        s3 = _port(_cfg(**_DURABLE, store_root=roots[1 - owner]), "hx")
        try:
            assert (s2.restored_seqs, s3.restored_seqs) == (1, 0)
            assert _finish_restored(s2)["tokens"] == res0["tokens"]
        finally:
            s2.stop()
            s3.stop()
    finally:
        s1.stop()


def test_split_kv_store_refuses_ferry_and_empty_sources(tmp_path, monkeypatch):
    """A ``(host, port)`` destination receives its part over the segment
    ferry (it raised naming [mesh] until the ferry was ported): the same
    snapshot files as a local destination, with the ferry's stats and the
    bytes ferried, as the JAX package's ``split_kv_store`` reports them. An
    empty source still raises ``HandoverError``."""
    from pathway_tpu.elastic.kv import split_kv_store as jax_split
    from pathway_tpu_torch.elastic.ferry import FerryReceiver

    monkeypatch.setenv("PATHWAY_DCN_SECRET", "kv-ferry-secret")
    led = KvLedger()
    for sid in range(1, 9):
        led.put_seq(sid, {"seq_id": sid})
        led.put_page(sid, 0, np.full((2, 4, 8), sid, np.float32), np.full((2, 4, 8), -sid, np.float32))
    led.snapshot(str(tmp_path / "src"))
    got = {}
    for name, split in (("port", split_kv_store), ("jax", jax_split)):
        recv = FerryReceiver(str(tmp_path / name / "remote"))
        try:
            res = split(str(tmp_path / "src"), [str(tmp_path / name / "local"), (recv.host, recv.port)],
                        transfer_id="kv")
        finally:
            recv.close()
        ferry = res["destinations"][1]["ferry"]
        assert ferry["committed"] and res["bytes_ferried"] == ferry["bytes_sent"] > 0
        assert res["destinations"][0]["ferry"] is None
        parts = [KvLedger.restore(str(tmp_path / name / d)) for d in ("local", "remote")]
        got[name] = (res["total_seqs"], [d["seqs"] for d in res["destinations"]], res["bytes_ferried"],
                     {k: v for k, v in ferry.items()},
                     [sorted(p.live_seqs()) for p in parts])
    assert got["port"] == got["jax"]
    total, seqs, _bytes, _ferry, owned = got["port"]
    assert total == 8 and sum(seqs) == 8 and sorted(owned[0] + owned[1]) == list(range(1, 9))
    with pytest.raises(HandoverError):
        split_kv_store(str(tmp_path / "none"), [str(tmp_path / "b")])


# --- durability across the packages ----------------------------------------

_X_CFG = dict(n_pages=16, page_size=8, max_batch=1, max_len=64, max_new_tokens=8, **_SMALL)


def _x_port(label, **kw):
    return _port(GenerateConfig(**_X_CFG, **kw), label)


def _x_jax(label, **kw):
    return JaxScheduler(JaxConfig(**_X_CFG, **kw, kernel="ref"), replica_label=label)


@pytest.mark.parametrize(
    "kw",
    # seed 3 samples no EOS within 24 tokens at this shape, so the kill lands
    # mid-generation
    [dict(_SAMPLED, max_new_tokens=24, seed=3), dict(max_new_tokens=24)],
    ids=["seeded", "greedy"],
)
@pytest.mark.parametrize(
    "writer,reader",
    [("jax", "torch"), ("torch", "jax")],
    ids=["jax-to-torch", "torch-to-jax"],
)
def test_kill_restore_across_packages(tmp_path, kw, writer, reader):
    """One package's scheduler snapshots mid-generation (24 of the 20 prompt
    + 24 new tokens' steps) and is frozen; the other package's scheduler
    restores the store and its tokens equal the writer package's
    uninterrupted run."""
    make = {"jax": (_x_jax, JaxRequest), "torch": (_x_port, GenerationRequest)}
    wmake, wreq = make[writer]
    rmake, _rreq = make[reader]
    res0 = _run_one(lambda: wmake("xu"), wreq, "xu", kw)
    root = str(tmp_path / "kv")
    s1 = wmake("xk", snapshot_every=3, store_root=root)
    try:
        _freeze_after(s1, 24, wreq, kw)
        s2 = rmake("xr", store_root=root)
        try:
            assert s2.restored_seqs == 1
            (meta,) = JaxLedger.restore(root).live_seqs().values()
            assert meta["n_generated"] > 0  # the kill landed mid-generation
            res2 = _finish_restored(s2)
            assert res2["tokens"] == res0["tokens"] and res2["text"] == res0["text"]
        finally:
            s2.stop()
    finally:
        s1.stop()


@pytest.mark.parametrize("splitter", ["jax", "torch"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")], ids=["jax-to-torch", "torch-to-jax"])
def test_split_kv_store_across_packages(tmp_path, splitter, writer, reader):
    """One package's scheduler snapshots mid-decode, either package's
    split_kv_store splits the store, and the other package's scheduler at
    the owning destination resumes with the uninterrupted run's tokens;
    both ledgers read every split store alike."""
    make = {"jax": (_x_jax, JaxRequest), "torch": (_x_port, GenerationRequest)}
    wmake, wreq = make[writer]
    rmake, _rreq = make[reader]
    res0 = _run_one(lambda: wmake("su"), wreq, "su", _SAMPLED)
    root = str(tmp_path / "src")
    s1 = wmake("sk", snapshot_every=3, store_root=root)
    try:
        _freeze_after(s1, 9, wreq, _SAMPLED)
        roots = [str(tmp_path / "d0"), str(tmp_path / "d1")]
        split = {"jax": jax_split_kv_store, "torch": split_kv_store}[splitter]
        stats = split(root, roots)
        assert stats["total_seqs"] == 1
        owner = seq_owner(1, 2)
        assert stats["destinations"][owner]["seqs"] == 1
        for r in roots:
            assert set(JaxLedger.restore(r).live_seqs()) == set(KvLedger.restore(r).live_seqs())
        s2 = rmake("so", store_root=roots[owner])
        try:
            assert _finish_restored(s2)["tokens"] == res0["tokens"]
        finally:
            s2.stop()
    finally:
        s1.stop()


def test_snapshot_meta_holds_only_python_scalars(tmp_path):
    """The pickled metadata must not need numpy or torch to restore."""
    root = str(tmp_path / "m")
    s = _port(_cfg(max_len=160, store_root=root), "meta")
    try:
        r = _req("m", "abc", max_new_tokens=40, temperature=np.float64(0.5), top_k=np.int64(3), seed=np.int64(2))
        r.prompt_tokens = [np.int64(t) for t in r.prompt_tokens]
        s.submit(r)
        deadline = time.monotonic() + 30
        while s.stats()["decode_steps"] < 6 and time.monotonic() < deadline:
            time.sleep(0.01)
        s.snapshot()
        (meta,) = KvLedger.restore(root).live_seqs().values()
        assert r.wait(60)["status"] == 200
    finally:
        s.stop()

    def plain(x):
        if isinstance(x, dict):
            return all(type(k) is str and plain(v) for k, v in x.items())
        if isinstance(x, list):
            return all(plain(v) for v in x)
        return x is None or type(x) in (int, float, str)

    assert plain(meta) and meta["top_k"] == 3 and meta["tokens"][:2] == dec.encode_text("abc")[:2]
