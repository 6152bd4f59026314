"""The router's result cache, held against the JAX package on the CPU
(``serving/result_cache.py``).

Each case of the reference's ``tests/test_result_cache.py`` runs the same
seeded sequence of stores, lookups and delta ticks through both packages'
``ResultCache`` and compares what is observable: the entries evicted at
each tick (and why, by the eviction counters), what every lookup answers
with its headers, flushes, the ordering guard, and — end to end — the
statuses, ``x-pathway-cache`` and replica hops through each package's
router. The reference's own assertions (the precision property: exactly
the covering entries leave, every survivor equals a fresh answer within
rtol 1e-5 / atol 1e-6) hold on the port's outcomes too.

Every wait and HTTP call has a deadline; ports are ephemeral."""

import json
import time

import numpy as np
import pytest

from torch_repl_parity import ToyVecIndex, both, pkg, post, wait


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "result-cache-parity-secret")
    monkeypatch.delenv("PATHWAY_ROUTER_CACHE", raising=False)
    monkeypatch.delenv("PATHWAY_ROUTER_CACHE_WRITER", raising=False)
    yield
    for name in ("jax", "torch"):
        pkg(name).reset()


def _norm(v):
    v = np.asarray(v, dtype=np.float32).reshape(-1)
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else v


def _fresh_answer(corpus, qvec, k):
    q = _norm(qvec)
    scored = sorted(((int(key), float(np.dot(q, _norm(vec)))) for key, vec in corpus.items()),
                    key=lambda m: (-m[1], m[0]))
    return {"matches": [[key, score] for key, score in scored[: int(k)]]}


def _body(qvec, k):
    return json.dumps({"vec": [float(x) for x in np.asarray(qvec).reshape(-1)], "k": k}).encode()


def _store(cache, tenant, corpus, qvec, k, tick=0, max_st=None, headers=()):
    body = _body(qvec, k)
    payload = json.dumps(_fresh_answer(corpus, qvec, k)).encode()
    hdrs = {"content-type": "application/json", "x-pathway-applied-tick": str(tick), **dict(headers)}
    return body, payload, cache.store(tenant, body, max_st, 200, payload, hdrs)


class _FakeStream:
    """Stands in for a DeltaStreamClient: freshness, applied tick and
    incarnation are set directly."""

    def __init__(self, staleness=0.0, applied_tick=0, incarnation=0):
        self.staleness = staleness
        self.applied_tick = applied_tick
        self.writer_incarnation = incarnation
        self.newest_known = applied_tick

    def staleness_seconds(self):
        return self.staleness

    def close(self):
        pass


def _lookup(cache, tenant, body, max_st=None, path=""):
    """A lookup's observable answer (the staleness header of a TTL-mode
    hit is its age, a clock: only its presence is compared)."""
    hit = cache.lookup(tenant, body, max_st, path=path)
    if hit is None:
        return None
    status, payload, headers = hit
    return status, payload, {k: (v if k != "x-pathway-staleness-seconds" or cache._client is not None else "age")
                             for k, v in headers.items()}


# --- the precision property (seeded) ------------------------------------------


def _precision(pk, n_shards):
    rng = np.random.default_rng(7 + n_shards)
    dim = 8
    cache = pk.result_cache.ResultCache(capacity=4096, dim=dim, ttl_ms=1e9)
    corpus = {k: rng.standard_normal(dim) for k in range(1, 41)}
    next_key = 1000
    queries = [(f"t{i % 3}", rng.standard_normal(dim), int(rng.choice([3, 5, 60]))) for i in range(18)]

    def store_all(tick):
        for tenant, qvec, k in queries:
            _store(cache, tenant, corpus, qvec, k, tick=tick)

    store_all(0)
    trace = []
    for tick in range(1, 13):
        ops = []
        live = sorted(corpus)
        for key in rng.choice(live, size=min(int(rng.integers(0, 3)), len(live)), replace=False):
            del corpus[int(key)]
            ops.append((int(key), -1, None))
        for _ in range(int(rng.integers(0, 3))):
            if rng.random() < 0.5 and corpus:
                key = int(rng.choice(sorted(corpus)))
            else:
                next_key += 1
                key = next_key
            vec = rng.standard_normal(dim).astype(np.float32)
            corpus[key] = vec
            ops.append((key, 1, vec))
        if not ops:
            continue
        changed = {k for k, _d, _v in ops}
        upserts = [(k, v) for k, d, v in ops if d > 0]
        expected = set()
        with cache._lock:
            entries = {ck: (set(e.keys), e.worst_score, e.full, e.qvec) for ck, e in cache._entries.items()}
        for ck, (keys, worst, full, qv) in entries.items():
            if keys & changed:
                expected.add(ck)
                continue
            for _u, uvec in upserts:
                if not full or float(np.dot(qv, _norm(uvec))) >= worst - 1e-6 * max(1.0, abs(worst)):
                    expected.add(ck)
                    break
        before = set(cache.entry_keys())
        if n_shards > 1:
            per_shard = {}
            for key, d, v in ops:
                per_shard.setdefault(key % n_shards, []).append((key, d, (v, None)))
            batches = [pk.batch(rows) for rows in per_shard.values()]
        else:
            batches = [pk.batch([(key, d, (v, None)) for key, d, v in ops])]
        cache.ingest(tick, batches)
        after = set(cache.entry_keys())
        assert before - after == expected and after == before - expected
        for tenant, qvec, k in queries:
            hit = cache.lookup(tenant, _body(qvec, k), None)
            if hit is None:
                continue
            got = json.loads(hit[1])["matches"]
            want = _fresh_answer(corpus, qvec, k)["matches"]
            assert [m[0] for m in got] == [m[0] for m in want]
            np.testing.assert_allclose([m[1] for m in got], [m[1] for m in want], rtol=1e-5, atol=1e-6)
        trace.append((tick, sorted(map(repr, before - after)), len(after)))
        store_all(tick)
    assert sum(n for _t, _e, n in trace) > 0, "every tick flushed the whole cache"
    return trace


@pytest.mark.parametrize("n_shards", [1, 3])
def test_invalidation_precision_property_equal_in_both_packages(n_shards):
    jax_out, torch_out = both(_precision, n_shards)
    assert torch_out == jax_out


def _bound_equality(pk):
    rng = np.random.default_rng(42)
    dim = 8
    out = []
    for _trial in range(25):
        cache = pk.result_cache.ResultCache(capacity=256, dim=dim, metric="cosine")
        corpus = {i: rng.normal(size=dim).astype(np.float32) for i in range(20)}
        for _e in range(rng.integers(3, 12)):
            _store(cache, f"t{rng.integers(0, 3)}", corpus, rng.normal(size=dim).astype(np.float32),
                   int(rng.integers(1, 26)), tick=0)
        rows = []
        for key in rng.choice(20, size=rng.integers(1, 4), replace=False):
            if rng.random() < 0.4:
                rows.append((int(key), -1, (None, None)))
            elif rng.random() < 0.15:
                rows.append((int(key), +1, (None, None)))
            else:
                vec = rng.normal(size=dim).astype(np.float32)
                s = rng.random()
                vec = vec * 10.0 if s < 0.25 else vec * 1e-3 if s < 0.5 else vec
                rows.append((int(key), +1, (vec, None)))
        changed = {int(k) for k, _d, _v in rows}
        dvecs = [cache._prep_vec(v[0]) if v[0] is not None else None for _k, d, v in rows if d > 0]
        with cache._lock:
            snapshot = [(ck, e.keys, e.worst_score, e.full, e.scoreable, e.qvec) for ck, e in cache._entries.items()]
        expected = set()
        for ck, keys, worst, full, scoreable, qvec in snapshot:
            if keys & changed:
                expected.add(ck)
                continue
            for dvec in dvecs:
                if not full or not scoreable or dvec is None or \
                        float(np.dot(qvec, dvec)) >= worst - pk.result_cache._SCORE_EPS * max(1.0, abs(worst)):
                    expected.add(ck)
                    break
        before = set(cache.entry_keys())
        cache.ingest(1, [pk.batch(rows)])
        evicted = before - set(cache.entry_keys())
        assert evicted == expected
        out.append(sorted(map(repr, evicted)))
    return out


def _bound_maintained(pk):
    rng = np.random.default_rng(7)
    dim = 8
    cache = pk.result_cache.ResultCache(capacity=4, dim=dim, metric="cosine")
    corpus = {i: rng.normal(size=dim).astype(np.float32) for i in range(6)}
    states = []

    def snap():
        bounds = [b for b, _s, _ck in cache._bound_index]
        assert len(cache._bound_index) == len(cache._entries) and bounds == sorted(bounds)
        assert {ck for _b, _s, ck in cache._bound_index} == set(cache._entries)
        states.append((bounds, sorted(map(repr, cache._entries))))

    for _ in range(8):
        _store(cache, "t", corpus, rng.normal(size=dim), 3, tick=0)
        snap()
    qvec = rng.normal(size=dim).astype(np.float32)
    _store(cache, "t", corpus, qvec, 3, tick=0)
    _store(cache, "t", corpus, qvec, 3, tick=0)
    snap()
    cache.ingest(1, [pk.batch([(0, -1, (None, None))])])
    snap()
    cache.flush("test")
    snap()
    return states


def _bound_excludes_safe(pk):
    import bisect

    rng = np.random.default_rng(11)
    dim = 8
    cache = pk.result_cache.ResultCache(capacity=64, dim=dim, metric="dot")
    qvec = _norm(rng.normal(size=dim)).astype(np.float32)

    def put(key_lo, worst):
        body = _body(qvec, 2)
        payload = json.dumps({"matches": [[key_lo, worst + 1.0], [key_lo + 1, worst]]}).encode()
        assert cache.store("t", body[:-1] + f',"tag":{key_lo}}}'.encode(), None, 200, payload,
                           {"x-pathway-applied-tick": "0"})

    put(0, 4.0)
    put(10, 0.01)
    d = (_norm(rng.normal(size=dim)) * 0.5).astype(np.float32)
    hi = bisect.bisect_right(cache._bound_index, (0.5, 1 << 62, ()))
    covered = len(cache._bound_index[:hi])
    cache.ingest(1, [pk.batch([(99, +1, (d, None))])])
    with cache._lock:
        worsts = sorted(e.worst_score for e in cache._entries.values())
    assert covered == 1 and 4.0 in worsts
    return covered, worsts


# --- keying, the request path and freshness -----------------------------------


def _keying(pk):
    rc = pk.result_cache
    out = {"fp": [rc.fingerprint(b) for b in (b'{"query": "x", "k": 3}', b'{"k": 3, "query": "x"}',
                                                b'{"k": 4, "query": "x"}', b"not json", b"[1,2,3]", b'"str"',
                                                b"", b"{}")]}
    rng = np.random.default_rng(1)
    corpus = {k: rng.standard_normal(4) for k in range(6)}
    cache = rc.ResultCache(capacity=16, dim=4, ttl_ms=1e9)
    q = rng.standard_normal(4)
    body, payload, ok = _store(cache, "tenant-a", corpus, q, 3, tick=5)
    out["roundtrip"] = (ok, _lookup(cache, "tenant-a", body), _lookup(cache, "tenant-b", body),
                        _lookup(cache, "tenant-a", _body(q, 5)), _lookup(cache, "tenant-a", body, 1000.0))
    ttl = rc.ResultCache(capacity=4, dim=4, ttl_ms=30.0)
    tb, _p, _ok = _store(ttl, "t", corpus, rng.standard_normal(4), 2)
    first = ttl.lookup("t", tb, None) is not None
    time.sleep(0.06)
    out["ttl"] = (first, ttl.lookup("t", tb, None) is None)
    c = rc.ResultCache(capacity=4, dim=4, ttl_ms=1e9)
    good = json.dumps({"matches": [[1, 0.5]]}).encode()
    b4 = _body(np.ones(4), 3)
    out["never_cached"] = [
        c.store("t", b4, None, 503, good, {}), c.store("t", b4, None, 200, good, {"x-pathway-stale": "1"}),
        c.store("t", b4, None, 200, b"not json", {}), c.store("t", b4, None, 200, json.dumps({"error": "x"}).encode(), {}),
        c.store("t", b4, None, 200, b"[1, 2, 3]", {}), c.store("t", b4, None, 200, b'"ok"', {}),
        c.store("t", b4, None, 200, b"42", {}),
    ]
    for bad_k in ("abc", None, [3], -1, 0):
        kb = json.dumps({"vec": [1.0, 0, 0, 0], "k": bad_k}).encode()
        out["never_cached"] += [c.lookup("t", kb, None), c.store("t", kb, None, 200, good, {})]
    out["never_cached"].append(len(c))
    p = rc.ResultCache(capacity=8, dim=4, ttl_ms=1e9)
    pb = _body(q, 2)
    pp = json.dumps(_fresh_answer(corpus, q, 2)).encode()
    out["path"] = (p.store("t", pb, None, 200, pp, {}, path="/query"), p.lookup("t", pb, None, path="/other"),
                   _lookup(p, "t", pb, path="/query"))
    lru = rc.ResultCache(capacity=2, dim=4, ttl_ms=1e9)
    bodies = [_store(lru, "t", corpus, rng.standard_normal(4), 2)[0] for _ in range(3)]
    out["lru"] = (len(lru), lru.lookup("t", bodies[0], None) is None, lru.lookup("t", bodies[2], None) is not None)
    return out


def _targeted(pk):
    rc = pk.result_cache
    e1, e2 = np.eye(4)[0], np.eye(4)[1]
    out = {}
    corpus = {1: e1, 2: e1 * 0.9, 3: e2, 4: e2 * 0.9}
    c = rc.ResultCache(capacity=8, dim=4, ttl_ms=1e9)
    b1, _p, _ = _store(c, "t", corpus, e1, 2)
    b2, _p, _ = _store(c, "t", corpus, e2, 2)
    c.ingest(1, [pk.batch([(1, -1, (None, None))])])
    out["delete"] = (c.lookup("t", b1, None) is None, c.lookup("t", b2, None) is not None)
    c = rc.ResultCache(capacity=8, dim=4, ttl_ms=1e9)
    b1, _p, _ = _store(c, "t", corpus, e1, 2)
    b2, _p, _ = _store(c, "t", corpus, e2, 2)
    c.ingest(1, [pk.batch([(99, 1, (np.eye(4)[1].astype(np.float32), None))])])
    out["score_test"] = (c.lookup("t", b1, None) is not None, c.lookup("t", b2, None) is None)
    far = (-np.eye(4)[0]).astype(np.float32)
    c = rc.ResultCache(capacity=8, dim=4, ttl_ms=1e9)
    b, _p, _ = _store(c, "t", {1: e1}, e1, 5)
    c.ingest(1, [pk.batch([(99, 1, (far, None))])])
    out["underfilled"] = c.lookup("t", b, None) is None
    c = rc.ResultCache(capacity=8, dim=4, metric="l2", ttl_ms=1e9)
    b, _p, ok = _store(c, "t", {1: e1, 2: e1 * 0.9}, e1, 2)
    c.ingest(1, [pk.batch([(99, 1, (far, None))])])
    out["unscoreable"] = (ok, c.lookup("t", b, None) is None)
    dim = 16
    qv = pk.replica.text_vector("hello world", dim)
    c = rc.ResultCache(capacity=8, dim=dim, ttl_ms=1e9)
    body = json.dumps({"query": "hello world", "k": 2}).encode()
    stored = c.store("t", body, None, 200, json.dumps(_fresh_answer({1: qv, 2: qv * 0.9}, qv, 2)).encode(), {})
    rng = np.random.default_rng(9)
    f = rng.standard_normal(dim).astype(np.float32)
    f -= qv * float(np.dot(_norm(f), _norm(qv)))
    c.ingest(1, [pk.batch([(99, 1, (f, None))])])
    out["query_text"] = (stored, c.lookup("t", body, None) is not None)
    return out


def _freshness(pk):
    rc = pk.result_cache
    out = {}
    rng = np.random.default_rng(4)
    corpus = {k: rng.standard_normal(4) for k in range(4)}
    c = rc.ResultCache(capacity=4, dim=4, max_lag_ms=100.0, ttl_ms=1e9)
    c._client = _FakeStream(staleness=0.0)
    body, _p, ok = _store(c, "t", corpus, rng.standard_normal(4), 2)
    lag = [ok, _lookup(c, "t", body)]
    for st, bound in ((0.5, None), (0.05, 10.0), (0.05, None), (None, None)):
        c._client.staleness = st
        lag.append(_lookup(c, "t", body, bound))
    out["lag"] = lag
    c = rc.ResultCache(capacity=4, dim=4, ttl_ms=1e9)
    c._client = _FakeStream(staleness=0.25, applied_tick=12)
    body, _p, ok = _store(c, "t", corpus, rng.standard_normal(4), 2, tick=12)
    c.max_lag_s = 10.0
    out["hit_headers"] = (ok, _lookup(c, "t", body))
    c = rc.ResultCache(capacity=4, dim=4, ttl_ms=1e9)
    c._client = _FakeStream(applied_tick=10)
    q = rng.standard_normal(4)
    guard = [_store(c, "t", corpus, q, 2, tick=5)[2],
             c.store("t", _body(q, 2), None, 200, json.dumps(_fresh_answer(corpus, q, 2)).encode(), {}),
             _store(c, "t", corpus, q, 2, tick=10)[2]]
    out["ordering_guard"] = guard
    c = rc.ResultCache(capacity=8, dim=4, ttl_ms=1e9)
    fake = _FakeStream(incarnation=0)
    c._client = fake
    _store(c, "t", corpus, rng.standard_normal(4), 2, tick=0)
    c.ingest(1, [])
    kept = len(c)
    fake.writer_incarnation = 1
    c.ingest(2, [])
    out["incarnation"] = (kept, len(c))
    c = rc.ResultCache(capacity=8, dim=4, ttl_ms=1e9)
    fake = _FakeStream(applied_tick=0)
    fake.newest_known = 7
    c._client = fake
    _store(c, "t", corpus, rng.standard_normal(4), 2, tick=0)
    out["resync"] = (c._on_resync(), len(c))
    return out


def _env_hatch(pk, monkeypatch):
    rc = pk.result_cache
    out = [rc.cache_enabled_via_env(), rc.cache_from_env()]
    out.append(pk.router.FailoverRouter(["http://127.0.0.1:9"]).cache)
    monkeypatch.setenv("PATHWAY_ROUTER_CACHE", "1")
    c = rc.cache_from_env()
    out.append((type(c).__name__, c._client, c.capacity, c.dim, c.max_lag_s, c.ttl_s))
    monkeypatch.setenv("PATHWAY_ROUTER_CACHE_WRITER", "not-a-hostport")
    with pytest.raises(ValueError) as e:
        rc.cache_from_env()
    out.append(str(e.value))
    monkeypatch.delenv("PATHWAY_ROUTER_CACHE")
    monkeypatch.delenv("PATHWAY_ROUTER_CACHE_WRITER")
    return out


def _dense_scores(pk):
    """A dense index's cosine scores are -(1 - cos) (the reference's
    USearch convention) while the cache re-scores an upsert as cos: an
    unrelated upsert passes the would-enter test against a replica's
    entry. Both packages evict — correct answers, fewer hits (a reference
    fault, kept for parity; see ROADMAP)."""
    idx = pk.knn_index(4)
    e = np.eye(4).astype(np.float32)
    for k in range(4):
        idx.upsert(k, e[k] + 0.1, None)
    matches = [[int(k), float(s)] for k, s in idx.search([(e[0], 2, None)])[0]]
    c = pk.result_cache.ResultCache(capacity=4, dim=4, ttl_ms=1e9)
    body = _body(e[0], 2)
    c.store("t", body, None, 200, json.dumps({"matches": matches}).encode(), {"x-pathway-applied-tick": "0"})
    c.ingest(1, [pk.batch([(9, 1, (e[3] - e[0] * 0.5, None))])])
    return [round(m[1], 5) for m in matches], len(c)


SCENARIOS = {
    "bound_index_eviction_equality_property": _bound_equality,
    "bound_index_maintained_across_store_drop_flush": _bound_maintained,
    "bound_index_excludes_provably_safe_entries": _bound_excludes_safe,
    "keying_and_request_path": _keying,
    "targeted_invalidation": _targeted,
    "freshness_with_a_stream": _freshness,
    "dense_index_scores_and_the_would_enter_test": _dense_scores,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reference_case_equal_in_both_packages(name):
    jax_out, torch_out = both(SCENARIOS[name])
    assert torch_out == jax_out


def test_reference_case_outcomes_hold():
    """The reference's own assertions on the port's outcomes."""
    tr = pkg("torch")
    k = _keying(tr)
    fp = k["fp"]
    assert fp[0][0] == fp[1][0] != fp[2][0] and fp[3:6] == [None, None, None] and fp[6][0] == fp[7][0]
    ok, hit, other, k5, bounded = k["roundtrip"]
    assert ok and hit[0] == 200 and hit[2]["x-pathway-cache"] == "hit" and hit[2]["x-pathway-applied-tick"] == "5"
    assert other is None and k5 is None and bounded is None
    assert k["ttl"] == (True, True) and k["never_cached"] == [False] * 7 + [None, False] * 5 + [0]
    assert k["path"][0] and k["path"][1] is None and k["path"][2] is not None and k["lru"] == (2, True, True)
    t = _targeted(tr)
    assert t == {"delete": (True, True), "score_test": (True, True), "underfilled": True,
                 "unscoreable": (True, True), "query_text": (True, True)}
    f = _freshness(tr)
    assert f["lag"][0] and f["lag"][1] is not None and f["lag"][2] is None and f["lag"][3] is None
    assert f["lag"][4] is not None and f["lag"][5] is None
    h = f["hit_headers"][1][2]
    assert h["x-pathway-applied-tick"] == "12" and h["x-pathway-staleness-seconds"] == "0.250"
    assert f["ordering_guard"] == [False, False, True] and f["incarnation"] == (1, 0) and f["resync"] == (7, 0)
    assert _dense_scores(tr)[1] == 0


def test_cache_from_env_escape_hatch_equal_in_both_packages(monkeypatch):
    jax_out, torch_out = both(_env_hatch, monkeypatch)
    assert torch_out == jax_out
    assert torch_out[:3] == [False, None, None] and "host:port" in torch_out[4]


# --- the cache on a live stream, and through the router -----------------------


def _attach_stream(pk, n_shards):
    srv = pk.replicate.DeltaStreamServer(0, n_shards=n_shards)
    cache = pk.result_cache.ResultCache(capacity=8, dim=4, max_lag_ms=60_000.0)
    try:
        cache.attach_stream("127.0.0.1", srv.port)
        e1 = np.eye(4)[0].astype(np.float32)
        srv.publish(1, [pk.batch([(1, 1, (e1, None)), (2, 1, (e1 * 0.9, None))])])
        assert wait(lambda: cache.applied_tick >= 1)
        body, _p, ok = _store(cache, "t", {1: e1, 2: e1 * 0.9}, e1, 2, tick=cache.applied_tick)
        hit = _lookup(cache, "t", body)
        srv.publish(2, [pk.batch([(1, -1, (None, None))])])
        assert wait(lambda: len(cache) == 0)
        return ok, hit[2]["x-pathway-cache"], hit[2]["x-pathway-applied-tick"], cache.lookup("t", body, None)
    finally:
        cache.close()
        srv.close()


@pytest.mark.parametrize("n_shards", [1, 3])
def test_attach_stream_evicts_from_live_writer_in_both_packages(n_shards):
    jax_out, torch_out = both(_attach_stream, n_shards)
    assert torch_out == jax_out == (True, "hit", "1", None)


def _router_cache(pk):
    srv = pk.replicate.DeltaStreamServer(0)
    hops = [0]

    def responder(server, values):
        hops[0] += 1
        q = np.asarray(values["vec"], dtype=np.float32)
        res = server.search([(q, int(values.get("k", 3)), None)])[0]
        return {"matches": [[int(k), float(s)] for k, s in res]}

    rep = pk.replica_server(replica_id=0, index_factory=ToyVecIndex, writer_port=srv.port,
                            responder=responder).start()
    cache = pk.result_cache.ResultCache(capacity=16, dim=4, metric="dot")
    cache.attach_stream("127.0.0.1", srv.port)
    router = pk.router.FailoverRouter([f"http://127.0.0.1:{rep.http_port}"], health_interval_ms=100,
                                      cache=cache).start()
    try:
        e1 = np.eye(4)[0].astype(np.float32)
        srv.publish(0, [pk.batch([(1, 1, (e1, None)), (2, 1, (e1 * 0.5, None))])])
        assert wait(lambda: rep.ready and cache.applied_tick >= 0)
        body = {"vec": [1.0, 0.0, 0.0, 0.0], "k": 2}
        hdrs = {"x-pathway-tenant": "hot"}
        assert wait(lambda: post(router.port, body=body, headers=hdrs).status == 200)
        cache.flush("test-reset")
        hops[0] = 0
        r1 = post(router.port, body=body, headers=hdrs)
        primed = hops[0]
        r2 = post(router.port, body=body, headers=hdrs)
        out = {"miss": (r1.status, r1.headers.get("x-pathway-cache"), primed >= 1),
               "hit": (r2.status, r2.headers.get("x-pathway-cache"), r2.headers.get("x-pathway-applied-tick"),
                       float(r2.headers["x-pathway-staleness-seconds"]) < 60.0, r2.json() == r1.json(),
                       hops[0] == primed)}
        r3 = post(router.port, body=body, headers={"x-pathway-tenant": "other"})
        out["other_tenant"] = (r3.status, r3.headers.get("x-pathway-cache"))
        srv.publish(1, [pk.batch([(1, -1, (None, None))])])
        assert wait(lambda: len(cache) == 0)
        assert wait(lambda: rep.applied_tick >= 1)
        r4 = post(router.port, body=body, headers=hdrs)
        out["after_delta"] = (r4.status, r4.headers.get("x-pathway-cache"), [m[0] for m in r4.json()["matches"]])
        return out
    finally:
        router.stop()
        rep.stop()
        srv.close()


def test_router_cache_end_to_end_zero_replica_hops_in_both_packages():
    jax_out, torch_out = both(_router_cache)
    assert torch_out == jax_out
    assert torch_out == {"miss": (200, None, True), "hit": (200, "hit", "0", True, True, True),
                         "other_tenant": (200, None), "after_delta": (200, None, [2])}
