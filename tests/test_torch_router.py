"""The failover router, the sharded plane and ``/generate`` on a replica,
held against the JAX package on the CPU (``serving/router.py``,
``serving/replica.py``, ``parallel/replicate.py``, ``generate/serving.py``).

Each case of the reference's ``tests/test_replication.py`` (router part),
``tests/test_sharded_serving.py`` (all but the standby and supervisor
cases) and ``tests/test_generate.py`` (the ``/generate`` cases) runs the
same scenario through both packages — the port's router and replica on its
own standard-library HTTP stack, the reference's on aiohttp — and compares
the observable outcome: statuses, headers, picks, ejections, retries,
merged top-k, fencing and the generated tokens (the JAX decoder on the CPU
as its own tests run it; both decoders are seeded alike, in float32). The
fleet views of the router and the replicas' ``/debug/signals`` and
``/debug/trace`` (501 naming [observability] until it was ported) answer
as the reference's do, and never hang.

Every wait, join and HTTP call has a deadline; ports are ephemeral."""

import socket
import threading
import time

import numpy as np
import pytest

from torch_repl_parity import ToyIndex, ToyVecIndex, both, get, pkg, post, toy_responder, wait


@pytest.fixture(autouse=True)
def _repl_env(monkeypatch):
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "router-parity-secret")
    for name in ("PATHWAY_SERVING_SHARDS", "PATHWAY_SERVING_SHARD_MAP", "PATHWAY_MESH_INCARNATION",
                 "PATHWAY_ROUTER_CACHE", "PATHWAY_SERVING_HEDGE_MS", "PATHWAY_TENANT_QOS"):
        monkeypatch.delenv(name, raising=False)
    yield
    for name in ("jax", "torch"):
        pkg(name).reset()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _stop_all(router=None, reps=(), srv=None):
    if router is not None:
        router.stop()
    for r in reps:
        r.stop()
    if srv is not None:
        srv.close()


def _plane(pk, n_replicas=2, stale_after_ms=3000, responder=None, **router_kw):
    srv = pk.replicate.DeltaStreamServer(0)
    reps = [
        pk.replica_server(replica_id=rid, index_factory=ToyIndex, writer_port=srv.port,
                          responder=responder or toy_responder, stale_after_ms=stale_after_ms).start()
        for rid in range(n_replicas)
    ]
    router = pk.router.FailoverRouter([f"http://127.0.0.1:{r.http_port}" for r in reps],
                                      health_interval_ms=100, **router_kw).start()
    return srv, reps, router


# --- the router (tests/test_replication.py) ----------------------------------


def _failover_smoke(pk):
    """A mid-query replica death is retried on the sibling inside the
    original deadline (two ``router.attempt`` spans); later reads answer;
    the restarted replica is re-admitted once it is ready."""
    srv, reps, router = _plane(pk)
    out = {}
    gate = threading.Event()
    try:
        srv.publish(0, [pk.batch([(i, 1, (f"d{i}", None)) for i in range(3)])])
        assert wait(lambda: all(r.ready for r in reps))
        assert wait(lambda: all(ep.ready for ep in router.endpoints), timeout=10)
        out["first"] = post(router.port, body={"k": 2}).status
        failures = []
        router.add_failure_listener(lambda name, why: failures.append(name))
        wedge = threading.Semaphore(1)

        def wedging(s, v):
            if v.get("block") and wedge.acquire(blocking=False):
                gate.wait(30.0)
                raise RuntimeError("victim never answers")
            return toy_responder(s, v)

        for rep in reps:
            rep.responder = wedging
        result = {}

        def do_request():
            t0 = time.monotonic()
            result["resp"] = post(router.port, body={"k": 2, "block": True},
                                  headers={"x-pathway-deadline-ms": "20000"}, timeout=25)
            result["elapsed"] = time.monotonic() - t0

        req_t = threading.Thread(target=do_request)
        req_t.start()
        assert wait(lambda: any(ep.inflight > 0 for ep in router.endpoints), timeout=10)
        victim = next(ep for ep in router.endpoints if ep.inflight > 0)
        victim_idx = int(victim.name.replace("replica", ""))
        reps[victim_idx]._http.stop()
        req_t.join(timeout=25)
        assert not req_t.is_alive()
        r = result["resp"]
        out["retried"] = (r.status, r.json()["replica"] != victim_idx, result["elapsed"] < 20.0)
        trace_id = r.headers["traceparent"].split("-")[1]
        attempts = [s for s in pk.tracing.get_tracer().spans(seconds=60)
                    if s.trace_id == trace_id and s.name == "router.attempt"]
        out["attempts"] = sorted(s.attributes.get("replica") for s in attempts)
        assert wait(lambda: failures, timeout=10)
        out["first_failure_is_victim"] = failures[0] == victim.name
        gate.set()
        out["after"] = [post(router.port, body={"k": 1}).status for _ in range(10)]
        old_port = reps[victim_idx].http_port
        reps[victim_idx].stop()
        reps[victim_idx] = pk.replica_server(replica_id=victim_idx, index_factory=ToyIndex, writer_port=srv.port,
                                             http_port=old_port, responder=toy_responder).start()
        out["restarted_ready"] = wait(lambda: reps[victim_idx].ready, timeout=15)
        out["readmitted"] = wait(lambda: not victim.ejected, timeout=15)
        return out
    finally:
        gate.set()
        _stop_all(router, reps, srv)


def _max_staleness_zero(pk):
    srv, reps, router = _plane(pk, stale_after_ms=400)
    try:
        srv.publish(0, [pk.batch([(1, 1, ("a", None))])])
        assert wait(lambda: all(r.ready for r in reps))
        assert wait(lambda: all(ep.ready for ep in router.endpoints))
        out = {"fresh_bound_zero": post(router.port, headers={"x-pathway-max-staleness-ms": "0"}).status}
        srv.close()
        assert wait(lambda: all(r.is_stale() for r in reps), timeout=10)
        assert wait(lambda: all(ep.staleness_s is None or ep.staleness_s > 0.4 for ep in router.endpoints),
                    timeout=10)
        r = post(router.port, headers={"x-pathway-max-staleness-ms": "200"})
        out["bounded"] = (r.status, "retry-after" in r.headers, r.json())
        r = post(router.port)
        out["unbounded"] = (r.status, r.headers.get("x-pathway-stale"))
        return out
    finally:
        _stop_all(router, reps, srv)


def _occupancy_pick(pk):
    E = pk.router.ReplicaEndpoint
    a, b = E("replica0", "http://a"), E("replica1", "http://b")
    for ep in (a, b):
        ep.ready = True
        ep.staleness_s = 0.0
    a.inflight, b.inflight = 5, 1
    out = [sorted([a, b], key=E.score)[0].name]
    b.reported_inflight = 10
    out.append(sorted([a, b], key=E.score)[0].name)
    a.ejected = True
    out += [a.qualifies(None), b.qualifies(None)]
    b.staleness_s = 2.0
    out += [b.qualifies(1000.0), b.qualifies(3000.0), b.serves_stale()]
    return out


def _hedge(pk):
    slow_gate = threading.Event()

    def slow(s, v):
        if s.replica_id == 0:
            slow_gate.wait(10.0)
        return {"replica": s.replica_id}

    srv, reps, router = _plane(pk, responder=slow, hedge_ms=150)
    try:
        srv.publish(0, [])
        assert wait(lambda: all(r.ready for r in reps))
        assert wait(lambda: all(ep.ready for ep in router.endpoints))
        router.endpoints[1].reported_inflight = 5  # the slow replica goes first
        t0 = time.monotonic()
        r = post(router.port)
        return {"status": r.status, "winner": r.json()["replica"], "fast": time.monotonic() - t0 < 5.0}
    finally:
        slow_gate.set()
        _stop_all(router, reps, srv)


def _deadline_and_client_errors(pk):
    """A replica slower than the request's deadline: 504 from the router;
    an unknown route: the replica's 404 passes through; the router's own
    journal at /debug/events."""

    def slow(s, v):
        time.sleep(float(v.get("delay_s", 0)))
        return {"ok": True}

    srv, reps, router = _plane(pk, n_replicas=1, responder=slow)
    try:
        srv.publish(0, [])
        assert wait(lambda: all(ep.ready for ep in router.endpoints), timeout=10)
        r = post(router.port, body={"delay_s": 1.0}, headers={"x-pathway-deadline-ms": "200"})
        out = {"deadline": (r.status, r.json())}
        out["unknown_route"] = post(router.port, "/nope").status
        out["events"] = get(router.port, "/debug/events").status
        return out
    finally:
        _stop_all(router, reps, srv)


# --- the sharded plane (tests/test_sharded_serving.py) ------------------------


def _merge_property(pk):
    rng = np.random.default_rng(7)
    outs = []
    for _trial in range(50):
        n_shards, k = int(rng.integers(1, 5)), int(rng.integers(1, 8))
        pool = [[int(key), float(score)] for key, score in
                zip(rng.choice(10_000, size=40, replace=False), rng.choice([0.1, 0.5, 0.5, 0.9], size=40))]
        shards = [pool[s::n_shards] for s in range(n_shards)]
        per = [sorted(s, key=lambda m: (-m[1], m[0]))[:k] for s in shards]
        merged = pk.router.merge_topk(per, k)
        assert merged == sorted(pool, key=lambda m: (-m[1], m[0]))[:k]
        outs.append(merged)
    return outs


def _torn_maps(pk, monkeypatch):
    R = pk.router
    out = []
    for bad in ([["http://a"], []], [["http://a"], ["http://a"]], []):
        with pytest.raises(ValueError) as e:
            R.validate_shard_map(bad)
        out.append(str(e.value))
    with pytest.raises(ValueError) as e:
        R.FailoverRouter(shards=[["http://a"], ["http://b", "http://a"]])
    out.append(str(e.value))
    monkeypatch.setenv("PATHWAY_SERVING_SHARD_MAP", "http://a|http://b|")
    with pytest.raises(ValueError) as e:
        R.shard_map_from_env()
    out.append(str(e.value))
    monkeypatch.setenv("PATHWAY_SERVING_SHARD_MAP", "http://a/,http://b | http://c")
    out.append(R.shard_map_from_env())
    monkeypatch.delenv("PATHWAY_SERVING_SHARD_MAP")
    for shard, n in ((5, 3), (-1, 3)):
        with pytest.raises(ValueError) as e:
            pk.replica_server(replica_id=0, index_factory=ToyVecIndex, shard=shard, n_shards=n)
        out.append(str(e.value))
    return out


def _apply(index, ops):
    for key, diff, vec in ops:
        if diff > 0:
            index.upsert(key, vec, None)
        else:
            index.remove(key)


def _scatter_property(pk):
    rng = np.random.default_rng(42)
    outs = []
    for _trial in range(8):
        n_shards = int(rng.integers(2, 5))
        vocab = rng.standard_normal((4, 6)).astype(np.float32)
        live, ops = set(), []
        for _ in range(200):
            if live and rng.random() < 0.3:
                key = int(rng.choice(sorted(live)))
                live.discard(key)
                ops.append((key, -1, None))
            else:
                key = int(rng.integers(0, 500))
                live.add(key)
                ops.append((key, 1, vocab[int(rng.integers(0, 4))]))
        shard_ops = [[] for _ in range(n_shards)]
        for op in ops:
            shard_ops[int(pk.replicate.corpus_shard_of([op[0]], n_shards)[0])].append(op)
        skew = [int(rng.integers(len(so) // 2, len(so) + 1)) if so else 0 for so in shard_ops]
        idxs, ref = [ToyVecIndex() for _ in range(n_shards)], ToyVecIndex()
        for s in range(n_shards):
            _apply(idxs[s], shard_ops[s][: skew[s]])
            _apply(ref, shard_ops[s][: skew[s]])
        for qi in range(5):
            q = vocab[qi % 4] + (0 if qi < 4 else rng.standard_normal(6).astype(np.float32))
            k = int(rng.integers(1, 9))
            per = [[[key, sc] for key, sc in ix.search([(q, k, None)])[0]] for ix in idxs]
            merged = pk.router.merge_topk(per, k)
            assert merged == [[key, sc] for key, sc in ref.search([(q, k, None)])[0]]
            outs.append(merged)
    return outs


def _sharded_fanout(pk):
    srv = pk.replicate.DeltaStreamServer(0, n_shards=2)
    seen = {0: [], 1: [], -1: []}
    ticks = {0: [], 1: [], -1: []}
    clients = []
    for shard in (0, 1, -1):
        cl = pk.replicate.DeltaStreamClient(
            "127.0.0.1", srv.port, shard if shard >= 0 else -7, from_tick=-1,
            on_deltas=lambda t, bs, shard=shard: (ticks[shard].append(t),
                                                  seen[shard].extend(int(k) for b in bs for k, _d, _v in b.iter_rows())),
            shard=shard, expect_shards=2 if shard >= 0 else 0,
        )
        cl.start()
        clients.append(cl)
    try:
        keys = list(range(40))
        srv.publish(0, [pk.batch([(k, 1, (f"d{k}", None)) for k in keys])])
        srv.publish(1, [])
        assert wait(lambda: all(t and t[-1] == 1 for t in ticks.values()))
        dest = pk.replicate.corpus_shard_of(keys, 2)
        for shard in (0, 1):
            assert set(seen[shard]) == {k for k, s in zip(keys, dest) if int(s) == shard}
        return {s: sorted(v) for s, v in seen.items()} | {"applied": [cl.applied_tick for cl in clients]}
    finally:
        for cl in clients:
            cl.close()
        srv.close()


def _fence_torn_count(pk):
    srv = pk.replicate.DeltaStreamServer(0, n_shards=2)
    applied = []
    cl = pk.replicate.DeltaStreamClient("127.0.0.1", srv.port, 0, from_tick=-1,
                                        on_deltas=lambda t, bs: applied.append(t), shard=0, expect_shards=3)
    cl.start()
    cl2 = None
    try:
        srv.publish(0, [pk.batch([(1, 1, ("a", None))])])
        assert wait(lambda: cl.config_error is not None, timeout=10)
        cl2 = pk.replicate.DeltaStreamClient("127.0.0.1", srv.port, 1, from_tick=-1,
                                             on_deltas=lambda t, bs: applied.append(t))
        cl2.start()
        assert wait(lambda: cl2.config_error is not None, timeout=10)
        time.sleep(0.3)
        return {"errors": [cl.config_error, cl2.config_error], "applied": applied}
    finally:
        cl.close()
        if cl2 is not None:
            cl2.close()
        srv.close()


def _vec_responder(server, values):
    q = np.asarray(values["vec"], dtype=np.float32)
    res = server.search([(q, int(values.get("k", 3)), None)])[0]
    return {"matches": [[int(k), float(s)] for k, s in res]}


def _two_shard_smoke(pk):
    srv = pk.replicate.DeltaStreamServer(0, n_shards=2)
    reps = [[pk.replica_server(replica_id=s * 2 + i, index_factory=ToyVecIndex, writer_port=srv.port,
                               responder=_vec_responder, shard=s, n_shards=2).start() for i in range(2)]
            for s in range(2)]
    router = pk.router.FailoverRouter(shards=[[f"http://127.0.0.1:{m.http_port}" for m in ms] for ms in reps],
                                      health_interval_ms=100).start()
    out = {}
    try:
        rng = np.random.default_rng(3)
        vecs = {k: rng.standard_normal(4).astype(np.float32) for k in range(30)}
        srv.publish(0, [pk.batch([(k, 1, (v, None)) for k, v in vecs.items()])])
        srv.publish(1, [pk.batch([(5, -1, (None, None))])])
        del vecs[5]
        assert wait(lambda: all(m.ready for ms in reps for m in ms), timeout=20)
        assert wait(lambda: all(ep.ready for ep in router.endpoints), timeout=10)
        out["owned"] = [[sorted(m.index.keys()) for m in ms] for ms in reps]
        q = [float(x) for x in rng.standard_normal(4).astype(np.float32)]
        r = post(router.port, body={"vec": q, "k": 6})
        out["merged"] = (r.status, r.headers.get("x-pathway-shards"), r.json()["matches"])
        ref = ToyVecIndex()
        for k, v in vecs.items():
            ref.upsert(k, v, None)
        want = [k for k, _s in ref.search([(np.asarray(q, np.float32), 6, None)])[0]]
        assert [m[0] for m in r.json()["matches"]] == want
        out["client_error"] = post(router.port, "/nope").status
        reps[0][0]._http.stop()
        r = post(router.port, body={"vec": q, "k": 6})
        out["sibling"] = (r.status, r.json()["matches"] == out["merged"][2])
        reps[0][1]._http.stop()
        assert wait(lambda: all(ep.ejected for ep in router.endpoints if ep.shard == 0), timeout=15)
        r = post(router.port, body={"vec": q, "k": 6}, headers={"x-pathway-max-staleness-ms": "60000"})
        out["shard_dark"] = (r.status, "retry-after" in r.headers, r.headers.get("x-pathway-missing-shards"),
                             r.json()["error"])
        return out
    finally:
        router.stop()
        for ms in reps:
            for m in ms:
                m.stop()
        srv.close()


def _zombie_fenced(pk):
    p1, p2 = _free_port(), _free_port()
    applied = []
    cl = pk.replicate.DeltaStreamClient(
        "127.0.0.1", p1, 0, from_tick=-1,
        on_deltas=lambda t, bs: applied.append((t, [int(k) for b in bs for k, _d, _v in b.iter_rows()])),
        endpoints=[("127.0.0.1", p1), ("127.0.0.1", p2)],
    )
    new_writer = pk.replicate.DeltaStreamServer(p2, incarnation=1)
    cl.start()
    zombie = None
    try:
        new_writer.publish(0, [pk.batch([(1, 1, ("legit", None))])])
        assert wait(lambda: cl.writer_incarnation == 1, timeout=15)
        assert wait(lambda: applied and applied[-1][0] == 0, timeout=10)
        new_writer.close()
        zombie = pk.replicate.DeltaStreamServer(p1, incarnation=0)
        zombie.publish(50, [pk.batch([(666, 1, ("zombie", None))])])
        assert wait(lambda: cl.fenced_count >= 1, timeout=15)
        time.sleep(0.5)
        return {"zombie_applied": any(666 in keys for _t, keys in applied), "applied_tick": cl.applied_tick}
    finally:
        cl.close()
        new_writer.close()
        if zombie is not None:
            zombie.close()


def _probe_shuns_zombie(pk):
    p1, p2 = _free_port(), _free_port()
    zombie = pk.replicate.DeltaStreamServer(p1, incarnation=0)
    legit = pk.replicate.DeltaStreamServer(p2, incarnation=1)
    zombie.publish(50, [pk.batch([(666, 1, ("zombie", None))])])
    legit.publish(0, [pk.batch([(1, 1, ("legit", None))])])
    applied = []
    cl = pk.replicate.DeltaStreamClient(
        "127.0.0.1", p1, 0, from_tick=-1,
        on_deltas=lambda t, bs: applied.append((t, [int(k) for b in bs for k, _d, _v in b.iter_rows()])),
        endpoints=[("127.0.0.1", p1), ("127.0.0.1", p2)],
    )
    cl.start()
    try:
        assert wait(lambda: cl.writer_incarnation == 1, timeout=15)
        assert wait(lambda: applied and applied[-1][0] == 0, timeout=10)
        time.sleep(0.3)
        return {"zombie_applied": any(666 in keys for _t, keys in applied), "incarnation": cl.writer_incarnation}
    finally:
        cl.close()
        zombie.close()
        legit.close()


def _unsharded_router_refuses(pk):
    srv = pk.replicate.DeltaStreamServer(0, n_shards=2)
    member = pk.replica_server(replica_id=0, index_factory=ToyVecIndex, writer_port=srv.port,
                               responder=_vec_responder, shard=0, n_shards=2).start()
    router = pk.router.FailoverRouter([f"http://127.0.0.1:{member.http_port}"], health_interval_ms=100).start()
    try:
        srv.publish(0, [pk.batch([(1, 1, (np.ones(4, np.float32), None))])])
        assert wait(lambda: member.ready, timeout=15)
        ep = router.endpoints[0]
        assert wait(lambda: ep.ejected, timeout=10)
        return {"reason": ep.eject_reason, "ready": ep.ready}
    finally:
        _stop_all(router, [member], srv)


def _filter_keys(pk):
    idx = pk.knn_index(8)
    rng = np.random.default_rng(0)
    vecs = {k: rng.standard_normal(8).astype(np.float32) for k in range(3000)}
    for k, v in vecs.items():
        idx.upsert(k, v, {"k": k})
    full = idx.resident_bytes()
    idx.filter_keys(lambda k: k < 900)
    res = idx.search([(vecs[5], 1, None)])[0]
    return {"keys": sorted(idx.keys()), "meta": idx.metadata == {k: {"k": k} for k in range(900)},
            "shrank": idx.resident_bytes() < full / 2, "top": res[0][0]}


def _hydrate_to_shard(pk, root):
    import json
    import pickle

    src = {k: np.ones(4, dtype=np.float32) * k for k in range(50)}
    store = pk.backends.FilesystemStore(str(root / f"pstorage-{pk.name}"))
    # a dense index's state blob, as a writer of either package stores it
    idx = pk.knn_index(4)
    for k, v in src.items():
        idx.upsert(k, v, None)
    state = {"live_queries": {}, "emitted": {}, "index_state": ("dict", idx.state_dict())}
    store.put("states/gen-000001/00003.pkl", pickle.dumps(state))
    store.put("metadata.json", json.dumps({"last_time": 9, "chunks": {}, "state": {
        "gen": 1, "time": 9, "nodes": {"3": "ExternalIndexNode"}}}).encode())
    rep = pk.replica_server(replica_id=0, index_factory=lambda: pk.knn_index(4),
                            store_root=str(root / f"pstorage-{pk.name}"), shard=1, n_shards=3)
    rep.hydrate()
    owned = sorted(rep.index.keys())
    dest = pk.replicate.corpus_shard_of(list(range(50)), 3)
    assert owned == [k for k in range(50) if int(dest[k]) == 1]
    return owned


SCENARIOS = {
    "router_two_replica_failover_smoke": _failover_smoke,
    "router_max_staleness_zero_routes_fresh_or_sheds": _max_staleness_zero,
    "router_occupancy_weighted_pick": _occupancy_pick,
    "router_hedges_slow_replica": _hedge,
    "router_deadline_and_client_errors": _deadline_and_client_errors,
    "merge_topk_equals_brute_force_property": _merge_property,
    "scatter_gather_property_random_corpora": _scatter_property,
    "sharded_fanout_delivers_only_owned_keys": _sharded_fanout,
    "stream_fences_torn_shard_count": _fence_torn_count,
    "router_two_shard_scatter_gather_smoke": _two_shard_smoke,
    "zombie_primary_is_fenced": _zombie_fenced,
    "restarted_replica_probes_endpoints_and_shuns_zombie": _probe_shuns_zombie,
    "unsharded_router_refuses_shard_owning_member": _unsharded_router_refuses,
    "tpu_index_filter_keys_compacts": _filter_keys,
}

EXPECTED = {
    "router_two_replica_failover_smoke": {
        "first": 200, "retried": (200, True, True), "attempts": ["replica0", "replica1"],
        "first_failure_is_victim": True, "after": [200] * 10, "restarted_ready": True, "readmitted": True,
    },
    "router_occupancy_weighted_pick": ["replica1", "replica0", False, True, False, True, False],
    "router_hedges_slow_replica": {"status": 200, "winner": 1, "fast": True},
    "zombie_primary_is_fenced": {"zombie_applied": False, "applied_tick": 0},
    "restarted_replica_probes_endpoints_and_shuns_zombie": {"zombie_applied": False, "incarnation": 1},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reference_case_equal_in_both_packages(name):
    jax_out, torch_out = both(SCENARIOS[name])
    assert torch_out == jax_out
    if name in EXPECTED:
        assert torch_out == EXPECTED[name]


def test_router_outcomes_hold_as_in_the_reference():
    """The reference's own assertions on the port's outcomes of the cases
    whose outcome is not a constant."""
    tr = pkg("torch")
    st = _max_staleness_zero(tr)
    assert st["fresh_bound_zero"] == 200 and st["bounded"][:2] == (503, True) and st["unbounded"] == (200, "true")
    dl = _deadline_and_client_errors(tr)
    assert dl["deadline"][0] == 504 and dl["unknown_route"] == 404 and dl["events"] == 200
    sm = _two_shard_smoke(tr)
    assert sm["merged"][:2] == (200, "2") and sm["client_error"] == 404 and sm["sibling"] == (200, True)
    assert sm["shard_dark"][:3] == (503, True, "0") and "shard" in sm["shard_dark"][3]
    ft = _fence_torn_count(tr)
    assert ft["applied"] == [] and all("torn shard assignment" in e for e in ft["errors"])
    assert "shard-mismatch" in _unsharded_router_refuses(tr)["reason"]


def test_shard_map_validation_equal_in_both_packages(monkeypatch):
    jax_out, torch_out = both(_torn_maps, monkeypatch)
    assert torch_out == jax_out
    assert "no members" in torch_out[0] and "listed in shard" in torch_out[1] and "empty" in torch_out[2]
    assert torch_out[5] == [["http://a", "http://b"], ["http://c"]]
    assert all("torn shard" in m for m in torch_out[6:])


def test_replica_hydration_filters_to_shard_in_both_packages(tmp_path):
    jax_out, torch_out = both(_hydrate_to_shard, tmp_path)
    assert torch_out == jax_out and torch_out


# --- the fleet views and the replicas' debug routes ---------------------------


def _fleet_routes(pk):
    import importlib

    from pathway_tpu_torch.observability.exposition import parse_exposition

    # in-process replicas arm no sampler (their process's main() does): start
    # from none, whatever an earlier test of this process armed
    importlib.import_module(f"{pk.root}.observability.signals").reset_sampler()
    srv, reps, router = _plane(pk, n_replicas=2)
    try:
        srv.publish(0, [])
        statuses, members = [], {}
        for path in ("/fleet/metrics", "/fleet/events", "/fleet/trace?trace_id=x"):
            r = get(router.port, path, timeout=10)
            statuses.append(r.status)
            if path == "/fleet/metrics":
                fams, errs = parse_exposition(r.body.decode())
                assert not errs, errs[:3]
                members["metrics"] = sorted(
                    {s.labels["member"] for f in fams.values() for s in f.samples})
                members["up"] = sorted(
                    (s.labels["member"], s.value) for s in fams["pathway_fleet_member_up"].samples)
            elif path == "/fleet/events":
                members["events"] = r.json()["members"]
            else:
                members["trace"] = r.json()["otherData"]["members"]
        for path in ("/debug/signals?series=5", "/debug/trace?seconds=1", "/debug/signals?series=x"):
            r = get(reps[0].http_port, path, timeout=10)
            statuses.append(r.status)
            if r.status == 200 and path.startswith("/debug/signals"):
                members["signals"] = sorted(r.json())
        statuses.append(get(reps[0].http_port, "/metrics").status)
        return statuses, members
    finally:
        _stop_all(router, reps, srv)


def test_fleet_and_signal_routes_answer_501_naming_observability():
    """Named for the 501s these routes gave until [observability] was
    ported: the fleet views and the replicas' debug routes now answer as
    the reference's — the same statuses, member names and documents."""
    jax_out, torch_out = both(_fleet_routes)
    assert torch_out == jax_out
    statuses, members = torch_out
    assert statuses == [200, 200, 200, 200, 200, 200, 200]
    assert [m for m, v in members["up"] if v == 1.0] == ["replica0", "replica1", "router"]
    assert members["trace"][0] == "router" and len(members["trace"]) == 3


# --- /generate on a replica (tests/test_generate.py) ---------------------------


def _gen_replica(pk):
    dim = 16
    cfg = pk.scheduler.GenerateConfig(n_pages=32, page_size=8, max_batch=4, max_len=128, max_new_tokens=8,
                                      dim=64, n_layers=1, n_heads=2, head_dim=32, ffn_dim=128)
    srv = pk.replica_server(replica_id=0, index_factory=lambda: pk.knn_index(dim), dim=dim)
    for i, text in enumerate(["alpha beta", "gamma delta", "epsilon zeta", "eta theta"]):
        srv.index.upsert(i, pk.replica.text_vector(text, dim), None)
    sched = pk.gen_serving.attach_generate(
        srv, pk.scheduler.DecodeScheduler(cfg, replica_label="e2e", **pk.device_kw))
    srv.start()
    return srv, sched


def _generate(pk):
    srv, sched = _gen_replica(pk)
    out = {}
    try:
        port = srv.http_port
        r = post(port, "/generate", {"prompt": "what is alpha?", "k": 2, "max_tokens": 8}, timeout=60)
        b = r.json()
        out["ask"] = (r.status, b["token_count"], b["tokens"], b["retrieved"][0][0], len(b["retrieved"]),
                      r.headers["x-pathway-replica"], r.headers["x-pathway-generate-tokens"],
                      "x-pathway-applied-tick" in r.headers, "x-pathway-staleness-seconds" in r.headers)
        srv.index.upsert(99, pk.replica.text_vector("what is alpha? exact", srv.dim), None)
        r2 = post(port, "/generate", {"prompt": "what is alpha?", "k": 2, "max_tokens": 8}, timeout=60).json()
        out["conditioned"] = (r2["retrieved"] != b["retrieved"], r2["tokens"] != b["tokens"], r2["tokens"])
        baseline = sched.pool.in_use
        r = post(port, "/generate", {"prompt": "y" * 60, "k": 0, "max_tokens": 48},
                 headers={"x-pathway-deadline-ms": "60"}, timeout=60)
        out["deadline"] = (r.status, "retry-after" in r.headers)
        out["pages_back"] = wait(lambda: sched.pool.in_use == baseline, timeout=5)
        out["bad"] = [post(port, "/generate", body, timeout=60).status
                      for body in ({"k": 2}, {"prompt": "x", "max_tokens": "lots"}, {"prompt": "x", "max_tokens": 10_000},
                                   {"prompt": "x", "k": 2, "vec": "abc"})]
        r = post(port, "/generate", {"prompt": "fresh only", "k": 1, "max_tokens": 4},
                 headers={"x-pathway-max-staleness-ms": "50"}, timeout=60)
        out["stale_shed"] = (r.status, "retry-after" in r.headers)
        neg = [post(port, "/generate", {"prompt": "neg", "k": 0, "max_tokens": 4, "temperature": 0.7, "seed": -1},
                    timeout=60).json() for _ in range(2)]
        out["negative_seed"] = (neg[0]["token_count"], neg[0]["tokens"] == neg[1]["tokens"])
        r = post(port, "/generate", {"prompt": "stream me", "k": 1, "max_tokens": 5, "stream": True}, timeout=60)
        import json

        lines = [json.loads(ln) for ln in r.body.decode().splitlines()]
        out["stream"] = (r.headers["content-type"].split(";")[0], len(lines[0]["meta"]["retrieved"]),
                         [ln["token"] for ln in lines if "token" in ln], lines[-1]["done"], lines[-1]["token_count"])
        router = pk.router.FailoverRouter([f"http://127.0.0.1:{port}"]).start()
        try:
            assert wait(lambda: all(ep.ready for ep in router.endpoints), timeout=10)
            r = post(router.port, "/generate", {"prompt": "via router", "k": 2, "max_tokens": 6},
                     headers={"x-pathway-deadline-ms": "30000"}, timeout=60)
            out["router"] = (r.status, r.json()["token_count"], r.json()["tokens"], r.headers.get("x-pathway-replica"))
        finally:
            router.stop()
        out["routes"] = [pk.gen_serving.is_generate_route(p) for p in ("/generate", "/v1/generate/", "/query",
                                                                        "/regenerate")]
        return out
    finally:
        srv.stop()


def test_generate_route_equal_in_both_packages():
    jax_out, torch_out = both(_generate)
    assert torch_out == jax_out
    assert torch_out["ask"][:2] == (200, 8) and torch_out["ask"][4:] == (2, "0", "8", True, True)
    assert torch_out["conditioned"][:2] == (True, True)
    assert torch_out["deadline"] == (504, True) and torch_out["pages_back"]
    assert torch_out["bad"] == [400, 400, 400, 400] and torch_out["stale_shed"] == (503, True)
    assert torch_out["negative_seed"] == (4, True)
    assert torch_out["stream"][0] == "application/x-ndjson" and len(torch_out["stream"][2]) == 5
    assert torch_out["router"][:2] == (200, 6) and torch_out["router"][3] == "0"
    assert torch_out["routes"] == [True, True, False, False]
