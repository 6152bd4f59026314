"""The replication wire and the read replica, held against the JAX package
on the CPU (``parallel/wire.py``, ``parallel/replicate.py``,
``serving/replica.py``).

* The wire: the same frames encode to the same bytes in both packages, and
  each package decodes the other's.
* The stream across the packages: a ``DeltaStreamServer`` of one package
  serves a ``DeltaStreamClient`` of the other under the same
  ``PATHWAY_DCN_SECRET``; a wrong secret is refused both ways.
* Stores across the packages: a store and a delta stream written by one
  package's pipeline writer (the reference's
  ``test_pipeline_writer_snapshot_hydration_and_stream``) hydrate a replica
  of each package; both answer the same reads with equal keys, scores
  within 1e-5 (the two packages' f32 cosine sums).
* The reference's ``tests/test_replication.py`` cases, each run through
  both packages with its outcome (statuses, headers, applied ticks,
  resyncs, drops) compared.
* ``python -m pathway_tpu_torch.serving.replica`` as a process with
  ``PATHWAY_REPLICA_DEVICE=cpu``, and without a card on its default device
  (it raises; it never falls back to the CPU).

Every wait, join and HTTP call has a deadline; ports are ephemeral."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from torch_repl_parity import ToyIndex, both, get, pkg, post, same_matches, wait

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _repl_env(monkeypatch):
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "replication-parity-secret")
    yield
    for name in ("jax", "torch"):
        pkg(name).reset()


# --- the wire ------------------------------------------------------------


def _frames(pk):
    rng = np.random.default_rng(3)
    vecs = [rng.standard_normal(8).astype(np.float32) for _ in range(6)]
    DB = pk.batch_mod.DiffBatch
    return {
        "vectors": [pk.batch([(10 + i, 1, (v, None)) for i, v in enumerate(vecs)])],
        "retractions": [pk.batch([(10, 1, (vecs[0], None)), (11, -1, (None, None)), (12, 1, (vecs[2], None))])],
        "unsorted_keys": [pk.batch([(k, 1, (vecs[0], None)) for k in (2**63 + 5, 7, 2**40, 3)])],
        "varint_diffs": [DB.from_rows([(1, 3, (1,)), (2, -7, (2,)), (3, 1, (300,))], ("n",))],
        "numeric": [DB(np.arange(5, dtype=np.uint64) * 1000, np.ones(5, np.int64),
                       {"i": np.arange(5, dtype=np.int64) * 70000, "f": np.linspace(0, 1, 5),
                        "b": np.array([True, False, True, True, False])})],
        "strings": [pk.batch([(1, 1, (vecs[0], "meta-a")), (2, 1, (vecs[1], None)), (3, 1, (vecs[2], "b"))])],
        "two_batches": [pk.batch([(1, 1, (vecs[0], None))]), pk.batch([(2, -1, (None, None))])],
    }


CASES = ["vectors", "retractions", "unsorted_keys", "varint_diffs", "numeric", "strings", "two_batches"]


@pytest.mark.parametrize("quant", [None, "bf16", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_wire_frame_bytes_equal_and_decode_across(case, quant):
    jx, tr = pkg("jax"), pkg("torch")
    fj, ft = _frames(jx)[case], _frames(tr)[case]
    bj, sj = jx.wire.encode_frame(("data", 0, "repl:idx", 42, fj, "00-tp"), "codec", quant)
    bt, st = tr.wire.encode_frame(("data", 0, "repl:idx", 42, ft, "00-tp"), "codec", quant)
    assert bt == bj and st == sj
    # each package decodes the other's bytes into its own batches
    dt, dj = tr.wire.decode_frame(bj), jx.wire.decode_frame(bt)
    assert dt[:4] == dj[:4] == ("data", 0, "repl:idx", 42) and dt[5] == "00-tp"
    assert tr.wire.batches_equal(dt[4], tr.wire.decode_frame(bt)[4])
    assert jx.wire.batches_equal(dj[4], jx.wire.decode_frame(bj)[4])
    assert all(type(b).__module__.startswith("pathway_tpu_torch.") for b in dt[4])
    if quant is None:
        assert tr.wire.batches_equal(dt[4], ft)


@pytest.mark.parametrize("frame", [("suback", 12, 3, False, 2, 1), ("hb", 99)], ids=["suback", "hb"])
def test_wire_control_frames_equal(frame):
    jx, tr = pkg("jax"), pkg("torch")
    bj, _ = jx.wire.encode_frame(frame)
    bt, _ = tr.wire.encode_frame(frame)
    assert bt == bj and tr.wire.decode_frame(bj) == jx.wire.decode_frame(bt) == frame


# --- the stream across the packages ---------------------------------------


@pytest.mark.parametrize("server,client", [("jax", "torch"), ("torch", "jax")])
def test_delta_stream_across_packages(server, client):
    sp, cp = pkg(server), pkg(client)
    srv = sp.replicate.DeltaStreamServer(0)
    applied = []
    cl = cp.replicate.DeltaStreamClient(
        "127.0.0.1", srv.port, 0, from_tick=-1,
        on_deltas=lambda t, bs: applied.append(
            (t, [(int(k), d, None if v[0] is None else v[0].tolist(), v[1]) for b in bs for k, d, v in b.iter_rows()])
        ),
    )
    cl.start()
    try:
        v = np.arange(4, dtype=np.float32)
        srv.publish(0, [sp.batch([(1, 1, (v, "m")), (2, 1, (v * 2, None))])])
        srv.publish(1, [])
        srv.publish(2, [sp.batch([(1, -1, (None, None))])])
        assert wait(lambda: applied and applied[-1][0] == 2)
        assert applied == [
            (0, [(1, 1, [0.0, 1.0, 2.0, 3.0], "m"), (2, 1, [0.0, 2.0, 4.0, 6.0], None)]),
            (1, []),
            (2, [(1, -1, None, None)]),
        ]
        assert cl.caught_up and cl.staleness_seconds() == 0.0
    finally:
        cl.close()
        srv.close()


@pytest.mark.parametrize("server,client", [("jax", "torch"), ("torch", "jax")])
def test_wrong_secret_is_refused_across_packages(server, client, monkeypatch):
    sp, cp = pkg(server), pkg(client)
    srv = sp.replicate.DeltaStreamServer(0)
    try:
        monkeypatch.setenv("PATHWAY_DCN_SECRET", "another-secret")
        cl = cp.replicate.DeltaStreamClient(
            "127.0.0.1", srv.port, 0, from_tick=-1, on_deltas=lambda t, bs: None, connect_timeout=5.0
        )
        with pytest.raises(cp.replicate.ReplicationError, match="authentication"):
            cl._dial()
    finally:
        srv.close()


# --- the reference's cases, through both packages --------------------------


def _consolidate(pk):
    rows = [(1, 1, ("a", None)), (2, 1, ("b", None)), (1, -1, (None, None)), (1, 1, ("a2", None)),
            (3, 1, ("c", None)), (2, -1, (None, None))]
    return pk.replicate.consolidate_rows(rows)


def _roundtrip(pk):
    srv = pk.replicate.DeltaStreamServer(0)
    applied, late = [], []
    cl = pk.replicate.DeltaStreamClient(
        "127.0.0.1", srv.port, 0, from_tick=-1, on_deltas=lambda t, bs: applied.append((t, sum(len(b) for b in bs)))
    )
    cl.start()
    try:
        srv.publish(0, [pk.batch([(1, 1, ("x", None)), (2, 1, ("y", "m"))])])
        srv.publish(1, [])
        srv.publish(2, [pk.batch([(1, -1, (None, None))])])
        assert wait(lambda: applied and applied[-1][0] == 2)
        cl2 = pk.replicate.DeltaStreamClient("127.0.0.1", srv.port, 1, from_tick=0,
                                             on_deltas=lambda t, bs: late.append(t))
        cl2.start()
        assert wait(lambda: late and late[-1] == 2)
        cl2.close()
        return {"applied": applied, "tick": cl.applied_tick, "caught_up": cl.caught_up,
                "staleness": cl.staleness_seconds(), "late": late}
    finally:
        cl.close()
        srv.close()


def _resync(pk):
    srv = pk.replicate.DeltaStreamServer(0, ring_ticks=2)
    for t in range(10):
        srv.publish(t, [])
    resyncs, applied = [], []

    def on_resync():
        resyncs.append(1)
        return 8

    cl = pk.replicate.DeltaStreamClient("127.0.0.1", srv.port, 0, from_tick=1,
                                        on_deltas=lambda t, bs: applied.append(t), on_resync=on_resync)
    cl.start()
    try:
        assert wait(lambda: cl.applied_tick >= 9)
        return {"resyncs": resyncs, "client_resyncs": cl.resyncs, "all_after": all(t >= 8 for t in applied),
                "caught_up": cl.caught_up, "applied_tick": cl.applied_tick}
    finally:
        cl.close()
        srv.close()


def _slow_replica(pk):
    srv = pk.replicate.DeltaStreamServer(0, outbox_depth=8)
    gate = threading.Event()
    cl = pk.replicate.DeltaStreamClient("127.0.0.1", srv.port, 0, from_tick=-1,
                                        on_deltas=lambda t, bs: gate.wait(30.0))
    cl.start()
    try:
        assert wait(lambda: len(srv._subs) == 1, timeout=10)
        t0 = time.monotonic()
        for t in range(200):
            srv.publish(t, [pk.batch([(t, 1, ("x", None))])])
        fast = time.monotonic() - t0 < 5.0
        return {"publish_never_blocked": fast, "dropped": wait(lambda: len(srv._subs) == 0, timeout=10)}
    finally:
        gate.set()
        cl.close()
        srv.close()


def _same_tick(pk):
    srv = pk.replicate.DeltaStreamServer(0)
    seen, late = {}, {}

    def into(d):
        return lambda t, bs: d.setdefault(t, set()).update(int(k) for b in bs for k, _d, _v in b.iter_rows())

    cl = pk.replicate.DeltaStreamClient("127.0.0.1", srv.port, 0, from_tick=-1, on_deltas=into(seen))
    cl.start()
    try:
        assert wait(lambda: len(srv._subs) == 1, timeout=10)
        srv.publish(5, [pk.batch([(1, 1, ("a", None))])])
        srv.publish(5, [pk.batch([(2, 1, ("b", None))])])
        assert wait(lambda: seen.get(5) == {1, 2}, timeout=10)
        cl2 = pk.replicate.DeltaStreamClient("127.0.0.1", srv.port, 1, from_tick=-1, on_deltas=into(late))
        cl2.start()
        assert wait(lambda: late.get(5) == {1, 2}, timeout=10)
        cl2.close()
        return {"live": sorted(seen[5]), "replayed": sorted(late[5])}
    finally:
        cl.close()
        srv.close()


def _deep_rejoin(pk):
    srv = pk.replicate.DeltaStreamServer(0, outbox_depth=16)
    for t in range(600):
        srv.publish(t, [pk.batch([(t, 1, ("x", None))])])
    applied = []
    cl = pk.replicate.DeltaStreamClient("127.0.0.1", srv.port, 0, from_tick=100,
                                        on_deltas=lambda t, bs: applied.append(t))
    cl.start()
    try:
        assert wait(lambda: cl.applied_tick == 599, timeout=20)
        return {"applied": applied == list(range(100, 600)), "resyncs": cl.resyncs}
    finally:
        cl.close()
        srv.close()


def _fake_store(pk, root):
    import pickle

    store = pk.backends.FilesystemStore(str(root / f"pstorage-{pk.name}"))
    old = {"live_queries": {}, "emitted": {}, "index_state": ("dict", {"corpus": "OLD", "metadata": {}})}
    store.put("states/gen-000004/00007.pkl", pickle.dumps(old))
    meta = {"last_time": 40, "chunks": {},
            "state": {"gen": 5, "time": 50, "nodes": {"7": "ExternalIndexNode"}},
            "retained_states": [{"state": {"gen": 4, "time": 40, "nodes": {"7": "ExternalIndexNode"}}, "chunks": {}}]}
    store.put("metadata.json", json.dumps(meta).encode())
    return store


def _hydrate_torn(pk, root):
    import pickle

    store = _fake_store(pk, root)
    first = pk.replica.hydrate_index_state(store)
    new = {"live_queries": {}, "emitted": {}, "index_state": ("dict", {"corpus": "NEW", "metadata": {}})}
    store.put("states/gen-000005/00007.pkl", pickle.dumps(new))
    second = pk.replica.hydrate_index_state(store)
    empty = pk.replica.hydrate_index_state(pk.backends.FilesystemStore(str(root / f"empty-{pk.name}")))
    return {"torn": first, "intact": second, "empty": empty}


def _serves_and_sheds(pk):
    srv = pk.replicate.DeltaStreamServer(0)
    rep = pk.replica_server(
        replica_id=7, index_factory=ToyIndex, writer_port=srv.port,
        responder=lambda s, v: {"n": len(s.index.d), "matches": s.search([(None, v.get("k", 3), None)])[0]},
        stale_after_ms=500,
    ).start()
    try:
        srv.publish(0, [pk.batch([(i, 1, (f"d{i}", None)) for i in range(4)])])
        assert wait(lambda: rep.ready)
        out = {}
        r = post(rep.http_port, body={"k": 2})
        out["fresh"] = (r.status, r.json(), r.headers["x-pathway-replica"], "x-pathway-stale" in r.headers,
                        float(r.headers["x-pathway-staleness-seconds"]) < 1.0)
        r = post(rep.http_port, body={}, headers={"x-pathway-max-staleness-ms": "0"})
        out["bound_zero"] = r.status
        srv.close()
        assert wait(lambda: rep.is_stale(), timeout=10)
        r = post(rep.http_port, body={}, headers={"x-pathway-max-staleness-ms": "100"})
        out["shed"] = (r.status, "retry-after" in r.headers, r.json())
        r = post(rep.http_port, body={})
        out["stale"] = (r.status, r.headers.get("x-pathway-stale"),
                        float(r.headers["x-pathway-staleness-seconds"]) > 0.4)
        return out
    finally:
        rep.stop()
        srv.close()


def _health(pk):
    srv = pk.replicate.DeltaStreamServer(0)
    rep = pk.replica_server(replica_id=3, index_factory=ToyIndex, writer_port=srv.port).start()
    try:
        srv.publish(5, [pk.batch([(1, 1, ("a", None))])])
        assert wait(lambda: rep.applied_tick == 5)
        h = get(rep.http_port, "/replica/health").json()
        return {k: h[k] for k in ("replica", "applied_tick", "newest_tick", "ready", "connected", "stale",
                                  "resyncs", "hydrated_gen", "shard", "n_shards", "fenced_writers",
                                  "config_error", "generate", "staleness_seconds")}
    finally:
        rep.stop()
        srv.close()


def _gated(pk):
    srv = pk.replicate.DeltaStreamServer(0)
    rep = pk.replica_server(replica_id=9, index_factory=ToyIndex, writer_port=srv.port,
                            responder=lambda s, v: {"ok": True},
                            qos=pk.serving.QoSConfig(rate_limit_rps=1.0, rate_limit_burst=1.0)).start()
    try:
        srv.publish(0, [])
        assert wait(lambda: rep.ready)
        codes = []
        for _ in range(8):
            r = post(rep.http_port, body={})
            codes.append((r.status, r.status != 429 or "retry-after" in r.headers))
        return codes
    finally:
        rep.stop()
        srv.close()


def _staleness_predicate(pk):
    f = pk.replica.staleness_bound_exceeded
    return [f(s, st, m) for s, st, m in [(0.0, False, "0"), (0.0, True, "0"), (None, False, "10"),
                                          (0.5, False, "400"), (0.5, False, "600"), (1.0, True, None),
                                          (1.0, False, "nan"), (1.0, False, "x")]]


def _text_vector(pk):
    return [pk.replica.text_vector(t, 16).tolist() for t in ("doc 1", "a b c", "")]


SCENARIOS = {
    "consolidate_rows_last_op_wins": _consolidate,
    "delta_stream_roundtrip_replay_and_staleness": _roundtrip,
    "delta_stream_resync_beyond_ring": _resync,
    "writer_never_blocks_on_slow_replica": _slow_replica,
    "second_publish_same_tick_reaches_live_subscribers": _same_tick,
    "deep_rejoin_backlog_larger_than_outbox": _deep_rejoin,
    "replica_serves_and_sheds_on_staleness_bound": _serves_and_sheds,
    "replica_health_endpoint_reports_freshness": _health,
    "gated_replica_sheds_429_not_500": _gated,
    "staleness_bound_predicate": _staleness_predicate,
    "text_vector_pseudo_embedder": _text_vector,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reference_case_equal_in_both_packages(name):
    jax_out, torch_out = both(SCENARIOS[name])
    assert torch_out == jax_out


def test_reference_case_outcomes_hold():
    """The reference's own assertions, on the port's outcomes."""
    tr = pkg("torch")
    out = _consolidate(tr)
    assert [(r[0], r[1]) for r in out] == [(1, 1), (3, 1), (2, -1)] and out[0][2] == ("a2", None)
    rt = _roundtrip(tr)
    assert rt["applied"] == [(0, 2), (1, 0), (2, 1)] and rt["late"] == [0, 1, 2] and rt["staleness"] == 0.0
    rs = _resync(tr)
    assert rs["resyncs"] == [1] and rs["client_resyncs"] == 1 and rs["all_after"] and rs["caught_up"]
    assert _slow_replica(tr) == {"publish_never_blocked": True, "dropped": True}
    assert _same_tick(tr) == {"live": [1, 2], "replayed": [1, 2]}
    assert _deep_rejoin(tr) == {"applied": True, "resyncs": 0}
    codes = [c for c, _ra in _gated(tr)]
    assert 200 in codes and 429 in codes and 500 not in codes


@pytest.mark.parametrize("name", ["hydrate_prefers_newest_but_survives_torn_generation"])
def test_reference_store_case_equal_in_both_packages(name, tmp_path):
    jax_out, torch_out = both(_hydrate_torn, tmp_path)
    assert torch_out == jax_out
    assert torch_out["torn"] == (("dict", {"corpus": "OLD", "metadata": {}}), 40, 4)
    assert torch_out["intact"][1:] == (50, 5) and torch_out["intact"][0][1]["corpus"] == "NEW"
    assert torch_out["empty"] is None


# --- stores across the packages: a pipeline writer, replicas of both -------


DIM = 8


def _writer(pk, tmp: Path):
    """The reference's pipeline writer in one package: documents stream in
    as JSON lines, ``text_vector`` embeds them, a persisted ``DataIndex``
    holds them and PATHWAY_REPL_PORT=0 publishes every tick."""
    import importlib

    pw = importlib.import_module(pk.root)
    indexing = importlib.import_module(pk.root + ".stdlib.indexing")
    pw.internals.parse_graph.G.clear()
    in_dir, q_dir = tmp / "in", tmp / "q"
    in_dir.mkdir()
    q_dir.mkdir()

    class DocS(pw.Schema):
        text: str

    with open(in_dir / "f0.jsonl", "w") as f:
        for i in range(8):
            f.write(json.dumps({"text": f"doc {i}"}) + "\n")
    tv = pk.replica.text_vector
    docs = pw.io.jsonlines.read(str(in_dir), schema=DocS, mode="streaming")
    docs = docs.select(vec=pw.apply(lambda t: tv(t, DIM), docs.text), text=docs.text)
    queries = pw.io.jsonlines.read(str(q_dir), schema=DocS, mode="streaming")
    queries = queries.select(vec=pw.apply(lambda t: tv(t, DIM), queries.text))
    index = indexing.DataIndex(docs, indexing.TpuKnn(docs.vec, dimensions=DIM, **pk.device_kw))
    pw.io.null.write(index.query_as_of_now(queries.vec, number_of_matches=2).select(texts=pw.right.text))
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(tmp / "pstorage")),
                                              snapshot_every=2)
    run_t = threading.Thread(target=lambda: pw.run(persistence_config=cfg, autocommit_duration_ms=25), daemon=True)
    run_t.start()
    assert wait(lambda: pk.replicate.publisher() is not None and pk.replicate.publisher().newest_tick() >= 0,
                timeout=60)
    for i in range(8, 20):
        with open(in_dir / f"f{i}.jsonl", "w") as f:
            f.write(json.dumps({"text": f"doc {i}"}) + "\n")
        time.sleep(0.05)
    store = pk.backends.FilesystemStore(str(tmp / "pstorage"))
    assert wait(lambda: pk.replica.hydrate_index_state(store) is not None, timeout=60)

    def stop():
        rt = pw.internals.parse_graph.G.runtime
        if rt is not None:
            rt.stop()
        run_t.join(timeout=30)
        assert not run_t.is_alive()
        pw.internals.parse_graph.G.clear()

    return pk.replicate.publisher(), stop


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_and_stream_of_one_package_serve_replicas_of_both(writer, tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_REPL_PORT", "0")
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    wp = pkg(writer)
    wp.reset()
    pub, stop = _writer(wp, tmp_path)
    reps = []
    try:
        for name in ("jax", "torch"):
            pk = pkg(name)
            reps.append(pk.replica_server(
                replica_id=len(reps), index_factory=lambda pk=pk: pk.knn_index(DIM),
                store_root=str(tmp_path / "pstorage"), writer_port=pub.port, dim=DIM,
            ).start())
        assert all(r.hydrated_tick >= 0 for r in reps)  # from a real generation
        assert wait(lambda: all(r.ready for r in reps), timeout=30)
        assert wait(lambda: all(r.index.corpus is not None and len(r.index.corpus) == 20 for r in reps), timeout=30)
        assert reps[0].applied_tick == reps[1].applied_tick
        for text in ("doc 12", "doc 3", "doc 19", "something else"):
            got = [post(r.http_port, body={"query": text, "k": 3}) for r in reps]
            assert [g.status for g in got] == [200, 200]
            mj, mt = (g.json()["matches"] for g in got)
            assert same_matches(mt, mj, 1e-5), (mt, mj)
            if text.startswith("doc"):
                assert abs(mt[0][1]) < 1e-5  # the exact self-match
    finally:
        for r in reps:
            r.stop()
        stop()


# --- the replica as a process ------------------------------------------------


def _child_env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **extra)
    for name in ("PATHWAY_FAULTS", "PATHWAY_REPLICA_DEVICE", "PATHWAY_REPL_PORT"):
        env.pop(name, None)
    env.update(extra)
    return env


def test_replica_process_on_the_cpu_follows_the_stream(tmp_path):
    """``python -m pathway_tpu_torch.serving.replica`` with
    PATHWAY_REPLICA_DEVICE=cpu: it subscribes to a JAX-package writer's
    stream, answers as the JAX package's index does, reports its (zero)
    kernel launches at /replica/kernels and exits cleanly on SIGTERM."""
    jx = pkg("jax")
    srv = jx.replicate.DeltaStreamServer(0)
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((40, DIM)).astype(np.float32)
    srv.publish(0, [jx.batch([(100 + i, 1, (v, None)) for i, v in enumerate(vecs)])])
    ref = jx.knn_index(DIM)
    for i, v in enumerate(vecs):
        ref.upsert(100 + i, v, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch.serving.replica"], cwd=str(ROOT),
        env=_child_env(PATHWAY_REPLICA_DEVICE="cpu", PATHWAY_REPL_PORT=str(srv.port),
                       PATHWAY_REPLICA_DIM=str(DIM), PATHWAY_REPLICA_ID="4",
                       PATHWAY_DCN_SECRET=os.environ["PATHWAY_DCN_SECRET"]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    try:
        port = None
        t_end = time.monotonic() + 120
        while port is None and time.monotonic() < t_end:
            ln = proc.stdout.readline()
            if not ln:
                break
            lines.append(ln)
            if ln.startswith("REPLICA-READY "):
                port = int(ln.split()[1])
        assert port is not None, "".join(lines)
        assert wait(lambda: get(port, "/replica/health").json()["ready"], timeout=30)
        for qi in range(3):
            r = post(port, body={"vec": vecs[qi].tolist(), "k": 4})
            assert r.status == 200 and r.headers["x-pathway-replica"] == "4"
            want = [[k, s] for k, s in ref.search([(vecs[qi], 4, None)])[0]]
            assert same_matches(r.json()["matches"], want, 1e-5)
        signals = get(port, "/debug/signals")
        assert signals.status == 200 and signals.json()["enabled"]  # the role arms its sampler
        launched = get(port, "/replica/kernels").json()
        assert launched["block_topk"] == 0 and launched["paged_attention"] == 0  # plain versions on the CPU
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
        assert proc.returncode == 0
        assert "REPLICA-CLEAN-EXIT" in out
        assert "[observability]" not in "".join(lines)  # nothing left unported on the role
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        srv.close()


def test_replica_process_on_its_default_device_raises_without_a_card():
    """Left on its default device (cuda) without a card the role raises —
    it does not fall back to the CPU; and it does so before it binds."""
    r = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.serving.replica"], cwd=str(ROOT),
        env=_child_env(PATHWAY_DCN_SECRET="x", PATHWAY_REPLICA_DIM=str(DIM)),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "REPLICA-READY" not in r.stdout
    assert "torch.cuda.is_available() is False" in r.stderr
