"""The port's Surge Gate (``pathway_tpu_torch/serving``) held against the JAX
package's: config, admission, token bucket, EDF micro-batching, the gate's
accounting races, the session priority classes and the bounded bulk drain,
tenancy (``PATHWAY_TENANT_QOS=1``) and degraded stale reads; then the REST
cases of ``tests/test_serving_qos.py`` on the port's stdlib server (429 with
``Retry-After``, expired deadlines never dispatched, drain, the listener
freed on stop, non-finite deadline headers, ``PATHWAY_SERVING_ENABLED``).

Deterministic scenarios run under both packages (parametrized by ``pkg``, or
run side by side and compared); the REST cases drive the port alone, with
stdlib ``http.client`` clients. The JAX side runs its interpreter
(``PATHWAY_COMPILED_TICK=0``)."""

import http.client
import importlib
import json
import socket
import threading
import time
from collections import Counter

import numpy as np
import pytest

import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph

PKGS = ["pathway_tpu", "pathway_tpu_torch"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _request(port, method, route, payload=None, headers=None, timeout=30.0):
    """(status, headers, parsed body) through a stdlib client."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = None if payload is None else json.dumps(payload)
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, route, body=body, headers=hdrs)
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type") or ""
        data = json.loads(raw) if ctype.startswith("application/json") else raw
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data
    finally:
        conn.close()


class _Req:
    def __init__(self, key, deadline):
        self.key = key
        self.vals = (key,)
        self.deadline = deadline
        self.enqueued_at = time.monotonic()


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


# --- config ----------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_bucket_ladder(pkg):
    s = _mod(pkg, "serving")
    assert s.default_bucket_ladder(32) == (1, 2, 4, 8, 16, 32)
    cfg = s.QoSConfig(max_batch_size=32)
    assert [cfg.bucket_for(n) for n in (1, 3, 32, 100)] == [1, 4, 32, 32]
    assert s.QoSConfig(max_batch_size=10, batch_buckets=(4, 10)).bucket_for(5) == 10


@pytest.mark.parametrize("pkg", PKGS)
def test_qos_config_env_overrides(pkg, monkeypatch):
    s = _mod(pkg, "serving")
    monkeypatch.setenv("PATHWAY_SERVING_MAX_QUEUE", "7")
    monkeypatch.setenv("PATHWAY_SERVING_MAX_BATCH", "4")
    monkeypatch.setenv("PATHWAY_SERVING_MAX_WAIT_MS", "2.5")
    monkeypatch.setenv("PATHWAY_SERVING_RPS", "100")
    cfg = s.QoSConfig.from_env()
    assert (cfg.max_queue, cfg.max_batch_size, cfg.max_wait_ms, cfg.rate_limit_rps) == (
        7, 4, 2.5, 100.0,
    )
    assert s.QoSConfig.from_env(s.QoSConfig(default_deadline_ms=1234.0)).default_deadline_ms == 1234.0
    monkeypatch.setenv("PATHWAY_SERVING_MAX_QUEUE", "nope")
    with pytest.raises(ValueError):
        s.QoSConfig.from_env()


@pytest.mark.parametrize("pkg", PKGS)
def test_qos_config_env_empty_values(pkg, monkeypatch):
    s = _mod(pkg, "serving")
    monkeypatch.setenv("PATHWAY_SERVING_MAX_QUEUE", "")
    monkeypatch.setenv("PATHWAY_SERVING_MAX_WAIT_MS", "")
    monkeypatch.setenv("PATHWAY_SERVING_RPS", "")
    cfg = s.QoSConfig.from_env(s.QoSConfig(rate_limit_rps=5.0))
    assert (cfg.max_queue, cfg.max_wait_ms, cfg.rate_limit_rps) == (256, 5.0, None)


@pytest.mark.parametrize("pkg", PKGS)
def test_qos_config_validation(pkg):
    s = _mod(pkg, "serving")
    with pytest.raises(ValueError):
        s.QoSConfig(max_queue=0)
    with pytest.raises(ValueError):
        s.QoSConfig(priority="bogus")
    assert s.QoSConfig(max_dispatched=None).dispatch_window() == 64
    assert s.QoSConfig(max_dispatched=5).dispatch_window() == 5


@pytest.mark.parametrize("pkg", PKGS)
def test_serving_enabled_and_plane_knobs(pkg, monkeypatch):
    cfg = _mod(pkg, "serving.config")
    monkeypatch.delenv("PATHWAY_SERVING_ENABLED", raising=False)
    assert not cfg.serving_enabled_via_env()
    monkeypatch.setenv("PATHWAY_SERVING_ENABLED", "yes")
    monkeypatch.setenv("PATHWAY_SERVING_BULK_CHUNK", "7")
    assert cfg.serving_enabled_via_env()
    knobs = cfg.plane_knobs()
    assert knobs["PATHWAY_SERVING_ENABLED"] == "yes"
    assert all(k.startswith("PATHWAY_") for k in knobs)
    assert list(knobs) == sorted(knobs)
    assert _mod(pkg, "internals.config").serving_bulk_chunk() == 7
    monkeypatch.setenv("PATHWAY_SERVING_BULK_CHUNK", "x")
    assert _mod(pkg, "internals.config").serving_bulk_chunk() == 128


# --- admission -------------------------------------------------------------


def _token_bucket_trace(pkg):
    s = _mod(pkg, "serving")
    tb = s.TokenBucket(rate=10.0, burst=2.0)
    now = 1000.0
    tb._last = now
    return [tb.try_acquire(now), tb.try_acquire(now), tb.try_acquire(now),
            tb.try_acquire(now + 0.05), tb.try_acquire(now + 0.2)]


def test_token_bucket_equal():
    ref, port = _token_bucket_trace("pathway_tpu"), _token_bucket_trace("pathway_tpu_torch")
    assert port == ref
    assert port[:2] == [0.0, 0.0] and 0.0 < port[2] <= 0.1 and port[4] == 0.0


def _admission_trace(pkg):
    s = _mod(pkg, "serving")
    out = []

    def attempt(ctl):
        try:
            ctl.admit(now=50.0)
            out.append("ok")
        except s.ShedError as e:
            out.append((e.status, e.reason, round(e.retry_after_s, 6)))

    ctl = s.AdmissionController(s.QoSConfig(max_queue=2, rate_limit_rps=None), route="/t")
    for _ in range(3):
        attempt(ctl)
    ctl.on_flushed(2)
    attempt(ctl)
    ctl.start_drain()
    attempt(ctl)
    for _ in range(3):
        ctl.complete()
    out.append(ctl.wait_idle(1.0))
    cap = s.AdmissionController(s.QoSConfig(max_inflight=1), route="/c")
    attempt(cap)
    attempt(cap)
    cap.complete()
    attempt(cap)
    rate = s.AdmissionController(s.QoSConfig(rate_limit_rps=5.0, rate_limit_burst=1.0), route="/r")
    rate._bucket._last = 50.0
    attempt(rate)
    attempt(rate)
    out.append((ctl.queued, ctl.inflight, cap.inflight, rate.under_pressure(50.0)))
    return out


def test_admission_equal():
    ref, port = _admission_trace("pathway_tpu"), _admission_trace("pathway_tpu_torch")
    assert port == ref
    assert port[2][:2] == (429, "queue_full") and port[4][:2] == (503, "draining")
    assert port[7][1] == "concurrency" and port[10][1] == "rate_limit"


# --- micro-batcher ---------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_microbatcher_edf_order_and_expiry(pkg):
    s = _mod(pkg, "serving")
    got = []
    mb = s.MicroBatcher(
        s.QoSConfig(max_batch_size=8, max_wait_ms=20),
        dispatch=lambda rs: got.append([r.key for r in rs]),
        reject=lambda r, e: got.append(("rej", r.key, type(e).__name__)),
    )
    try:
        now = time.monotonic()
        for key, dl in ((1, 5), (2, 1), (3, 3)):
            mb.put(_Req(key, now + dl))
        assert _wait(lambda: got, 2)
        assert got == [[2, 3, 1]]
        mb.put(_Req(4, now - 1))
        assert _wait(lambda: len(got) >= 2, 2)
        assert got[1] == ("rej", 4, "DeadlineExceeded")
    finally:
        mb.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_microbatcher_full_batch_and_window(pkg):
    s = _mod(pkg, "serving")
    got = []
    cap = {"n": 2}

    def dispatch(rs):
        cap["n"] -= len(rs)
        got.append([r.key for r in rs])

    mb = s.MicroBatcher(
        s.QoSConfig(max_batch_size=8, max_wait_ms=5),
        dispatch=dispatch,
        reject=lambda r, e: got.append(("rej", r.key)),
        capacity=lambda: cap["n"],
    )
    full = []
    mb2 = s.MicroBatcher(
        s.QoSConfig(max_batch_size=4, max_wait_ms=10_000),
        dispatch=lambda rs: full.append(len(rs)),
        reject=lambda r, e: None,
    )
    try:
        now = time.monotonic()
        for i in range(5):
            mb.put(_Req(i, now + 60))
            mb2.put(_Req(i, now + 60))
        assert _wait(lambda: got, 2)
        time.sleep(0.2)
        assert got == [[0, 1]]  # only the window's worth
        cap["n"] = 8
        mb.notify()
        assert _wait(lambda: len(got) >= 2, 2)
        assert got[1] == [2, 3, 4]
        assert full[:1] == [4]  # the size trigger, long before 10 s
    finally:
        mb.close()
        mb2.close(reject_queued=_mod(pkg, "serving").ShedError(503, "shutdown", 1.0))


# --- gate accounting -------------------------------------------------------


class _FakeSession:
    def __init__(self, fail=False):
        self.rows = []
        self.fail = fail

    def insert_batch(self, rows):
        if self.fail:
            raise RuntimeError("insert failed")
        self.rows.extend(rows)


def _pending(pkg, key, deadline):
    return _mod(pkg, "serving.gate").PendingRequest(key, (key,), deadline)


def _abandon_trace(pkg):
    s = _mod(pkg, "serving")
    session = _FakeSession()
    gate = s.SurgeGate(s.QoSConfig(max_batch_size=4, max_wait_ms=5), session, route="/ab")
    try:
        now = time.monotonic()
        live, gone = _pending(pkg, 1, now + 60), _pending(pkg, 2, now + 60)
        gate.submit(live)
        gate.submit(gone)
        first = gone.abandon()
        gate.complete(gone.key, was_dispatched=False)
        _wait(lambda: session.rows, 2)
        time.sleep(0.05)
        mid = ([r[0] for r in session.rows], gone.abandon(), gate._dispatched_pending, gate.queue_depth)
        gate.complete(live.key, was_dispatched=not live.abandon())
        return first, mid, gate._dispatched_pending, gate.inflight
    finally:
        gate.close()


def test_abandoned_request_skipped_and_window_slot_not_leaked():
    ref, port = _abandon_trace("pathway_tpu"), _abandon_trace("pathway_tpu_torch")
    assert port == ref == (True, ([1], True, 1, 0), 0, 0)


@pytest.mark.parametrize("pkg", PKGS)
def test_dispatch_wins_abandon_race_claims_slot(pkg):
    req = _pending(pkg, 1, time.monotonic() + 60)
    assert req.try_mark_dispatched() and not req.abandon() and req.was_dispatched
    req2 = _pending(pkg, 2, time.monotonic() + 60)
    assert req2.abandon() and not req2.try_mark_dispatched() and not req2.was_dispatched


@pytest.mark.parametrize("pkg", PKGS)
def test_submit_shutdown_race_does_not_leak_queue_depth(pkg):
    s = _mod(pkg, "serving")
    gate = s.SurgeGate(s.QoSConfig(), _FakeSession(), route="/cl")
    try:
        gate.batcher.close()
        with pytest.raises(s.ShedError):
            gate.submit(_pending(pkg, 1, time.monotonic() + 60))
        assert (gate.queue_depth, gate.inflight) == (0, 0)
    finally:
        gate.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_failed_dispatch_decrements_queue_depth_exactly_once(pkg):
    s = _mod(pkg, "serving")
    gate = s.SurgeGate(s.QoSConfig(), _FakeSession(fail=True), route="/ff")
    try:
        for _ in range(6):
            gate.admission.admit()
        now = time.monotonic()
        batch = [_pending(pkg, i, now + 60) for i in range(4)]
        with pytest.raises(RuntimeError):
            gate._dispatch(batch)
        for r in batch:
            gate._reject(r, RuntimeError("insert failed"))
        assert gate.queue_depth == 2
        for r in batch:
            assert not r.abandon()
            gate.complete(r.key, was_dispatched=True)
        assert gate._dispatched_pending == 0
    finally:
        gate.close()


def test_collected_gate_stops_batcher_thread():
    import gc

    from pathway_tpu_torch.serving import QoSConfig, SurgeGate

    gate = SurgeGate(QoSConfig(), _FakeSession(), route="/gc")
    thread = gate.batcher._thread
    assert thread.is_alive()
    del gate
    for _ in range(3):
        gc.collect()
    thread.join(timeout=5)
    assert not thread.is_alive()


# --- session priorities and the bounded bulk drain ------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_input_session_drain_bounds_upserts(pkg):
    InputSession = _mod(pkg, "engine.runtime").InputSession
    sess = InputSession(["v"])
    sess.insert_batch([(i, 1, (i,)) for i in range(3)], offsets={"at": 3})
    for k in range(100, 110):
        sess.upsert(k, (k,))
    assert sess.has_data()
    first = sess.drain(max_rows=5)
    assert len(first) == 5 and sess.last_offsets is None
    rest = sess.drain(max_rows=100)
    assert len(rest) == 8 and sess.last_offsets == {"at": 3}
    assert {r[0] for r in first + rest} == set(range(3)) | set(range(100, 110))
    assert not sess.has_data()


@pytest.mark.parametrize("pkg", PKGS)
def test_gated_session_is_interactive_priority(pkg):
    InputSession = _mod(pkg, "engine.runtime").InputSession
    s = _mod(pkg, "serving")
    session = InputSession(["text"])
    assert session.priority == InputSession.PRIORITY_BULK and not session.hot()
    gate = s.SurgeGate(s.QoSConfig(max_wait_ms=10_000), session, route="/p")
    try:
        assert session.priority == InputSession.PRIORITY_INTERACTIVE
        gate.submit(_pending(pkg, 1, time.monotonic() + 60))
        assert session.hot() and not session.has_data()  # queued upstream
    finally:
        gate.close()
    session2 = InputSession(["text"])
    gate2 = s.SurgeGate(s.QoSConfig(priority="bulk"), session2, route="/p2")
    try:
        assert session2.priority == InputSession.PRIORITY_BULK
    finally:
        gate2.close()


def _bulk_drain_ticks(pkg, monkeypatch):
    """A bulk backlog of 10 rows and one hot interactive query, with a
    bulk chunk of 4: the rows each tick takes from each session."""
    pw = importlib.import_module(pkg)
    InputSession = _mod(pkg, "engine.runtime").InputSession
    monkeypatch.setenv("PATHWAY_SERVING_BULK_CHUNK", "4")
    ticks = []
    all_bulk = threading.Event()

    class Bulk(pw.io.python.ConnectorSubject):
        def run(self):  # open until its rows ticked: a finished session drains whole
            all_bulk.wait(30)

    class Query(pw.io.python.ConnectorSubject):
        def run(self):
            pass

    bulk_subject, query_subject = Bulk(), Query()
    bulk = pw.io.python.read(bulk_subject, schema=pw.schema_from_types(v=int))
    query = pw.io.python.read(query_subject, schema=pw.schema_from_types(q=int))
    seen = {"bulk": [], "query": []}
    def on_bulk(key, row, time, is_addition):
        seen["bulk"].append((time, row["v"]))
        if len(seen["bulk"]) == 10:
            all_bulk.set()

    pw.io.subscribe(bulk, on_change=on_bulk)
    pw.io.subscribe(query, on_change=lambda key, row, time, is_addition: seen["query"].append((time, row["q"])))
    bulk_session, query_session = bulk_subject._session, query_subject._session
    for i in range(10):
        bulk_session.insert(1000 + i, (i,))
    query_session.priority = InputSession.PRIORITY_INTERACTIVE
    query_session.insert(1, (99,))
    pw.run()
    times = sorted({t for t, _v in seen["bulk"] + seen["query"]})
    for t in times:
        ticks.append((sum(1 for tt, _ in seen["bulk"] if tt == t), sum(1 for tt, _ in seen["query"] if tt == t)))
    return ticks


def test_bounded_bulk_drain_while_interactive_is_hot(monkeypatch):
    from pathway_tpu.internals import parse_graph as ref_parse_graph

    ref = _bulk_drain_ticks("pathway_tpu", monkeypatch)
    ref_parse_graph.G.clear()
    port = _bulk_drain_ticks("pathway_tpu_torch", monkeypatch)
    assert port == ref
    # the query's tick took one chunk of bulk rows, the next tick the rest
    assert port == [(4, 1), (6, 0)]


# --- tenancy ---------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_tenant_qos_escape_hatch_and_ledger(pkg, monkeypatch):
    s = _mod(pkg, "serving")
    monkeypatch.delenv("PATHWAY_TENANT_QOS", raising=False)
    gate = s.SurgeGate(s.QoSConfig(), _FakeSession(), route="/t0")
    try:
        assert gate.ledger is None
    finally:
        gate.close()
    monkeypatch.setenv("PATHWAY_TENANT_QOS", "1")
    gate = s.SurgeGate(s.QoSConfig(rate_limit_rps=8.0), _FakeSession(), route="/t1")
    try:
        assert isinstance(gate.ledger, s.TenantLedger)
        assert gate.ledger.capacity_rps == 8.0
    finally:
        gate.close()


def _tenant_trace(pkg):
    s = _mod(pkg, "serving")
    cfg = s.TenancyConfig(weights={"default": 1.0, "premium": 4.0}, metric_topn=2,
                          state_cap=8, burst=2.0)
    ledger = s.TenantLedger(cfg, route="/fair", capacity_rps=10.0)
    out = []
    now = 500.0
    for i in range(6):
        for tenant, cls in (("hot", None), ("hot", None), ("vip", "premium"), (f"tail{i}", None)):
            try:
                out.append(round(ledger.admit(tenant, cls, now + i * 0.01, pressure=True), 6))
            except s.ShedError as e:
                out.append((e.status, e.reason, round(e.retry_after_s, 6)))
    out.append(sorted(ledger.labeler.labeled()))
    out.append(ledger.tracked_tenants)
    out.append(round(ledger.active_weight(now + 0.06), 6))
    out.append(s.parse_weight_classes("premium:4,batch:0.25"))
    return out


def test_tenant_ledger_equal():
    ref, port = _tenant_trace("pathway_tpu"), _tenant_trace("pathway_tpu_torch")
    assert port == ref
    assert any(isinstance(x, tuple) and x[1] == "tenant_rate" for x in port)


# --- degraded stale reads --------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_degrade_state_and_stale_search(pkg):
    degrade = _mod(pkg, "serving.degrade")
    degrade.reset()
    try:
        assert degrade.recovering() is None and degrade.staleness_seconds() is None
        degrade.enter_recovery("b")
        degrade.enter_recovery("a")
        assert degrade.recovering() == "b"  # the oldest reason
        degrade.exit_recovery("b")
        assert degrade.recovering() == "a"
        degrade.exit_recovery()
        assert degrade.recovering() is None
        with pytest.raises(RuntimeError):
            degrade.stale_knn_search([(np.ones(2), 1, None)])

        class Reader:
            class index:
                @staticmethod
                def search(triples):
                    return [((7, 0.5),) for _ in triples]

        reader = Reader()
        degrade.register_index_reader(reader)
        assert degrade.staleness_seconds() is not None
        assert degrade.stale_knn_search([(None, 1, None)] * 2) == [((7, 0.5),)] * 2
    finally:
        degrade.reset()


# --- REST end to end on the port ------------------------------------------


def _serve_slow_pipeline(qos, sleep_s=0.25, route="/upper"):
    from pathway_tpu_torch.io.http import rest_connector

    seen: list[str] = []

    class QuerySchema(tpw.Schema):
        text: str

    @tpw.udf
    def slow_upper(text: str) -> str:
        seen.append(text)
        time.sleep(sleep_s)
        return text.upper()

    port = _free_port()
    queries, writer = rest_connector(
        host="127.0.0.1", port=port, schema=QuerySchema, route=route, qos=qos
    )
    writer(queries.select(query_id=queries.id, result=slow_upper(queries.text)))
    t = threading.Thread(target=tpw.run, daemon=True)
    t.start()
    return port, t, seen


def _await_up(port, route="/upper", payload=None, timeout=20):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if _request(port, "POST", route, payload or {"text": "warmup"}, timeout=5)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise RuntimeError("server did not come up")


def _stop(t):
    port_parse_graph.G.runtime.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def _post_many(port, route, n, headers=None, timeout=30):
    results = []
    lock = threading.Lock()

    def worker(i):
        try:
            res = _request(port, "POST", route, {"text": f"w{i}"}, headers=headers, timeout=timeout)
        except OSError as e:
            res = ("conn", {}, str(e))
        with lock:
            results.append(res)

    ws = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for w in ws:
        w.start()
    for w in ws:
        w.join(timeout=60)
    return results


def test_rest_overload_sheds_429_with_retry_after():
    from pathway_tpu_torch.serving import QoSConfig

    qos = QoSConfig(max_batch_size=2, max_wait_ms=5, max_queue=3, max_dispatched=2,
                    default_deadline_ms=30_000)
    port, t, _seen = _serve_slow_pipeline(qos)
    try:
        _await_up(port)
        results = _post_many(port, "/upper", 12)
        statuses = Counter(s for s, _h, _b in results)
        assert statuses[200] >= 1 and statuses[429] >= 1, statuses
        assert "conn" not in statuses, results
        for status, headers, body in results:
            if status == 429:
                assert float(headers["retry-after"]) >= 0
                assert body["error"].startswith("request shed: ")
            if status == 200:
                assert body.startswith("W")
    finally:
        _stop(t)


def test_rest_expired_deadline_never_dispatched():
    from pathway_tpu_torch.serving import QoSConfig

    qos = QoSConfig(max_batch_size=1, max_wait_ms=2, max_queue=8, max_dispatched=1,
                    default_deadline_ms=30_000)
    port, t, seen = _serve_slow_pipeline(qos, sleep_s=0.4)
    try:
        _await_up(port)
        blockers = [
            threading.Thread(target=_request, args=(port, "POST", "/upper", {"text": f"blocker{i}"}))
            for i in range(3)
        ]
        for b in blockers:
            b.start()
        time.sleep(0.15)
        status, _h, body = _request(port, "POST", "/upper", {"text": "mustexpire"},
                                    headers={"x-pathway-deadline-ms": "50"}, timeout=10)
        assert status == 504 and "deadline exceeded" in body["error"]
        for b in blockers:
            b.join(timeout=30)
        time.sleep(0.5)
        assert "mustexpire" not in seen
    finally:
        _stop(t)


def test_rest_drain_completes_admitted_requests():
    from pathway_tpu_torch.serving import QoSConfig, drain_all

    qos = QoSConfig(max_batch_size=4, max_wait_ms=5, max_queue=32, default_deadline_ms=30_000)
    port, t, _seen = _serve_slow_pipeline(qos, sleep_s=0.05)
    try:
        _await_up(port)
        results = []
        stop_firing = threading.Event()

        def worker(i):
            while not stop_firing.is_set():
                try:
                    s, _h, b = _request(port, "POST", "/upper", {"text": f"d{i}"})
                    results.append((s, b))
                except OSError:
                    results.append(("conn", None))
                    return

        ws = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for w in ws:
            w.start()
        time.sleep(0.5)
        assert drain_all(grace_s=15)
        stop_firing.set()
        for w in ws:
            w.join(timeout=10)
        statuses = Counter(s for s, _ in results)
        assert statuses[200] >= 1
        assert set(statuses) <= {200, 503, "conn"}, statuses
        assert all(b.startswith("D") for s, b in results if s == 200)
        with pytest.raises(OSError):
            _request(port, "POST", "/upper", {"text": "late"}, timeout=2)
    finally:
        _stop(t)


def test_webserver_stop_releases_port_on_runtime_stop():
    from pathway_tpu_torch.io.http import rest_connector

    class QuerySchema(tpw.Schema):
        text: str

    port = _free_port()
    queries, writer = rest_connector(host="127.0.0.1", port=port, schema=QuerySchema, route="/echo")
    writer(queries.select(query_id=queries.id, result=queries.text))
    t = threading.Thread(target=tpw.run, daemon=True)
    t.start()
    _await_up(port, route="/echo")
    _stop(t)
    with pytest.raises(ConnectionRefusedError):
        _request(port, "POST", "/echo", {"text": "x"}, timeout=1)
    # the port is free again: a new listener binds it
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
    finally:
        s.close()


def test_webserver_stop_during_startup_does_not_leak_thread(monkeypatch):
    import asyncio

    from pathway_tpu_torch.io.http._server import PathwayWebserver

    real_new_loop = asyncio.new_event_loop

    def slow_new_loop():
        time.sleep(0.3)
        return real_new_loop()

    monkeypatch.setattr(asyncio, "new_event_loop", slow_new_loop)
    ws = PathwayWebserver("127.0.0.1", _free_port())
    ws.start()
    ws.stop(timeout=10)
    assert not ws._thread.is_alive()


def test_non_finite_deadline_header_falls_back_to_default():
    from pathway_tpu_torch.serving import QoSConfig, gates

    port, t, _seen = _serve_slow_pipeline(QoSConfig(max_batch_size=4, max_wait_ms=5, max_queue=8),
                                          sleep_s=0.01)
    try:
        _await_up(port)
        for bad in ("nan", "inf", "-inf", "garbage"):
            status = _request(port, "POST", "/upper", {"text": "ok"},
                              headers={"x-pathway-deadline-ms": bad}, timeout=10)[0]
            assert status == 200, (bad, status)
        assert all(g.queue_depth == 0 and g.inflight == 0 for g in gates())
    finally:
        _stop(t)


@pytest.mark.parametrize("pkg", PKGS)
def test_serving_enabled_via_env_gates_rest_connector(pkg, monkeypatch):
    pw = importlib.import_module(pkg)
    http = _mod(pkg, "io.http._server")
    monkeypatch.setenv("PATHWAY_SERVING_ENABLED", "1")
    monkeypatch.setenv("PATHWAY_SERVING_MAX_QUEUE", "5")
    made = []
    real_init = http.RestServerSubject.__init__

    def spy(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(http.RestServerSubject, "__init__", spy)

    class QuerySchema(pw.Schema):
        text: str

    queries, writer = http.rest_connector(host="127.0.0.1", port=_free_port(), schema=QuerySchema,
                                          route="/env")
    writer(queries.select(query_id=queries.id, result=queries.text))
    (subject,) = made
    assert subject._qos is not None and subject._qos.max_queue == 5
    monkeypatch.delenv("PATHWAY_SERVING_ENABLED")
    queries, writer = http.rest_connector(host="127.0.0.1", port=_free_port(), schema=QuerySchema,
                                          route="/plain")
    assert made[1]._qos is None


def test_rest_stale_reads_while_recovering():
    """Recovery mode on a gated route: 503 without a responder, 200 with
    the stale headers through one, 503 past x-pathway-max-staleness-ms."""
    from pathway_tpu_torch.serving import QoSConfig, degrade

    port, t, seen = _serve_slow_pipeline(QoSConfig(max_batch_size=4, max_wait_ms=5), sleep_s=0.0)
    try:
        _await_up(port)
        degrade.mark_fresh()
        degrade.enter_recovery("peer-down")
        status, headers, body = _request(port, "POST", "/upper", {"text": "x"})
        assert status == 503 and headers["x-pathway-stale"] == "true"
        assert headers["retry-after"] == "1.0" and "engine recovering: peer-down" in body["error"]
        degrade.register_stale_responder("/upper", lambda values: {"stale": values["text"]})
        status, headers, body = _request(port, "POST", "/upper", {"text": "y"})
        assert status == 200 and body == {"stale": "y"}
        assert headers["x-pathway-stale"] == "true"
        assert float(headers["x-pathway-staleness-seconds"]) >= 0.0
        time.sleep(0.01)
        status, headers, body = _request(port, "POST", "/upper", {"text": "z"},
                                         headers={"x-pathway-max-staleness-ms": "0"})
        assert status == 503 and "x-pathway-max-staleness-ms" in body["error"]
        assert "y" not in seen and "z" not in seen  # the engine never saw them
        degrade.exit_recovery()
        assert _request(port, "POST", "/upper", {"text": "w"})[2] == "W"
    finally:
        degrade.reset()
        _stop(t)


# --- the deadline drop in the index exec -----------------------------------


def _expired_query_replies(pkg):
    pw = importlib.import_module(pkg)
    sdl = _mod(pkg, "serving.deadline")
    DataIndex = _mod(pkg, "stdlib.indexing.data_index").DataIndex
    BruteForceKnn = _mod(pkg, "stdlib.indexing.nearest_neighbors").BruteForceKnn
    right = _mod(pkg, "internals.thisclass").right
    _SCORE = _mod(pkg, "stdlib.indexing.colnames")._SCORE
    T, table_to_dicts = pw.debug.T, pw.debug.table_to_dicts
    kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}

    @pw.udf
    def emb(text: str) -> np.ndarray:
        v = np.zeros(4, dtype=np.float32)
        for ch in str(text).lower():
            v[ord(ch) % 4] += 1.0
        return v / np.linalg.norm(v)

    docs = T(
        """
        text
        apple
        banana
        """
    )
    docs = docs.with_columns(embedding=emb(docs.text))
    index = DataIndex(docs, BruteForceKnn(docs.embedding, dimensions=4, **kw))
    queries = T(
        """
        qtext  | k
        apple  | 1
        banana | 1
        """
    )
    queries = queries.with_columns(_q=emb(queries.qtext))
    keys = sorted(int(k) for k in table_to_dicts(queries)[0])
    sdl.register(keys[0], time.monotonic() - 1.0)
    try:
        out = index.query_as_of_now(queries._q, number_of_matches=queries.k).select(
            score=right[_SCORE]
        )
        _k, cols = table_to_dicts(out)
        return {int(k): tuple(v) for k, v in cols["score"].items()}, keys
    finally:
        sdl.unregister(keys[0])


def test_knn_skips_expired_queries():
    from pathway_tpu.internals import parse_graph as ref_parse_graph
    from pathway_tpu_torch.observability import REGISTRY

    ref, ref_keys = _expired_query_replies("pathway_tpu")
    ref_parse_graph.G.clear()

    def expired_total():
        text = REGISTRY.render()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith('pathway_serving_deadline_expired_total{stage="knn"}')]
        return float(lines[0].split()[-1]) if lines else 0.0

    before = expired_total()
    port, keys = _expired_query_replies("pathway_tpu_torch")
    assert keys == ref_keys
    assert port.keys() == ref.keys()
    assert port[keys[0]] == ref[keys[0]] == ()  # no search for the expired query
    assert len(port[keys[1]]) == len(ref[keys[1]]) == 1
    assert np.allclose(port[keys[1]], ref[keys[1]], atol=1e-6)
    assert expired_total() == before + 1
