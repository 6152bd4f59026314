"""Fleet federation of the port (``pathway_tpu_torch.observability.fleet``)
against the JAX package's: two local member servers (plus a dead one)
answer ``/metrics``, ``/debug/events``, ``/debug/trace`` and ``/debug/tick``;
each package's ``federate_metrics``, ``federate_events``, ``stitch_traces``
and ``federate_ticks`` over them give the same documents, and
``window_from_events`` the same windows. A fleet of one port monitoring
server and one reference monitoring server federates from either side."""

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from pathway_tpu.observability import fleet as jfleet
from pathway_tpu.observability import registry as jreg
from pathway_tpu_torch.observability import fleet as tfleet
from pathway_tpu_torch.observability import registry as treg
from pathway_tpu_torch.observability.exposition import validate_exposition
from pathway_tpu_torch.observability.tracing import validate_chrome_trace

FLEETS = {"port": tfleet, "jax": jfleet}


def _exposition(seed: int) -> str:
    rng = np.random.default_rng(seed)
    r = treg.MetricsRegistry()
    c = r.counter("pathway_serving_admitted_total", "admitted requests", ("route",))
    for route in ("/v1/retrieve", '/q"uote', "/b\\s"):
        c.labels(route).inc(float(rng.integers(1, 100)))
    r.gauge("pathway_replica_staleness_seconds", "staleness", ("replica",)).labels(
        str(seed)).set(float(rng.random()))
    h = r.histogram("pathway_knn_query_seconds", "knn", ("kind",),
                    buckets=treg.log_linear_buckets(1e-4, 1.0, 3))
    for v in rng.random(20) * 0.01:
        h.labels("dense").observe(float(v))
    if seed:
        r.counter("pathway_member_only_total", "only on member 1").inc(3)
    return r.render()


def _events(member: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    kinds = ["stream-disconnect", "caught-up", "replica-ejected", "takeover"]
    evs = []
    for i in range(12):
        evs.append({
            "seq": i, "kind": kinds[int(rng.integers(0, 4))],
            "incarnation": int(rng.integers(0, 2)),
            "wall": float(1.7e9 + rng.random() * 100), "mono": float(rng.random()),
            "tick": None if i % 5 == 0 else int(rng.integers(0, 40)),
            "data": {"i": i},
        })
    if seed == 2:
        evs[3]["member"] = "explicit"
    return {"member": member, "events": evs}


def _trace(member: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    evs = [{"name": "process_name", "ph": "M", "pid": 7, "tid": 0, "ts": 0,
            "args": {"name": member}}]
    for i in range(10):
        evs.append({"name": f"span{i}", "cat": "pathway", "ph": "X", "pid": 7,
                    "tid": int(rng.integers(1, 3)), "ts": float(rng.random() * 1e6),
                    "dur": float(rng.random() * 100),
                    "args": {"trace_id": "t1" if i % 3 == 0 else f"t{seed}{i}"}})
    return {"traceEvents": evs, "displayTimeUnit": "ms",
            "otherData": {"exemplars": [{"member": member, "i": seed}]}}


def _tick(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    nodes = [f"Op_{i}" for i in range(5)]
    return {"last": {
        "wall_ms": float(rng.random() * 10),
        "operators": [{"node": n, "wall_ms": float(rng.random() * 3)} for n in nodes],
        "edges": [[nodes[i], nodes[i + 1]] for i in range(4)] + [[nodes[0], nodes[3]]],
        "critical_path": {"stages": nodes[:2]},
    }}


class _Member:
    """A local HTTP server answering a member's canned documents."""

    def __init__(self, name: str, seed: int):
        docs = {
            "/metrics": _exposition(seed).encode(),
            "/debug/events": json.dumps(_events(name, seed)).encode(),
            "/debug/trace": json.dumps(_trace(name, seed)).encode(),
            "/debug/tick": json.dumps(_tick(seed)).encode(),
        }

        class H(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                body = docs.get(self.path)
                self.send_response(200 if body is not None else 404)
                self.send_header("Content-Length", str(len(body or b"")))
                self.end_headers()
                self.wfile.write(body or b"")

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()


@pytest.fixture(scope="module")
def members():
    ms = [_Member("writer", 0), _Member("replica-1", 1), _Member("replica-2", 2)]
    dead = ThreadingHTTPServer(("127.0.0.1", 0), BaseHTTPRequestHandler)
    dead_url = f"http://127.0.0.1:{dead.server_address[1]}"
    dead.server_close()  # nobody listens there
    yield [(m_name, m.url) for m_name, m in zip(("writer", "replica-1", "replica-2"), ms)] + [
        ("gone", dead_url)
    ]
    for m in ms:
        m.server.shutdown()
        m.server.server_close()


def _both(fn):
    return {name: fn(mod) for name, mod in FLEETS.items()}


def test_federate_metrics_equals_the_reference(members):
    local = ("router", _exposition(9))
    out = _both(lambda f: f.federate_metrics(members, timeout=2.0, local=local))
    (ttext, terr), (jtext, jerr) = out["port"], out["jax"]
    assert ttext == jtext
    assert sorted(terr) == sorted(jerr) == ["gone"]
    assert not validate_exposition(ttext)
    assert 'pathway_fleet_member_up{member="gone"} 0' in ttext
    assert 'member="replica-1"' in ttext and "pathway_member_only_total" in ttext
    out = _both(lambda f: f.federate_metrics(dict(members[:2])))
    assert out["port"] == out["jax"]


def test_federate_events_equals_the_reference(members):
    local = _events("router", 7)["events"][:3]
    out = _both(lambda f: f.federate_events(members, local=local))
    assert out["port"]["events"] == out["jax"]["events"]
    assert out["port"]["members"] == out["jax"]["members"] == ["writer", "replica-1", "replica-2"]
    assert sorted(out["port"]["errors"]) == ["gone"]
    evs = out["port"]["events"]
    for start, end, inc in ((["stream-disconnect"], ["caught-up"], 0),
                            (["takeover"], ["caught-up", "replica-ejected"], 1),
                            (["nothing"], ["caught-up"], 0)):
        w = {n: f.window_from_events(evs, start, end, min_incarnation=inc)
             for n, f in FLEETS.items()}
        assert w["port"] == w["jax"]


@pytest.mark.parametrize("trace_id", [None, "t1", "t15"])
def test_stitch_traces_equals_the_reference(members, trace_id):
    local = ("router", _trace("router", 4))
    out = _both(lambda f: f.stitch_traces(members, trace_id=trace_id, local=local))
    assert out["port"]["traceEvents"] == out["jax"]["traceEvents"]
    assert out["port"]["otherData"]["members"] == out["jax"]["otherData"]["members"]
    assert out["port"]["otherData"]["exemplars"] == out["jax"]["otherData"]["exemplars"]
    assert sorted(out["port"]["otherData"]["errors"]) == ["gone"]
    assert not validate_chrome_trace(out["port"])
    pids = {e["pid"] for e in out["port"]["traceEvents"] if e["ph"] == "M"}
    assert len(pids) == 4


def test_federate_ticks_equals_the_reference(members):
    edges = [(("writer", "Op_4"), ("replica-1", "Op_0"), 0.002),
             (("replica-1", "Op_4"), ("replica-2", "Op_0"), 0.0)]
    for kw in ({}, {"channel_edges": edges}, {"local": ("router", _tick(5))}):
        out = _both(lambda f: f.federate_ticks(members, **kw))
        assert out["port"] == out["jax"]
        assert out["port"]["critical_path"]["stages"]


def test_members_from_env_equals_the_reference():
    for raw in ("", "a=http://h:1/,b=http://h:2", "http://x:9, ,y=http://y:8//", "bare"):
        env = {"PATHWAY_FLEET_MEMBERS": raw}
        assert tfleet.members_from_env(env) == jfleet.members_from_env(env)


def test_a_mixed_fleet_federates_from_either_side(monkeypatch):
    """A port monitoring server and a reference one, each listing the
    other in PATHWAY_FLEET_MEMBERS: each one's /fleet/metrics holds both
    members' series and the other member up."""
    from pathway_tpu.internals import monitoring_server as jms
    from pathway_tpu_torch.internals import monitoring_server as tms

    monkeypatch.setenv("PATHWAY_SIGNALS", "0")
    tsrv = tms.start_http_server(port=0)
    jsrv = jms.start_http_server(port=0)
    try:
        tport, jport = tsrv.server_address[1], jsrv.server_address[1]
        monkeypatch.setenv(
            "PATHWAY_FLEET_MEMBERS",
            f"port=http://127.0.0.1:{tport},jax=http://127.0.0.1:{jport}",
        )
        for port in (tport, jport):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet/metrics",
                                        timeout=10) as resp:
                text = resp.read().decode()
            assert not validate_exposition(text)
            other = "jax" if port == tport else "port"
            assert f'pathway_fleet_member_up{{member="{other}"}} 1' in text
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet/events",
                                        timeout=10) as resp:
                assert json.loads(resp.read())["members"] == [other]
    finally:
        tsrv.shutdown()
        jsrv.shutdown()
    # the reference registry renders what the port's parser reads
    assert jreg.REGISTRY.render()
