"""The port's monitoring server (``internals/monitoring_server.py``), its
debug surfaces (``observability/debug.py``) and the terminal dashboard
(``internals/monitoring.py``) against the JAX package's: after the same
pipeline, ``_render_metrics`` gives the same runtime families with the same
label sets, ``graph_table`` rows with the same keys and counts, every route
the same status (``/debug/profile`` and ``/debug/autoscale`` apart, by
design), ``StatsMonitor`` the same table; ``take_profile`` keeps the
reference's 200/400/409 contract on the CPU and answers 501 for the card
without one; ``pw.run(with_http_server=True)`` serves a run."""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.observability.exposition import parse_exposition

PACKAGES = {"port": tpw, "jax": jpw}

# the families the runtime bridge promotes onto the registry at scrape time
BRIDGE = (
    "pathway_ticks_total", "pathway_logical_time", "pathway_last_tick_seconds",
    "pathway_frontier_lag_ms", "pathway_process_cpu_seconds_total",
    "pathway_process_memory_rss_bytes", "pathway_input_rows_total",
    "pathway_output_rows_total", "pathway_operator_rows_total",
    "pathway_operator_seconds_total",
)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    monkeypatch.setenv("PATHWAY_SIGNALS_INTERVAL_MS", "100")
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
    yield
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()


def _pipeline(pw):
    t = pw.debug.table_from_markdown(
        """
        k | v | __time__
        a | 1 | 2
        b | 2 | 2
        a | 5 | 4
        c | 7 | 6
        """
    )
    g = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
    f = t.select(pw.this.k, w=pw.this.v * 3).filter(pw.this.w > 3)
    seen = []
    pw.io.subscribe(g, on_change=lambda **kw: seen.append(kw))
    pw.io.subscribe(f, on_change=lambda **kw: seen.append(kw))
    pw.run()
    return pw.internals.parse_graph.G.last_runtime, seen


def _runs():
    return {name: _pipeline(pw) for name, pw in PACKAGES.items()}


def _families(text: str, since_node_ids=None) -> dict:
    fams, errs = parse_exposition(text)
    assert not errs, errs[:3]
    return fams


def test_render_metrics_has_the_reference_families_and_labels():
    from pathway_tpu.internals.monitoring_server import _render_metrics as jrender
    from pathway_tpu_torch.internals.monitoring_server import _render_metrics as trender

    runs = _runs()
    got = {"port": _families(trender(runs["port"][0])), "jax": _families(jrender(runs["jax"][0]))}
    for name in BRIDGE:
        tf, jf = got["port"][name], got["jax"][name]
        assert tf.type == jf.type and tf.help == jf.help, name
        tl = {tuple(sorted(s.labels)) for s in tf.samples}
        jl = {tuple(sorted(s.labels)) for s in jf.samples}
        assert tl == jl, name
    # per-node series of this run, matched by node type (ids differ)
    for name in ("pathway_operator_rows_total", "pathway_input_rows_total",
                 "pathway_output_rows_total"):
        rows = {}
        for side, rt in ((k, runs[k][0]) for k in runs):
            labels = {f"{n.name}_{n.id}": type(n).__name__ for n in rt.order}
            rows[side] = sorted(
                (labels[s.labels["node"]], s.value)
                for s in got[side][name].samples
                if s.labels.get("node") in labels
            )
        assert rows["port"] == rows["jax"], name
    assert runs["port"][1] and len(runs["port"][1]) == len(runs["jax"][1])
    # the torch gauges stand where the JAX ones are
    for name in ("pathway_build_info", "pathway_device_memory_bytes",
                 "pathway_torch_local_devices", "pathway_torch_kernel_builds_total"):
        assert name in got["port"], name
    build = got["port"]["pathway_build_info"].samples[0].labels
    assert "torch" in build and "jax" not in build


def test_ticks_total_counts_every_runtime_monotonically():
    from pathway_tpu_torch.internals.monitoring_server import _render_metrics

    rt1, _ = _pipeline(tpw)
    first = _families(_render_metrics(rt1))["pathway_ticks_total"].samples[0].value
    tpw.internals.parse_graph.G.clear()
    rt2, _ = _pipeline(tpw)
    second = _families(_render_metrics(rt2))["pathway_ticks_total"].samples[0].value
    assert second - first == rt2.stats.ticks


def test_graph_table_rows_equal_the_reference():
    from pathway_tpu.observability.debug import graph_table as jtable
    from pathway_tpu_torch.observability.debug import graph_table as ttable

    runs = _runs()
    t, j = ttable(runs["port"][0]), jtable(runs["jax"][0])
    assert len(t) == len(j) == len(runs["port"][0].order)
    for a, b in zip(t, j):
        assert sorted(a) == sorted(b)
        assert a["type"] == b["type"]
        assert (a["rows"], a["rows_in"], a["rows_out"], a["backlog"], a["compiled"]) == (
            b["rows"], b["rows_in"], b["rows_out"], b["backlog"], b["compiled"])
    assert ttable(None) == jtable(None) == []


ROUTES = [
    "/", "/metrics", "/status", "/debug/threads", "/debug/graph", "/debug/trace",
    "/debug/trace?seconds=5", "/debug/trace?seconds=x", "/debug/trace?seconds=-1",
    "/debug/signals", "/debug/signals?series=3", "/debug/signals?series=x",
    "/debug/events", "/debug/events?kind=caught-up,takeover&n=2", "/debug/events?n=x",
    "/debug/tick", "/debug/tick?ticks=4&deep=1", "/debug/tick?trace=1", "/debug/tick?ticks=x",
    "/fleet/metrics", "/fleet/events", "/fleet/trace", "/fleet/trace?trace_id=abc",
    "/debug/profile?seconds=x", "/debug/profile?seconds=0", "/debug/profile?seconds=500",
    "/no/such/route",
]


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_every_route_answers_the_reference_status(monkeypatch):
    from pathway_tpu.internals import monitoring_server as jms
    from pathway_tpu_torch.internals import monitoring_server as tms

    monkeypatch.delenv("PATHWAY_FLEET_MEMBERS", raising=False)
    runs = _runs()
    servers = {"port": tms.start_http_server(runs["port"][0], port=0),
               "jax": jms.start_http_server(runs["jax"][0], port=0)}
    try:
        statuses = {
            name: [_get(srv.server_address[1], r)[0] for r in ROUTES]
            for name, srv in servers.items()
        }
        assert statuses["port"] == statuses["jax"], list(zip(ROUTES, *statuses.values()))
        assert statuses["port"].count(200) >= 18
        tport = servers["port"].server_address[1]
        # /debug/autoscale: 404 in both packages until a controller is
        # armed, then each package's controller's status()
        from pathway_tpu import autoscale as jauto
        from pathway_tpu_torch import autoscale as tauto

        jport = servers["jax"].server_address[1]
        assert _get(tport, "/debug/autoscale") == _get(jport, "/debug/autoscale") == (
            404, b"no autoscale controller armed")
        try:
            for auto in (tauto, jauto):
                auto.arm_controller(auto.CallbackActuator(lambda m: None), ranks=2,
                                    config=auto.AutoscaleConfig(min_ranks=1, max_ranks=3))
            got = {name: _get(srv.server_address[1], "/debug/autoscale") for name, srv in servers.items()}
            assert got["port"][0] == got["jax"][0] == 200
            assert json.loads(got["port"][1]) == json.loads(got["jax"][1]) == tauto.get_controller().status()
        finally:
            tauto.reset_controller()
            jauto.reset_controller()
        # the card's profile without a card: 501, never a CPU-only trace
        status, body = _get(tport, "/debug/profile?seconds=0.1")
        assert status == 501 and b"device='cpu'" in body
        status, body = _get(tport, "/debug/profile?seconds=0.1&device=cpu")
        assert status == 200
        doc = json.loads(body)
        assert doc["device"] == "cpu" and doc["activities"] == ["CPU"]
        with open(doc["trace_file"]) as fh:
            assert json.load(fh)["traceEvents"]
        # the graph route's rows are the runtime's nodes
        graph = json.loads(_get(tport, "/debug/graph")[1])
        assert [r["id"] for r in graph] == [n.id for n in runs["port"][0].order]
    finally:
        for srv in servers.values():
            srv.shutdown()
        # starting a server armed each package's process-wide sampler
        from pathway_tpu.observability.signals import reset_sampler as jreset
        from pathway_tpu_torch.observability.signals import reset_sampler as treset

        jreset()
        treset()


def test_take_profile_contract_on_the_cpu():
    import torch

    from pathway_tpu_torch.observability import debug

    for bad in (0, -1, 121, float("nan")):
        with pytest.raises(ValueError):
            debug.take_profile(bad, device="cpu")
    with pytest.raises(ValueError, match="device"):
        debug.take_profile(0.1, device="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(debug.ProfilerUnavailable):
            debug.take_profile(0.1)
    results = {}

    def first():
        results["first"] = debug.take_profile(1.0, device="cpu")

    th = threading.Thread(target=first)
    th.start()
    deadline = time.time() + 10
    while not debug._profile_lock.locked() and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="in progress"):
        debug.take_profile(0.1, device="cpu")
    # the trace is on while the capture sleeps, and off once it returns
    while not debug._profile_tracing.is_set() and time.time() < deadline:
        time.sleep(0.001)
    assert debug._profile_tracing.is_set()
    th.join(30)
    assert not debug._profile_tracing.is_set()
    trace_dir = results["first"]
    with open(os.path.join(trace_dir, debug.SUMMARY_FILE)) as fh:
        summary = json.load(fh)
    assert summary["device"] == "cpu" and summary["device_events"] == 0
    assert os.path.exists(os.path.join(trace_dir, debug.TRACE_FILE))
    # the lock is free again
    assert debug.take_profile(0.05, device="cpu")


def test_stats_monitor_table_equals_the_reference():
    pytest.importorskip("rich")
    from rich.console import Console

    from pathway_tpu.internals.monitoring import StatsMonitor as JMon
    from pathway_tpu_torch.internals.monitoring import StatsMonitor as TMon

    runs = _runs()
    text = {}
    for name, mon in (("port", TMon(runs["port"][0])), ("jax", JMon(runs["jax"][0]))):
        console = Console(record=True, width=120)
        console.print(mon._render())
        out = console.export_text()
        # node ids differ between the packages; timings differ run to run
        out = re.sub(r"#\d+", "#N", out)
        out = re.sub(r"\d+\.\d{3}", "S", out)
        # the cells, not the box drawing (its widths follow the ids'
        # digits); the operators table is ordered by timing-dependent seconds
        cells = (re.sub(r"[\s\u2500-\u257f]+", " ", line).strip() for line in out.splitlines())
        text[name] = sorted(c for c in cells if c)
    assert text["port"] == text["jax"]
    assert any("connectors" in line for line in text["port"])
    assert any("operators" in line for line in text["port"])


def test_run_with_http_server_serves_the_run_and_reuses_its_server(monkeypatch):
    from pathway_tpu_torch.internals import monitoring_server as tms
    from pathway_tpu_torch.observability import signals

    monkeypatch.setenv("PATHWAY_PROCESS_ID", "7")
    signals.reset_sampler()
    try:
        rt, _ = _pipeline_served()
        srv = rt.http_server
        assert srv is not None
        port = srv.server_address[1]
        metrics = _families(_get(port, "/metrics")[1].decode())
        assert metrics["pathway_ticks_total"].samples[0].value >= rt.stats.ticks
        assert json.loads(_get(port, "/status")[1])["ticks"] == rt.stats.ticks
        assert b"MainThread" in _get(port, "/debug/threads")[1]
        assert signals.get_sampler() is not None
        tpw.internals.parse_graph.G.clear()
        rt2, _ = _pipeline_served(monitoring_level=tpw.MonitoringLevel.IN_OUT)
        assert rt2.http_server is srv  # the reuse registry re-attaches the run
        status = json.loads(_get(port, "/status")[1])
        assert status["ticks"] == rt2.stats.ticks
    finally:
        with tms._servers_lock:
            servers = list(tms._servers.values())
        for s in servers:
            s.shutdown()
        signals.reset_sampler()


def _pipeline_served(**kw):
    t = tpw.debug.table_from_markdown(
        """
        k | v
        a | 1
        """
    )
    tpw.io.subscribe(t.select(w=tpw.this.v + 1), on_change=lambda **k: None)
    tpw.run(with_http_server=True, **kw)
    return tpw.internals.parse_graph.G.last_runtime, None
