"""Prometheus/OpenMetrics monitoring endpoint + debug surfaces —
counterpart of ``pathway_tpu/internals/monitoring_server.py``, with the
same routes, port rule and reuse registry.

The per-process metrics server (upstream Pathway's
src/engine/http_server.rs:21-90 — an OpenMetrics endpoint at port 20000 +
process_id), on the Flight Recorder registry
(pathway_tpu_torch/observability): ``/metrics`` renders the process-wide
MetricsRegistry (runtime counters are promoted onto it at scrape time, the
torch/CUDA gauges are installed beside them), ``/status`` the runtime's
stats, ``/debug/threads`` an all-thread stack dump, ``/debug/graph``
per-node rows/ns/backlog with their compiled-tick segment as JSON,
``/debug/profile?seconds=N[&device=cpu]`` an on-demand torch.profiler
capture (CPU + CUDA activity; 501 without a card unless ``device=cpu``),
``/debug/trace?seconds=N`` the span ring as Chrome trace-event JSON,
``/debug/signals`` the SLO signal rings and burn rates (``?series=N``
includes trailing points), ``/debug/events`` the incident journal, and
``/debug/tick`` Tick Scope (per-operator tick anatomy, critical path,
memory-ledger top owners, roofline; ``?ticks=N&deep=1&trace=1``).
``/fleet/{metrics,events,trace}`` federate the members of
``PATHWAY_FLEET_MEMBERS``. ``/debug/autoscale`` answers the armed Flux Pilot
controller's status, 404 until one is armed. Arming the server also arms the per-process signal
sampler (disable with ``PATHWAY_SIGNALS=0``) and installs the crash hooks
that write the postmortem bundle.

Bind host comes from PATHWAY_MONITORING_HOST (default 127.0.0.1 — set
0.0.0.0 for multi-host scrape); a taken port falls back to an ephemeral
one with a logged warning instead of crashing the run.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from pathway_tpu_torch.observability.debug import (
    ProfilerUnavailable,
    graph_table,
    take_profile,
    thread_stack_dump,
)
from pathway_tpu_torch.observability.registry import REGISTRY
from pathway_tpu_torch.observability.registry import MetricsRegistry
from pathway_tpu_torch.observability.torch_metrics import install_torch_metrics

BASE_PORT = 20000

logger = logging.getLogger("pathway_tpu_torch")

# one server per requested (host, port) per process: a second monitored
# run re-attaches its runtime to the existing server instead of leaking
# a new thread per run and falling back to an ephemeral port — which
# would leave the canonical scrape port serving the finished run's
# frozen stats forever
_servers: dict[tuple[str, int], ThreadingHTTPServer] = {}
_servers_lock = threading.Lock()


def _monitoring_host() -> str:
    return os.environ.get("PATHWAY_MONITORING_HOST", "127.0.0.1")


class _RuntimeBridge:
    """Promotes RuntimeStats raw dicts onto the registry at scrape time
    (pull-based: the tick loop never pays for metric formatting). Node ids
    are process-unique, so per-node series from earlier runtimes stay
    monotone; whole-runtime counters (ticks) roll retired runtimes into a
    base so the process counter never goes backward."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._lock = threading.Lock()
        self._runtime: weakref.ref | None = None
        self._names: dict[int, str] = {}
        self._ticks_base = 0
        self._last_ticks = 0
        g, c = registry.gauge, registry.counter
        self.m_ticks = c("pathway_ticks_total", "engine ticks processed")
        self.m_logical_time = g(
            "pathway_logical_time", "current logical time (ms clock)"
        )
        self.m_last_tick = g(
            "pathway_last_tick_seconds", "duration of the last tick"
        )
        self.m_frontier_lag = g(
            "pathway_frontier_lag_ms",
            "wall clock minus logical frontier (streaming mode only)",
        )
        self.m_cpu = c(
            "pathway_process_cpu_seconds_total", "process CPU time"
        )
        self.m_rss = g(
            "pathway_process_memory_rss_bytes", "resident set size"
        )
        self.m_rows_in = c(
            "pathway_input_rows_total", "rows ingested per input node",
            ("node",),
        )
        self.m_rows_out = c(
            "pathway_output_rows_total", "rows emitted per output node",
            ("node",),
        )
        self.m_node_rows = c(
            "pathway_operator_rows_total", "rows produced per node",
            ("node",),
        )
        self.m_node_seconds = c(
            "pathway_operator_seconds_total",
            "cumulative processing time per node",
            ("node",),
        )
        registry.register_collector(self.collect)

    def attach(self, runtime) -> None:
        with self._lock:
            old = self._runtime() if self._runtime is not None else None
            if old is runtime:
                return
            if old is not None:
                self._ticks_base += old.stats.ticks
            elif self._runtime is not None:
                # previous runtime was GC'd: fold in its last-seen count
                self._ticks_base += self._last_ticks
            self._last_ticks = 0
            self._runtime = weakref.ref(runtime)
            self._names = {
                n.id: f"{n.name}_{n.id}" for n in runtime.order
            }

    def collect(self) -> None:
        import time as _time

        from pathway_tpu_torch.internals.telemetry import process_gauges

        gauges = process_gauges()
        self.m_cpu._unlabeled().set_total(
            gauges["process_cpu_seconds_total"]
        )
        self.m_rss.set(gauges["process_memory_rss_bytes"])
        with self._lock:
            runtime = self._runtime() if self._runtime is not None else None
            names = self._names
            base = self._ticks_base
        if runtime is None:
            self.m_ticks._unlabeled().set_total(base + self._last_ticks)
            return
        s = runtime.stats
        with self._lock:
            self._last_ticks = s.ticks
        self.m_ticks._unlabeled().set_total(base + s.ticks)
        self.m_logical_time.set(s.current_time)
        self.m_last_tick.set(s.last_tick_ns / 1e9)
        # frontier lag vs wall clock — the reference's input/output latency
        # gauges (http_server.rs:25-90). Only meaningful when logical times
        # ARE wall-clock ms (streaming mode); static runs with explicit
        # small event times would otherwise report a multi-decade "lag"
        now_ms = _time.time() * 1000.0
        week_ms = 7 * 86400 * 1000.0
        if 0 < s.current_time <= now_ms and now_ms - s.current_time < week_ms:
            self.m_frontier_lag.set(now_ms - s.current_time)
        else:
            self.m_frontier_lag.set(0.0)
        for metric, data in (
            (self.m_rows_in, s.rows_in),
            (self.m_rows_out, s.rows_out),
            (self.m_node_rows, s.node_rows),
        ):
            for nid, v in data.items():
                metric.labels(names.get(nid, str(nid))).set_total(v)
        for nid, v in s.node_ns.items():
            self.m_node_seconds.labels(
                names.get(nid, str(nid))
            ).set_total(v / 1e9)


_bridge: _RuntimeBridge | None = None
_bridge_lock = threading.Lock()


def _ensure_bridge() -> _RuntimeBridge:
    global _bridge
    with _bridge_lock:
        if _bridge is None:
            _bridge = _RuntimeBridge(REGISTRY)
        return _bridge


def _render_metrics(runtime) -> str:
    """Render the registry with `runtime`'s stats promoted onto it
    (kept as the model for tests and the TUI; the HTTP handler calls the
    same path)."""
    bridge = _ensure_bridge()
    if runtime is not None:
        bridge.attach(runtime)
    install_torch_metrics(REGISTRY)
    return REGISTRY.render()


def start_http_server(
    runtime=None, port: int | None = None, host: str | None = None
) -> ThreadingHTTPServer:
    """Start the metrics/debug endpoint in a daemon thread; returns the
    server (``server.server_address`` carries the actual bound port).
    ``runtime=None`` serves registry metrics and debug surfaces only —
    bench probes use that standalone mode."""
    if port is None:
        process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
        port = BASE_PORT + process_id
    if host is None:
        host = _monitoring_host()
    bridge = _ensure_bridge()
    if runtime is not None:
        bridge.attach(runtime)
    install_torch_metrics(REGISTRY)
    # Fleet Lens: a monitored process samples its own SLO signals and
    # keeps an incident journal with crash hooks — both opt-out
    # (PATHWAY_SIGNALS=0) and cheap when idle
    from pathway_tpu_torch.observability.journal import install_crash_hooks
    from pathway_tpu_torch.observability.signals import arm_sampler

    arm_sampler()
    install_crash_hooks()
    with _servers_lock:
        # port 0 asks for a FRESH ephemeral server (multi-member fleet
        # drivers start several in one process) — only canonical ports
        # participate in the reuse registry
        existing = _servers.get((host, port)) if port else None
        if existing is not None and existing.socket.fileno() == -1:
            # closed without going through the shutdown wrapper
            del _servers[(host, port)]
            existing = None
    if existing is not None:
        existing._pw_set_runtime(runtime)  # type: ignore[attr-defined]
        if runtime is not None:
            runtime.http_server = existing
        return existing

    # the handler resolves the runtime per request through this weak
    # cell: serving must not pin a finished run's whole graph in memory
    # (the bridge holds runtimes weakly for the same reason), and the
    # next run re-points the cell at its runtime
    cell: dict = {"ref": None}

    def set_runtime(rt) -> None:
        cell["ref"] = weakref.ref(rt) if rt is not None else None

    def current_runtime():
        ref = cell["ref"]
        return ref() if ref is not None else None

    set_runtime(runtime)

    class Handler(BaseHTTPRequestHandler):
        def _reply(
            self, code: int, body: bytes, ctype: str = "text/plain"
        ) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            runtime = current_runtime()
            parsed = urlparse(self.path)
            route = parsed.path.rstrip("/")
            try:
                if route in ("", "/metrics"):
                    self._reply(
                        200,
                        _render_metrics(runtime).encode(),
                        "text/plain; version=0.0.4",
                    )
                elif route == "/status":
                    snap = (
                        runtime.stats.snapshot()
                        if runtime is not None
                        else {}
                    )
                    self._reply(
                        200, json.dumps(snap).encode(), "application/json"
                    )
                elif route == "/debug/threads":
                    self._reply(200, thread_stack_dump().encode())
                elif route == "/debug/graph":
                    self._reply(
                        200,
                        json.dumps(graph_table(runtime)).encode(),
                        "application/json",
                    )
                elif route == "/debug/profile":
                    self._profile(parse_qs(parsed.query))
                elif route == "/debug/trace":
                    self._trace(parse_qs(parsed.query))
                elif route == "/debug/signals":
                    self._signals(parse_qs(parsed.query))
                elif route == "/debug/events":
                    self._events(parse_qs(parsed.query))
                elif route == "/debug/tick":
                    self._tick(runtime, parse_qs(parsed.query))
                elif route == "/debug/autoscale":
                    # Flux Pilot: the armed controller's live status
                    # (ranks, cooldown, last decision, actuation-cost
                    # EWMA) — 404s when no controller is armed so
                    # probes can distinguish "absent" from "idle"
                    from pathway_tpu_torch.autoscale import get_controller

                    ctrl = get_controller()
                    if ctrl is None:
                        self._reply(404, b"no autoscale controller armed")
                    else:
                        self._reply(
                            200,
                            json.dumps(ctrl.status()).encode(),
                            "application/json",
                        )
                elif route in (
                    "/fleet/metrics",
                    "/fleet/events",
                    "/fleet/trace",
                ):
                    self._fleet(route, parse_qs(parsed.query))
                else:
                    self._reply(404, b"not found")
            except BrokenPipeError:
                pass
            except Exception as exc:  # a broken page must not kill serving
                try:
                    self._reply(
                        500, f"internal error: {exc}".encode()
                    )
                except Exception:
                    pass

        def _trace(self, query: dict) -> None:
            """Trace Weaver export: the span ring as Chrome trace-event
            JSON — save the body to a file and load it in Perfetto
            (ui.perfetto.dev) or chrome://tracing. ``seconds=N`` keeps
            only spans that ended within the trailing window."""
            from pathway_tpu_torch.observability.tracing import get_tracer

            raw = query.get("seconds", ["0"])[0]
            try:
                seconds = float(raw)
            except ValueError:
                self._reply(400, b"seconds must be a number")
                return
            if seconds < 0:
                self._reply(400, b"seconds must be non-negative")
                return
            doc = get_tracer().chrome_trace(
                seconds=seconds if seconds > 0 else None
            )
            self._reply(
                200, json.dumps(doc).encode(), "application/json"
            )

        def _tick(self, runtime, query: dict) -> None:
            """Tick Scope (observability/tickscope.py): last-tick
            anatomy (per-operator wall/rows, compiled-vs-interpreted,
            critical path), the memory ledger's top owners, roofline
            MFU per kernel family, and per-channel wire bytes.
            ``ticks=N`` adds a trailing-N operator rollup; ``deep=1``
            includes monolith-pickle sizes (costs a pickle per
            monolithic exec); ``trace=1`` returns the ring as Chrome
            trace-event JSON instead (one Perfetto track per exec)."""
            from pathway_tpu_torch.observability import tickscope

            scope = getattr(runtime, "_tickscope", None)
            if scope is None:
                scope = tickscope.recorder()
            try:
                ticks = int(query.get("ticks", ["1"])[0])
            except ValueError:
                self._reply(400, b"ticks must be an integer")
                return
            deep = query.get("deep", ["0"])[0] not in ("0", "")
            if query.get("trace", ["0"])[0] not in ("0", ""):
                doc = (
                    scope.chrome_trace(n_ticks=ticks if ticks > 0 else None)
                    if scope is not None
                    else {"traceEvents": []}
                )
                self._reply(
                    200, json.dumps(doc).encode(), "application/json"
                )
                return
            if scope is None:
                doc = {
                    "enabled": tickscope.enabled_from_env(),
                    "ticks_recorded": 0,
                    "memory": tickscope.memory_snapshot(deep=deep),
                    "roofline": tickscope.roofline().snapshot(),
                    "wire": tickscope.wire_snapshot(),
                }
            else:
                doc = scope.snapshot(ticks=max(ticks, 1), deep=deep)
            self._reply(200, json.dumps(doc).encode(), "application/json")

        def _signals(self, query: dict) -> None:
            """Fleet Lens SLO signal rings (observability/signals.py):
            the feed the autoscaler consumes. ``series=N`` includes the
            trailing N ring points per signal."""
            from pathway_tpu_torch.observability.signals import get_sampler

            sampler = get_sampler()
            if sampler is None:
                self._reply(
                    200,
                    json.dumps(
                        {"enabled": False, "signals": {}, "slo": {}}
                    ).encode(),
                    "application/json",
                )
                return
            raw = query.get("series", ["0"])[0]
            try:
                series_points = int(raw)
            except ValueError:
                self._reply(400, b"series must be an integer")
                return
            snap = sampler.snapshot(series_points=series_points)
            snap["enabled"] = True
            self._reply(200, json.dumps(snap).encode(), "application/json")

        def _events(self, query: dict) -> None:
            """Incident journal (observability/journal.py). ``kind=a,b``
            filters; ``n=N`` caps at the trailing N events."""
            from pathway_tpu_torch.observability.journal import journal

            j = journal()
            kinds_raw = query.get("kind", [""])[0]
            kinds = (
                [k for k in kinds_raw.split(",") if k] or None
            )
            events = j.events(kinds=kinds)
            raw = query.get("n", ["0"])[0]
            try:
                n = int(raw)
            except ValueError:
                self._reply(400, b"n must be an integer")
                return
            if n > 0:
                events = events[-n:]
            self._reply(
                200,
                json.dumps(
                    {"member": j.member, "events": events}
                ).encode(),
                "application/json",
            )

        def _fleet(self, route: str, query: dict) -> None:
            """Fleet Lens federation over PATHWAY_FLEET_MEMBERS (the
            group supervisor stamps the rank -> monitoring-port map into
            every rank's env): one member-labeled exposition, one merged
            incident timeline, one stitched cross-member trace."""
            from pathway_tpu_torch.observability.fleet import (
                federate_events,
                federate_metrics,
                members_from_env,
                stitch_traces,
            )
            from pathway_tpu_torch.observability.journal import journal

            members = members_from_env()
            me = journal().member
            # this process serves its own view inline — a member entry
            # naming OUR port would double-count us in the merge
            port = self.server.server_address[1]

            def _is_self(u: str) -> bool:
                p = urlparse(u)
                return p.port == port and p.hostname in (
                    "127.0.0.1", "localhost", host,
                )

            members = [(n, u) for n, u in members if not _is_self(u)]
            if route == "/fleet/metrics":
                # fetch errors are already encoded in the body as
                # pathway_fleet_member_up{member=...} 0
                text, _errors = federate_metrics(
                    members, local=(me, _render_metrics(current_runtime()))
                )
                self._reply(
                    200, text.encode(), "text/plain; version=0.0.4"
                )
            elif route == "/fleet/events":
                merged = federate_events(
                    members, local=journal().events()
                )
                self._reply(
                    200, json.dumps(merged).encode(), "application/json"
                )
            else:
                from pathway_tpu_torch.observability.tracing import get_tracer

                trace_id = query.get("trace_id", [""])[0] or None
                doc = stitch_traces(
                    members,
                    trace_id=trace_id,
                    local=(me, get_tracer().chrome_trace()),
                )
                self._reply(
                    200, json.dumps(doc).encode(), "application/json"
                )

        def _profile(self, query: dict) -> None:
            """torch.profiler capture (observability/debug.py):
            ``seconds=N`` (0 < N <= 120), ``device=cuda`` (default) or
            ``cpu``. 400 on a bad argument, 409 while another capture
            runs, 501 when the asked device cannot be traced."""
            try:
                seconds = float(query.get("seconds", ["1.0"])[0])
            except ValueError:
                self._reply(400, b"seconds must be a number")
                return
            device = query.get("device", ["cuda"])[0]
            try:
                trace_dir = take_profile(seconds, device=device)
            except ProfilerUnavailable as exc:
                self._reply(501, str(exc).encode())
                return
            except ValueError as exc:
                self._reply(400, str(exc).encode())
                return
            except RuntimeError as exc:
                self._reply(409, str(exc).encode())
                return
            from pathway_tpu_torch.observability.debug import (
                SUMMARY_FILE,
                TRACE_FILE,
            )

            with open(os.path.join(trace_dir, SUMMARY_FILE)) as fh:
                summary = json.load(fh)
            self._reply(
                200,
                json.dumps(
                    {
                        "trace_dir": trace_dir,
                        "seconds": seconds,
                        "trace_file": os.path.join(trace_dir, TRACE_FILE),
                        **summary,
                    }
                ).encode(),
                "application/json",
            )

        def log_message(self, *args):
            pass

    try:
        server = ThreadingHTTPServer((host, port), Handler)
    except OSError as exc:
        # the requested port is taken (common when several runs share a
        # box): fall back to an ephemeral port instead of crashing the run
        server = ThreadingHTTPServer((host, 0), Handler)
        logger.warning(
            "monitoring port %s:%d unavailable (%s); serving metrics on "
            "ephemeral port %d instead",
            host, port, exc, server.server_address[1],
        )
    server._pw_set_runtime = set_runtime  # type: ignore[attr-defined]
    real_shutdown = server.shutdown
    # canonical asks key by the REQUESTED port (the next run asking for
    # that port reuses this server even when a foreign process forced
    # the ephemeral fallback); a requested port of 0 keys by the BOUND
    # port instead, so it stays visible to the doctor's armed check but
    # can never be handed to a second port-0 caller
    reg_key = (host, port or server.server_address[1])

    def shutdown_and_deregister() -> None:
        with _servers_lock:
            if _servers.get(reg_key) is server:
                del _servers[reg_key]
        real_shutdown()
        # shutdown() only stops serve_forever; the listening socket
        # would stay bound and its backlog would swallow scrapes of the
        # canonical port without ever replying
        server.server_close()

    server.shutdown = shutdown_and_deregister  # type: ignore[method-assign]
    with _servers_lock:
        _servers[reg_key] = server
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    if runtime is not None:
        runtime.http_server = server
    return server
