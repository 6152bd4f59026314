"""REST server connector: HTTP requests become table rows; responses are
delivered when the result row for the request id arrives — the port's copy
of ``pathway_tpu/io/http/_server.py`` (``PathwayWebserver`` with its OpenAPI
document, ``RestServerSubject``, ``rest_connector``), with the same HTTP
contract: status codes, JSON bodies, the Surge Gate's 429/503/504 with
``Retry-After``, stale reads with their ``x-pathway-stale*`` headers,
``traceparent`` in and out, and the ``pathway_rest_*`` metrics.

One difference: the reference serves on aiohttp; this copy serves on the
standard library's asyncio (``_web.py``), so REST runs where aiohttp is not
installed. A request (or a gate's flush) goes into the connector's session
with ``insert``, not ``next``: it reaches the engine at once, one tick, and
waits for no ``commit()``."""

from __future__ import annotations

import asyncio
import json as _json
import threading
import time as _time
import uuid
from typing import Any, Mapping, Sequence


from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import OutputNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.internals.api import Pointer, ref_scalar
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.schema import SchemaMetaclass, schema_from_types
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.http import _web as web
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read


class EndpointDocumentation:
    def __init__(
        self,
        summary: str | None = None,
        description: str | None = None,
        tags: Sequence[str] | None = None,
        method_status: Any = None,
        **kwargs,
    ):
        self.summary = summary
        self.description = description
        self.tags = list(tags or [])


class EndpointExamples:
    def __init__(self):
        self.examples: list = []

    def add_example(self, *args, **kwargs):
        return self


class PathwayWebserver:
    """One HTTP server shared by all rest_connector routes, on its own
    thread and event loop."""

    def __init__(
        self,
        host: str,
        port: int,
        with_schema_endpoint: bool = True,
        with_cors: bool = False,
    ):
        self.host = host
        self.port = port
        self._app = web.Application()
        self._openapi: dict[str, Any] = {
            "openapi": "3.0.3",
            "info": {"title": "Pathway-TPU API", "version": "1.0"},
            "paths": {},
        }
        self._started = False
        self._stopped = False
        self._lock = threading.Lock()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_ready = threading.Event()
        self._stop_async: Any = None  # threadsafe resolver of the stop event
        self._thread: threading.Thread | None = None
        self._gates: list[Any] = []  # SurgeGates of this server's routes
        if with_schema_endpoint:
            self._app.add_get("/_schema", self._schema_handler)

    async def _schema_handler(self, request: web.Request) -> web.Response:
        return web.json_response(self._openapi)

    def _register_endpoint(
        self, route: str, handler, methods: Sequence[str], schema, documentation
    ) -> None:
        with self._lock:
            for method in methods:
                self._app.add_route(method, route, handler)
            doc: dict[str, Any] = {}
            for method in methods:
                entry: dict[str, Any] = {
                    "responses": {"200": {"description": "OK"}}
                }
                if documentation is not None:
                    if documentation.summary:
                        entry["summary"] = documentation.summary
                    if documentation.description:
                        entry["description"] = documentation.description
                    if documentation.tags:
                        entry["tags"] = documentation.tags
                if schema is not None:
                    props = {
                        name: {"type": _openapi_type(c.dtype)}
                        for name, c in schema.columns().items()
                    }
                    entry["requestBody"] = {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "properties": props,
                                }
                            }
                        }
                    }
                doc[method.lower()] = entry
            self._openapi["paths"][route] = doc

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True

        def run_loop():
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)
            stop_ev = asyncio.Event()
            self._stop_async = lambda: loop.call_soon_threadsafe(stop_ev.set)
            self._loop_ready.set()

            # serve until stop(); a stop that landed while the server
            # was coming up (including one whose _loop_ready wait timed
            # out, so _stop_async was never called) skips the wait —
            # shutdown always releases the socket + pending handlers
            if self._stopped:
                stop_ev.set()
            try:
                loop.run_until_complete(
                    self._app.serve(self.host, self.port, stop_ev)
                )
            finally:
                loop.close()

        self._thread = threading.Thread(target=run_loop, daemon=True)
        self._thread.start()

    def register_gate(self, gate: Any) -> None:
        with self._lock:
            self._gates.append(gate)

    def drain(self, grace_s: float | None = None) -> bool:
        """Graceful shutdown: every attached SurgeGate stops admitting
        (503 + Retry-After), flushes its queue, and waits for in-flight
        responses; then the listener closes. Returns True if all gates
        went idle within their grace period."""
        with self._lock:
            gates = list(self._gates)
        all_idle = True
        for gate in gates:
            all_idle = gate.drain(grace_s) and all_idle
        for gate in gates:
            gate.close()
        self.stop()
        return all_idle

    def stop(self, timeout: float = 5.0) -> None:
        """Close the listener and join the server thread (idempotent).
        In-flight handlers get the application's shutdown timeout (1 s)
        to answer, then are cancelled."""
        with self._lock:
            if not self._started or self._stopped:
                return
            self._stopped = True
        # stop() can race the server thread's startup: wait until the
        # loop exists (the ready event is set before any server setup
        # work, so this wait is bounded by loop creation alone), then
        # resolve the async stop event — it lands whether main() is
        # still starting up or already serving.
        self._loop_ready.wait(timeout)
        stop_async = self._stop_async
        if stop_async is not None:
            try:
                stop_async()
            except RuntimeError:
                pass  # loop already closed
        if self._thread is not None:
            self._thread.join(timeout)


def _openapi_type(d: dt.DType) -> str:
    sd = d.strip_optional()
    if sd == dt.INT:
        return "integer"
    if sd == dt.FLOAT:
        return "number"
    if sd == dt.BOOL:
        return "boolean"
    if sd == dt.JSON:
        return "object"
    return "string"


class RestServerSubject(ConnectorSubject):
    """Feeds HTTP requests into the graph; resolves response futures when the
    response writer delivers results (reference: _server.py:490)."""

    def __init__(
        self,
        webserver: PathwayWebserver,
        route: str,
        schema: SchemaMetaclass,
        methods: Sequence[str],
        delete_completed_queries: bool,
        format: str = "raw",
        documentation: EndpointDocumentation | None = None,
        qos: Any = None,
    ):
        self._webserver = webserver
        self._route = route
        self._format = format
        self._request_schema = schema
        self._delete_completed = delete_completed_queries
        self._qos = qos  # serving.QoSConfig | None (None = ungated seed path)
        self._gate: Any = None  # SurgeGate, built in run() once the
        # InputSession exists
        self._stop_event = threading.Event()
        self._futures: dict[int, asyncio.Future] = {}
        self._futures_lock = threading.Lock()
        # Flight Recorder: serving-path latency, request-in to
        # response-out (covers the whole dataflow round trip, which is
        # what a client experiences), labeled by route
        from pathway_tpu_torch.observability import REGISTRY

        self._m_seconds = REGISTRY.histogram(
            "pathway_rest_request_seconds",
            "REST request latency: ingestion to delivered response",
            labelnames=("route",),
        ).labels(route)
        self._m_requests = REGISTRY.counter(
            "pathway_rest_requests_total",
            "REST requests served, by route/method/status",
            labelnames=("route", "method", "status"),
        )
        self._m_inflight = REGISTRY.gauge(
            "pathway_rest_inflight_requests",
            "requests currently awaiting their dataflow result",
            labelnames=("route",),
        ).labels(route)
        webserver._register_endpoint(
            route, self._handle, methods, schema, documentation
        )
        self._ready = threading.Event()

    def run(self) -> None:
        if self._qos is not None:
            # Surge Gate: the QoS layer between this endpoint and the
            # engine tick. Built here (not __init__) because it feeds
            # the connector's InputSession, which exists only once the
            # runtime wires the source.
            from pathway_tpu_torch.serving import SurgeGate

            self._gate = SurgeGate(
                self._qos,
                self._session,
                route=self._route,
                webserver=self._webserver,
            )
            self._webserver.register_gate(self._gate)
        self._webserver.start()
        self._ready.set()
        # stay alive for the lifetime of the graph (on_stop releases us)
        self._stop_event.wait()

    def on_stop(self) -> None:
        """Runtime stop: fail queued requests, close the gate, shut the
        webserver down so tests (and drains) don't leak servers."""
        if self._gate is not None:
            try:
                self._gate.close()
            except Exception:
                pass
        try:
            self._webserver.stop()
        except Exception:
            pass
        self._stop_event.set()

    async def _handle(self, request: web.Request) -> web.Response:
        from pathway_tpu_torch.observability import tracing

        t0 = _time.perf_counter()
        self._m_inflight.inc()
        # Trace Weaver ingress: continue the caller's W3C trace when a
        # `traceparent` header arrives (the cross-service contract the
        # reference keeps across the Python/engine boundary,
        # python_api.rs:3343), mint a fresh root otherwise. The span
        # covers the whole dataflow round trip; the engine tick adopts
        # this context via the pending-request registry, so embed/KNN/
        # operator spans downstream share the trace id.
        span = tracing.get_tracer().span(
            "http.request",
            parent=tracing.parse_traceparent(
                request.headers.get("traceparent")
            ),
            root=True,
            ingress=True,
            route=self._route,
            method=request.method,
        )
        try:
            with span:
                response = await self._handle_inner(request)
                span.set_attribute("status", response.status)
        except Exception:
            self._m_requests.labels(
                self._route, request.method, "500"
            ).inc()
            raise
        finally:
            self._m_inflight.dec()
            self._m_seconds.observe(
                _time.perf_counter() - t0, exemplar=span.trace_id
            )
        self._m_requests.labels(
            self._route, request.method, str(response.status)
        ).inc()
        if span.context is not None:
            # echo the trace identity so callers can find this request in
            # /debug/trace (response contract: same trace id, our span id)
            response.headers["traceparent"] = span.context.traceparent()
        return response

    async def _handle_inner(self, request: web.Request) -> web.Response:
        from pathway_tpu_torch.observability import tracing

        rid = uuid.uuid4().hex
        key = int(ref_scalar(rid))
        if self._format == "raw":
            body = await request.text()
            values: dict[str, Any] = {"query": body}
        else:
            try:
                payload = await request.json()
            except ValueError:
                payload = {}
            if request.query:
                payload = {**request.query, **payload}
            values = {}
            for name, col in self._request_schema.columns().items():
                if name in payload:
                    values[name] = payload[name]
                elif col.has_default_value:
                    values[name] = col.default_value
                else:
                    return web.json_response(
                        {"error": f"missing field {name!r}"}, status=400
                    )
        coerced = self._coerce_values(values)
        vals = self._vals(coerced)
        assert self._session is not None
        if self._gate is not None:
            return await self._handle_gated(request, key, vals, coerced)
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        with self._futures_lock:
            self._futures[key] = future
        # hand the request's span context to the engine: the tick that
        # processes this row parents itself on it (tracing registry)
        tracing.register_pending(key, tracing.current_context())
        try:
            self._session.insert(key, vals)
            result = await future
        finally:
            tracing.unregister_pending(key)
        if self._delete_completed:
            self._session.remove(key, vals)
        return web.json_response(result)

    def _deadline_for(self, request: web.Request) -> float:
        """Absolute monotonic deadline: the ``x-pathway-deadline-ms``
        budget header (clamped to the configured cap), or the endpoint
        default when absent/garbled."""
        import math

        cfg = self._qos
        budget_ms = None
        raw = request.headers.get("x-pathway-deadline-ms")
        if raw is not None:
            try:
                budget_ms = float(raw)
            except ValueError:
                budget_ms = None
            # nan/inf would bypass the clamp AND both sides of the
            # batcher's live/dead partition — treat as absent
            if budget_ms is not None and not math.isfinite(budget_ms):
                budget_ms = None
        if budget_ms is None:
            budget_ms = cfg.default_deadline_ms
        budget_ms = min(budget_ms, cfg.max_deadline_ms)
        return _time.monotonic() + budget_ms / 1000.0

    async def _handle_gated(
        self,
        request: web.Request,
        key: int,
        vals: tuple,
        values: dict | None = None,
    ) -> web.Response:
        """Surge Gate serving path: admission → EDF queue → micro-batch
        dispatch → engine tick → response, with explicit shedding.

        Phoenix degradation: while the engine is recovering (peer
        failure / restore replay), reads are answered from the last
        hydrated index snapshot via the route's registered stale
        responder instead of queueing behind a tick loop that is not
        running — with explicit staleness headers and the
        ``x-pathway-max-staleness-ms`` bound honored."""
        from pathway_tpu_torch.observability import tracing
        from pathway_tpu_torch.serving import (
            DeadlineExceeded,
            PendingRequest,
            ShedError,
        )
        from pathway_tpu_torch.serving import degrade

        reason = degrade.recovering()
        if reason is not None:
            return await self._handle_stale(
                request, values if values is not None else {}, reason
            )
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        dispatched: asyncio.Future = loop.create_future()
        deadline = self._deadline_for(request)
        req = PendingRequest(
            key,
            vals,
            deadline,
            loop=loop,
            dispatched=dispatched,
            # Tenant Weave identity: consumed only when the gate's
            # ledger is armed (PATHWAY_TENANT_QOS=1); inert otherwise
            tenant=request.headers.get("x-pathway-tenant"),
            tenant_class=request.headers.get("x-pathway-tenant-class"),
        )
        with self._futures_lock:
            self._futures[key] = future
        tracing.register_pending(key, tracing.current_context())
        admitted = False
        timed_out = False
        try:
            try:
                self._gate.submit(req)
                admitted = True
            except ShedError as e:
                return web.json_response(
                    {"error": f"request shed: {e.reason}"},
                    status=e.status,
                    headers={"Retry-After": f"{e.retry_after_s:.3f}"},
                )
            except DeadlineExceeded:
                return web.json_response(
                    {"error": "deadline exceeded"}, status=504
                )
            try:
                # queue.wait: admission to micro-batch release — the
                # QoS-added latency, as a child of the request span
                with tracing.get_tracer().span(
                    "queue.wait", route=self._route
                ) as qs:
                    batch_size = await dispatched
                    qs.set_attribute("batch", batch_size)
            except DeadlineExceeded:
                # dropped at flush: the engine never saw this request
                return web.json_response(
                    {"error": "deadline exceeded before dispatch"},
                    status=504,
                )
            except ShedError as e:
                return web.json_response(
                    {"error": f"request shed: {e.reason}"},
                    status=e.status,
                    headers={"Retry-After": f"{e.retry_after_s:.3f}"},
                )
            try:
                result = await asyncio.wait_for(
                    future, timeout=max(0.001, deadline - _time.monotonic())
                )
            except asyncio.TimeoutError:
                # dispatched but the result missed the deadline; KEEP
                # the registry entry so the tick that eventually reaches
                # this row skips its device work (index_node) — _deliver
                # or the registry's lazy sweep cleans it up
                timed_out = True
                return web.json_response(
                    {"error": "deadline exceeded"}, status=504
                )
        finally:
            tracing.unregister_pending(key)
            with self._futures_lock:
                self._futures.pop(key, None)
            if admitted:
                # settle the race with the batcher atomically: a
                # handler cancelled (client disconnect) while its
                # request is still queued abandons it, so the flush
                # skips the row — it must not claim an engine batch
                # slot or a dispatch-window slot nobody will ever free
                was_dispatched = not req.abandon()
                self._gate.complete(
                    None if timed_out else key,
                    was_dispatched=was_dispatched,
                )
                if was_dispatched and self._delete_completed:
                    try:
                        self._session.remove(key, vals)
                    except Exception:
                        pass
        return web.json_response(result)

    async def _handle_stale(
        self, request: web.Request, values: dict, reason: str
    ) -> web.Response:
        """Answer a read from the last hydrated snapshot while the
        engine recovers. No responder registered → explicit 503 (never
        hang a request on a tick loop that is not ticking)."""
        from pathway_tpu_torch.serving import degrade

        staleness = degrade.staleness_seconds()
        stale_hdrs = {
            "x-pathway-stale": "true",
            "x-pathway-staleness-seconds": (
                f"{staleness:.3f}" if staleness is not None else "unknown"
            ),
        }
        responder = degrade.stale_responder(self._route)
        if responder is None:
            degrade.count_degraded_shed(self._route, "no_responder")
            return web.json_response(
                {"error": f"engine recovering: {reason}"},
                status=503,
                headers={"Retry-After": "1.0", **stale_hdrs},
            )
        max_raw = request.headers.get("x-pathway-max-staleness-ms")
        if max_raw is not None:
            import math

            try:
                bound_ms = float(max_raw)
            except ValueError:
                bound_ms = None
            if bound_ms is not None and math.isfinite(bound_ms):
                if staleness is None or staleness * 1000.0 > bound_ms:
                    degrade.count_degraded_shed(
                        self._route, "max_staleness"
                    )
                    return web.json_response(
                        {
                            "error": "snapshot staler than "
                            "x-pathway-max-staleness-ms while the "
                            f"engine recovers: {reason}"
                        },
                        status=503,
                        headers={"Retry-After": "1.0", **stale_hdrs},
                    )
        loop = asyncio.get_running_loop()
        try:
            result = await loop.run_in_executor(None, responder, values)
        except Exception:
            degrade.count_degraded_shed(self._route, "responder_error")
            return web.json_response(
                {"error": f"stale read failed while recovering: {reason}"},
                status=503,
                headers={"Retry-After": "1.0", **stale_hdrs},
            )
        degrade.count_stale_served(self._route)
        return web.json_response(result, headers=stale_hdrs)

    def _deliver(self, key: int, payload: Any) -> None:
        if self._gate is not None:
            # late result for a 504'd request: its deadline entry was
            # deliberately left registered so the engine could skip the
            # work — this is the natural cleanup point
            from pathway_tpu_torch.serving import deadline as _sdl

            _sdl.unregister(key)
        with self._futures_lock:
            future = self._futures.pop(key, None)
        if future is None:
            return
        loop = future.get_loop()
        loop.call_soon_threadsafe(
            lambda: future.done() or future.set_result(payload)
        )

    def _key_for(self, values):  # keys are assigned in _handle
        raise NotImplementedError


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    schema: SchemaMetaclass | None = None,
    methods: Sequence[str] = ("POST",),
    autocommit_duration_ms: int | None = 50,
    keep_queries: bool | None = None,
    delete_completed_queries: bool | None = None,
    request_validator: Any = None,
    documentation: EndpointDocumentation | None = None,
    qos: Any = None,
) -> tuple[Table, Any]:
    """Returns (queries_table, response_writer). Call
    ``response_writer(result_table)`` where result_table has columns
    ``query_id`` (Pointer) and ``result`` (reference: _server.py:624).

    ``qos``: a :class:`pathway_tpu_torch.serving.QoSConfig` puts the endpoint
    behind a Surge Gate (micro-batching + deadline-aware admission
    control + graceful overload). ``None`` keeps the ungated per-request
    path unless ``PATHWAY_SERVING_ENABLED=1``, in which case the
    env-configured gate applies."""
    if delete_completed_queries is None:
        delete_completed_queries = not bool(keep_queries)
    if qos is None:
        from pathway_tpu_torch.serving import QoSConfig, serving_enabled_via_env

        if serving_enabled_via_env():
            qos = QoSConfig.from_env()
    if webserver is None:
        assert host is not None and port is not None
        webserver = PathwayWebserver(host, port)
    if schema is None:
        schema = schema_from_types(query=str)
        fmt = "raw"
    else:
        fmt = "custom"
    subject = RestServerSubject(
        webserver,
        route,
        schema,
        methods,
        delete_completed_queries,
        format=fmt,
        documentation=documentation,
        qos=qos,
    )
    queries = python_read(subject, schema=schema)

    def response_writer(response_table: Table) -> None:
        col_names = response_table.column_names()
        assert "query_id" in col_names and "result" in col_names, (
            "response table must have query_id and result columns"
        )
        qi = col_names.index("query_id")
        ri = col_names.index("result")

        def on_batch(t: int, batch: DiffBatch) -> None:
            for k, d, vals in batch.iter_rows():
                if d <= 0:
                    continue
                qid = vals[qi]
                result = vals[ri]
                if isinstance(result, Json):
                    result = result.value
                subject._deliver(int(qid), _jsonable(result))

        node = OutputNode(response_table._node, on_batch)
        parse_graph.G.add_output(node)

    return queries, response_writer


def _jsonable(v: Any):
    import numpy as np

    if isinstance(v, Json):
        return v.value
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, Pointer):
        return str(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v
