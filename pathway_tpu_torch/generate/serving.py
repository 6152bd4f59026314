"""The ``/generate`` serving route: ask -> retrieve -> generate —
counterpart of ``pathway_tpu/generate/serving.py``, on the port's own
HTTP server (``io/http/_web.py``: its ``StreamResponse`` carries the
NDJSON stream). The scheduler it builds runs on the replica's ``device``,
so on the card every decode step is a ``paged_attention`` launch and every
retrieval a ``block_topk`` launch.

``attach_generate(replica_server)`` mounts a generation stage on a read
replica: the handler embeds the prompt with the plane's deterministic
``text_vector`` embedder, retrieves top-k context from the replica's
(delta-stream-fresh) KNN index, assembles the grounded prompt, and
streams the decode through the replica's
:class:`~pathway_tpu_torch.generate.scheduler.DecodeScheduler`.

Contract (the read plane's degrade headers hold through generation):

* request body: ``{"prompt": str, "k": int (retrieval fan-in, 0 = no
  retrieval), "max_tokens": int, "temperature": float, "top_k": int,
  "seed": int, "stream": bool}``;
* ``x-pathway-deadline-ms`` bounds the WHOLE generation: an expired
  deadline drops the sequence mid-decode (504 — pages reclaimed, never
  another step); ``x-pathway-max-staleness-ms`` sheds 503 when the
  retrieval corpus is staler than the bound (same rule as ``/query``);
* responses carry ``x-pathway-replica`` / ``x-pathway-applied-tick`` /
  ``x-pathway-staleness-seconds`` (the retrieval corpus freshness the
  generation was conditioned on) plus ``x-pathway-generate-tokens``;
* ``stream: true`` answers NDJSON over chunked encoding: a ``meta``
  line (retrieved context, freshness), one line per sampled token, and
  a final ``done`` line.  Non-streaming responses are a single JSON
  object — the shape the failover router proxies.

The router routes ``/generate`` through the SAME occupancy/staleness/
tenant machinery as every read, but always to ONE member (generation
is stateful on the member holding the KV pages — scatter-gather is a
retrieval concept), see serving/router.py ``is_generate_route``.
"""

from __future__ import annotations

import json
import time
from typing import Any

import numpy as np

GENERATE_ROUTE = "/generate"


def is_generate_route(path: str) -> bool:
    # segment-exact: "/v1/generate" and "/generate/" match, a route
    # that merely ENDS in the word (e.g. "/regenerate") must not — on
    # a sharded plane a false match would divert a scatter-gather read
    # to a single member's partial corpus
    return path.rstrip("/").endswith(GENERATE_ROUTE)


def attach_generate(
    server: Any,
    scheduler: Any = None,
    *,
    route: str = GENERATE_ROUTE,
) -> Any:
    """Mount the generation stage on a ReplicaServer BEFORE ``start()``.
    Builds the scheduler from env (``PATHWAY_GENERATE_*``) when none is
    given; returns it."""
    if scheduler is None:
        from pathway_tpu_torch.generate.scheduler import (
            DecodeScheduler,
            GenerateConfig,
        )

        scheduler = DecodeScheduler(
            GenerateConfig.from_env(),
            replica_label=str(server.replica_id),
            # Tenant Weave: the replica's ledger (PATHWAY_TENANT_QOS=1)
            # extends WFQ fairness past the admission gate into decode
            # batching — the batcher orders by (vfinish, deadline)
            ledger=getattr(server, "tenant_ledger", None),
            device=server.device,
        )
    server.generate_scheduler = scheduler
    server.extra_post_routes[route] = _handle_generate
    return scheduler


def assemble_prompt(prompt: str, matches: list) -> str:
    """Grounded prompt assembly: retrieved doc keys/scores prefix the
    user ask.  (With the bundled random-init decoder the text is not
    semantically meaningful — what matters, and what the e2e test pins,
    is that the tokens fed to the decoder are CONDITIONED on the
    retrieved context: a corpus change changes the generation.)"""
    ctx = " ".join(f"[doc {int(k)}:{score:.3f}]" for k, score in matches)
    return f"context: {ctx}\nask: {prompt}\nanswer:" if ctx else (
        f"ask: {prompt}\nanswer:"
    )


async def _handle_generate(http: Any, request: Any):
    """Handler running inside _ReplicaHttp (its loop thread)."""
    import asyncio

    from pathway_tpu_torch.io.http import _web as web

    from pathway_tpu_torch.generate.scheduler import GenerationRequest
    from pathway_tpu_torch.observability import tracing
    from pathway_tpu_torch.serving.admission import ShedError
    from pathway_tpu_torch.serving.replica import text_vector

    srv = http.server
    sched = srv.generate_scheduler
    span = tracing.get_tracer().span(
        "generate.request",
        parent=tracing.parse_traceparent(
            request.headers.get("traceparent")
        ),
        root=True,
        ingress=True,
        replica=srv.replica_id,
    )
    with span:
        staleness = srv.staleness_seconds()
        stale = srv.is_stale()
        headers = {
            "x-pathway-replica": str(srv.replica_id),
            "x-pathway-applied-tick": str(srv.applied_tick),
            "x-pathway-staleness-seconds": (
                f"{staleness:.3f}" if staleness is not None else "unknown"
            ),
        }
        if stale:
            headers["x-pathway-stale"] = "true"
        if span.context is not None:
            headers["traceparent"] = span.context.traceparent()
        # the retrieval-freshness bound: generation grounded on a
        # corpus staler than the client accepts must shed, not guess —
        # the SAME predicate as the /query read path
        from pathway_tpu_torch.serving.replica import staleness_bound_exceeded

        if staleness_bound_exceeded(
            staleness,
            stale,
            request.headers.get("x-pathway-max-staleness-ms"),
        ):
            span.set_attribute("status", 503)
            return web.json_response(
                {
                    "error": "retrieval corpus staler than "
                    "x-pathway-max-staleness-ms"
                },
                status=503,
                headers={"Retry-After": "1.0", **headers},
            )
        try:
            values = await request.json()
        except ValueError:
            values = {}
        if not isinstance(values, dict) or not str(
            values.get("prompt", "")
        ).strip():
            span.set_attribute("status", 400)
            return web.json_response(
                {"error": "body must be a JSON object with `prompt`"},
                status=400,
                headers=headers,
            )
        prompt = str(values["prompt"])
        try:
            k = int(values.get("k", 3))
            max_tokens = int(
                values.get("max_tokens", sched.config.max_new_tokens)
            )
            temperature = float(values.get("temperature", 0.0))
            top_k = int(values.get("top_k", 40))
            seed = int(values.get("seed", 0))
        except (TypeError, ValueError):
            span.set_attribute("status", 400)
            return web.json_response(
                {"error": "k/max_tokens/temperature/top_k/seed must be "
                 "numbers"},
                status=400,
                headers=headers,
            )
        max_tokens = max(1, max_tokens)
        # deadline propagation: the generation inherits the request's
        # remaining budget and is dropped MID-decode past it.  Non-
        # finite budgets fall back to the default — a NaN deadline
        # compares False against every sweep predicate, which would
        # park the sequence forever with its KV pages pinned
        import math

        try:
            budget_ms = float(
                request.headers.get("x-pathway-deadline-ms", "")
            )
        except ValueError:
            budget_ms = sched.qos.default_deadline_ms
        if not math.isfinite(budget_ms):
            budget_ms = sched.qos.default_deadline_ms
        budget_ms = min(budget_ms, sched.qos.max_deadline_ms)
        deadline = time.monotonic() + budget_ms / 1000.0
        # retrieve: the existing KNN read plane, same index the /query
        # route answers from.  The search runs in an executor — it
        # takes the replica's _index_lock, and blocking the only event
        # loop would stall /replica/health into a router ejection.
        loop = asyncio.get_running_loop()
        matches: list = []
        if k > 0:
            if values.get("vec") is not None:
                try:
                    vec = np.asarray(
                        values["vec"], dtype=np.float32
                    ).reshape(-1)
                except (TypeError, ValueError):
                    span.set_attribute("status", 400)
                    return web.json_response(
                        {"error": "`vec` must be a numeric array"},
                        status=400,
                        headers=headers,
                    )
            else:
                vec = text_vector(prompt, srv.dim)
            results = await loop.run_in_executor(
                None, srv.search, [(vec, k, None)]
            )
            matches = [
                [int(key), float(score)] for key, score in results[0]
            ]
        from pathway_tpu_torch.xpacks.llm.decoder import encode_text

        full_prompt = assemble_prompt(prompt, matches)
        prompt_tokens = encode_text(full_prompt)
        # leave room for the generation inside the decoder bound
        limit = sched.config.max_len - max_tokens
        if limit < 2:
            span.set_attribute("status", 400)
            return web.json_response(
                {"error": "max_tokens leaves no room for the prompt"},
                status=400,
                headers=headers,
            )
        prompt_tokens = prompt_tokens[:limit]
        stream = bool(values.get("stream", False))
        token_q: asyncio.Queue | None = (
            asyncio.Queue() if stream else None
        )

        def on_token(tok: int, done: bool) -> None:
            if token_q is not None:
                loop.call_soon_threadsafe(token_q.put_nowait, (tok, done))

        req = GenerationRequest(
            request_id=f"g{srv.replica_id}-{id(request):x}-"
            f"{int(time.monotonic() * 1e6):x}",
            prompt_tokens=prompt_tokens,
            deadline=deadline,
            max_new_tokens=max_tokens,
            tenant=request.headers.get("x-pathway-tenant"),
            tenant_class=request.headers.get("x-pathway-tenant-class"),
            temperature=temperature,
            top_k=top_k,
            seed=seed,
            on_token=on_token if stream else None,
            traceparent=(
                span.context.traceparent()
                if span.context is not None
                else None
            ),
        )
        done_ev = asyncio.Event()
        req.on_done = lambda: loop.call_soon_threadsafe(done_ev.set)
        if req.done.is_set():
            done_ev.set()  # finished before the hook landed
        try:
            sched.submit(req)
        except ShedError as e:
            span.set_attribute("status", e.status)
            return web.json_response(
                {"error": f"generation shed: {e.reason}"},
                status=e.status,
                headers={
                    "Retry-After": f"{e.retry_after_s:.3f}",
                    **headers,
                },
            )
        if stream:
            return await _stream_response(
                request, req, token_q, matches, headers, span
            )
        budget = deadline - time.monotonic() + 5.0
        try:
            await asyncio.wait_for(done_ev.wait(), timeout=max(budget, 0.1))
        except asyncio.TimeoutError:
            pass
        result = req.result
        if result is None:
            result = {"status": 504, "error": "generation timed out"}
        status = int(result.get("status", 500))
        span.set_attribute("status", status)
        headers["x-pathway-generate-tokens"] = str(
            result.get("token_count", len(result.get("tokens", []) or []))
            if status == 200
            else result.get("tokens", 0)
        )
        body = (
            {
                "text": result.get("text", ""),
                "tokens": result.get("tokens", []),
                "token_count": result.get("token_count", 0),
                "retrieved": matches,
                "request_id": req.request_id,
            }
            if status == 200
            else {"error": result.get("error", "generation failed")}
        )
        if status in (429, 503, 504):
            headers.setdefault("Retry-After", "1.0")
        return web.json_response(body, status=status, headers=headers)


async def _stream_response(
    request: Any,
    req: Any,
    token_q: Any,
    matches: list,
    headers: dict,
    span: Any,
):
    """NDJSON chunked streaming: meta line, token lines, done line."""
    from pathway_tpu_torch.io.http import _web as web

    resp = web.StreamResponse(
        status=200,
        headers={"content-type": "application/x-ndjson", **headers},
    )
    await resp.prepare(request)

    async def line(obj: dict) -> None:
        await resp.write((json.dumps(obj) + "\n").encode())

    try:
        return await _stream_body(req, token_q, matches, span, resp, line)
    except (ConnectionResetError, OSError):
        # client disconnected mid-stream: once the response is
        # PREPARED no second response can go out — swallow the write
        # failure (the scheduler finishes the sequence regardless) and
        # hand the half-written response back as-is
        span.set_attribute("status", "client_disconnect")
        return resp


async def _stream_body(
    req: Any, token_q: Any, matches: list, span: Any, resp: Any, line: Any
):
    import asyncio

    from pathway_tpu_torch.xpacks.llm.decoder import decode_tokens

    await line({"meta": {"retrieved": matches, "request_id": req.request_id}})
    n = 0
    finished = False
    while not finished:
        # the request's own deadline bounds the wait; the scheduler's
        # mid-decode drop resolves req.done so the loop always ends
        if req.done.is_set():
            # every on_token call_soon_threadsafe preceded finish() on
            # the scheduler thread: one yield lets those callbacks land
            # so no trailing token line is dropped, then drain
            await asyncio.sleep(0)
            await asyncio.sleep(0.02)
            while not token_q.empty():
                tok, _d = token_q.get_nowait()
                n += 1
                await line(
                    {
                        "token": int(tok),
                        "text_delta": decode_tokens([int(tok)]),
                    }
                )
            break
        try:
            tok, done = await asyncio.wait_for(token_q.get(), timeout=0.25)
        except asyncio.TimeoutError:
            continue
        n += 1
        await line(
            {"token": int(tok), "text_delta": decode_tokens([int(tok)])}
        )
        finished = done
    # on_token(done=True) fires BEFORE finish() on the scheduler
    # thread: give the result a moment to land before reading it
    for _ in range(200):
        if req.done.is_set():
            break
        await asyncio.sleep(0.01)
    result = req.result or {"status": 504, "error": "dropped"}
    status = int(result.get("status", 500))
    # the HTTP status is committed (200 at prepare), but the replica's
    # request accounting must see the generation's REAL outcome — a
    # mid-stream 504 drop counted as 200 would hide deadline pressure
    # from streaming clients entirely
    resp._pathway_status_override = status
    span.set_attribute("status", status)
    span.set_attribute("streamed_tokens", n)
    if status == 200:
        await line(
            {
                "done": True,
                "token_count": result.get("token_count", n),
                "text": result.get("text", ""),
            }
        )
    else:
        await line(
            {
                "done": True,
                "status": status,
                "error": result.get("error", "generation failed"),
            }
        )
    await resp.write_eof()
    return resp
